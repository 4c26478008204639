"""Throughput of the sharded scan by rank count, and the bytes each rank
exchanges, counted in the run.

The counterpart of the JAX package's ``tools/scaling_bench.py``, which
times 1 device against 8 virtual CPU devices of one process.  Torch has no
virtual devices, so this times one rank against R ranks, each
a process started through ``parallel.multihost.RankProcesses``.  Every
rank scans the same bytes per rank (``--per-device-bytes``, 4 MiB) of a
corpus of 200 names (seed 42, the upstream LONG recipe of
``tools/_synth.py``) with ``parallel.sharded.scan_sharded`` over
``models.automaton.build_automaton`` and ``ops.scan_cuda.DeviceTables``
(the DFA engine, so K2 with its head and K3 on a card): a warm call, then
the best of three, each after a barrier and ending in a host fetch.  A
call's time is the slower rank's.

R is 2, or the card count where there are two cards or more (then over
NCCL); both runs use the backend of the R-rank run
(``multihost.pick_backend``): gloo where the ranks share one card.

The bytes a rank exchanges are counted, not guessed: each rank's group
records every ``all_gather`` it sends, and the matched (position, state)
pairs it contributed to the gathered outputs.  ``comm_bytes_per_shard``
is the reference's quantity, the halo (``max_len - 1`` bytes) plus 8
bytes a pair, from those counts; ``wire_bytes_by_rank`` is what the
collectives moved (the halo as int32, the outputs as int64 padded to the
compaction capacity).  Every rank's pairs must equal the host tier's
(``native``) on the same bytes.

Run from the repository root::

    python -m ahocorasick_rs_tpu_torch.tools.scaling_bench [--device cpu] \
        [--per-device-bytes N] [--out PATH]

Without ``--device`` the ranks run on the card, and without one the tool
exits non-zero.  It writes its record under the key ``scaling_bench`` of
``--out``, by default ``H100_SCALING.json`` at the repository root on a
card (never ``SCALING_r03.json``); on the CPU only where ``--out`` is
given.  It exits non-zero when a rank's pairs differ from the host tier's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..api import BytesAhoCorasick, _resolve_device
from ..models.automaton import build_automaton
from ..ops.scan_cuda import DeviceTables
from ..parallel import multihost, sharded
from ._synth import synth_corpus, synth_names
from .gpu_conformance import _commit, source_hash
from .multihost_run import OUT, RANK_TIMEOUT_S, card_label, merge_record, \
    spawn

MODULE = "ahocorasick_rs_tpu_torch.tools.scaling_bench"
SEED = 42
NAMES = 200
PER_DEVICE_BYTES = 4 << 20
REPS = 3


class CountingGroup(sharded.ShardGroup):
    """A ``ShardGroup`` that counts the bytes it sends, and keeps the
    totals row of the last gathered outputs (int64, last column)."""

    def __init__(self, group: Optional[dist.ProcessGroup]) -> None:
        super().__init__(group)
        self.sent: list[int] = []
        self.totals: Optional[list[int]] = None

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self.sent.append(t.numel() * t.element_size())
        out = super().all_gather(t)
        if t.dtype == torch.int64:  # the compacted outputs, not the halo
            self.totals = out[:, -1].tolist()
        return out


def corpus(world: int, per_rank: int) -> tuple[list[bytes], np.ndarray]:
    """The names and ``world * per_rank`` bytes of corpus."""
    rng = np.random.default_rng(SEED)
    names = synth_names(NAMES, rng)
    return names, synth_corpus(world * per_rank, names, rng)


def pairs_digest(pos: np.ndarray, st: np.ndarray) -> str:
    h = hashlib.sha256(np.asarray(pos, np.int64).tobytes())
    h.update(np.asarray(st, np.int64).tobytes())
    return h.hexdigest()


def rank_child(a: argparse.Namespace) -> dict:
    """One rank: join the group, scan the corpus sharded, count."""
    backend = a.backend
    dev = torch.device(multihost.rank_device(backend, a.rank, a.device))
    multihost.init_distributed(a.init_method, a.world_size, a.rank, backend)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        names, hay = corpus(a.world_size, a.per_device_bytes)
        am = build_automaton(names)
        tables = DeviceTables(am, "dfa", dev)
        g = CountingGroup(dist.group.WORLD)
        pos, st = sharded.scan_sharded(am, hay, tables, g)  # warm
        best = float("inf")
        for _ in range(REPS):
            g.sent = []
            dist.barrier()
            t0 = time.perf_counter()
            pos, st = sharded.scan_sharded(am, hay, tables, g)
            _ = int(pos.sum()) if len(pos) else 0  # host fetch
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        halo = am.max_len - 1
        pairs = g.totals[g.rank]
        return {
            "rank": g.rank, "world_size": g.size,
            "backend": dist.get_backend(), "device": str(dev),
            "nbytes": len(hay), "scan_seconds_best": best,
            "matches": len(pos), "digest": pairs_digest(pos, st),
            "halo_bytes": halo, "pairs": pairs,
            "comm_bytes": halo + 8 * pairs,
            "wire_bytes": sum(g.sent), "collectives": len(g.sent),
        }
    finally:
        dist.destroy_process_group()


def host_pairs(world: int, per_rank: int) -> tuple[int, str]:
    """The ``native`` host tier's pair count and digest on the corpus."""
    names, hay = corpus(world, per_rank)
    ac = BytesAhoCorasick(names, backend="native", device="cpu")
    pos, st = ac._host_scan(hay, "native")
    return len(pos), pairs_digest(pos, st)


def run_world(
    world: int, per_rank: int, backend: str, device: Optional[str],
    timeout: float = RANK_TIMEOUT_S,
) -> list[dict]:
    """``world`` ranks of :func:`rank_child`; their records."""
    args = ["--child", "--backend", backend,
            "--per-device-bytes", str(per_rank)]
    if device is not None:
        args += ["--device", device]
    with tempfile.TemporaryDirectory(prefix="sb_") as tmp, spawn(
            MODULE, world, args, tmp, tag=f"scaling{world}") as ranks:
        return ranks.records(timeout)


def default_ranks(device: Optional[str]) -> int:
    """2, or the card count where there are two or more and the ranks run
    on the cards."""
    on_cards = device is None or torch.device(device).type == "cuda"
    n = torch.cuda.device_count() if on_cards else 0
    return n if n >= 2 else 2


def run(
    device: Optional[str] = None,
    ranks: Optional[int] = None,
    per_rank: int = PER_DEVICE_BYTES,
    commit: Optional[str] = None,
    timeout: float = RANK_TIMEOUT_S,
) -> dict:
    """One rank against ``ranks`` ranks; the record."""
    gpu = card_label(device)
    R = ranks or default_ranks(device)
    backend = multihost.pick_backend(R, device)
    runs = {}
    mismatches = []
    for world in sorted({1, R}):
        records = run_world(world, per_rank, backend, device, timeout)
        want = host_pairs(world, per_rank)
        for r in records:
            if (r["matches"], r["digest"]) != want:
                mismatches.append(
                    f"{world} ranks, rank {r['rank']}: {r['matches']} pairs "
                    f"{r['digest'][:16]}, host tier {want[0]} "
                    f"{want[1][:16]}")
        runs[world] = records
    t1 = max(r["scan_seconds_best"] for r in runs[1])
    tR = max(r["scan_seconds_best"] for r in runs[R])
    comm = [r["comm_bytes"] for r in runs[R]]
    return {
        "tool": "python -m ahocorasick_rs_tpu_torch.tools.scaling_bench",
        "gpu": gpu,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "commit": commit or _commit(),
        "source_hash": source_hash(),
        "mesh": f"1 rank against {R} ranks, one process each, over "
                f"torch.distributed ({backend})",
        "backend": backend,
        "ranks": R,
        "names": NAMES,
        "per_device_bytes": per_rank,
        "seconds_1dev": t1,
        f"seconds_{R}dev": tR,
        "bytes_per_s_1dev": per_rank / t1,
        f"bytes_per_s_{R}dev": R * per_rank / tR,
        "weak_scaling_efficiency": t1 / tR,
        "weak_scaling_caveat": (
            "ranks on one card share it, the host's cores and memory; the "
            "collectives of gloo go through the host.  Not a measure of "
            "NCCL across cards"),
        "halo_bytes": runs[R][0]["halo_bytes"],
        "comm_bytes_per_shard": comm,
        "comm_byte_ratio": max(comm) / per_rank,
        # every run by its rank count: each rank's device, time and counts
        "by_world": {w: {k: [r[key] for r in recs] for k, key in (
            ("devices_by_rank", "device"),
            ("seconds_by_rank", "scan_seconds_best"),
            ("pairs_by_rank", "pairs"),
            ("comm_bytes_by_rank", "comm_bytes"),
            ("wire_bytes_by_rank", "wire_bytes"),
            ("collectives_by_rank", "collectives"),
            # the kernels each rank's process launched, warm call included
            ("launches_by_rank", "launches"))}
            for w, recs in runs.items()},
        "exact_vs_host_tier": not mismatches,
        "mismatches": mismatches,
    }


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="every rank's device, e.g. cpu (default: the cards)")
    p.add_argument("--per-device-bytes", type=int, default=PER_DEVICE_BYTES)
    p.add_argument("--out", default=None,
                   help=f"the record's file (default on a card: {OUT})")
    p.add_argument("--commit", default=None,
                   help="the commit to record where the tree is no git "
                        "checkout")
    # a rank of the run, started by run_world
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--init-method", "--backend"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world-size", type=int, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.child:
        record = rank_child(a)
        with open(a.out, "w") as f:
            json.dump(record, f)
        return 0
    try:
        dev = _resolve_device(a.device)
    except RuntimeError as e:
        raise SystemExit(f"scaling_bench: {e}; on the command line: "
                         "--device cpu")
    record = run(a.device, per_rank=a.per_device_bytes, commit=a.commit)
    out = a.out if a.out is not None or dev.type != "cuda" else OUT
    if out is not None:
        merge_record(out, "scaling_bench", record)
    print(json.dumps(record), flush=True)
    if record["mismatches"]:
        print("PAIRS MISMATCH: sharded != host tier", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
