"""Multi-process execution of the sharded scan over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``.  Every
process is one rank: it builds the same automaton (construction is
deterministic), holds the same haystack, and calls the public API with
``backend="sharded"`` and ``mesh=`` the default process group; the sharded
scan (``parallel/sharded.py``) splits the haystack across the ranks.
Failures during initialization are raised at once: a partly initialized
group never falls back to one process.

One command per rank (here two ranks on one machine, one card each)::

    python -m ahocorasick_rs_tpu_torch.parallel.multihost \
        --init-method tcp://10.0.0.1:29500 --world-size 2 --rank 0
    python -m ahocorasick_rs_tpu_torch.parallel.multihost \
        --init-method tcp://10.0.0.1:29500 --world-size 2 --rank 1

The backend is NCCL, with rank ``r`` on ``cuda:r``, when the machine has
a card for every rank, else gloo (ranks share the cards, or run on the
CPU with ``--device cpu``).  ``--init-method file:///path`` rendezvous
through a file that no other run uses.  Each rank prints one JSON record:
per-semantics match counts and digests (equal on every rank and to a
single-process run) and the best scan time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


def pick_backend(world_size: int, device: Optional[str] = None) -> str:
    """NCCL when every rank can have a card of its own, else gloo."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(
    init_method: str,
    world_size: int,
    rank: int,
    backend: Optional[str] = None,
) -> None:
    """Initialize the default process group (idempotent, fail-fast)."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend or pick_backend(world_size),
        init_method=init_method,
        world_size=world_size,
        rank=rank,
    )


def global_mesh(device_type: Optional[str] = None) -> object:
    """Every rank of the initialized default group: the group itself, or
    a 1-D ``DeviceMesh`` of ``device_type`` over it."""
    if device_type is None:
        return dist.group.WORLD
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),))


def rank_device(backend: str, rank: int, device: Optional[str]) -> str:
    """The rank's torch device: ``device`` when given, else its own card
    under NCCL or a shared card under gloo.  Raises without a card: the
    ranks run on the CPU only when ``device`` asks for it."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass --device cpu to run the ranks on the CPU"
        )
    if backend == "nccl":
        return f"cuda:{rank}"
    return f"cuda:{rank % torch.cuda.device_count()}"


def demo_corpus(
    nbytes: int, seed: int = 42, npatterns: int = 200
) -> tuple[list[str], str]:
    """Deterministic (patterns, haystack) every process can rebuild.

    Lowercase 6-char patterns over a random lowercase haystack with a few
    planted occurrences, including some spanning the byte ranges where
    shard boundaries fall for small power-of-two rank counts.
    """
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    pats = sorted(
        {
            bytes(letters[rng.integers(0, 26, 6)]).decode()
            for _ in range(npatterns)
        }
    )
    hay = bytearray(bytes(letters[rng.integers(0, 26, nbytes)]))
    # plant matches, including at likely shard boundaries (n/2, n/4, ...)
    spots = [int(x) for x in rng.integers(0, max(nbytes - 8, 1), 64)]
    spots += [nbytes // 2 - 3, nbytes // 4 - 3, (3 * nbytes) // 4 - 3]
    for i, s in enumerate(spots):
        if 0 <= s <= nbytes - 6:
            hay[s : s + 6] = pats[i % len(pats)].encode()
    return pats, hay.decode()


def _match_digest(matches: list[tuple[int, int, int]]) -> str:
    h = hashlib.sha256()
    for t in matches:
        h.update(repr(t).encode())
    return h.hexdigest()


#: the four public semantics: (match kind name, overlapping)
SEMANTICS = (
    ("Standard", False),
    ("Standard", True),
    ("LeftmostFirst", False),
    ("LeftmostLongest", False),
)


def demo_docs(hay: str) -> list[str]:
    """The demo haystack cut into documents of 0-1,199 characters."""
    rng = np.random.default_rng(7)
    cuts = np.cumsum(rng.integers(0, 1200, len(hay) // 300 + 2))
    cuts = [0] + [int(c) for c in cuts if c < len(hay)] + [len(hay)]
    return [hay[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def semantics_digests(
    pats: list[str], hay: str, **kwargs: object
) -> dict[str, dict]:
    """Match count and digest of each public semantics over ``hay``, and
    of the Standard batch over :func:`demo_docs`, from matchers built with
    ``kwargs``."""
    from ..api import AhoCorasick
    from ..models.engine import MatchKind

    out = {}
    for kind, overlapping in SEMANTICS:
        ac = AhoCorasick(pats, matchkind=MatchKind[kind], **kwargs)
        matches = ac.find_matches_as_indexes(hay, overlapping=overlapping)
        out[kind + ("_overlapping" if overlapping else "")] = {
            "matches": len(matches),
            "digest": _match_digest(matches),
            "backend": ac.stats()["last_backend"],
        }
    ac = AhoCorasick(pats, **kwargs)
    per_doc = ac.find_matches_as_indexes_batch(demo_docs(hay))
    out["Standard_batch"] = {
        "matches": sum(map(len, per_doc)),
        "digest": _match_digest(
            [(i, *t) for i, doc in enumerate(per_doc) for t in doc]
        ),
        "backend": ac.stats()["last_backend"],
    }
    return out


def run_worker(
    init_method: str,
    world_size: int,
    rank: int,
    *,
    nbytes: int = 4 << 20,
    repeats: int = 3,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    device_mesh: bool = False,
    out_path: Optional[str] = None,
) -> dict:
    """Join the group, scan the demo corpus through the public API with
    ``backend="sharded"`` for all four semantics and as a batch, time the
    Standard scan, and return (and optionally write) the rank's record.
    ``device_mesh`` passes ``mesh=`` a ``DeviceMesh``, else the group."""
    backend = backend or pick_backend(world_size, device)
    dev = rank_device(backend, rank, device)
    init_distributed(init_method, world_size, rank, backend)
    try:
        if torch.device(dev).type == "cuda":
            torch.cuda.set_device(torch.device(dev))
        mesh = global_mesh(torch.device(dev).type if device_mesh else None)
        pats, hay = demo_corpus(nbytes)
        record: dict = {
            "rank": dist.get_rank(),
            "world_size": dist.get_world_size(),
            "backend": dist.get_backend(),
            "device": dev,
            "nbytes": nbytes,
            "semantics": semantics_digests(
                pats, hay, backend="sharded", mesh=mesh, device=dev
            ),
        }
        from ..api import AhoCorasick

        # throughput: best of `repeats` Standard scans, each after a
        # barrier so that one rank's host tail does not count against
        # another's scan
        ac = AhoCorasick(pats, backend="sharded", mesh=mesh, device=dev)
        ac.find_matches_as_indexes(hay)  # warm: tables, caps
        best = float("inf")
        for _ in range(repeats):
            dist.barrier()
            t0 = time.perf_counter()
            ac.find_matches_as_indexes(hay)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        record["scan_seconds_best"] = best
        record["scan_bytes_per_s"] = nbytes / best
    finally:
        dist.destroy_process_group()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f)
    return record


class RankProcesses:
    """``world`` ranks, each a child process, started at once.

    Rank ``r`` runs ``argv(r, init, out)``: ``init`` is a ``file://``
    rendezvous and ``out`` the path of the JSON record the rank writes,
    both in ``work_dir``, where each rank's output is logged too
    (``<tag>_rank<r>.log``).  :meth:`records` waits for the ranks and
    returns their records; :meth:`stop` (also on leaving a ``with``
    block) kills any rank still running."""

    def __init__(
        self,
        argv: Callable[[int, str, str], list[str]],
        world: int,
        work_dir: str,
        *,
        tag: str = "ranks",
        cwd: Optional[str] = None,
        env: Optional[dict] = None,
    ) -> None:
        os.makedirs(work_dir, exist_ok=True)
        rdv = os.path.join(work_dir, f"{tag}_rendezvous")
        if os.path.exists(rdv):
            os.remove(rdv)
        self.tag = tag
        #: (process, record path, log path) of each rank
        self.procs: list[tuple[subprocess.Popen, str, str]] = []
        try:
            for r in range(world):
                out = os.path.join(work_dir, f"{tag}_rank{r}.json")
                log = os.path.join(work_dir, f"{tag}_rank{r}.log")
                with open(log, "w") as log_f:
                    self.procs.append((subprocess.Popen(
                        argv(r, f"file://{rdv}", out), cwd=cwd, env=env,
                        stdout=log_f, stderr=subprocess.STDOUT,
                    ), out, log))
        except BaseException:
            self.stop()
            raise

    def records(self, timeout: float) -> list[dict]:
        """Every rank's record, in rank order.  Raises ``RuntimeError``,
        with the first failed rank's log tail, when a rank exits non-zero
        (its peers would wait in a collective, so this stops waiting at
        once) or ``timeout`` seconds pass first."""
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p, _, _ in self.procs]  # poll every rank
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{self.tag}: ranks still running after {timeout} s")
            time.sleep(0.2)
        bad = [(r, p.returncode, log) for r, (p, _, log)
               in enumerate(self.procs) if p.returncode not in (None, 0)]
        if bad:
            with open(bad[0][2]) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(
                f"{self.tag}: ranks {[(r, rc) for r, rc, _ in bad]} "
                f"failed; rank {bad[0][0]}:\n{tail}")
        records = []
        for _, out, _ in self.procs:
            with open(out) as f:
                records.append(json.load(f))
        return records

    def stop(self) -> None:
        for p, _, _ in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def __enter__(self) -> "RankProcesses":
        return self

    def __exit__(self, *exc: object) -> None:
        self.stop()


def main(argv: Optional[list[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--init-method", required=True,
        help="tcp://host:port or file:///path of the rendezvous",
    )
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--nbytes", type=int, default=4 << 20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default=None, help="e.g. cpu or cuda:0")
    p.add_argument(
        "--backend", default=None, choices=("nccl", "gloo"),
        help="default: nccl with a card per rank, else gloo",
    )
    p.add_argument(
        "--device-mesh", action="store_true",
        help="pass mesh= a 1-D DeviceMesh instead of the process group",
    )
    p.add_argument(
        "--threads", type=int, default=None,
        help="torch intra-op threads of this process",
    )
    p.add_argument("--out", default=None, help="write the record here")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    record = run_worker(
        args.init_method,
        args.world_size,
        args.rank,
        nbytes=args.nbytes,
        repeats=args.repeats,
        device=args.device,
        backend=args.backend,
        device_mesh=args.device_mesh,
        out_path=args.out,
    )
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
