"""Multi-process runs of the sharded scan: every rank's digests held to one
process's, and the weak scaling of a second rank.

The counterpart of the JAX package's ``tools/multihost_run.py``.  It starts
``--num-processes`` ranks of the port's worker, ``python -m
ahocorasick_rs_tpu_torch.parallel.multihost``, through
``parallel.multihost.RankProcesses`` (a ``file://`` rendezvous in a
temporary directory).  Each rank scans the worker's demo corpus through
the public API with ``backend="sharded"`` for the four semantics and the
Standard batch.  The tool holds every rank's digests to each other's and
to one process's truth: ``multihost.semantics_digests`` on the port's
``native`` host tier on the CPU, not the sharded path under test.

The backend follows the worker's rule (``multihost.pick_backend``): NCCL
with a card per rank, else gloo, with ranks sharing the cards (or on the
CPU with ``--device cpu``).  A rank has one device, so the reference's
``--devices-per-process`` has no counterpart.  The record names the
backend that ran and the device of every rank.

Then, unless ``--no-weak-scaling``, weak scaling: one rank scanning N
bytes against two ranks scanning 2N (N each), every rank pinned to a core
of its own (``os.sched_setaffinity`` in the child, one torch thread) and
both runs over the backend of the two-rank run, beside a control: two
unrelated one-rank runs at once, pinned to the same two cores.  The
control splits the efficiency into contention (one rank alone against
two unrelated ones) and the cost of being one group (the pair against
the two-rank run).  ``--curve`` measures that point at :data:`CURVE`'s
sizes instead of ``--nbytes``.  A call's time is the slower rank's best
of its repeats.  Every timed run's digests are held to the truth at its
haystack's size too, so a timing comes only from a run that was right.
Each rank's record also names the kernels its process launched
(``launches_by_rank``).

Run from the repository root::

    python -m ahocorasick_rs_tpu_torch.tools.multihost_run [--device cpu] \
        [--num-processes 2] [--nbytes 4194304] [--curve] [--out PATH]

Without ``--device`` the ranks run on the card, and without one the tool
exits non-zero.  It writes its record under the key ``multihost_run`` (or
``multihost_run_curve``) of ``--out``, by default ``H100_SCALING.json``
at the repository root on a card; on the CPU only where ``--out`` is
given.  It exits non-zero when a rank's digests differ.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from ..api import _resolve_device
from ..parallel import multihost
from .gpu_conformance import ROOT, _commit, source_hash
from .probe_transpose_kernel import device_label

#: the record's path when a run on a card names none
OUT = os.path.join(ROOT, "H100_SCALING.json")
WORKER = "ahocorasick_rs_tpu_torch.parallel.multihost"
#: seconds a spawned run may take before its ranks are killed
RANK_TIMEOUT_S = 1800.0
#: ``--curve``'s points: (bytes per rank, repeats, runs)
CURVE = ((16 << 20, 8, 2), (64 << 20, 6, 2), (256 << 20, 4, 1))
#: the cores pinned ranks run on, rank by rank
CORES = (0, 1)
#: runs a module as ``python -m`` would, first pinning the process to the
#: core named by its first argument unless that is ``-``; then writes the
#: kernels the process launched (nonzero counts) into the record the
#: module wrote to its ``--out``, under ``launches``
_RUN = """\
import json, os, runpy, sys
core, sys.argv = sys.argv[1], sys.argv[2:]
if core != "-":
    os.sched_setaffinity(0, {int(core)})
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code:
        raise
from ahocorasick_rs_tpu_torch import _kernels
out = sys.argv[sys.argv.index("--out") + 1]
with open(out) as f:
    record = json.load(f)
record["launches"] = {k: v for k, v in _kernels.LAUNCHES.items() if v}
with open(out, "w") as f:
    json.dump(record, f)
"""


def card_label(device: Optional[str]) -> str:
    """``nvidia-smi``'s name and power limit of the first card, or the
    CPU's label where the ranks run on the CPU."""
    dev = _resolve_device(device)
    return device_label(torch.device("cuda", 0) if dev.type == "cuda"
                        else dev)


def spawn(
    module: str,
    world: int,
    args: list[str],
    work_dir: str,
    *,
    cores: Optional[tuple[int, ...]] = None,
    tag: str = "ranks",
) -> multihost.RankProcesses:
    """Start ``world`` ranks of ``python -m module`` with ``args`` and
    the rank's ``--init-method``, ``--world-size``, ``--rank`` and
    ``--out`` (a rendezvous, records and logs in ``work_dir``); rank ``r``
    pinned to ``cores[r]`` where ``cores`` is given.  Each rank's record
    gains the kernels its process launched (:data:`_RUN`)."""
    def argv(r: int, init: str, out: str) -> list[str]:
        core = str(cores[r]) if cores else "-"
        return [sys.executable, "-c", _RUN, core, module, "--init-method",
                init, "--world-size", str(world), "--rank", str(r), "--out",
                out, *args]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    return multihost.RankProcesses(argv, world, work_dir, tag=tag, cwd=ROOT,
                                   env=env)


def worker_args(
    nbytes: int, repeats: int, backend: str, device: Optional[str],
    threads: Optional[int],
) -> list[str]:
    args = ["--nbytes", str(nbytes), "--repeats", str(repeats),
            "--backend", backend]
    if device is not None:
        args += ["--device", device]
    if threads:
        args += ["--threads", str(threads)]
    return args


def run_ranks(
    world: int,
    nbytes: int,
    *,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    repeats: int = 3,
    cores: Optional[tuple[int, ...]] = None,
    threads: Optional[int] = None,
    timeout: float = RANK_TIMEOUT_S,
) -> list[dict]:
    """``world`` ranks of the port's worker over ``nbytes`` of its demo
    corpus; their records in rank order.  Raises ``RuntimeError`` with a
    failed rank's log, and kills every rank still running, when one
    fails or ``timeout`` seconds pass."""
    backend = backend or multihost.pick_backend(world, device)
    with tempfile.TemporaryDirectory(prefix="mh_") as tmp:
        with spawn(WORKER, world,
                   worker_args(nbytes, repeats, backend, device, threads),
                   tmp, cores=cores, tag=f"{backend}{world}") as ranks:
            return ranks.records(timeout)


@functools.lru_cache(maxsize=None)
def single_process_truth(nbytes: int) -> dict:
    """Digests of the four semantics and the Standard batch from one
    process, on the ``native`` host tier on the CPU."""
    pats, hay = multihost.demo_corpus(nbytes)
    return multihost.semantics_digests(
        pats, hay, backend="native", device="cpu")


def mismatches(records: list[dict], truth: dict) -> list[str]:
    """Every (rank, semantics) whose count or digest differs from the
    truth's, and every rank whose digests differ from rank 0's."""
    bad = []
    for r in records:
        for name, want in truth.items():
            got = r["semantics"].get(name, {})
            if (got.get("matches"), got.get("digest")) != (
                    want["matches"], want["digest"]):
                bad.append(f"rank {r['rank']} {name}: {got} != truth {want}")
        if r["semantics"] != records[0]["semantics"]:
            bad.append(f"rank {r['rank']} differs from rank 0")
    return bad


def _best(records: list[dict]) -> float:
    """A call's time: the slower rank's best."""
    return max(r["scan_seconds_best"] for r in records)


def checked_best(records: list[dict], bad: list[str], what: str) -> float:
    """:func:`_best` of a timed run whose ranks' digests are first held to
    the truth at their haystack's size; each mismatch, prefixed with
    ``what``, goes to ``bad``."""
    truth = single_process_truth(records[0]["nbytes"])
    bad.extend(f"{what}: {m}" for m in mismatches(records, truth))
    return _best(records)


def weak_scaling(
    nbytes_per_rank: int,
    backend: str,
    device: Optional[str] = None,
    repeats: int = 8,
    runs: int = 2,
) -> dict:
    """One rank over ``nbytes_per_rank`` against two ranks over twice as
    many, each rank pinned to a core of its own with one torch thread, both
    over ``backend``; bytes per rank constant.  The best of ``runs``.
    Beside them the control pair (:func:`independent_pair`), which splits
    the efficiency into its contention part (one rank alone against the
    pair) and its group part (the pair against the two-rank run).  Every
    timed run's digests are held to the truth at its size; the point's
    ``mismatches`` lists each difference."""
    kw = dict(device=device, backend=backend, repeats=repeats, threads=1)
    bad: list[str] = []
    t1 = min(checked_best(run_ranks(1, nbytes_per_rank, cores=CORES[:1],
                                    **kw), bad, "1 rank")
             for _ in range(runs))
    t2 = min(checked_best(run_ranks(2, 2 * nbytes_per_rank, cores=CORES,
                                    **kw), bad, "2 ranks")
             for _ in range(runs))
    t_ind = independent_pair(nbytes_per_rank, backend, device,
                             max(4, repeats - 2), runs, bad)
    return {
        "nbytes_per_process": nbytes_per_rank,
        "backend": backend,
        "seconds_1proc": t1,
        "seconds_2proc": t2,
        "bytes_per_s_1proc": nbytes_per_rank / t1,
        "bytes_per_s_2proc": 2 * nbytes_per_rank / t2,
        "weak_scaling_efficiency": t1 / t2,
        "seconds_independent_pair": t_ind,
        "memory_contention_efficiency": t1 / t_ind,
        "communication_efficiency": t_ind / t2,
        "timed_runs_checked": 4 * runs,
        "mismatches": bad,
        "method": (
            "os.sched_setaffinity-pinned 1 core and 1 torch thread per "
            "rank in both configs; bytes per rank constant; a call's time "
            f"is the slower rank's best of {repeats}; best of {runs} runs"
        ),
    }


def independent_pair(
    nbytes: int,
    backend: str,
    device: Optional[str] = None,
    repeats: int = 6,
    runs: int = 2,
    bad: Optional[list[str]] = None,
) -> float:
    """The control: two unrelated one-rank runs started together, each
    with its own rendezvous, pinned to the two cores of the two-rank run.
    The slower one's best seconds, the best of ``runs``; each run's digests
    held to the truth, its mismatches added to ``bad``."""
    bad = [] if bad is None else bad
    best = float("inf")
    args = worker_args(nbytes, repeats, backend, device, 1)
    for _ in range(runs):
        with tempfile.TemporaryDirectory(prefix="mh_ind_") as tmp, \
                contextlib.ExitStack() as stack:
            pair = [stack.enter_context(spawn(
                WORKER, 1, args, tmp, cores=(core,), tag=f"ind{i}"))
                for i, core in enumerate(CORES)]
            times = [checked_best(p.records(RANK_TIMEOUT_S), bad,
                                  f"control rank {i}")
                     for i, p in enumerate(pair)]
        best = min(best, max(times))
    return best


def weak_scaling_curve(
    backend: str, device: Optional[str] = None,
    points: tuple = CURVE,
) -> list[dict]:
    """:func:`weak_scaling` at each of ``points``' bytes per rank, each
    point's runs held to the truth at its sizes."""
    out = []
    for nbytes, repeats, runs in points:
        pt = weak_scaling(nbytes, backend, device, repeats, runs)
        out.append(pt)
        print(f"curve point {nbytes >> 20} MiB/rank: "
              f"eff={pt['weak_scaling_efficiency']:.4f} (contention "
              f"{pt['memory_contention_efficiency']:.4f} x group "
              f"{pt['communication_efficiency']:.4f})", flush=True)
    return out


def merge_record(path: str, key: str, value: dict) -> None:
    """Write ``value`` under ``key`` of the JSON object at ``path``,
    keeping its other keys."""
    try:
        with open(path) as f:
            record = json.load(f)
    except FileNotFoundError:
        record = {}
    record[key] = value
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


def run(
    num_processes: int = 2,
    nbytes: int = 4 << 20,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    curve: bool = False,
    weak: bool = True,
    commit: Optional[str] = None,
    timeout: float = RANK_TIMEOUT_S,
    threads: Optional[int] = None,
) -> dict:
    """The ranks' run (``threads`` torch threads a rank), its checks and
    (``weak``) the weak scaling or (``curve``) its curve; the record.
    ``bit_exact_vs_single_process`` is false where any run, the timed ones
    of the weak scaling included, differs from the truth."""
    gpu = card_label(device)
    t0 = time.perf_counter()
    records = run_ranks(num_processes, nbytes, device=device,
                        backend=backend, timeout=timeout, threads=threads)
    truth = single_process_truth(nbytes)
    bad = mismatches(records, truth)
    sem_names = sorted(truth)
    run_seconds = time.perf_counter() - t0
    # the weak scaling's two runs share the backend of a two-rank run
    weak_backend = backend if backend is not None else (
        multihost.pick_backend(2, device))
    ws = (weak_scaling(nbytes, weak_backend, device)
          if weak and not curve else None)
    points = weak_scaling_curve(weak_backend, device) if curve else None
    for pt in ([ws] if ws else []) + (points or []):
        bad += [f"{pt['nbytes_per_process']} bytes a rank, {m}"
                for m in pt["mismatches"]]
    return {
        "tool": "python -m ahocorasick_rs_tpu_torch.tools.multihost_run",
        "what": (
            f"{num_processes} ranks of python -m {WORKER} over "
            f"torch.distributed ({records[0]['backend']}), the public-API "
            "sharded scan "
            "over the default process group"
        ),
        "gpu": gpu,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "commit": commit or _commit(),
        "source_hash": source_hash(),
        "num_processes": num_processes,
        "backend": records[0]["backend"],
        "devices_by_rank": [r["device"] for r in records],
        "launches_by_rank": [r["launches"] for r in records],
        "nbytes": nbytes,
        "bit_exact_vs_single_process": not bad,
        "mismatches": bad,
        "truth": "multihost.semantics_digests, native host tier, CPU",
        "semantics_verified": sem_names,
        "per_semantics_matches": {s: truth[s]["matches"] for s in sem_names},
        "tier_by_semantics": {s: records[0]["semantics"][s]["backend"]
                              for s in sem_names},
        "scan_seconds_by_rank": [r["scan_seconds_best"] for r in records],
        "scan_seconds_best": _best(records),
        "scan_gbps": nbytes / _best(records) / 1e9,
        "run_seconds": run_seconds,
        "caveat": (
            "Ranks on one card share it over gloo: the weak scaling "
            "measures what a second process costs (the collectives through "
            "the host, and contention for the host's cores, memory and the "
            "card), not NCCL across cards.  Every rank holds the whole "
            "haystack and encodes it on each call, and stages only its own "
            "shard.  The control pair runs the same two pinned ranks "
            "without a group."
        ),
        "weak_scaling": ws,
        "weak_scaling_curve": points,
    }


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--nbytes", type=int, default=4 << 20,
                   help="haystack bytes of the checked run")
    p.add_argument("--device", default=None,
                   help="every rank's device, e.g. cpu or cuda:0 (default: "
                        "a card per rank under NCCL, else shared cards)")
    p.add_argument("--curve", action="store_true",
                   help="the efficiency at each size of CURVE, with its "
                        "control, instead of one weak-scaling point")
    p.add_argument("--no-weak-scaling", action="store_true",
                   help="the checked run only")
    p.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S,
                   help="seconds the checked run may take")
    p.add_argument("--threads", type=int, default=None,
                   help="torch threads of each rank of the checked run")
    p.add_argument("--out", default=None,
                   help=f"the record's file (default on a card: {OUT})")
    p.add_argument("--commit", default=None,
                   help="the commit to record where the tree is no git "
                        "checkout")
    a = p.parse_args(argv)
    try:
        dev = _resolve_device(a.device)
    except RuntimeError as e:
        raise SystemExit(f"multihost_run: {e}; on the command line: "
                         "--device cpu")
    record = run(a.num_processes, a.nbytes, a.device, curve=a.curve,
                 weak=not a.no_weak_scaling, commit=a.commit,
                 timeout=a.timeout, threads=a.threads)
    out = a.out if a.out is not None or dev.type != "cuda" else OUT
    if out is not None:
        merge_record(out, "multihost_run_curve" if a.curve
                     else "multihost_run", record)
    print(json.dumps(record, indent=1), flush=True)
    if not record["bit_exact_vs_single_process"]:
        print("DIGEST MISMATCH: multi-process != single-process",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
