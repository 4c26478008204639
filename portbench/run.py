"""Run one cell of ``BENCHMARK.json`` once and print its result line.

From the root of a checkout::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Before torch is imported the process binds itself to the CPUs local to
the cell's cards, where the host says which they are (``host.bind``).
Without as many CUDA cards
as the cell asks for it exits 2 and prints no result.  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a trace of the whole window.

Output: the host record as one JSON line (``{"host": ...}``), then the
result as the last line of standard output; each number compared for
``correct`` and its limit as the last lines of standard error.  If
``jax``, ``jaxlib``, ``flax`` or the JAX package ``ahocorasick_rs_tpu``
is loaded once the window has closed, it names them and exits 3 with no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "ahocorasick_rs_tpu")


def process_start() -> float:
    """When this process started, on the epoch clock (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def cell_spec(bench: dict, workload: str, root: str = ROOT) -> dict:
    """Everything one cell needs, found by name from ``BENCHMARK.json``:
    its configuration file and its traffic mix, each with every key
    checked, and the names and units of the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    from . import config, traffic

    return {
        "workload": workload,
        "config": config.load(os.path.join(root, conf["file"])),
        "traffic": traffic.load(cell["traffic"]),
        "chips": int(cell["chips"]),
        "end_to_end": [(m["name"], m["unit"]) for m in bench["end_to_end"]
                       if _applies(m, workload)],
        "per_layer": [(m["name"], m["unit"]) for m in bench["per_layer"]
                      if _applies(m, workload)],
    }


def forbidden_modules(modules: Optional[dict] = None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in list(mods) if m.split(".")[0] in FORBIDDEN)


def parse(argv: Optional[list[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> int:
    t_start = process_start()
    args = parse(argv)
    spec = cell_spec(load_bench(), args.workload)
    from . import host

    binding = host.bind(spec["chips"])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{spec['workload']} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from .cell import run_cell

    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    host_rec = out.pop("host")
    host_rec["binding"] = binding
    checks = out.pop("checks")
    out["checks"] = checks  # the numbers compared come last in the line
    print(json.dumps({"host": host_rec}), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
