"""The control of ``correct``: the reference with its byte check left
out, put in the program's place, at a cell's own size.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

For each seed it makes the cell's inputs as a run does, answers each
distinct input with the control (``Reference(fingerprint=3)``: every
place where a pattern's first 3 bytes occur taken as its match, as the
Teddy prefilter's hits would be without the verify stage) and holds the
answers to the reference as a run holds the program's, printing one JSON
line a seed with the numbers a run compares.  The control has to fail
them: a limit that it passed would pass a matcher that reports what it
never verified.  The benchmark's own runs never run it.  It needs
no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from . import config, run, traffic
from .cell import _compact, _compare
from .reference import Reference

#: the bytes of a pattern the control compares: a fingerprint's
CONTROL_BYTES = 3


def readings(spec: dict, seed: int) -> dict:
    """The control's ``wrong_calls`` and ``wrong_tuples`` over one pass of
    the cell's distinct inputs from ``seed``."""
    cfg, params = spec["config"], spec["traffic"]
    patterns = config.patterns(cfg, seed)
    items = traffic.inputs(patterns, params, seed)
    ov = bool(cfg.get("overlapping", False))
    ref = Reference(patterns, cfg["matchkind"], overlapping=ov)
    ctl = Reference(patterns, cfg["matchkind"], overlapping=ov,
                    fingerprint=CONTROL_BYTES)
    call = params["call"]
    wrong_calls = wrong_tuples = 0
    for x in items:
        if call == "doc":
            got, want = ctl.find(x), ref.find(x)
        else:
            got, want = ctl.find_batch(x), ref.find_batch(x)
        gap = _compare(call, _compact(call, got), _compact(call, want))
        wrong_calls += gap > 0
        wrong_tuples += gap
    return {"wrong_calls": wrong_calls, "wrong_tuples": wrong_tuples,
            "calls": len(items)}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    args = ap.parse_args(argv)
    spec = run.cell_spec(run.load_bench(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(spec, seed)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
