"""One run of one cell: set-up, the measured window, the check, metrics.

:func:`run_cell` drives the port's public API in closed loops: each of
the mix's callers (one thread each, the first on the calling thread)
sends the cell's inputs back to back, each call after its last one
returned.  Set-up makes the patterns and inputs from the seed, builds the
matcher from every key of the configuration and sends every distinct
input once (the cell's shapes, and on a first run the kernels' build).
After the window it reads the peak device memory, frees the matcher, and
holds every call's answer to the plain reference (``reference/``),
computed again from the same inputs.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import config, host, traffic
from .reference import Reference
from .trace import CALL_SPAN, SpanRecorder, Trace, profiler_events, summarize

HERE = os.path.dirname(os.path.abspath(__file__))
#: calls that raise before the window is given up
MAX_FAILED = 3


@dataclass
class Window:
    """What the metric readers read about one measured window."""

    call: str  # "doc" or "batch"
    device_kind: str
    setup_s: float
    window_s: float
    call_s: list[float]
    call_bytes: list[int]
    tuples: int
    usage: dict[str, float]
    trace: Optional[Trace]


def load_reader(name: str) -> Callable[[Window], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path
    )
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_matcher(cfg: dict, patterns: list, devices: Optional[list[str]]):
    """The configuration's matcher, built from every one of its matcher
    keys (``config.MATCHER_KEYS``); ``devices`` names the devices (the
    tests' ``["cpu"] * k``), else the cards."""
    import ahocorasick_rs_tpu_torch as port
    from ahocorasick_rs_tpu_torch import Implementation, MatchKind

    cls = getattr(port, cfg["matcher"], None)
    if not (isinstance(cls, type)
            and hasattr(cls, "find_matches_as_indexes_batch")):
        raise ValueError(f"the port has no matcher {cfg['matcher']!r}")
    mesh = None
    if cfg.get("mesh") == "local":
        from ahocorasick_rs_tpu_torch.parallel.sharded import make_mesh

        mesh = (make_mesh(devices=devices) if devices
                else make_mesh(cfg["chips"]))
    impl = cfg.get("implementation")
    kwargs: dict[str, Any] = {
        "matchkind": MatchKind[cfg["matchkind"]],
        "implementation": Implementation[impl] if impl else None,
        "backend": cfg["backend"],
        "device": devices[0] if devices else None,
        "mesh": mesh,
    }
    if "store_patterns" in cfg:
        kwargs["store_patterns"] = cfg["store_patterns"]
    return cls(patterns, **kwargs)


class GcClock:
    """Collections of each generation, and their seconds, while installed
    in ``gc.callbacks``."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t


def closed_loops(
    call: Callable[[Any], Any],
    items: list,
    call_kind: str,
    callers: int,
    seconds: float,
    record: Callable[[str], Any],
    log: Callable[[str], None],
) -> tuple[list[tuple[int, int, float, float, Any]], int, float, float]:
    """``callers`` closed loops over ``items`` until ``seconds`` have
    passed, caller ``c`` taking items ``c``, ``c + callers``, ... in turn;
    the first runs on this thread.  Returns each completed call as
    ``(item, thread, start, end, compact answer)``, the calls that
    raised, and the window's start and end (``perf_counter``)."""
    done: list[tuple[int, int, float, float, Any]] = []
    lock = threading.Lock()
    state = {"failed": 0, "t_last": 0.0}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    state["t_last"] = t0

    def loop(c: int) -> None:
        tid = threading.get_ident()
        i = c
        while time.perf_counter() < deadline and state["failed"] < MAX_FAILED:
            k = i % len(items)
            i += callers
            with record(CALL_SPAN):
                a = time.perf_counter()
                try:
                    r = call(items[k])
                except Exception:  # the window goes on; the run is not correct
                    with lock:
                        state["failed"] += 1
                    log(traceback.format_exc())
                    continue
                finally:
                    b = time.perf_counter()
                    state["t_last"] = max(state["t_last"], b)
            done.append((k, tid, a, b, _compact(call_kind, r)))

    threads = [threading.Thread(target=loop, args=(c,), daemon=True)
               for c in range(1, callers)]
    for t in threads:
        t.start()
    loop(0)
    for t in threads:
        t.join()
    return done, state["failed"], t0, state["t_last"]


def halves_mb_per_s(calls: list[tuple[float, float]], sizes: list[int],
                    t0: float, t1: float) -> list[float]:
    """MB/s of the calls that ended in each half of the window."""
    mid = (t0 + t1) / 2
    first = sum(n for (_a, b), n in zip(calls, sizes) if b <= mid)
    rest = sum(sizes) - first
    half = max((t1 - t0) / 2, 1e-9)
    return [first / half / 1e6, rest / half / 1e6]


def _compact(call: str, result: list) -> Any:
    """A call's answer as kept until the check, in tuples, which the
    garbage collector stops tracking, so that kept answers do not slow
    the window's later collections: a batch's non-empty answers by index,
    with the count of documents."""
    if call == "doc":
        return tuple(result)
    return len(result), tuple(
        (i, tuple(r)) for i, r in enumerate(result) if r
    )


def _tuple_gap(a: tuple, b: tuple) -> int:
    """Tuples in one list and not the other, both ways."""
    sa, sb = set(a), set(b)
    return len(sa ^ sb) + abs((len(a) - len(sa)) - (len(b) - len(sb)))


def _compare(call: str, got: Any, want: Any) -> int:
    """Tuples by which an answer differs from the reference's."""
    if call == "doc":
        return 0 if got == want else max(1, _tuple_gap(got, want))
    if got == want:
        return 0
    n_got, nz_got = got
    n_want, nz_want = want
    gap = abs(n_got - n_want)
    g, w = dict(nz_got), dict(nz_want)
    for i in set(g) | set(w):
        gap += _tuple_gap(g.get(i, ()), w.get(i, ()))
    return max(gap, 1)


def _sync(devices: Optional[list[str]]) -> None:
    if devices is None:
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def run_cell(
    spec: dict,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    t_start: float,
    devices: Optional[list[str]] = None,
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr),
) -> dict:
    """Run the cell ``spec`` (:func:`portbench.run.cell_spec`) once.

    Returns the result line's keys, with ``host`` (the host record) and
    ``checks`` (each number compared, with its limit) beside them.
    ``devices`` puts the matcher on named devices instead of the cards
    (the CPU tests); ``t_start`` is the process's start on the epoch clock.
    """
    cfg, params = spec["config"], spec["traffic"]
    chips = int(cfg["chips"])
    call_kind = params["call"]
    patterns = config.patterns(cfg, seed)
    items = traffic.inputs(patterns, params, seed)
    sizes = [traffic.input_bytes(x) for x in items]
    overlapping = bool(cfg.get("overlapping", False))

    matcher = make_matcher(cfg, patterns, devices)
    call = functools.partial(
        matcher.find_matches_as_indexes if call_kind == "doc"
        else matcher.find_matches_as_indexes_batch,
        overlapping=overlapping)
    for x in items:  # every shape the window sends, once
        call(x)
    _sync(devices)
    setup_s = time.time() - t_start

    cards = range(torch.cuda.device_count()) if devices is None else ()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    gpu_before = host.gpu_sample(chips) if devices is None else []
    mem_before = host.memory()
    record = torch.profiler.record_function  # before the recorder wraps it
    recorder = prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if devices is None:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        recorder = SpanRecorder().__enter__()
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    u0 = host.usage()
    done, failed, t0, t_last = closed_loops(
        call, items, call_kind, traffic.callers(params), seconds, record,
        log)
    usage = host.usage_delta(u0, host.usage())
    gc.callbacks.remove(gc_clock)
    window_s = t_last - t0
    if trace:
        recorder.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    gpu_after = host.gpu_sample(chips) if devices is None else []
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    stats = matcher.stats()
    del matcher, call
    gc.collect()
    if devices is None:
        torch.cuda.empty_cache()
    mem_after = host.memory()
    call_iv = [(tid, a, b) for _k, tid, a, b, _r in done]
    call_s = [b - a for _k, _tid, a, b, _r in done]
    call_bytes = [sizes[k] for k, *_ in done]

    summary = None
    if trace:
        t_sum = time.perf_counter()
        summary = summarize(profiler_events(prof), recorder, call_iv,
                            chips if devices is None else 1)
        log(f"trace read in {time.perf_counter() - t_sum:.1f} s")
        prof = recorder = None

    # the check: every call's answer against the reference's
    t_ref = time.perf_counter()
    ref = Reference(patterns, cfg["matchkind"], overlapping=overlapping)
    want = [
        _compact(call_kind, ref.find(x) if call_kind == "doc"
                 else ref.find_batch(x))
        for x in items
    ]
    wrong_calls = wrong_tuples = 0
    for k, _tid, _a, _b, got in done:
        gap = _compare(call_kind, got, want[k])
        wrong_calls += gap > 0
        wrong_tuples += gap
    ref_s = time.perf_counter() - t_ref
    tuples = sum(
        len(r) if call_kind == "doc" else sum(len(x) for _, x in r[1])
        for *_, r in done
    )
    checks = {
        "calls_failed": {"value": failed, "limit": 0},
        "wrong_calls": {"value": wrong_calls, "limit": 0},
        "wrong_tuples": {"value": wrong_tuples, "limit": 0},
    }
    correct = bool(done) and all(
        c["value"] <= c["limit"] for c in checks.values()
    )

    kind = (torch.cuda.get_device_name(0) if devices is None
            else str(devices[0]))
    w = Window(
        call=call_kind, device_kind=kind, setup_s=setup_s,
        window_s=window_s, call_s=call_s,
        call_bytes=call_bytes, tuples=tuples, usage=usage,
        trace=summary,
    )
    metrics = {}
    for name, unit in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = load_reader(name)(w)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device: dict[str, Any] = {
        "platform": "gpu" if devices is None else str(devices[0]),
        "kind": kind, "count": chips, "memory_peak_bytes": peak,
    }
    out: dict[str, Any] = {
        "correct": correct,
        "attempted": len(done) + failed,
        "failed": failed + wrong_calls,
        "metrics": metrics,
        "device": device,
    }
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["host"] = {
        "seed": seed,
        "calls": len(done),
        "callers": traffic.callers(params),
        "distinct_inputs": len(items),
        "bytes_per_input": sizes,
        "last_backend": stats.get("last_backend"),
        "window_s": window_s,
        "setup_s": setup_s,
        "reference_s": ref_s,
        "usage": usage,
        "halves_mb_per_s": halves_mb_per_s(
            [(a, b) for _t, a, b in call_iv], call_bytes, t0, t_last),
        "gc": {"collections": gc_clock.count, "seconds": gc_clock.seconds},
        "thp": host.thp_mode(),
        "memory_before": mem_before,
        "memory_after": mem_after,
        "loadavg": host.loadavg(),
        "build_bytes": host.tree_bytes(host.port_build_dir()),
        "gpu_before": gpu_before,
        "gpu_after": gpu_after,
        "p50_ms": float(np.percentile(call_s, 50) * 1e3) if call_s else None,
    }
    out["checks"] = checks
    return out
