"""What a traced run reads: the program's spans and the device's activity.

Two sources, both over the measured window:

* :class:`SpanRecorder` times every ``ahocorasick:*`` range the port
  opens with ``torch.profiler.record_function``, on every thread, on the
  host clock.  ``torch.profiler`` keeps only the calling thread's ranges,
  and the ranks of a local mesh are threads of their own.
* ``torch.profiler``'s events: the device's kernels and copies, and the
  calling thread's ranges on the profiler's clock, which say what the
  host was doing while the device sat idle (with several callers, what
  the first caller was doing).

:func:`summarize` turns them into a :class:`Trace`, which the metric
readers under ``metrics/`` read.  The span and busy-union arithmetic
follows the port's ``profile_main_path.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

PREFIX = "ahocorasick:"
#: the harness's own range around each timed call
CALL_SPAN = "portbench:call"
#: the port's kernels by a part of their names; other kernels are
#: PyTorch's own
KERNEL_FAMILIES = {
    "fire_kernel": "K1_fire",
    "lane_scan_kernel": "K2_lane_scan",
    "compact_kernel": "K3_compact",
    "verify_kernel": "K4_verify",
    "batch_scan_kernel": "K5_batch_scan",
    "stride2_scan_kernel": "K6_stride2_scan",
    "sparse_scan_kernel": "K7_sparse_scan",
    "groups_kernel": "K9_fire_groups",
}


def kernel_family(name: str) -> str:
    """A device event's family: a port kernel's, ``copies`` or ``torch``."""
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if "at::" not in name:
        for part, family in KERNEL_FAMILIES.items():
            if part in name:
                return family
    return "torch"


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(spans: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in spans)


class SpanRecorder:
    """Times each ``ahocorasick:*`` range on every thread while active
    (the port looks ``torch.profiler.record_function`` up at each call)."""

    def __init__(self) -> None:
        import torch

        self._torch = torch
        self._orig = torch.profiler.record_function
        self._lock = threading.Lock()
        #: (name without prefix, thread ident, start, end), host seconds
        self.ranges: list[tuple[str, int, float, float]] = []

    def __enter__(self) -> "SpanRecorder":
        rec, orig = self, self._orig

        class Timed:
            def __init__(self, name: str, *args: Any) -> None:
                self.name, self.inner = name, orig(name, *args)

            def __enter__(self) -> Any:
                self.t0 = time.perf_counter()
                return self.inner.__enter__()

            def __exit__(self, *exc: Any) -> Any:
                out = self.inner.__exit__(*exc)
                if self.name.startswith(PREFIX):
                    item = (self.name[len(PREFIX):], threading.get_ident(),
                            self.t0, time.perf_counter())
                    with rec._lock:
                        rec.ranges.append(item)
                return out

        self._torch.profiler.record_function = Timed
        return self

    def __exit__(self, *exc: Any) -> None:
        self._torch.profiler.record_function = self._orig


@dataclass
class Trace:
    """The traced window, reduced."""

    #: host seconds of each program span, summed over threads and calls
    span_s: dict[str, float]
    #: host seconds of each call outside the calling thread's spans
    api_self_s: float
    #: device time of the kernels, copies left out, summed over devices
    kernel_s: float
    #: union of device activity (copies included), mean over devices
    busy_s: float
    #: first call's start to last call's end, profiler clock
    window_s: float
    device_s_by_family: dict[str, float] = field(default_factory=dict)
    #: idle device time by what the calling thread was doing
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def breakdown(self) -> dict[str, list[list[Any]]]:
        top = sorted(self.device_s_by_family.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {
            "device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]],
        }


def profiler_events(prof: Any) -> list[tuple[str, bool, int, float, float]]:
    """``(name, on the device, device index, start us, end us)`` of every
    event of a stopped ``torch.profiler.profile``, read from its raw
    results (building its ``events()`` tree takes minutes for a window)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [
        (e.name(), e.device_type() == cuda, e.device_index(),
         e.start_ns() / 1e3, e.end_ns() / 1e3)
        for e in prof.profiler.kineto_results.events()
    ]


def summarize(
    events: list[tuple[str, bool, int, float, float]],
    recorder: SpanRecorder,
    calls: list[tuple[int, float, float]],
    devices: int,
) -> Trace:
    """Reduce the profiler's ``events`` (:func:`profiler_events`) and the
    recorder's ranges over the window of ``calls`` (the calling thread and
    host ``(start, end)`` of each timed call)."""
    span_s: dict[str, float] = {}
    own: dict[int, list[tuple[float, float]]] = {}
    for name, tid, a, b in recorder.ranges:
        span_s[name] = span_s.get(name, 0.0) + (b - a)
        own.setdefault(tid, []).append((a, b))

    # API self time: each call less its own thread's program spans
    by_thread: dict[int, list[tuple[float, float]]] = {}
    for tid, a, b in calls:
        by_thread.setdefault(tid, []).append((a, b))
    api_self = 0.0
    for tid, ivs in by_thread.items():
        spans = sorted(own.get(tid, ()))
        j = 0
        for a, b in sorted(ivs):
            inside = []
            while j < len(spans) and spans[j][0] < b:
                if spans[j][0] >= a:
                    inside.append(spans[j])
                j += 1
            api_self += (b - a) - length(union(inside))

    # profiler clock (us): device intervals, host spans, the window
    dev_spans: dict[int, list[tuple[float, float]]] = {}
    by_family: dict[str, float] = {}
    kernel_us = 0.0
    host: list[tuple[float, float, str]] = []
    call_us: list[tuple[float, float]] = []
    for name, on_device, index, a, b in events:
        if on_device:
            if name.startswith(PREFIX) or name == CALL_SPAN:
                continue
            dev_spans.setdefault(index, []).append((a, b))
            fam = kernel_family(name)
            by_family[fam] = by_family.get(fam, 0.0) + (b - a) / 1e6
            if fam != "copies":
                kernel_us += b - a
        elif name == CALL_SPAN:
            call_us.append((a, b))
        elif name.startswith(PREFIX):
            host.append((a, b, name[len(PREFIX):]))
    if not call_us:
        raise RuntimeError("the profiler recorded no timed call")
    w0 = min(a for a, _ in call_us)
    w1 = max(b for _, b in call_us)
    busy = {d: _clip(union(s), w0, w1) for d, s in dev_spans.items()}
    busy_us = sum(length(s) for s in busy.values()) / max(devices, 1)
    all_busy = union([iv for s in busy.values() for iv in s])
    idle = _complement(all_busy, w0, w1)
    labelled = _innermost(
        [(a, b, "api") for a, b in call_us] + host, w0, w1
    )
    return Trace(
        span_s=span_s,
        api_self_s=api_self,
        kernel_s=kernel_us / 1e6,
        busy_s=busy_us / 1e6,
        window_s=(w1 - w0) / 1e6,
        device_s_by_family=by_family,
        idle_by_host=_overlap_by_label(idle, labelled),
    )


def _clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def _complement(busy, lo, hi):
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def _innermost(spans, lo, hi):
    """Cut [lo, hi) into pieces labelled by the innermost of the nested
    ``(start, end, label)`` spans over each, "harness" outside them all."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []
    cur = lo

    def emit(upto: float) -> None:
        nonlocal cur
        if upto > cur:
            out.append((cur, upto, stack[-1][1] if stack else "harness"))
            cur = upto

    for a, b, label in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        emit(a)
        stack.append((b, label))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(hi)
    return out


def _overlap_by_label(idle, labelled):
    """Seconds of ``idle`` under each label of ``labelled`` (us inputs)."""
    out: dict[str, float] = {}
    i = j = 0
    while i < len(idle) and j < len(labelled):
        a, b = idle[i]
        c, d, label = labelled[j]
        lo, hi = max(a, c), min(b, d)
        if hi > lo:
            out[label] = out.get(label, 0.0) + (hi - lo) / 1e6
        if b <= d:
            i += 1
        else:
            j += 1
    return out
