"""Metric readers: one file a metric, ``<name>.py``, each with
``read(w) -> float | None`` over a :class:`portbench.cell.Window`.

A reader that finds nothing to read in the window (a batch metric in a
document cell, a span the path does not open, a per-layer metric in an
untraced run) returns None, and the harness leaves the metric out.  The
helpers below are shared by the readers.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

#: published peaks by the card's name (``torch.cuda.get_device_name``)
PEAKS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "peaks.json")

#: bytes of one returned (pattern, start, end) tuple in the roofline count
TUPLE_BYTES = 12


def rate_mb_per_s(w: Any, call: str) -> Optional[float]:
    """MB (10^6 bytes) of every completed call over the window."""
    if w.call != call or not w.call_s or w.window_s <= 0:
        return None
    return sum(w.call_bytes) / w.window_s / 1e6


def p95_ms(w: Any, call: str) -> Optional[float]:
    """95th percentile of every call time of the window."""
    if w.call != call or not w.call_s:
        return None
    return float(np.percentile(w.call_s, 95) * 1e3)


def spans_ms_per_call(w: Any, call: str, *names: str) -> Optional[float]:
    """Host ms of the named program spans a call, summed over threads;
    None where the path opened none of them."""
    if w.call != call or w.trace is None or not w.call_s:
        return None
    got = [w.trace.span_s[n] for n in names if n in w.trace.span_s]
    if not got:
        return None
    return sum(got) / len(w.call_s) * 1e3


def api_self_ms(w: Any, call: str) -> Optional[float]:
    """Host ms a call spends outside the port's spans on its thread."""
    if w.call != call or w.trace is None or not w.call_s:
        return None
    return w.trace.api_self_s / len(w.call_s) * 1e3


def idle_pct(w: Any, call: str) -> Optional[float]:
    """100 x (1 - union of device activity / traced window)."""
    if w.call != call or w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)


def roofline_pct(w: Any, call: str) -> Optional[float]:
    """The least time the card's memory rate allows for the window's work
    (haystack bytes read once, tuples written once) over the kernels'
    summed device time, copies left out, in percent."""
    if w.call != call or w.trace is None or w.trace.kernel_s <= 0:
        return None
    with open(PEAKS) as f:
        peak = json.load(f).get(w.device_kind)
    if peak is None:
        return None
    work = sum(w.call_bytes) + TUPLE_BYTES * w.tuples
    return 100.0 * work / peak["hbm_bytes_per_s"] / w.trace.kernel_s
