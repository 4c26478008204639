"""The port's tracing: named spans and process-wide byte counters.

Spans.  :func:`span` is the one way the port opens a range.  While a
``torch.profiler`` session runs it opens
``torch.profiler.record_function("ahocorasick:" + name)``, looked up at
each call (a harness may wrap that attribute to time the ranges of every
thread), so the profiler stamps the range on the clock of the card's
kernels and copies.  With no session it opens nothing and returns one
shared no-op context.  While a session runs, every garbage collection
is a range too, on the thread that ran it: ``gc_full`` for generation 2,
``gc_young`` for generations 0 and 1.  The hook that opens them sits in
``gc.callbacks`` only while a session runs: the first span that finds a
session on puts it in, the first span or collection that finds none
takes it out.  A local mesh's calling thread holds ``ranks`` over the
whole run of its rank threads (``parallel.sharded.LocalMesh.run``), so
its wait for them is labelled and is not the API's own time.

Counters.  :func:`count` adds to a named total, always, under one lock;
:func:`counters` reads them.  The port counts once a call or a staging
site, never a document:

* ``scanned_bytes``: haystack bytes of every public call;
* ``encode_bytes``: UTF-8 bytes the ``str`` API's encode produced;
* ``str_view_bytes``: bytes of the ASCII ``str`` haystacks the
  single-document API viewed in place of an encode (``encode_bytes``
  counts the rest);
* ``pad_bytes``: every tail ``scan_cuda.stage_padded`` zeroes, every
  row block ``scan_cuda.stage_rows`` zeroes, and the Teddy batch's flat
  host layout and row lengths (``api._batch_occurrences``);
* ``pin_bytes``: every haystack ``scan_cuda.stage_padded`` copies into
  its pinned block, and the documents and 4 bytes a row of lengths
  ``scan_cuda.stage_rows`` writes into its pinned blocks (on the CPU
  device, the ordinary tensors that stand in for them);
* ``h2d_bytes``: every host-to-device copy staging issues;
* ``gather_bytes``: every byte a rank of a sharded scan receives from
  another rank through ``all_gather`` (``parallel.sharded``): the shard
  tails' exchange and the gather of every rank's outputs.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, ContextManager

import torch

PREFIX = "ahocorasick:"

_NOOP = contextlib.nullcontext()
_counts: dict[str, int] = {}
_count_lock = threading.Lock()
#: re-entrant: a collection may start while this thread holds it
_hook_lock = threading.RLock()
_gc_hooked = False
#: the garbage collector's open range on each thread
_gc_open = threading.local()


def _session_on() -> bool:
    """Whether a ``torch.profiler`` session runs: the process-wide flag,
    which rank threads see too, or this thread's profiler state."""
    return bool(
        getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
        or torch.autograd._profiler_enabled()
    )


def span(name: str) -> ContextManager[Any]:
    """The range ``ahocorasick:<name>`` while a profiler session runs,
    else a no-op context."""
    if not _session_on():
        if _gc_hooked:
            _unhook()
        return _NOOP
    if not _gc_hooked:
        _hook()
    return torch.profiler.record_function(PREFIX + name)


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if _session_on():
            r = torch.profiler.record_function(
                PREFIX + ("gc_full" if info["generation"] == 2 else "gc_young")
            )
            r.__enter__()
            _gc_open.range = r
            return
    else:
        r = getattr(_gc_open, "range", None)
        if r is not None:
            _gc_open.range = None
            r.__exit__(None, None, None)
        if _session_on():
            return
    # the collector walks the live list: only the last callback may take
    # itself out without another being skipped; else the next span does
    if gc.callbacks and gc.callbacks[-1] is _on_gc:
        _unhook()


def _hook() -> None:
    global _gc_hooked
    with _hook_lock:
        if not _gc_hooked:
            gc.callbacks.append(_on_gc)
            _gc_hooked = True


def _unhook() -> None:
    global _gc_hooked
    with _hook_lock:
        if _gc_hooked:
            while _on_gc in gc.callbacks:
                gc.callbacks.remove(_on_gc)
            _gc_hooked = False


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """Every counter's total since the process started (or the last
    :func:`reset_counters`)."""
    with _count_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _count_lock:
        _counts.clear()
