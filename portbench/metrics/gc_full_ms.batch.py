"""Host ms of full (generation 2) garbage collections a batch call, from the ahocorasick:gc_full spans of the window."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "batch", "gc_full")
