"""Host ms of the ahocorasick:fetch, expand and resolve spans a batch call."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "batch", "fetch", "expand", "resolve")
