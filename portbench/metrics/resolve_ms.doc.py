"""Host ms of the ahocorasick:fetch, expand and resolve spans a doc call."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "doc", "fetch", "expand", "resolve")
