"""Host ms of the ahocorasick:encode span a batch call: every line's str -> UTF-8 encode and the list of uint8 views."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "batch", "encode")
