"""Host ms of the ahocorasick:encode span a doc call: the str -> UTF-8 encode and its uint8 view."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "doc", "encode")
