"""Host ms of the ahocorasick:pin spans a doc call: the pinned buffer's allocation and the copy into it."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "doc", "pin")
