"""Host ms of the ahocorasick:pad spans a batch call: the [rows, T] layout and lens, zeroed and filled."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "batch", "pad")
