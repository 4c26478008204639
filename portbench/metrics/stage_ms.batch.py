"""Host ms of the ahocorasick:stage spans a batch call, summed over rank threads."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "batch", "stage")
