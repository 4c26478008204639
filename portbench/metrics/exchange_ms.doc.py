"""Host ms of the ahocorasick:exchange and gather spans a doc call,
summed over rank threads: the shard tails' exchange, and the gather of
every rank's matches with the wait for the cards' kernels it holds."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "doc", "exchange", "gather")
