"""UTF-8 MB of every line of every completed batch call, over the window."""

from portbench.metrics import rate_mb_per_s


def read(w):
    return rate_mb_per_s(w, "batch")
