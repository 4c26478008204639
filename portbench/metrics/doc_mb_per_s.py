"""UTF-8 MB of every document whose call completed, over the window."""

from portbench.metrics import rate_mb_per_s


def read(w):
    return rate_mb_per_s(w, "doc")
