"""95th percentile of every document call time of the traced window, ms:
a tail that swings too far between runs to bound end to end."""

from portbench.metrics import p95_ms


def read(w):
    if w.trace is None:
        return None
    return p95_ms(w, "doc")
