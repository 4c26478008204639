"""Host ms of the ahocorasick:pad spans a doc call: the padded host layout's np.zeros and the fill into it."""

from portbench.metrics import spans_ms_per_call


def read(w):
    return spans_ms_per_call(w, "doc", "pad")
