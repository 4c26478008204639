"""The kernels' share of the memory roofline over the doc window's work, percent."""

from portbench.metrics import roofline_pct


def read(w):
    return roofline_pct(w, "doc")
