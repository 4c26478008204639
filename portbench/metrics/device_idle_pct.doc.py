"""Share of the traced doc window in which the device ran nothing, percent."""

from portbench.metrics import idle_pct


def read(w):
    return idle_pct(w, "doc")
