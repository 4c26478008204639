"""Host ms a batch call spends in the API outside the port's spans (encode, code-point map, lists)."""

from portbench.metrics import api_self_ms


def read(w):
    return api_self_ms(w, "batch")
