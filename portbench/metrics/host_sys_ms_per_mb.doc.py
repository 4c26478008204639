"""System CPU ms of the traced window per MB of documents scanned: the
kernel's share of the host work (page faults, mappings), from getrusage."""


def read(w):
    if w.call != "doc" or w.trace is None or not w.call_bytes:
        return None
    return w.usage["sys_s"] * 1e3 / (sum(w.call_bytes) / 1e6)
