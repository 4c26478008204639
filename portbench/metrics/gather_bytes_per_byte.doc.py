"""Bytes the ranks of a sharded doc call receive from other ranks a
haystack byte: the port's gather_bytes counter (the tails' exchange and
the gather of the outputs, every rank) over its scanned bytes,
process-wide (set-up sends the same inputs as the window).  None where
the port has no such counter or ran no sharded call."""


def read(w):
    if w.call != "doc":
        return None
    try:
        from ahocorasick_rs_tpu_torch.utils import trace
    except ImportError:
        return None
    c = trace.counters()
    if not c.get("scanned_bytes") or not c.get("gather_bytes"):
        return None
    return c["gather_bytes"] / c["scanned_bytes"]
