"""Bytes staging copies to the device a haystack byte in the batch calls:
the port's h2d byte counter over its scanned bytes, process-wide (set-up
sends the same inputs as the window, so the ratio is the window's).  None
where the port has no such counters."""


def read(w):
    if w.call != "batch":
        return None
    try:
        from ahocorasick_rs_tpu_torch.utils import trace
    except ImportError:
        return None
    c = trace.counters()
    if not c.get("scanned_bytes") or "h2d_bytes" not in c:
        return None
    return c["h2d_bytes"] / c["scanned_bytes"]
