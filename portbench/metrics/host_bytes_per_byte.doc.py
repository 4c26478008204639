"""Host bytes written a haystack byte in the doc calls: the port's
encode, pad and pin byte counters over its scanned bytes, process-wide
(set-up sends the same inputs as the window, so the ratio is the
window's).  None where the port has no such counters."""


def read(w):
    if w.call != "doc":
        return None
    try:
        from ahocorasick_rs_tpu_torch.utils import trace
    except ImportError:
        return None
    c = trace.counters()
    if not c.get("scanned_bytes"):
        return None
    written = sum(c.get(k, 0) for k in ("encode_bytes", "pad_bytes", "pin_bytes"))
    return written / c["scanned_bytes"]
