"""UTF-8 byte-offset → code-point-offset mapping.

Vectorized analogue of the reference's ``get_byte_to_code_point`` walk
(upstream src/lib.rs:71-88): instead of a per-character loop we take
the cumulative sum of the "not a continuation byte" mask.  Match endpoints in
valid UTF-8 always land on character boundaries (a pattern never starts with
a continuation byte), so the mapping is total on every index we convert —
the same invariant the reference exploits with its ``usize::MAX`` sentinel
slots.
"""

from __future__ import annotations

import numpy as np


def byte_to_codepoint_prefix(hay_bytes: np.ndarray) -> np.ndarray:
    """Return ``cp`` with ``cp[o]`` = number of code points before byte ``o``.

    ``cp`` has length ``len(hay_bytes) + 1`` so end-exclusive offsets map too
    (the reference's extra slot, upstream src/lib.rs:84-86).
    """
    n = len(hay_bytes)
    cp = np.zeros(n + 1, dtype=np.int64)
    if n:
        starts = (hay_bytes & 0xC0) != 0x80
        np.cumsum(starts, out=cp[1:])
    return cp
