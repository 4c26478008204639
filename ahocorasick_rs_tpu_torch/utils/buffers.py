"""Python buffer-protocol handling.

Counterpart of the reference's ``PyBufferBytes`` adapter
(upstream src/lib.rs:276-340): validates that a haystack object is a
one-dimensional, contiguous byte buffer and exposes it as a NumPy ``uint8``
view without copying.  Error messages match the reference exactly
(upstream src/lib.rs:288-298).
"""

from __future__ import annotations

import numpy as np


def as_byte_view(obj: object) -> np.ndarray:
    """Return a read-only uint8 ndarray view of a buffer-protocol object.

    Raises ``TypeError`` for non-buffers (including ``str``, which does not
    implement the buffer protocol — upstream tests/test_ac_bytes.py:128-130),
    multi-dimensional buffers, and non-contiguous buffers.
    """
    try:
        mv = memoryview(obj)
    except TypeError:
        raise TypeError(
            f"a bytes-like object is required, not {type(obj).__name__!r}"
        ) from None
    if mv.ndim != 1:
        raise TypeError("Only one-dimensional sequences are supported")
    if not mv.contiguous:
        raise TypeError("Must be a contiguous sequence of bytes")
    if mv.itemsize != 1:
        # the reference's PyBuffer::<u8> rejects non-byte-sized elements
        raise TypeError("buffer contents are not compatible with u8")
    return np.frombuffer(mv, dtype=np.uint8)


def pattern_bytes(obj: object) -> bytes:
    """Convert one pattern to ``bytes`` via the buffer protocol."""
    try:
        mv = memoryview(obj)
    except TypeError:
        raise TypeError(
            f"a bytes-like object is required, not {type(obj).__name__!r}"
        ) from None
    return mv.tobytes()
