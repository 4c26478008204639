"""Python buffer-protocol handling, and the bytes of an ASCII ``str``.

Counterpart of the reference's ``PyBufferBytes`` adapter
(upstream src/lib.rs:276-340): validates that a haystack object is a
one-dimensional, contiguous byte buffer and exposes it as a NumPy ``uint8``
view without copying.  Error messages match the reference exactly
(upstream src/lib.rs:288-298).  :func:`ascii_view` views an ASCII ``str``
haystack's own storage the same way, where it is already the string's
UTF-8.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np

#: ``PyUnicode_AsUTF8AndSize`` under a prototype of its own (called with
#: the GIL held, as every C-API call is), so ``ctypes.pythonapi``'s shared
#: entry keeps its own ``restype``; None on another interpreter
_AS_UTF8 = (
    ctypes.PYFUNCTYPE(
        ctypes.c_void_p, ctypes.py_object, ctypes.POINTER(ctypes.c_ssize_t)
    )(("PyUnicode_AsUTF8AndSize", ctypes.pythonapi))
    if sys.implementation.name == "cpython"
    else None
)


class _StrStorage:
    """A string's storage as NumPy's array interface: read-only bytes at
    ``ptr``.  An array made from it keeps it as its base, and it keeps the
    string, so the bytes live as long as any view of them."""

    __slots__ = ("_s", "__array_interface__")

    def __init__(self, s: str, ptr: int, n: int) -> None:
        self._s = s
        self.__array_interface__ = {
            "data": (ptr, True),
            "typestr": "|u1",
            "shape": (n,),
            "version": 3,
        }


def ascii_view(s: str) -> Optional[np.ndarray]:
    """A read-only uint8 view of a plain ASCII ``str``'s own storage, or
    None where the string has to be encoded.

    For a compact ASCII string CPython's storage is its UTF-8, and
    ``PyUnicode_AsUTF8AndSize`` returns a pointer to it without
    allocating.  It is never called on any other string: there it would
    build a UTF-8 copy and attach it to the string for the string's whole
    life.  A ``str`` subclass, which may override ``isascii``, is encoded.
    """
    if _AS_UTF8 is None or type(s) is not str or not s.isascii():
        return None
    n = ctypes.c_ssize_t()
    ptr = _AS_UTF8(s, ctypes.byref(n))
    return np.asarray(_StrStorage(s, ptr, n.value))


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
