"""The plain matcher that decides ``correct``: NumPy and Python only.

It imports nothing of the port.  From the same patterns and haystacks the
benchmark hands the port it finds every occurrence of every pattern,
then resolves them by the upstream match kind, and gives code-point
indexes for a ``str`` haystack and byte offsets for a bytes one, as
``ahocorasick_rs``'s ``AhoCorasick`` and ``BytesAhoCorasick`` do.

Finding: each haystack position's first ``m`` bytes (``m`` the shortest
pattern's length, at most 8) are packed into one integer; a hash of it,
of 22 bits or 10 more than the patterns' count takes, picks the positions
whose prefix some pattern has; each such position is checked byte for
byte against the patterns with that prefix.  The haystack is taken in
blocks of 16 MiB so that the arrays stay small.

Resolving (upstream semantics):

* ``Standard``: the match that ends first, the longest of those ending
  there; the next search starts at its end;
* ``LeftmostLongest``: the match that starts first, the longest of those
  starting there; the next search starts at its end;
* ``Standard`` with ``overlapping``: every occurrence, by its end, the
  longest first at one end.

``fingerprint=3`` is the control: a position where a pattern's first 3
bytes occur is taken as that pattern's match, with no byte check of the
rest.  That is the Teddy prefilter's hit (K1) with its verify stage (K4)
left out, the step a later change would be tempted to take.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

_MULT = np.uint64(0x9E3779B97F4A7C15)
#: the hash's bits: at least this many, and at most ``_MAX_BITS``
_MIN_BITS, _MAX_BITS = 22, 28
_BLOCK = 1 << 24
KINDS = ("Standard", "LeftmostLongest")


class Reference:
    """Patterns prepared once; :meth:`find` and :meth:`find_batch` as the
    public API's ``find_matches_as_indexes`` and ``*_batch``."""

    def __init__(
        self,
        patterns: Iterable[Union[str, bytes]],
        kind: str,
        *,
        overlapping: bool = False,
        fingerprint: int = 0,
    ) -> None:
        if kind not in KINDS:
            raise ValueError(f"match kind {kind!r} is not one of {KINDS}")
        if overlapping and kind != "Standard":
            raise ValueError("overlapping matches need Standard")
        self.patterns = [p.encode("utf-8") if isinstance(p, str) else
                         bytes(p) for p in patterns]
        if not self.patterns or not all(self.patterns):
            raise ValueError("patterns must be non-empty")
        self.kind = kind
        self.overlapping = overlapping
        self.verify = not fingerprint
        self.m = fingerprint or min(8, min(len(p) for p in self.patterns))
        if self.m > min(len(p) for p in self.patterns):
            raise ValueError("the fingerprint is longer than a pattern")
        bits = min(_MAX_BITS, max(_MIN_BITS,
                                  len(self.patterns).bit_length() + 10))
        self.shift = np.uint64(64 - bits)
        self.by_key: dict[int, list[tuple[int, bytes]]] = {}
        self.bitmap = np.zeros(1 << bits, dtype=bool)
        for pid, p in enumerate(self.patterns):
            key = int.from_bytes(p[: self.m], "big")
            h = ((key * int(_MULT)) & 0xFFFF_FFFF_FFFF_FFFF) >> int(self.shift)
            self.by_key.setdefault(key, []).append((pid, p))
            self.bitmap[h] = True

    def occurrences(self, hay: bytes) -> list[tuple[int, int, int]]:
        """Every (pattern, start, end) in ``hay``, byte offsets."""
        arr = np.frombuffer(hay, dtype=np.uint8)
        m = self.m
        last = len(arr) - m + 1  # window starts run over [0, last)
        out: list[tuple[int, int, int]] = []
        for s in range(0, max(last, 0), _BLOCK):
            cnt = min(_BLOCK, last - s)
            key = np.zeros(cnt, dtype=np.uint64)
            for j in range(m):
                key <<= np.uint64(8)
                key |= arr[s + j : s + j + cnt]
            h = (key * _MULT) >> self.shift
            cand = np.flatnonzero(self.bitmap[h])
            for c, k in zip(cand.tolist(), key[cand].tolist()):
                pos = s + c
                for pid, p in self.by_key.get(k, ()):
                    if not self.verify or hay.startswith(p, pos):
                        out.append((pid, pos, pos + len(p)))
        return out

    def resolve(
        self, occ: list[tuple[int, int, int]]
    ) -> list[tuple[int, int, int]]:
        """The matches the match kind picks."""
        if self.overlapping:
            return sorted(occ, key=lambda o: (o[2], o[1], o[0]))
        if self.kind == "Standard":
            order = sorted(occ, key=lambda o: (o[2], o[1], o[0]))
        else:
            order = sorted(occ, key=lambda o: (o[1], -o[2], o[0]))
        out = []
        at = 0
        for pid, s, e in order:
            if s >= at:
                out.append((pid, s, e))
                at = e
        out.sort(key=lambda o: o[1])
        return out

    def find(self, haystack: Union[str, bytes]) -> list[tuple[int, int, int]]:
        """``find_matches_as_indexes(haystack)``: code-point indexes of a
        ``str``, byte offsets of bytes."""
        data = _data(haystack)
        found = self.resolve(self.occurrences(data))
        return _to_codepoints(data, found) if isinstance(haystack, str) \
            else found

    def find_batch(
        self, haystacks: list
    ) -> list[list[tuple[int, int, int]]]:
        """``find_matches_as_indexes_batch(haystacks)``: one scan over the
        documents joined, occurrences kept inside their own document."""
        datas = [_data(h) for h in haystacks]
        offsets = np.zeros(len(datas) + 1, dtype=np.int64)
        np.cumsum([len(d) + 1 for d in datas], out=offsets[1:])
        joined = b"\0".join(datas)
        per_doc: dict[int, list[tuple[int, int, int]]] = {}
        for pid, s, e in self.occurrences(joined):
            d = int(np.searchsorted(offsets, s, side="right")) - 1
            base = int(offsets[d])
            if e - base <= len(datas[d]):
                per_doc.setdefault(d, []).append((pid, s - base, e - base))
        out: list[list[tuple[int, int, int]]] = [[] for _ in datas]
        for d, occ in per_doc.items():
            out[d] = self.resolve(occ)
            if isinstance(haystacks[d], str):
                out[d] = _to_codepoints(datas[d], out[d])
        return out


def _data(haystack: Union[str, bytes]) -> bytes:
    return haystack.encode("utf-8") if isinstance(haystack, str) \
        else bytes(haystack)


def _to_codepoints(
    data: bytes, matches: list[tuple[int, int, int]]
) -> list[tuple[int, int, int]]:
    """Byte offsets to code-point offsets (identity for ASCII)."""
    if not matches or data.isascii():
        return matches
    arr = np.frombuffer(data, dtype=np.uint8)
    cp = np.zeros(len(arr) + 1, dtype=np.int64)
    np.cumsum((arr & 0xC0) != 0x80, out=cp[1:])
    return [(p, int(cp[s]), int(cp[e])) for p, s, e in matches]
