"""Occurrence expansion and match-semantics resolution.

Device-first decomposition of the reference's search semantics
(upstream src/lib.rs:42-68 plus the crate engines): the device does
one dense, semantics-agnostic scan that yields the *complete* set of pattern
occurrences (every ``(pattern, start, end)`` in the haystack); every public
semantic is then a cheap deterministic reduction over that set, done here on
the host over the compacted (typically tiny) occurrence list:

* ``overlapping=True`` (Standard only): the occurrence list itself, ordered
  by end position, then pattern length descending, then pattern id — the
  reference's exact emission order (upstream tests/test_ac.py:276-288).
* ``Standard``: earliest-ending match wins, then the automaton restarts at
  the match end (upstream README.md:97-118).  Over the complete set
  this is a greedy sweep in (end asc, length desc) order keeping matches
  whose start is >= the previous kept match's end.
* ``LeftmostFirst`` / ``LeftmostLongest``: leftmost start wins; ties broken
  by pattern-list position / pattern length
  (upstream README.md:121-149).  Greedy sweep in (start asc, priority)
  order with the same restart rule.

The equivalence of the greedy sweeps to the reference's sequential automaton
iteration follows from the suffix-state property: a scan restarted at
position ``i`` reports, as its first match, the minimal-end occurrence whose
start is >= ``i``, breaking same-end ties by maximal length then pattern id.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.automaton import Automaton


class MatchDenseError(RuntimeError):
    """A device scan bailed out on extreme matched-position density.

    Compacting O(n) matched positions on device and expanding their
    occurrence sets on host costs far more than the scan itself in the
    adversarial regime (nested patterns over repetitive corpora); the
    device tiers raise this instead, and ``api._find`` re-routes to the
    host resolve paths whose complexity matches the reference's O(n)
    walk (the fused native resolver / streamed resolve).
    """


def expand_occurrences(
    am: Automaton, positions: np.ndarray, states: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand matched (position, state) pairs into (pids, starts, ends).

    ``positions`` are 0-based haystack byte indexes (ascending) at which the
    free-running automaton sat in ``states`` with a non-empty match set; a
    match at index ``i`` has exclusive end ``i + 1``.  Expansion follows the
    per-state match CSR, so the result is ordered (end asc, len desc, pid
    asc).
    """
    if len(positions) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z
    states = np.asarray(states, dtype=np.int64)
    cnt = am.match_count[states].astype(np.int64)
    total = int(cnt.sum())
    ends = np.repeat(np.asarray(positions, dtype=np.int64) + 1, cnt)
    # ragged arange within each state's CSR slice
    csum = np.cumsum(cnt)
    inner = np.arange(total, dtype=np.int64) - np.repeat(csum - cnt, cnt)
    flat = am.match_offsets[np.repeat(states, cnt)] + inner
    pids = am.match_pids[flat]
    starts = ends - am.match_lens[flat]
    return pids, starts, ends


#: matched-position counts at or below this go through the pure-Python
#: expand+resolve fast path — numpy dispatch overhead (~25us of array ops)
#: dwarfs the work for the per-document match counts of the reference's
#: benchmark workloads (a handful of matches per ~70-600 char haystack).
_SMALL_THRESHOLD = 64


def resolve_from_scan_small(
    am: Automaton,
    positions: np.ndarray,
    states: np.ndarray,
    kind: str,
    overlapping: bool,
) -> list[tuple[int, int, int]]:
    """Fused expand+resolve for small match counts, no numpy dispatches.

    Semantically identical to ``resolve(*expand_occurrences(...))`` —
    pinned against it by the cross-tier equivalence tests; the CSR
    expansion order (end asc, len desc, pid asc) and the greedy restart
    sweep mirror the vectorized path line for line.
    """
    mo = am.match_offsets
    mp = am.match_pids
    ml = am.match_lens
    mc = am.match_count
    occ: list[tuple[int, int, int]] = []
    for pos, st in zip(positions.tolist(), states.tolist()):
        e = pos + 1
        base = int(mo[st])
        for j in range(int(mc[st])):
            ln = int(ml[base + j])
            occ.append((int(mp[base + j]), e - ln, e))
    if overlapping:
        return occ
    if kind == "leftmost_first":
        occ.sort(key=lambda t: (t[1], t[0]))
    elif kind == "leftmost_longest":
        occ.sort(key=lambda t: (t[1], t[1] - t[2], t[0]))
    out: list[tuple[int, int, int]] = []
    cur = 0
    for t in occ:
        if t[1] >= cur:
            out.append(t)
            cur = t[2]
    return out


#: occurrence counts above this use the vectorized pointer-doubling sweep.
_VECTOR_THRESHOLD = 16384


def _greedy_chain_indexes(
    starts: np.ndarray, ends: np.ndarray, cur0: int = 0
) -> np.ndarray:
    """Kept indexes of the greedy restart sweep over priority-ordered arrays.

    The sweep keeps the first element whose ``start`` is >= ``cur0`` (the
    restart cursor carried in from a previous stream segment; 0 for a
    whole-input resolve), then repeatedly jumps to the first later
    element whose ``start`` is >= the kept element's ``end``.  Because
    ``start < end`` for every occurrence, the jump target always lies
    strictly later in the array, so the kept set is exactly the nodes
    reachable from the entry node through the jump pointer — computed
    here with O(M log M) pointer doubling instead of a python loop.
    """
    M = len(starts)
    if M <= _VECTOR_THRESHOLD:
        s_l = starts.tolist()
        e_l = ends.tolist()
        keep = []
        cur = cur0
        for i in range(M):
            if s_l[i] >= cur:
                keep.append(i)
                cur = e_l[i]
        return np.asarray(keep, dtype=np.int64)
    # jump[i] = min{ j : starts[j] >= ends[i] }, else M (sentinel)
    order = np.argsort(starts, kind="stable")
    sorted_starts = starts[order]
    # suffix-min of original indexes over the start-sorted order
    sufmin = np.minimum.accumulate(order[::-1])[::-1]
    sufmin = np.concatenate([sufmin, [M]])
    entry = sufmin[np.searchsorted(sorted_starts, cur0, side="left")]
    jump = sufmin[np.searchsorted(sorted_starts, ends, side="left")]
    jump = np.concatenate([jump, [M]])  # sentinel self-loop target
    mark = np.zeros(M + 1, dtype=bool)
    mark[entry] = True
    while True:
        new = jump[np.nonzero(mark)[0]]
        before = mark.sum()
        mark[new] = True
        if mark.sum() == before:
            break
        jump = jump[jump]
    mark[M] = False
    return np.nonzero(mark)[0]


def _resolve_arrays(
    pids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    kind: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-overlapping resolution core; returns the kept arrays.

    Kept matches come back position-ordered: (end asc) for ``standard``,
    (start asc) for the leftmost kinds.
    """
    if kind == "standard":
        # Already in priority order: (end asc, start asc) — within one end
        # position, longer pattern == smaller start.
        order = None
    elif kind == "leftmost_first":
        order = np.lexsort((pids, starts))
    elif kind == "leftmost_longest":
        order = np.lexsort((pids, starts - ends, starts))
    else:  # pragma: no cover - internal misuse
        raise ValueError(f"unknown match kind: {kind}")

    if order is not None:
        pids, starts, ends = pids[order], starts[order], ends[order]
    keep = _greedy_chain_indexes(starts, ends)
    return pids[keep], starts[keep], ends[keep]


def resolve(
    pids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    *,
    kind: str = "standard",
    overlapping: bool = False,
) -> list[tuple[int, int, int]]:
    """Reduce the complete occurrence set to the requested semantics.

    ``kind`` is one of ``standard`` / ``leftmost_first`` /
    ``leftmost_longest``.  Inputs must be in (end asc, len desc, pid asc)
    order, as produced by :func:`expand_occurrences`.
    """
    if overlapping:
        return list(
            zip(pids.tolist(), starts.tolist(), ends.tolist())
        )
    if len(pids) == 0:
        return []
    pids, starts, ends = _resolve_arrays(pids, starts, ends, kind)
    return list(
        zip(pids.tolist(), starts.tolist(), ends.tolist())
    )


class StreamResolver:
    """Greedy restart sweep over an occurrence *stream* (bounded memory).

    The vectorized :func:`resolve` materializes the complete occurrence
    set first — O(n * nesting) host memory on adversarial inputs like
    ``["a", "aa", ..., "a"*64]`` over gigabytes of ``"a"`` where the
    reference's automaton walk is O(n) with restart skipping
    (upstream src/lib.rs:59, SURVEY.md §3.6.1).  This class
    factorizes every public semantic across stream segments so peak
    memory is O(kept + one segment's occurrences):

    * ``feed(pids, starts, ends, bound)`` consumes one chunk in canonical
      (end asc, len desc, pid asc) order — :func:`expand_occurrences`
      output for an ascending position range.  ``bound`` is the chunk's
      position horizon: every occurrence of every LATER chunk must have
      ``end > bound``.
    * ``standard`` streams directly: the priority order is end-major, so
      a chunk's decisions are final; only the restart cursor crosses
      chunks.
    * leftmost kinds sort start-major, and a later chunk's occurrences
      all have ``start > bound - max_len`` (``len <= max_len``); chunk
      occurrences at or below that frontier are decided now, the (at
      most ``max_len``-window) tail is carried into the next chunk.
    * ``overlapping`` keeps everything — the output IS the occurrence
      stream, which is the reference's contract too.

    Equivalence with the one-shot resolve is pinned by
    ``tests/test_resolve_stream.py`` and the differential fuzzer's
    large-haystack cases.
    """

    def __init__(self, kind: str, overlapping: bool, max_len: int) -> None:
        self.kind = kind
        self.overlapping = overlapping
        self.max_len = max_len
        self._cur = 0
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._carry: Optional[
            tuple[np.ndarray, np.ndarray, np.ndarray]
        ] = None

    def feed(
        self,
        pids: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        bound: int,
    ) -> None:
        if len(pids) == 0 and self._carry is None:
            return
        if self.overlapping:
            self._chunks.append((pids, starts, ends))
            return
        if self.kind == "standard":
            # already in (end asc, start asc) priority order; all future
            # ends are > bound >= these ends, so every decision is final
            keep = _greedy_chain_indexes(starts, ends, self._cur)
            if len(keep):
                self._chunks.append(
                    (pids[keep], starts[keep], ends[keep])
                )
                self._cur = int(ends[keep[-1]])
            return
        # leftmost kinds: merge the carried tail, sort start-major,
        # decide everything at or below the frontier, carry the rest
        if self._carry is not None:
            cp, cs, ce = self._carry
            pids = np.concatenate([cp, pids])
            starts = np.concatenate([cs, starts])
            ends = np.concatenate([ce, ends])
            self._carry = None
        if self.kind == "leftmost_first":
            order = np.lexsort((pids, starts))
        else:
            order = np.lexsort((pids, starts - ends, starts))
        pids, starts, ends = pids[order], starts[order], ends[order]
        frontier = bound - self.max_len
        split = int(np.searchsorted(starts, frontier, side="right"))
        if split < len(pids):
            self._carry = (pids[split:], starts[split:], ends[split:])
            pids, starts, ends = (
                pids[:split], starts[:split], ends[:split]
            )
        keep = _greedy_chain_indexes(starts, ends, self._cur)
        if len(keep):
            self._chunks.append((pids[keep], starts[keep], ends[keep]))
            self._cur = int(ends[keep[-1]])

    def result(self) -> list[tuple[int, int, int]]:
        """Flush the carried tail and return the kept match list."""
        if self._carry is not None:
            cp, cs, ce = self._carry
            self._carry = None
            keep = _greedy_chain_indexes(cs, ce, self._cur)
            if len(keep):
                self._chunks.append((cp[keep], cs[keep], ce[keep]))
                self._cur = int(ce[keep[-1]])
        out: list[tuple[int, int, int]] = []
        for p, s, e in self._chunks:
            out.extend(zip(p.tolist(), s.tolist(), e.tolist()))
        return out


def resolve_batch(
    pids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    offsets: np.ndarray,
    *,
    kind: str = "standard",
    overlapping: bool = False,
) -> list[list[tuple[int, int, int]]]:
    """Per-document semantics over a flat multi-document occurrence set.

    Documents occupy disjoint, ascending position ranges (document ``d``
    spans ``[offsets[d], offsets[d+1])``) and no occurrence crosses a
    boundary, so every semantic reduction factorises: the greedy restart
    sweep never carries state across a gap (the next document's starts are
    >= the previous document's range end), and leftmost selection is local
    to a start position.  ONE vectorized global resolution therefore equals
    the concatenation of per-document resolutions — this is what makes the
    batched API's semantics cost O(total matches), not O(documents) numpy
    dispatches.  Returns per-document match lists in local coordinates.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    B = len(offsets) - 1
    if len(pids) == 0:
        return [[] for _ in range(B)]
    if overlapping:
        kp, ks, ke = pids, starts, ends
    else:
        kp, ks, ke = _resolve_arrays(pids, starts, ends, kind)
    # kept matches are position-ordered (end asc or start asc — both give
    # non-decreasing document ids over disjoint ranges)
    if not overlapping and kind != "standard":
        bounds = np.searchsorted(ks, offsets[1:], side="left")
    else:
        # ends are exclusive: document d's ends lie in (offsets[d],
        # offsets[d+1]]
        bounds = np.searchsorted(ke, offsets[1:], side="right")
    counts = np.diff(np.concatenate([[0], bounds]))
    docoff = np.repeat(offsets[:B], counts)
    kp = kp.tolist()
    ks = (ks - docoff).tolist()
    ke = (ke - docoff).tolist()
    prev = 0
    out: list[list[tuple[int, int, int]]] = []
    for d in range(B):
        hi = int(bounds[d])
        out.append(
            list(zip(kp[prev:hi], ks[prev:hi], ke[prev:hi]))
        )
        prev = hi
    return out
