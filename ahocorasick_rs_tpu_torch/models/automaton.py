"""Host-side Aho-Corasick automaton compiler.

This is the device-oriented replacement for the reference's algorithm core (the
external ``aho-corasick`` Rust crate, reached through
``upstream src/lib.rs:186-215``).  Instead of building a pointer-based
NFA that a sequential CPU loop walks, we compile the pattern set host-side
into flat NumPy tables that device kernels consume:

* a dense ``int32 [S, 257]`` transition table (the DFA engine; column 256 is a
  virtual "padding byte" that always returns to the root so device lanes can
  be padded without affecting results),
* a byte-class-compressed ``int32 [S, C+1]`` table plus a ``[257]`` byte→class
  map (the ContiguousNFA engine analogue: same answers, much less memory),
* a sparse CSR goto table + failure links (the NoncontiguousNFA engine
  analogue: fastest build, smallest memory, slowest search),
* a match CSR: for every state, the ordered list of pattern ids whose
  patterns are suffixes of that state's string.  Order within a state is
  (pattern length descending, pattern id ascending), which is exactly the
  order the reference emits same-end-position overlapping matches in
  (upstream tests/test_ac.py:276-288).

The canonical goto representation is the sorted edge CSR (``edge_keys =
state*257 + byte``, ``edge_targets``), shared by the pure-Python builder and
the C++ native builder (``native/ac_builder.cpp``); everything else derives
from it with vectorized NumPy passes.

Because any Aho-Corasick state's string is at most ``max_len`` bytes long, a
scan started from the root at position ``p - max_len`` is guaranteed to be in
the true state at every position ``>= p``.  All device scans exploit this:
haystack chunks are scanned fully in parallel with a ``max_len - 1`` halo of
left context, with no sequential dependency and no cross-chunk fixup.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

#: Virtual byte value used to pad device lanes.  ``delta[:, PAD_BYTE]`` is the
#: root state for every state, so padding never creates or destroys matches at
#: non-padding positions.
PAD_BYTE = 256


@dataclass
class Automaton:
    """A fully compiled pattern automaton (host representation).

    All arrays are NumPy; device paths copy them to torch tensors lazily.
    """

    # --- core automaton (CSR goto + failure links) ---
    num_states: int
    edge_keys: np.ndarray  # int64 [E], sorted; key = state*257 + byte
    edge_targets: np.ndarray  # int32 [E]
    fail: np.ndarray  # int32 [S]
    depth: np.ndarray  # int32 [S]

    # --- match CSR (ordered: length desc, pattern id asc within a state) ---
    match_offsets: np.ndarray  # int64 [S+1]
    match_pids: np.ndarray  # int32 [M]
    match_lens: np.ndarray  # int32 [M]
    match_count: np.ndarray  # int32 [S]

    # --- pattern metadata ---
    num_patterns: int
    pattern_lens: np.ndarray  # int32 [P] (byte lengths)
    max_len: int  # longest pattern in bytes (halo size driver)

    # --- optional python-walk accelerator (built by the python builder) ---
    goto: Optional[list] = field(default=None, repr=False)

    # --- lazily built engine tables ---
    _delta: Optional[np.ndarray] = field(default=None, repr=False)
    _byte_classes: Optional[np.ndarray] = field(default=None, repr=False)
    _delta_classed: Optional[np.ndarray] = field(default=None, repr=False)
    _packed2: Optional[np.ndarray] = field(default=None, repr=False)

    # ------------------------------------------------------------------
    # Dense DFA table (Implementation.DFA analogue)
    # ------------------------------------------------------------------
    @property
    def delta(self) -> np.ndarray:
        """Dense ``int32 [S, 257]`` next-state table.

        ``delta[s, b]`` is the failure-resolved transition, i.e. the longest
        suffix of (string(s) + byte b) that is a trie node.  Column
        ``PAD_BYTE`` is all-root.

        Built level-by-level over BFS depth: every state first inherits its
        failure state's whole row (a vectorized fancy-index copy per level),
        then its own goto edges overwrite — the classic subset construction,
        but with NumPy doing rows in bulk instead of a per-state loop.
        """
        if self._delta is None:
            self._delta = self._build_dense(None)
        return self._delta

    def _build_dense(self, classes: Optional[np.ndarray]) -> np.ndarray:
        """Level-by-level failure-resolved table, optionally in class space.

        With ``classes`` the table is built directly over byte classes —
        never materialising the full ``[S, 257]`` table (which is ~10x
        larger and was the construction bottleneck for 10^6-pattern sets:
        ~6 GB / 2 minutes at 5.9M states vs ~660 MB built directly).
        Mapping goto edges through ``classes`` is lossless because
        same-class bytes have identical (src, tgt) edge sets by definition.
        """
        S = self.num_states
        if classes is None:
            ncols = 257
            pad_col = PAD_BYTE
        else:
            ncols = int(classes.max()) + 1
            pad_col = int(classes[PAD_BYTE])
        delta = np.zeros((S, ncols), dtype=np.int32)
        e_state = (self.edge_keys // 257).astype(np.int64)
        e_byte = (self.edge_keys % 257).astype(np.int64)
        if classes is not None:
            e_byte = classes[e_byte].astype(np.int64)
        edge_depth = self.depth[e_state]
        max_d = int(self.depth.max()) if S > 1 else 0
        states_by_depth = np.argsort(self.depth, kind="stable")
        level_bounds = np.searchsorted(
            self.depth[states_by_depth], np.arange(max_d + 2)
        )
        edges_by_depth = np.argsort(edge_depth, kind="stable")
        e_level_bounds = np.searchsorted(
            edge_depth[edges_by_depth], np.arange(max_d + 2)
        )
        for d in range(max_d + 1):
            if d > 0:
                lvl = states_by_depth[
                    level_bounds[d] : level_bounds[d + 1]
                ]
                delta[lvl] = delta[self.fail[lvl]]
                delta[lvl, pad_col] = 0
            sel = edges_by_depth[
                e_level_bounds[d] : e_level_bounds[d + 1]
            ]
            delta[e_state[sel], e_byte[sel]] = self.edge_targets[sel]
        return delta

    # ------------------------------------------------------------------
    # Byte-class compressed table (Implementation.ContiguousNFA analogue)
    # ------------------------------------------------------------------
    @property
    def byte_classes(self) -> np.ndarray:
        """``int32 [257]`` map byte -> equivalence class.

        Two bytes are equivalent iff they label identical goto-edge sets, in
        which case their dense-table columns are identical as well (the
        failure closure is a function of the edge set alone).  The padding
        byte always gets its own dedicated final class.
        """
        if self._byte_classes is None:
            e_byte = (self.edge_keys % 257).astype(np.int64)
            order = np.argsort(e_byte, kind="stable")  # stable: state asc
            by_b = e_byte[order]
            bounds = np.searchsorted(by_b, np.arange(257))
            bounds = np.append(bounds, len(by_b))
            src = (self.edge_keys // 257).astype(np.int64)[order]
            tgt = self.edge_targets[order]
            sig_to_class: dict[bytes, int] = {b"": 0}
            classes = np.zeros(257, dtype=np.int32)
            for b in range(256):
                lo, hi = bounds[b], bounds[b + 1]
                sig = src[lo:hi].tobytes() + tgt[lo:hi].tobytes()
                cid = sig_to_class.setdefault(sig, len(sig_to_class))
                classes[b] = cid
            classes[PAD_BYTE] = len(sig_to_class)
            self._byte_classes = classes
        return self._byte_classes

    @property
    def num_classes(self) -> int:
        """Number of byte classes including the padding class."""
        return int(self.byte_classes.max()) + 1

    @property
    def delta_classed(self) -> np.ndarray:
        """Dense ``int32 [S, num_classes]`` table over byte classes.

        Column-subsets the dense table when it already exists; otherwise
        builds directly in class space (the low-memory engine must not pay
        the full table's footprint — its whole contract is less memory).
        """
        if self._delta_classed is None:
            classes = self.byte_classes
            if self._delta is not None:
                # One representative byte per class (padding class maps to
                # the all-root PAD_BYTE column).
                reps = np.zeros(self.num_classes, dtype=np.int64)
                reps[classes] = np.arange(257)
                self._delta_classed = np.ascontiguousarray(
                    self._delta[:, reps]
                )
            else:
                self._delta_classed = self._build_dense(classes)
        return self._delta_classed

    # ------------------------------------------------------------------
    # Stride-2 packed table (gather-bound device-scan accelerator)
    # ------------------------------------------------------------------
    @property
    def packed2(self) -> np.ndarray:
        """``int32 [S, C*C]`` two-byte composed transition table.

        ``packed2[s, c1*C + c2] = delta2 << 2 | end_flag << 1 | mid_flag``
        where ``delta2`` is the state after consuming a byte of class ``c1``
        then one of class ``c2`` from ``s``, ``mid_flag`` says the
        intermediate state has matches, and ``end_flag`` says ``delta2``
        does.  Device scans step two haystack bytes per gather with this
        table — exactly halving the lookup count of the gather-bound scan —
        and recover the (rare) intermediate states only at matched
        positions.  ``C`` includes the padding class, whose column is
        all-root with no flags, so lane padding stays inert.
        """
        if self._packed2 is None:
            if self.num_states >= (1 << 29):
                raise ValueError(
                    "stride-2 packing needs state ids < 2**29"
                )
            dc = self.delta_classed  # [S, C]
            has = (self.match_count > 0).astype(np.int32)
            S = self.num_states
            C = dc.shape[1]
            out = np.empty((S, C * C), dtype=np.int32)
            # chunk over states so transient [chunk, C, C] intermediates stay
            # small (ADVICE r1: the one-shot [S, C, C] build tripled memory)
            chunk = max(1, (32 << 20) // (C * C * 4))
            for lo in range(0, S, chunk):
                hi = min(S, lo + chunk)
                mid = dc[lo:hi]  # [c, C] state after the first byte
                d2 = dc[mid]  # [c, C, C]: state after both bytes
                np.copyto(
                    out[lo:hi].reshape(hi - lo, C, C),
                    (d2 << 2) | (has[d2] << 1) | has[mid][:, :, None],
                )
            self._packed2 = out
        return self._packed2

    @property
    def packed2_bytes(self) -> int:
        """Size the stride-2 table would occupy, without building it."""
        return self.num_states * self.num_classes * self.num_classes * 4

    # ------------------------------------------------------------------
    # Sparse CSR view (Implementation.NoncontiguousNFA analogue)
    # ------------------------------------------------------------------
    @property
    def sparse(self) -> tuple:
        """``(keys_int64_sorted, targets_int32, fail_int32)``."""
        return (self.edge_keys, self.edge_targets, self.fail)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Compile-time observability counters (SURVEY.md §5: metrics)."""
        return {
            "num_states": self.num_states,
            "num_patterns": self.num_patterns,
            "max_pattern_len": self.max_len,
            "num_edges": len(self.edge_keys),
            "match_entries": int(self.match_offsets[-1]),
            "dense_table_bytes": self.num_states * 257 * 4,
            "classed_table_bytes": self.num_states * self.num_classes * 4,
            "num_byte_classes": self.num_classes,
            "packed2_table_bytes": self.packed2_bytes,
        }


def _finalize(
    edge_keys: np.ndarray,
    edge_targets: np.ndarray,
    fail: np.ndarray,
    depth: np.ndarray,
    match_offsets: np.ndarray,
    match_pids: np.ndarray,
    pattern_lens: np.ndarray,
    goto: Optional[list],
) -> Automaton:
    S = len(fail)
    counts = np.diff(match_offsets).astype(np.int32)
    match_lens = (
        pattern_lens[match_pids]
        if len(match_pids)
        else np.zeros(0, dtype=np.int32)
    )
    return Automaton(
        num_states=S,
        edge_keys=edge_keys,
        edge_targets=edge_targets,
        fail=fail,
        depth=depth,
        match_offsets=match_offsets,
        match_pids=match_pids,
        match_lens=match_lens,
        match_count=counts,
        num_patterns=len(pattern_lens),
        pattern_lens=pattern_lens,
        max_len=int(pattern_lens.max()) if len(pattern_lens) else 1,
        goto=goto,
    )


def build_automaton_py(patterns: Sequence[bytes]) -> Automaton:
    """Pure-Python reference builder (used for small sets and as oracle)."""
    goto: list[dict[int, int]] = [{}]
    depth_l: list[int] = [0]
    out: list[list[int]] = [[]]  # per-node pattern ids ending exactly here

    for pid, pat in enumerate(patterns):
        node = 0
        for b in pat:
            nxt = goto[node].get(b)
            if nxt is None:
                nxt = len(goto)
                goto[node][b] = nxt
                goto.append({})
                depth_l.append(depth_l[node] + 1)
                out.append([])
            node = nxt
        out[node].append(pid)

    S = len(goto)
    fail = np.zeros(S, dtype=np.int32)
    depth = np.asarray(depth_l, dtype=np.int32)

    # BFS failure links.
    queue: deque[int] = deque()
    for b, v in goto[0].items():
        queue.append(v)
    while queue:
        u = queue.popleft()
        fu = int(fail[u])
        for b, v in goto[u].items():
            queue.append(v)
            f = fu
            while True:
                nxt = goto[f].get(b)
                if nxt is not None and nxt != v:
                    fail[v] = nxt
                    break
                if f == 0:
                    fail[v] = 0
                    break
                f = int(fail[f])

    # Match CSR: matches(v) = own pids (ascending) ++ matches(fail(v)).
    # Own pids all have length == depth[v] > depth[fail[v]] >= inherited
    # lengths, so the concatenation is (length desc, pid asc) ordered — the
    # same-end-position emission order of the reference
    # (upstream tests/test_ac.py:276-288).
    pattern_lens = np.asarray([len(p) for p in patterns], dtype=np.int32)
    matches: list[tuple[int, ...]] = [()] * S
    order = np.argsort(depth, kind="stable")
    for u in order:
        own = tuple(out[u])
        inherited = matches[int(fail[u])] if u != 0 else ()
        matches[u] = own + inherited if own else inherited

    offsets = np.zeros(S + 1, dtype=np.int64)
    np.cumsum([len(m) for m in matches], out=offsets[1:])
    match_pids = np.asarray(
        [pid for m in matches for pid in m], dtype=np.int32
    )

    n_edges = sum(len(g) for g in goto)
    keys = np.empty(n_edges, dtype=np.int64)
    targets = np.empty(n_edges, dtype=np.int32)
    i = 0
    for u, g in enumerate(goto):
        for b, v in g.items():
            keys[i] = u * 257 + b
            targets[i] = v
            i += 1
    order = np.argsort(keys)

    return _finalize(
        keys[order],
        targets[order],
        fail,
        depth,
        offsets,
        match_pids,
        pattern_lens,
        goto,
    )


def build_automaton(patterns: Sequence[bytes]) -> Automaton:
    """Compile byte patterns into an :class:`Automaton`.

    Dispatches to the C++ native builder when available (the analogue of the
    reference keeping construction in native code); falls back to the
    pure-Python builder otherwise.
    """
    patterns = list(patterns)
    total = sum(len(p) for p in patterns)
    if total >= 1 << 14:
        from . import native

        if native.available():
            return native.build_automaton_native(patterns)
    return build_automaton_py(patterns)
