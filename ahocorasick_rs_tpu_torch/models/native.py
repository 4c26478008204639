"""ctypes loader for the C++ native builder (``native/ac_builder.cpp``).

Compiles the shared library on first use (cached beside the source) and
exposes :func:`build_automaton_native`, producing byte-identical tables to
the pure-Python builder — asserted by ``tests/test_native_builder.py``.
Falls back gracefully (``available() -> False``) if no compiler is present.

GIL story (reference parity: upstream src/lib.rs:194-199,238 releases
the GIL in 10k-pattern chunks during build and during match collection):
every ``ctypes`` foreign call here releases the GIL for its entire duration,
so large builds (``ac_build``) and native scans (``ac_scan_*``) run with the
GIL dropped — other Python threads keep running, and concurrent scans of a
shared matcher are safe because the exported tables are immutable after
construction.  Device launches likewise release the GIL while the device
computes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from .automaton import Automaton, _finalize

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "native", "ac_builder.cpp"
)
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libac_builder.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _compile() -> bool:
    try:
        subprocess.run(
            [
                "g++",
                "-O2",
                "-march=native",
                "-shared",
                "-fPIC",
                "-o",
                _LIB_PATH,
                _SRC,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(_SRC):
            if not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.ac_build.restype = ctypes.c_void_p
        lib.ac_build.argtypes = [_i8p, _i64p, ctypes.c_int64]
        for name in ("ac_num_states", "ac_num_edges", "ac_num_match_entries"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.ac_max_len.restype = ctypes.c_int32
        lib.ac_max_len.argtypes = [ctypes.c_void_p]
        lib.ac_export.restype = None
        lib.ac_export.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i64p, _i32p]
        lib.ac_export_edges.restype = None
        lib.ac_export_edges.argtypes = [ctypes.c_void_p, _i64p, _i32p]
        lib.ac_build_dense.restype = None
        lib.ac_build_dense.argtypes = [ctypes.c_void_p, _i32p]
        lib.ac_free.restype = None
        lib.ac_free.argtypes = [ctypes.c_void_p]
        lib.ac_scan_dense.restype = ctypes.c_int64
        lib.ac_scan_dense.argtypes = [
            _i32p, _i32p, _i8p, ctypes.c_int64, _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_classed.restype = ctypes.c_int64
        lib.ac_scan_classed.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i32p, _i8p, ctypes.c_int64,
            _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_dense_batch.restype = ctypes.c_int64
        lib.ac_scan_dense_batch.argtypes = [
            _i32p, _i32p, _i8p, _i64p, ctypes.c_int64, _i64p, _i32p,
            ctypes.c_int64,
        ]
        lib.ac_scan_classed_batch.restype = ctypes.c_int64
        lib.ac_scan_classed_batch.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i32p, _i8p, _i64p,
            ctypes.c_int64, _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_dense_lanes.restype = ctypes.c_int64
        lib.ac_scan_dense_lanes.argtypes = [
            _i32p, _i32p, _i8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_classed_lanes.restype = ctypes.c_int64
        lib.ac_scan_classed_lanes.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i32p, _i8p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_dense_batch_lanes.restype = ctypes.c_int64
        lib.ac_scan_dense_batch_lanes.argtypes = [
            _i32p, _i32p, _i8p, _i64p, ctypes.c_int64, ctypes.c_int32,
            _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_scan_classed_batch_lanes.restype = ctypes.c_int64
        lib.ac_scan_classed_batch_lanes.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i32p, _i8p, _i64p,
            ctypes.c_int64, ctypes.c_int32, _i64p, _i32p, ctypes.c_int64,
        ]
        lib.ac_resolve_dense.restype = ctypes.c_int64
        lib.ac_resolve_dense.argtypes = [
            _i32p, _i64p, _i32p, _i32p, _i8p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, _i64p, _i64p, _i64p,
            ctypes.c_int64,
        ]
        lib.ac_resolve_classed.restype = ctypes.c_int64
        lib.ac_resolve_classed.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i64p, _i32p, _i32p, _i8p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _i64p, _i64p,
            _i64p, ctypes.c_int64,
        ]
        lib.ac_build_dense_leftmost.restype = None
        lib.ac_build_dense_leftmost.argtypes = [ctypes.c_void_p, _i32p]
        lib.ac_resolve_leftmost.restype = ctypes.c_int64
        lib.ac_resolve_leftmost.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i32p, _i8p, ctypes.c_int64,
            ctypes.c_int32, _i64p, _i64p, _i64p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def build_leftmost_table(patterns: Sequence[bytes]) -> np.ndarray:
    """Leftmost-priority pruned dense table, int32 ``[S+1, 257]``.

    Row ``S`` is the DEAD state; a DEAD transition during the leftmost
    walk means the recorded candidate is final (see
    ``ac_build_dense_leftmost`` in the C++ source for the pruning rule).
    The automaton-core tables are unchanged — this is an EXTRA layout
    the leftmost O(n) scan uses, the package's analogue of the crate's
    per-match-kind NFA variants (SURVEY.md X7/X8).
    """
    lib = _load()
    assert lib is not None
    data = np.frombuffer(b"".join(patterns), dtype=np.uint8)
    if len(data) == 0:
        data = np.zeros(1, dtype=np.uint8)
    lens = np.asarray([len(p) for p in patterns], dtype=np.int64)
    handle = lib.ac_build(data, lens, len(patterns))
    try:
        S = lib.ac_num_states(handle)
        delta = np.empty((S + 1, 257), dtype=np.int32)
        lib.ac_build_dense_leftmost(handle, delta)
        return delta
    finally:
        lib.ac_free(handle)


def leftmost_best(am: "Automaton") -> tuple[np.ndarray, np.ndarray]:
    """Per-state (bestlen, bestpid) arrays sized S+1 for the walk.

    The match CSR is ordered (len desc, pid asc), so the first entry of
    each state's slice is its longest match with the smallest pattern id
    — exactly the candidate the leftmost register records.
    """
    S = am.num_states
    bestlen = np.zeros(S + 1, dtype=np.int32)
    bestpid = np.zeros(S + 1, dtype=np.int32)
    has = am.match_count > 0
    first = am.match_offsets[:-1][has]
    bestlen[:S][has] = am.match_lens[first]
    bestpid[:S][has] = am.match_pids[first]
    return bestlen, bestpid


def resolve_leftmost_native(
    delta_lm: np.ndarray,
    bestlen: np.ndarray,
    bestpid: np.ndarray,
    hay: np.ndarray,
    kind: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """O(n) leftmost scan over the pruned table (GIL released)."""
    lib = _load()
    assert lib is not None
    hay = np.ascontiguousarray(hay, dtype=np.uint8)
    n = len(hay)
    dead = delta_lm.shape[0] - 1
    kcode = 1 if kind == "leftmost_first" else 2
    cap = 4096
    while True:
        out_pid = np.empty(cap, dtype=np.int64)
        out_start = np.empty(cap, dtype=np.int64)
        out_end = np.empty(cap, dtype=np.int64)
        total = lib.ac_resolve_leftmost(
            delta_lm, dead, bestlen, bestpid, hay, n, kcode,
            out_pid, out_start, out_end, cap,
        )
        if total <= cap:
            return out_pid[:total], out_start[:total], out_end[:total]
        cap = int(total)


#: match-kind name -> the native resolver's kind code
_RESOLVE_KIND = {"standard": 0, "leftmost_first": 1, "leftmost_longest": 2}


def resolve_scan_native(
    am: "Automaton",
    hay: np.ndarray,
    kind: str,
    classes: Optional[np.ndarray] = None,
    delta: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused scan + non-overlapping resolution (``ac_resolve_dense``).

    One native pass over ``hay`` producing the KEPT matches directly —
    O(output + max_len) memory at any match density, the guard for the
    occurrence-set engine's O(n * nesting) blowup on nested pattern sets
    over repetitive corpora (VERDICT r4; the reference's walk is O(n),
    upstream src/lib.rs:59).  ``delta``/``classes`` select the
    dense or byte-classed table; the GIL is released for the whole walk.
    """
    lib = _load()
    assert lib is not None
    if delta is None:
        delta = am.delta
    hay = np.ascontiguousarray(hay, dtype=np.uint8)
    n = len(hay)
    kcode = _RESOLVE_KIND[kind]
    cap = 4096
    while True:
        out_pid = np.empty(cap, dtype=np.int64)
        out_start = np.empty(cap, dtype=np.int64)
        out_end = np.empty(cap, dtype=np.int64)
        if classes is None:
            total = lib.ac_resolve_dense(
                delta, am.match_offsets, am.match_pids, am.match_lens,
                hay, n, kcode, am.max_len, out_pid, out_start, out_end,
                cap,
            )
        else:
            total = lib.ac_resolve_classed(
                delta, delta.shape[1], classes, am.match_offsets,
                am.match_pids, am.match_lens, hay, n, kcode, am.max_len,
                out_pid, out_start, out_end, cap,
            )
        if total <= cap:
            return (
                out_pid[:total],
                out_start[:total],
                out_end[:total],
            )
        cap = int(total)


def scan_dense_native(
    delta: np.ndarray,
    match_count: np.ndarray,
    hay: np.ndarray,
    classes: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Native sequential scan; returns matched (positions, states).

    ``delta`` is [S, 257] (classes=None) or [S, C] with a [257] byte→class
    map.  Retries on output-capacity overflow (exact count returned).
    """
    lib = _load()
    assert lib is not None
    n = len(hay)
    hay = np.ascontiguousarray(hay, dtype=np.uint8)
    if n == 0:
        hay = np.zeros(1, dtype=np.uint8)
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    match_count = np.ascontiguousarray(match_count, dtype=np.int32)
    cap = 4096
    while True:
        out_pos = np.empty(cap, dtype=np.int64)
        out_state = np.empty(cap, dtype=np.int32)
        if classes is None:
            found = lib.ac_scan_dense(
                delta, match_count, hay, n, out_pos, out_state, cap
            )
        else:
            found = lib.ac_scan_classed(
                delta,
                delta.shape[1],
                np.ascontiguousarray(classes, dtype=np.int32),
                match_count,
                hay,
                n,
                out_pos,
                out_state,
                cap,
            )
        if found <= cap:
            return out_pos[:found], out_state[:found].astype(np.int64)
        cap = int(found)


class DenseScanner:
    """Per-matcher native scanner with cached ctypes argument state.

    ``scan_dense_native`` pays ~20us/call in ``ndpointer`` conversions and
    output allocations — more than the scan itself for sub-KB haystacks
    (the reference's per-call overhead is a single PyO3 boundary,
    upstream src/lib.rs:229-249).  This caches the table pointers
    once and reuses thread-local output buffers, calling through a second
    CDLL handle whose prototypes take raw pointers.
    """

    #: haystacks at least this long use the interleaved-lane scan (the
    #: serial walk is a dependent-load chain; 8 lanes/core x threads hide
    #: the table-fetch latency — measured multi-x on both cache-resident
    #: and DRAM-resident tables)
    LANES_MIN_BYTES = 1 << 16
    #: scans below this use a single thread (worker spawn ~50us/call)
    THREADS_MIN_BYTES = 1 << 20

    def __init__(
        self,
        delta: np.ndarray,
        match_count: np.ndarray,
        classes: Optional[np.ndarray] = None,
        halo: int = 0,
    ) -> None:
        lib = _load_raw()
        assert lib is not None
        self._lib = lib
        self._halo = int(halo)
        self._threads = min(os.cpu_count() or 1, 8)
        # keep references so the arrays outlive the cached pointers
        self._delta = np.ascontiguousarray(delta, dtype=np.int32)
        self._mc = np.ascontiguousarray(match_count, dtype=np.int32)
        self._dp = ctypes.c_void_p(self._delta.ctypes.data)
        self._mcp = ctypes.c_void_p(self._mc.ctypes.data)
        self._nc = self._delta.shape[1]
        if classes is not None:
            self._classes = np.ascontiguousarray(classes, dtype=np.int32)
            self._cp = ctypes.c_void_p(self._classes.ctypes.data)
        else:
            self._classes = None
            self._cp = None
        self._tl = threading.local()

    def _buffers(self, cap: int) -> tuple[np.ndarray, np.ndarray]:
        bufs = getattr(self._tl, "bufs", None)
        if bufs is None or bufs[0].shape[0] < cap:
            bufs = (np.empty(cap, np.int64), np.empty(cap, np.int32))
            self._tl.bufs = bufs
        return bufs

    def scan(self, hay: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Matched (positions, states); output arrays are fresh copies."""
        n = len(hay)
        if n == 0 or not hay.flags["C_CONTIGUOUS"] or hay.dtype != np.uint8:
            hay = np.ascontiguousarray(hay, dtype=np.uint8)
        hp = ctypes.c_void_p(hay.ctypes.data if n else 0)
        lanes = n >= self.LANES_MIN_BYTES
        cap = 4096 if lanes else 1024
        while True:
            out_pos, out_state = self._buffers(cap)
            cap = out_pos.shape[0]
            pp = ctypes.c_void_p(out_pos.ctypes.data)
            sp = ctypes.c_void_p(out_state.ctypes.data)
            # worker-thread spawn costs ~50us/call; sub-MB scans get the
            # full ILP win from in-core lane interleaving alone
            threads = self._threads if n >= self.THREADS_MIN_BYTES else 1
            if lanes and self._cp is None:
                found = self._lib.ac_scan_dense_lanes(
                    self._dp, self._mcp, hp, n, self._halo,
                    threads, pp, sp, cap,
                )
            elif lanes:
                found = self._lib.ac_scan_classed_lanes(
                    self._dp, self._nc, self._cp, self._mcp, hp, n,
                    self._halo, threads, pp, sp, cap,
                )
            elif self._cp is None:
                found = self._lib.ac_scan_dense(
                    self._dp, self._mcp, hp, n, pp, sp, cap
                )
            else:
                found = self._lib.ac_scan_classed(
                    self._dp, self._nc, self._cp, self._mcp, hp, n, pp,
                    sp, cap,
                )
            if found <= cap:
                return (
                    out_pos[:found].copy(),
                    out_state[:found].astype(np.int64),
                )
            cap = int(found)


_lib_raw: Optional[ctypes.CDLL] = None


def _load_raw() -> Optional[ctypes.CDLL]:
    """Second CDLL handle with raw-pointer prototypes (no per-call
    ndpointer validation); shares the compiled library with :func:`_load`."""
    global _lib_raw
    if _lib_raw is not None:
        return _lib_raw
    if _load() is None:  # ensures the library exists on disk
        return None
    with _lock:
        if _lib_raw is None:
            lib = ctypes.CDLL(_LIB_PATH)
            p = ctypes.c_void_p
            lib.ac_scan_dense.restype = ctypes.c_int64
            lib.ac_scan_dense.argtypes = [
                p, p, p, ctypes.c_int64, p, p, ctypes.c_int64,
            ]
            lib.ac_scan_classed.restype = ctypes.c_int64
            lib.ac_scan_classed.argtypes = [
                p, ctypes.c_int64, p, p, p, ctypes.c_int64, p, p,
                ctypes.c_int64,
            ]
            lib.ac_scan_dense_lanes.restype = ctypes.c_int64
            lib.ac_scan_dense_lanes.argtypes = [
                p, p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                p, p, ctypes.c_int64,
            ]
            lib.ac_scan_classed_lanes.restype = ctypes.c_int64
            lib.ac_scan_classed_lanes.argtypes = [
                p, ctypes.c_int64, p, p, p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, p, p, ctypes.c_int64,
            ]
            _lib_raw = lib
    return _lib_raw


def scan_dense_native_batch(
    delta: np.ndarray,
    match_count: np.ndarray,
    buf: np.ndarray,
    offsets: np.ndarray,
    classes: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Native batch scan over concatenated documents (one foreign call).

    ``buf`` holds the documents back to back; document ``d`` spans
    ``buf[offsets[d]:offsets[d+1]]`` and is scanned from the root.  Returns
    matched (positions, states) in concatenated coordinates — ascending, so
    per-document slices are recoverable by binary search over ``offsets``.
    """
    lib = _load()
    assert lib is not None
    ndocs = len(offsets) - 1
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if len(buf) == 0:
        buf = np.zeros(1, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    match_count = np.ascontiguousarray(match_count, dtype=np.int32)
    # interleaved lanes pay off once the batch is big enough to amortize
    # the group machinery; tiny batches keep the serial walk
    lanes = ndocs >= 32 and len(buf) >= (1 << 16)
    threads = min(os.cpu_count() or 1, 8)
    cap = max(4096, len(buf) // 64)
    while True:
        out_pos = np.empty(cap, dtype=np.int64)
        out_state = np.empty(cap, dtype=np.int32)
        if lanes and classes is None:
            found = lib.ac_scan_dense_batch_lanes(
                delta, match_count, buf, offsets, ndocs, threads,
                out_pos, out_state, cap,
            )
        elif lanes:
            found = lib.ac_scan_classed_batch_lanes(
                delta,
                delta.shape[1],
                np.ascontiguousarray(classes, dtype=np.int32),
                match_count,
                buf,
                offsets,
                ndocs,
                threads,
                out_pos,
                out_state,
                cap,
            )
        elif classes is None:
            found = lib.ac_scan_dense_batch(
                delta, match_count, buf, offsets, ndocs, out_pos,
                out_state, cap,
            )
        else:
            found = lib.ac_scan_classed_batch(
                delta,
                delta.shape[1],
                np.ascontiguousarray(classes, dtype=np.int32),
                match_count,
                buf,
                offsets,
                ndocs,
                out_pos,
                out_state,
                cap,
            )
        if found <= cap:
            return out_pos[:found], out_state[:found].astype(np.int64)
        cap = int(found)


def available() -> bool:
    return _load() is not None


def build_automaton_native(patterns: Sequence[bytes]) -> Automaton:
    lib = _load()
    assert lib is not None
    data = np.frombuffer(b"".join(patterns), dtype=np.uint8)
    if len(data) == 0:
        data = np.zeros(1, dtype=np.uint8)  # non-null pointer for ctypes
    lens = np.asarray([len(p) for p in patterns], dtype=np.int64)
    handle = lib.ac_build(data, lens, len(patterns))
    try:
        S = lib.ac_num_states(handle)
        E = lib.ac_num_edges(handle)
        M = lib.ac_num_match_entries(handle)
        fail = np.empty(S, dtype=np.int32)
        depth = np.empty(S, dtype=np.int32)
        match_offsets = np.empty(S + 1, dtype=np.int64)
        match_pids = np.empty(max(M, 1), dtype=np.int32)
        lib.ac_export(handle, fail, depth, match_offsets, match_pids)
        keys = np.empty(max(E, 1), dtype=np.int64)
        targets = np.empty(max(E, 1), dtype=np.int32)
        lib.ac_export_edges(handle, keys, targets)
        am = _finalize(
            keys[:E],
            targets[:E],
            fail,
            depth,
            match_offsets,
            match_pids[:M],
            lens.astype(np.int32),
            goto=None,
        )
        # Prebuild the dense table in native code when it's small enough
        # that the auto heuristic will pick the DFA engine anyway; larger
        # sets derive tables lazily from the CSR (vectorized NumPy).
        if S * 257 * 4 <= (64 << 20):
            delta = np.zeros((S, 257), dtype=np.int32)
            lib.ac_build_dense(handle, delta)
            am._delta = delta
        return am
    finally:
        lib.ac_free(handle)
