"""Device scan tier: the halo'd lane scans in PyTorch and CUDA.

Single-device formulation of the halo'd lane scan (see ``scan_host.py`` for
the exactness argument).  The haystack crosses to the device as raw
``uint8``; then hand-written kernels run:

1. **Lane scan**: the haystack is cut into ``L`` lanes of ``T`` bytes.
   Every lane starts at the root, walks the ``halo`` bytes before its own
   segment, then its ``T`` bytes.  Bytes before the start and at or past
   ``n`` read as ``PAD_BYTE``.  It writes the state stream and the match
   mask.  One of three kernels, by engine and table size
   (:func:`scan_device`): the stride-2 pair scan (K6, ``csrc/stride2.cu``)
   whenever the packed pair table fits, else the one-byte dense scan (K2,
   ``csrc/scan.cu``); the sparse engine runs the per-state edge-search
   scan (K7, ``csrc/sparse.cu``).
2. **Compaction** (K3): matched positions are compacted on the device into
   a fixed-capacity buffer plus an exact count.  :func:`fit_capacity` is
   the one retry protocol of every dense dispatch, one device or sharded:
   grow the capacity on overflow, or bail out of a match-dense input.
   Only O(matches) bytes return to the host.

Many small documents scan in one dispatch through :func:`scan_device_batch`
(K5, ``csrc/batch.cu``): one document per row, no halo.  The rows'
layout is :func:`batch_layout`'s, staged by :func:`stage_rows` (one
document's layout by :func:`stage_padded`).

Each kernel has a plain PyTorch version of the same function beside its
wrapper.  The wrapper takes it for CPU tensors (the tests); for CUDA
tensors it launches the kernel.
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import _kernels
from ..models.automaton import Automaton, PAD_BYTE
from ..utils import trace
from .resolve import MatchDenseError

#: target time-axis length; lanes are derived from it.
TARGET_TIME = 512
#: lane-count bounds for the single-device scan.
MIN_LANES = 8
MAX_LANES = 1 << 16
#: haystack bytes per device segment; larger inputs stream through
#: independent halo'd segments, bounding device memory for the state stream.
SEGMENT_BYTES = 256 << 20
#: compaction-overflow totals past max(this, a dispatch's bytes / 8) raise
#: :class:`~.resolve.MatchDenseError` instead of growing the cap toward the
#: dispatch's length (density bailout, :func:`fit_capacity`; api._find
#: re-routes)
DENSE_BAILOUT_MIN = 1 << 22
#: mask bytes per block of the plain two-level compaction
COMPACT_BLOCK = 4096


def _copy_to(
    pinned: torch.Tensor, device: torch.device,
    stream: Optional[torch.cuda.Stream],
):
    """The ``non_blocking`` copy of a pinned host tensor to ``device``: the
    tensor, or with a side ``stream`` ``(tensor, ready event)``."""
    if stream is None:
        return pinned.to(device, non_blocking=True)
    with torch.cuda.stream(stream):
        out = pinned.to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def _read_view(hay: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous uint8 array's bytes, for reading
    only.  A read-only array (the view of a ``bytes`` haystack) is first
    viewed writable through its address, since ``torch.from_numpy`` warns
    on read-only arrays; nothing writes through the view."""
    if not hay.flags.writeable:
        raw = (ctypes.c_uint8 * len(hay)).from_address(hay.ctypes.data)
        hay = np.frombuffer(raw, dtype=np.uint8)
    return torch.from_numpy(hay)


def stage_padded(
    hay: np.ndarray, shape: tuple[int, ...], device: torch.device,
    stream: Optional[torch.cuda.Stream] = None,
):
    """Stage ``hay`` at the head of a zero-padded uint8 layout of ``shape``
    on ``device``, in one host pass.

    On CUDA the layout's block comes straight from PyTorch's caching host
    allocator (pinned, and already mapped after the first call of its
    size).  The haystack's ``n`` bytes are copied into its head by
    ``Tensor.copy_``, over the intra-op threads (the ``pin`` span,
    ``pin_bytes``), and only the tail ``[n, total)`` is zeroed (the
    ``pad`` span, opened even when the tail is empty; ``pad_bytes``).
    The whole layout is copied ``non_blocking`` to the device
    (``h2d_bytes``): without ``stream`` on the current stream, returning
    the tensor; with a side ``stream`` (CUDA only) there, returning
    ``(tensor, ready event)``, and before a kernel on another stream reads
    the tensor, that stream must wait on the event and the tensor must be
    ``record_stream``-ed to it
    (:meth:`.scan_teddy.TeddyScanner.occurrences_streamed`).  The
    allocator hands the block out again only after that copy's event.
    On the CPU device the same layout is built in an ordinary tensor,
    counted the same way.
    """
    hay = np.ascontiguousarray(hay, dtype=np.uint8)
    n, total = len(hay), math.prod(shape)
    if n > total:
        raise ValueError(f"{n} haystack bytes exceed a {total}-byte layout")
    trace.count("pin_bytes", n)
    trace.count("pad_bytes", total - n)
    trace.count("h2d_bytes", total)
    cuda = device.type == "cuda"
    with trace.span("pin"):
        block = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        if n:
            block[:n].copy_(_read_view(hay))
    with trace.span("pad"):
        block[n:].zero_()
    block = block.view(shape)
    return _copy_to(block, device, stream) if cuda else block


def fill_rows(docs: list, rows: np.ndarray, lens: np.ndarray) -> None:
    """Write document ``i`` at the head of row ``i`` of ``rows`` (uint8
    ``[R, T]``) and its length into ``lens[i]``; lengths past the
    documents read 0.  The row bytes past each document are left as they
    are."""
    for i, d in enumerate(docs):
        rows[i, : len(d)] = d
    lens[: len(docs)] = [len(d) for d in docs]
    lens[len(docs) :] = 0


def stage_rows(
    docs: list, shape: tuple[int, int], device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage ``docs``, one a row, in a zero-padded uint8 ``[R, T]`` layout,
    with their int32 lengths, on ``device``, in one host pass.

    On CUDA both blocks come from the caching host allocator, as in
    :func:`stage_padded`.  The row block is zeroed once (the ``pad``
    span, ``pad_bytes`` ``R*T``), then the documents and their lengths are
    written by :func:`fill_rows` (the ``pin`` span, ``pin_bytes`` the
    documents' bytes and ``4*R``), and both blocks are copied
    ``non_blocking`` on the current stream (``h2d_bytes`` ``R*T + 4*R``).
    On the CPU device the same layout is built in ordinary tensors,
    counted the same way.  Returns ``(rows, lens)`` on ``device``.
    """
    R, T = shape
    trace.count("pad_bytes", R * T)
    trace.count("pin_bytes", sum(len(d) for d in docs) + 4 * R)
    trace.count("h2d_bytes", R * T + 4 * R)
    cuda = device.type == "cuda"
    with trace.span("pad"):
        rows = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
        lens = torch.empty(R, dtype=torch.int32, pin_memory=cuda)
        rows.zero_()
    with trace.span("pin"):
        fill_rows(docs, rows.numpy(), lens.numpy())
    if not cuda:
        return rows, lens
    return _copy_to(rows, device, None), _copy_to(lens, device, None)


def build_lanes(
    flat: torch.Tensor, L: int, T: int, halo: int, n: int,
    head: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Halo'd lanes ``[L, halo + T]`` (int64) from a flat byte stream.

    ``flat`` has length ``L*T``; positions >= ``n`` are forced to
    ``PAD_BYTE`` (whose transition column is all-root).  The ``halo``
    values before position 0 are ``head`` (a shard's left context, values
    0-256) or PAD.  Requires ``halo <= T``.
    """
    idx = torch.arange(L * T, device=flat.device)
    flat = torch.where(idx < n, flat.long(), PAD_BYTE)
    if head is None:
        head = torch.full((halo,), PAD_BYTE, device=flat.device)
    pf = torch.cat([head.long(), flat])
    halos = pf[: L * T].view(L, T)[:, :halo]
    return torch.cat([halos, flat.view(L, T)], dim=1)


def _lane_scan_plain(
    table: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    match_count: torch.Tensor, n: int, L: int, T: int, halo: int,
    use_classes: bool, head: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: one vectorised step per time column."""
    ext = build_lanes(hay, L, T, halo, n, head)
    if use_classes:
        ext = classes.long()[ext]
    ncols = table.shape[1]
    flat_table = table.reshape(-1)
    s = torch.zeros(L, dtype=torch.long, device=hay.device)
    out = torch.empty((L, T), dtype=torch.int32, device=hay.device)
    for j in range(halo + T):
        s = flat_table[s * ncols + ext[:, j]].long()
        if j >= halo:
            out[:, j - halo] = s
    states = out.reshape(-1)
    idx = torch.arange(L * T, device=hay.device)
    mask = (match_count[states.long()] > 0) & (idx < n)
    return states, mask.to(torch.uint8)


def scan_lanes(
    table: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    match_count: torch.Tensor, n: int, L: int, T: int, halo: int,
    use_classes: bool, head: Optional[torch.Tensor] = None,
    flagged: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: (states int32 [L*T], match mask uint8 [L*T]) for a uint8
    haystack of ``L*T`` bytes of which the first ``n`` are real, preceded
    by ``head`` (int32 [halo]) or by PAD.

    The mask is exact everywhere; ``states`` is defined where the mask is
    1 (the kernel writes it nowhere else; the plain version writes every
    position).  ``flagged`` is the kernel's table
    (:meth:`DeviceTables.lane_table`), needed on a card; the plain version
    reads ``table`` and ``match_count``.
    """
    if hay.device.type == "cpu":
        return _lane_scan_plain(
            table, classes, hay, match_count, n, L, T, halo, use_classes,
            head,
        )
    if flagged is None:
        raise ValueError("scan_lanes on a card needs the flagged table")
    return _kernels.lane_scan(
        flagged, classes, hay, n, L, T, halo, use_classes, head
    )


def _compact_plain(
    mask: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: block counts, exclusive offsets, then
    an in-block rank and scatter, as the kernel does."""
    mask = mask.reshape(-1).to(torch.bool)
    N = mask.numel()
    pad = (-N) % COMPACT_BLOCK
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
    m2 = mask.view(-1, COMPACT_BLOCK).long()
    cnt = m2.sum(dim=1)
    offs = torch.cumsum(cnt, 0) - cnt
    rank = torch.cumsum(m2, dim=1) - m2
    tgt = offs[:, None] + rank
    keep = (m2 > 0) & (tgt < cap)
    pos = torch.arange(m2.numel(), device=mask.device).view_as(m2)
    idx = torch.full((cap,), -1, dtype=torch.int32, device=mask.device)
    idx[tgt[keep]] = pos[keep].to(torch.int32)
    return idx, cnt.sum().to(torch.int32).reshape(1)


def compact_sparse(
    mask: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: ascending indexes of the true elements of a rare 1-D mask.

    Returns ``(idx int32 [cap] (-1 padded), total int32 [1])``; ``idx``
    holds the first ``cap`` indexes and is complete only when ``total <=
    cap`` (the callers' overflow-retry protocol); ``total`` is exact
    always.
    """
    if mask.device.type == "cpu":
        return _compact_plain(mask, cap)
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    return _kernels.compact(mask.reshape(-1), cap)


def _scan_compact(
    table: torch.Tensor,
    classes: torch.Tensor,
    hay: torch.Tensor,
    match_count: torch.Tensor,
    n: int,
    L: int,
    T: int,
    halo: int,
    cap: int,
    use_classes: bool,
    head: Optional[torch.Tensor] = None,
    flagged: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 haystack [L*T] → compacted (positions[cap], states[cap], total)."""
    return _compact_states(
        *scan_lanes(
            table, classes, hay, match_count, n, L, T, halo, use_classes,
            head, flagged,
        ),
        cap,
    )


def _compact_states(
    states: torch.Tensor, mask: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 over a scan's match mask, and the scan's states at the
    compacted positions (-1 past the matches): the only positions where
    a kernel's ``states`` are defined."""
    positions, total = compact_sparse(mask, cap)
    states_at = torch.where(
        positions >= 0, states[positions.clamp(min=0).long()], -1
    )
    return positions, states_at, total


def _batch_scan_plain(
    table: torch.Tensor, classes: torch.Tensor, hay2d: torch.Tensor,
    lens: torch.Tensor, match_count: torch.Tensor, use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: one vectorised step per column."""
    B, T = hay2d.shape
    col = torch.arange(T, device=hay2d.device)[None, :]
    valid = col < lens.long()[:, None]
    ext = torch.where(valid, hay2d.long(), PAD_BYTE)
    if use_classes:
        ext = classes.long()[ext]
    ncols = table.shape[1]
    flat_table = table.reshape(-1)
    s = torch.zeros(B, dtype=torch.long, device=hay2d.device)
    out = torch.empty((B, T), dtype=torch.int32, device=hay2d.device)
    for t in range(T):
        s = flat_table[s * ncols + ext[:, t]].long()
        out[:, t] = s
    states = out.reshape(-1)
    mask = (match_count[states.long()] > 0) & valid.reshape(-1)
    return states, mask.to(torch.uint8)


def scan_batch(
    table: torch.Tensor, classes: torch.Tensor, hay2d: torch.Tensor,
    lens: torch.Tensor, match_count: torch.Tensor, use_classes: bool,
    flagged: Optional[torch.Tensor] = None, halo: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: (states int32 [B*T], match mask uint8 [B*T]) for a uint8
    ``[B, T]`` buffer whose row ``b`` holds ``lens[b]`` real bytes.

    The mask is exact everywhere; ``states`` is defined where the mask is
    1 (the kernel writes it nowhere else; the plain version writes every
    position).  On a card the kernel needs the flagged table
    (:meth:`DeviceTables.lane_table`) and the automaton's ``halo``
    (``max_len - 1``, the warm-up of its in-row sub-lanes); the plain
    version reads ``table`` and ``match_count``.
    """
    if hay2d.device.type == "cpu":
        return _batch_scan_plain(
            table, classes, hay2d, lens, match_count, use_classes
        )
    if flagged is None or halo is None:
        raise ValueError("scan_batch on a card needs the flagged table and "
                         "the halo")
    return _kernels.batch_scan(
        flagged, classes, hay2d, lens, halo, use_classes
    )


def _scan_batch_compact(
    table: torch.Tensor,
    classes: torch.Tensor,
    hay2d: torch.Tensor,
    lens: torch.Tensor,
    match_count: torch.Tensor,
    cap: int,
    use_classes: bool,
    flagged: Optional[torch.Tensor] = None,
    halo: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched scan: one document per row, no halo (each starts at root).

    ``hay2d`` is uint8 ``[B, T]`` (zero-padded documents), ``lens`` int32
    ``[B]``.  Returns compacted flat (row*T + t) positions, states and the
    total.  ``flagged`` and ``halo`` as :func:`scan_batch`.
    """
    return _compact_states(
        *scan_batch(
            table, classes, hay2d, lens, match_count, use_classes, flagged,
            halo,
        ),
        cap,
    )


def _scan_fetch(
    span: str, scan: Callable, cap: int
) -> tuple[tuple[np.ndarray, np.ndarray], int]:
    """``scan(cap=cap)`` under ``span``, then one host fetch of its
    outputs (waits for the device): ``((positions, states), total)``, as
    :func:`fit_capacity`'s ``run`` returns them."""
    with trace.span(span):
        pos, st, total = scan(cap=cap)
    with trace.span("fetch"):
        out = torch.cat([pos, st, total]).cpu().numpy()
    return (out[:cap], out[cap : 2 * cap]), int(out[-1])


def fit_capacity(
    tables: "DeviceTables",
    cap: int,
    run: Callable[[int], tuple[Any, int]],
    limit: int,
    where: str,
) -> tuple[Any, int, int]:
    """The compaction-capacity protocol of every dense dispatch.

    ``run(cap)`` runs the kernels at compaction capacity ``cap`` and
    returns the fetched outputs and the exact total (sharded: the worst
    rank's).  From the caller's ``cap``, a total past the capacity either
    raises :class:`~.resolve.MatchDenseError` (past
    ``max(DENSE_BAILOUT_MIN, limit)``) or grows the capacity to the
    total's bucket and runs again.  The capacity the total fits is left in
    ``tables.last_cap`` for the next call.  Returns
    ``(fetched, total, cap)``.
    """
    while True:
        fetched, total = run(cap)
        if total <= cap:
            break
        if total > max(DENSE_BAILOUT_MIN, limit):
            # match-dense input: growing the capacity toward its length and
            # expanding occurrence sets on the host is the wrong complexity
            # class; the host resolve paths take it (api._find, _find_batch)
            raise MatchDenseError(f"{total} matched positions in {where}")
        cap = _bucket(total, lo=4096)
    tables.last_cap = _bucket(total, lo=4096)
    return fetched, total, cap


def batch_layout(lens: list[int], n_dev: int) -> tuple[int, int]:
    """``(Bb, T)``: ``Bb`` rows (a multiple of ``n_dev``; rank ``d`` owns
    rows ``[d*Bb/n_dev, (d+1)*Bb/n_dev)``) of ``T`` bytes."""
    T = _bucket(max(max(lens, default=1), 16), lo=16)
    Bb = _bucket(max(len(lens), MIN_LANES, n_dev), lo=MIN_LANES)
    if Bb % n_dev:  # rank counts are not always powers of two
        Bb = -(-Bb // n_dev) * n_dev
    return Bb, T


def scan_device_batch(
    am: Automaton,
    docs: list,
    tables: "DeviceTables",
) -> tuple[np.ndarray, np.ndarray, int]:
    """Scan many small documents in one device dispatch.

    Returns flat ascending ``(positions, states, T)`` where document ``i``
    occupies positions ``[i*T, i*T + len(doc_i))`` — the layout
    ``ops.resolve.resolve_batch`` consumes directly.
    """
    if not docs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 1
    Bb, T = batch_layout([len(d) for d in docs], 1)
    with trace.span("stage"):
        hay2d, lens = stage_rows(docs, (Bb, T), tables.device)

    scan = partial(
        _scan_batch_compact, tables.table, tables.classes, hay2d, lens,
        tables.match_count, use_classes=tables.use_classes,
        flagged=tables.lane_table(), halo=tables.halo,
    )
    (pos, st), total, _ = fit_capacity(
        tables, tables.last_cap, partial(_scan_fetch, "batch_scan", scan),
        Bb * T // 8, f"a {Bb}x{T} batch",
    )
    return pos[:total].astype(np.int64), st[:total].astype(np.int64), T


#: build the stride-2 packed table when it fits in this many bytes.
PACKED2_MAX_BYTES = 256 << 20


def _stride2_scan_plain(
    packed2: torch.Tensor, table_classed: torch.Tensor, classes: torch.Tensor,
    hay: torch.Tensor, n: int, L: int, T: int, halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: one vectorised step per byte pair,
    then the mid-pair state by one gather at the matched first bytes.
    ``states`` holds the pair's end state at every second byte, the mid
    state at matched first bytes and -1 at the other first bytes."""
    C = table_classed.shape[1]
    ext = classes.long()[build_lanes(hay, L, T, halo, n)]  # [L, halo+T]
    cc = ext[:, 0::2] * C + ext[:, 1::2]  # [L, (halo+T)//2]
    hp = halo // 2
    flat = packed2.reshape(-1)
    s = torch.zeros(L, dtype=torch.long, device=hay.device)
    # state entering each pair, then the state after it
    prev = torch.empty((L, T // 2), dtype=torch.int32, device=hay.device)
    ends = torch.empty((L, T // 2), dtype=torch.int32, device=hay.device)
    flags = torch.empty((L, T // 2), dtype=torch.int32, device=hay.device)
    for j in range(hp + T // 2):
        if j >= hp:
            prev[:, j - hp] = s
        v = flat[s * (C * C) + cc[:, j]]
        s = (v >> 2).long()
        if j >= hp:
            ends[:, j - hp] = s
            flags[:, j - hp] = v & 3
    idx = torch.arange(L * T, device=hay.device)
    # interleave (first, second) byte flags back to per-byte order
    mask = torch.stack([flags & 1, flags >> 1], dim=-1).reshape(L * T)
    mask = (mask > 0) & (idx < n)
    states = torch.stack(
        [torch.full_like(ends, -1), ends], dim=-1
    ).reshape(L * T)
    first = mask[0::2].nonzero().reshape(-1)  # pairs whose first byte hit
    states[2 * first] = table_classed[
        prev.reshape(-1)[first].long(), ext[:, halo::2].reshape(-1)[first]
    ]
    return states, mask.to(torch.uint8)


def stride2_scan(
    packed2: torch.Tensor, table_classed: torch.Tensor, classes: torch.Tensor,
    hay: torch.Tensor, n: int, L: int, T: int, halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: (states int32 [L*T], match mask uint8 [L*T]) through the pair
    table; ``T`` and ``halo`` even.  K2's contract: the mask is exact
    everywhere, ``states`` defined where it is 1 (the state after that
    byte: a pair's end state, or at a first byte the mid state rebuilt
    from ``table_classed``)."""
    if hay.device.type == "cpu":
        return _stride2_scan_plain(
            packed2, table_classed, classes, hay, n, L, T, halo
        )
    return _kernels.stride2_scan(
        packed2, table_classed, classes, hay, n, L, T, halo
    )


def _scan_compact2(
    packed2: torch.Tensor,
    table_classed: torch.Tensor,
    classes: torch.Tensor,
    hay: torch.Tensor,
    n: int,
    L: int,
    T: int,
    halo: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stride-2 scan: two haystack bytes per table load.

    ``packed2[s, c1*C+c2]`` carries the two-byte-composed next state plus
    per-pair match flags (``Automaton.packed2``), so the scan does half the
    loads of the plain scan and needs no ``match_count`` test over the
    state stream.  The state at a matched first byte of a pair is rebuilt
    by K6 at the match only, from the state entering the pair.  ``halo``
    and ``T`` must be even.
    """
    return _compact_states(
        *stride2_scan(packed2, table_classed, classes, hay, n, L, T, halo),
        cap,
    )


def _sparse_scan_plain(
    tabs: _kernels.SparseTables, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7 over the same derived tables
    (:func:`._kernels.sparse_tables`): per time column, every lane
    binary-searches its state's label run, follows fail links on a miss
    and reads the root's next state once it reaches the root."""
    records = tabs.records.long()
    labels = tabs.labels.long()
    targets = tabs.targets.long()
    root_next = tabs.root_next.long()
    E = targets.numel()
    ext = build_lanes(hay, L, T, halo, n)
    dev = hay.device
    s = torch.zeros(L, dtype=torch.long, device=dev)
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    for j in range(halo + T):
        b = ext[:, j]
        st = s
        done = b == PAD_BYTE  # no edge carries PAD: the root at once
        res = torch.zeros(L, dtype=torch.long, device=dev)
        while True:
            at_root = ~done & (st == 0)
            res = torch.where(at_root, root_next[b], res)
            done = done | at_root
            if bool(done.all()):
                break
            start, end = records[st, 0], records[st, 0] + records[st, 1]
            lo, hi = start, end
            while bool((lo < hi).any()):
                mid = (lo + hi) >> 1
                less = labels[mid] < b
                live = lo < hi
                lo = torch.where(live & less, mid + 1, lo)
                hi = torch.where(live & ~less, mid, hi)
            found = ~done & (lo < end) & (labels[lo] == b)
            if E:
                res = torch.where(found, targets[lo.clamp(max=E - 1)], res)
            done = done | found
            st = torch.where(done, st, records[st, 2])
        s = res
        if j >= halo:
            out[:, j - halo] = s
    states = out.reshape(-1)
    idx = torch.arange(L * T, device=dev)
    mask = (records[states.long(), 3] > 0) & (idx < n)
    return states, mask.to(torch.uint8)


def sparse_scan(
    tabs: _kernels.SparseTables, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: (states int32 [L*T], match mask uint8 [L*T]) over the sparse
    automaton's derived tables (:attr:`DeviceTables.sparse`).

    K2's contract: the mask is exact everywhere; ``states`` is defined
    where the mask is 1 (the kernel writes it nowhere else; the plain
    version writes every position)."""
    if hay.device.type == "cpu":
        return _sparse_scan_plain(tabs, hay, n, L, T, halo)
    return _kernels.sparse_scan(tabs, hay, n, L, T, halo)


def _scan_compact_sparse(
    tabs: _kernels.SparseTables,
    hay: torch.Tensor,
    n: int,
    L: int,
    T: int,
    halo: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse lane scan: per-state edge search + failure walk.

    The NoncontiguousNFA engine's device path: smallest tables, slowest
    scan.  Returns compacted (positions[cap], states[cap], total).
    """
    return _compact_states(*sparse_scan(tabs, hay, n, L, T, halo), cap)


class DeviceTables:
    """Per-automaton cache of device-resident tables + scan state."""

    def __init__(self, am: Automaton, engine: str,
                 device: torch.device | str = "cpu",
                 packed2_max_bytes: int = PACKED2_MAX_BYTES) -> None:
        self.device = torch.device(device)
        self.engine = engine
        #: K7's tables (:func:`._kernels.sparse_tables`), sparse engine only
        self.sparse: Optional[_kernels.SparseTables] = None
        self.table = None
        self.flagged = None
        if engine == "dfa":
            self.table = self._upload(am.delta)
            classes = np.zeros(257, dtype=np.int32)  # unused placeholder
            self.use_classes = False
        elif engine == "classed":  # byte-classed (ContiguousNFA analogue)
            self.table = self._upload(am.delta_classed)
            classes = am.byte_classes
            self.use_classes = True
        else:  # sparse CSR (NoncontiguousNFA analogue)
            classes = np.zeros(257, dtype=np.int32)
            self.use_classes = False
        self.classes = self._upload(np.asarray(classes, dtype=np.int32))
        self.match_count = self._upload(am.match_count)
        if engine == "sparse":
            keys, targets, fail = am.sparse
            self.sparse = _kernels.sparse_tables(
                self._upload(keys), self._upload(targets),
                self._upload(fail), self.match_count,
            )
        #: bytes before a position that decide its state (K5's warm-up)
        self.halo = max(am.max_len - 1, 0)
        self._am = am
        # stride-2 tables, used by either dense engine when they fit (the
        # pair table halves the loads of the load-bound scan); built on the
        # first device scan.  The low-memory 'classed' engine gets a
        # tighter default budget, but an explicit caller cap (0 disables)
        # is always honored.
        self.packed2 = None
        self.classes2 = None
        self.table_classed = None
        budget = (
            packed2_max_bytes
            if engine == "dfa"
            else min(packed2_max_bytes, 64 << 20)
        )
        self._packed2_ok = (
            engine != "sparse"
            and am.num_states < (1 << 29)
            and am.packed2_bytes <= budget
        )
        #: adaptive initial compaction capacity (sticky across calls)
        self.last_cap = 4096
        self._packed2_max_bytes = packed2_max_bytes
        self._copies: dict[torch.device, DeviceTables] = {}

    def on(self, device: torch.device | str) -> "DeviceTables":
        """These tables on ``device``: ``self`` on its own device, else a
        copy made on first use and kept.  Its flagged table is built here,
        so the thread ranks of a local mesh that share it only read it."""
        device = torch.device(device)
        t = self if device == self.device else self._copies.get(device)
        if t is None:
            t = self._copies[device] = DeviceTables(
                self._am, self.engine, device, self._packed2_max_bytes
            )
        if t.table is not None:
            t.lane_table()
        return t

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def lane_table(self) -> torch.Tensor:
        """The flagged table ``next | has_match << 24``
        (``_kernels.flag_table``) that K2 and the Teddy verify walk (K4)
        read, built once on first use."""
        if self.flagged is None:
            self.flagged = _kernels.flag_table(self.table, self.match_count)
        return self.flagged

    def ensure_packed2(self) -> bool:
        """Build + upload the stride-2 tables on first use; False if unfit."""
        if not self._packed2_ok:
            return False
        if self.packed2 is None:
            am = self._am
            self.packed2 = self._upload(am.packed2)
            self.classes2 = self._upload(
                np.asarray(am.byte_classes, dtype=np.int32)
            )
            self.table_classed = self._upload(am.delta_classed)
        return True


def _bucket(x: int, lo: int) -> int:
    """The least ``lo * 2**k`` at or above ``x``."""
    b = lo
    while b < x:
        b <<= 1
    return b


def choose_layout(m: int, halo: int) -> tuple[int, int]:
    """Pick (L, T): T a power of two >= halo, L*T >= m, L in bounds."""
    T = _bucket(max(TARGET_TIME, halo), lo=16)
    L = max(MIN_LANES, _bucket(-(-m // T), lo=MIN_LANES))
    if L > MAX_LANES:
        L = MAX_LANES
        T = _bucket(max(-(-m // L), halo), lo=16)
    return L, T


def scan_device(
    am: Automaton,
    hay: np.ndarray,
    tables: DeviceTables,
    *,
    segment_bytes: int = SEGMENT_BYTES,
) -> tuple[np.ndarray, np.ndarray]:
    """Scan ``hay`` (uint8 ndarray) on ``tables.device``.

    Streams large haystacks through independent halo'd segments; within a
    segment runs the bucketed lane scan with overflow-retry compaction.
    Segments are cut by their context: a later segment's halo and new
    bytes together fill at most ``segment_bytes``, so with a power of two
    every full segment fills its layout exactly.
    Returns global (positions, states) as int64 NumPy arrays.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    stride2 = tables.ensure_packed2()
    halo = am.max_len - 1
    if stride2:
        halo += halo & 1  # pairs must align across the halo boundary
    all_pos: list[np.ndarray] = []
    all_states: list[np.ndarray] = []
    seg = max(segment_bytes, 2 * max(1, halo))
    seg_start = 0
    while seg_start < n:
        ctx_start = max(0, seg_start - halo)
        seg_end = min(n, ctx_start + seg)
        drop = seg_start - ctx_start  # leading context positions to discard
        m = seg_end - ctx_start
        L, T = choose_layout(m, halo)
        with trace.span("stage"):
            hay_dev = stage_padded(
                hay[ctx_start:seg_end], (L * T,), tables.device
            )
        # the engine's kernel (K7 sparse, K6 stride-2, else K2), with every
        # argument but the compaction capacity bound
        if tables.engine == "sparse":
            span, scan = "sparse_scan", partial(
                _scan_compact_sparse, tables.sparse, hay_dev, m, L, T, halo,
            )
        elif stride2:
            span, scan = "stride2_scan", partial(
                _scan_compact2, tables.packed2, tables.table_classed,
                tables.classes2, hay_dev, m, L, T, halo,
            )
        else:
            span, scan = "lane_scan", partial(
                _scan_compact, tables.table, tables.classes, hay_dev,
                tables.match_count, m, L, T, halo,
                use_classes=tables.use_classes, flagged=tables.lane_table(),
            )
        (pos, st), total, _ = fit_capacity(
            tables, tables.last_cap, partial(_scan_fetch, span, scan),
            m // 8, f"a {m}-byte segment",
        )
        pos = pos[:total].astype(np.int64)
        st = st[:total].astype(np.int64)
        keep = pos >= drop
        all_pos.append(pos[keep] - drop + seg_start)
        all_states.append(st[keep])
        seg_start = seg_end
    positions = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
    states = np.concatenate(all_states) if all_states else np.zeros(0, np.int64)
    return positions, states
