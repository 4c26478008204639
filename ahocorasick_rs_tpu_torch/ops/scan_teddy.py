"""Prefiltered scan: Teddy fire kernel + exact windowed verification.

Pipeline (device):

1. **Fire kernel** (K1, ``csrc/teddy.cu``): the haystack, staged as
   ``[R, 128]`` row-major (position = row*128 + lane), is tested position
   by position against Teddy's ``AND_k tables_k[h[i+k]]`` for every pass.
   Only the last ``m-1`` positions of the staged buffer, whose next bytes
   do not exist, are force-fired; verification discards false fires, so
   that can only over-fire, never miss.
2. **Groups and compaction** (K9, ``csrc/groups.cu``, then K3): the fire
   mask is OR-reduced over ``COARSE``-byte groups, each tested against
   ``n``, and the fired groups are compacted on the device (capacity +
   exact-count retry, as in ``scan_cuda``).
3. **Verification** (K4, ``csrc/verify.cu``, one launch): every fired
   group start ``i`` is a candidate match start.  The window
   ``hay[i : i+W]`` is walked from the root with the engine's transition
   table, and the matched steps are compacted in order inside the same
   kernel; a window match of length ``j`` at step ``j`` has start exactly
   ``i``.  Each true occurrence fires at its start, lands in exactly one
   window, and is emitted exactly once.

The result is the complete occurrence set (pids, starts, ends) in canonical
(end asc, len desc, pid asc) order — identical to the dense scan's output.
Each kernel has a plain PyTorch version beside its wrapper, which the
wrapper takes for CPU tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _kernels
from .._kernels import pack_fire_tables
from ..models.automaton import Automaton, PAD_BYTE
from ..models.prefilter import Prefilter
from ..utils import trace
from .scan_cuda import DeviceTables, _bucket, compact_sparse, stage_padded

#: staged rows per block of the layout (``stage`` pads the row count to a
#: power of two of at least this many rows once the haystack reaches it)
BLOCK_ROWS = 512


def _fire_mask_plain(
    tables: torch.Tensor, hay2d: torch.Tensor, m: int, words: int,
    passes: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same bits, one position per element)."""
    h = hay2d.reshape(-1)
    N = h.numel()
    hp = torch.cat([h, h.new_zeros(m - 1)]).long()
    lo, hi = hp & 15, hp >> 4
    t = tables[:, :16]
    fire = torch.ones(N, dtype=torch.bool, device=h.device)
    for p in range(passes):
        hit = torch.zeros(N, dtype=torch.bool, device=h.device)
        for w in range(words):
            acc = None
            for k in range(m):
                r = ((p * m + k) * 2) * words + w
                term = t[r][lo[k : k + N]] & t[r + words][hi[k : k + N]]
                acc = term if acc is None else acc & term
            hit |= acc != 0
        fire &= hit
    fire[max(0, N - (m - 1)) :] = True
    return fire.to(torch.uint8).view_as(hay2d)


def _fire_mask_packed_plain(
    packed: torch.Tensor, hay2d: torch.Tensor, m: int, words: int,
    passes: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1 over the packed tables: per pass, the
    AND over ``k`` of whole entries, then any nonzero plane."""
    h = hay2d.reshape(-1)
    N = h.numel()
    hp = torch.cat([h, h.new_zeros(m - 1)]).long()
    lo, hi = hp & 15, hp >> 4
    fire = torch.ones(N, dtype=torch.bool, device=h.device)
    for p in range(passes):
        acc = None
        for k in range(m):
            lo_k, hi_k = packed[p, k, 0], packed[p, k, 1]  # [16, WP] each
            term = lo_k[lo[k : k + N]] & hi_k[hi[k : k + N]]
            acc = term if acc is None else acc & term
        fire &= (acc != 0).any(dim=1)
    fire[max(0, N - (m - 1)) :] = True
    return fire.to(torch.uint8).view_as(hay2d)


def fire_mask(
    tables: torch.Tensor,
    hay2d: torch.Tensor,
    m: int,
    words: int,
    passes: int = 1,
    tile: int | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1: uint8 [Rtot, 128] fire mask for a row-major haystack layout,
    all ``passes`` AND-combined.  ``tile`` is the positions a kernel block
    stages a step (``_kernels.FIRE_TILE`` by default); the mask does not
    depend on it, so the plain version ignores it.  ``packed`` is
    :func:`pack_fire_tables` of ``tables`` (``TeddyScanner.packed``), which
    the kernel reads; the plain version reads ``tables``."""
    if hay2d.device.type == "cpu":
        return _fire_mask_plain(tables, hay2d, m, words, passes)
    if packed is None:
        raise ValueError("fire_mask on a card needs the packed tables")
    return _kernels.fire(packed, hay2d, m, words, passes, tile)


def _fire_groups_plain(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of K9: bool [G], the groups of ``COARSE``
    bytes of the flat fire mask that hold a nonzero byte and start below
    ``n``."""
    G = mask.numel() // COARSE
    grp = mask.view(G, COARSE).amax(dim=1)
    gidx = torch.arange(G, device=mask.device)
    return (grp != 0) & (gidx * COARSE < n)


def fire_groups(mask: torch.Tensor, n: int) -> torch.Tensor:
    """K9: the fired groups of K1's flat mask (``N`` a multiple of
    ``COARSE``), the input of K3: uint8 [N / COARSE] from the kernel,
    bool from the plain version on the CPU."""
    if mask.device.type == "cpu":
        return _fire_groups_plain(mask, n)
    return _kernels.fire_groups(mask, n)


#: bit position where the verify table carries the "next state has matches"
#: flag; states must stay below this (automata that large use the sparse
#: engine, which never builds a Teddy scanner).  K2's table is the same.
FLAG_SHIFT = _kernels.FLAG_SHIFT


def _verify_walk_plain(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, use_classes: bool,
) -> torch.Tensor:
    """Plain PyTorch version of K4: one vectorised step per window column."""
    fp = fire_pos.long()
    col = torch.arange(W, device=hay.device)
    src = fp.clamp(min=0)[:, None] + col[None, :]
    invalid = (src >= n) | (fp[:, None] < 0)
    ext = hay[src.clamp(max=max(hay.numel() - 1, 0))].long()
    ext = torch.where(invalid, PAD_BYTE, ext)
    if use_classes:
        ext = classes.long()[ext]
    ncols = vtable.shape[1]
    flat = vtable.reshape(-1)
    s = torch.zeros(fp.numel(), dtype=torch.long, device=hay.device)
    out = torch.empty((fp.numel(), W), dtype=torch.int32, device=hay.device)
    for j in range(W):
        v = flat[s * ncols + ext[:, j]]
        out[:, j] = v
        s = (v & ((1 << FLAG_SHIFT) - 1)).long()
    return out


def verify_walk(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, use_classes: bool,
) -> torch.Tensor:
    """K4: packed walk int32 [cap, W] (next state | has_match << 24) of
    the W-byte windows starting at ``fire_pos`` (-1 = empty window)."""
    if hay.device.type == "cpu":
        return _verify_walk_plain(
            vtable, classes, hay, fire_pos, n, W, use_classes
        )
    return _kernels.verify(vtable, classes, hay, fire_pos, n, W, use_classes)


def _verify_body(
    vtable: torch.Tensor,
    classes: torch.Tensor,
    hay: torch.Tensor,
    fire_pos: torch.Tensor,
    n: int,
    W: int,
    cap2: int,
    use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk W-byte windows from each fire position; compact match steps.

    ``vtable`` packs ``has_match`` into bit FLAG_SHIFT of every transition
    (see :class:`TeddyScanner`), so the walk yields the match flag with
    the next state.  fire_pos: int32 [M] (-1 padded).  Returns
    (win_idx[cap2], step[cap2], state[cap2], total).

    On a card this is K4's one launch (``_kernels.verify_body``), which
    walks each window in pieces; on the CPU, the walk and K3's plain
    versions below.
    """
    if hay.device.type != "cpu":
        # W is max_len + COARSE - 1 on every caller, so the W - COARSE
        # bytes before a step decide its state with the step's own
        return _kernels.verify_body(
            vtable, classes, hay, fire_pos, n, W, cap2, use_classes,
            halo=max(W - COARSE, 0),
        )
    packed = verify_walk(vtable, classes, hay, fire_pos, n, W, use_classes)
    matched = packed.reshape(-1) >= (1 << FLAG_SHIFT)
    sel, total = compact_sparse(matched, cap2)
    win = torch.where(sel >= 0, sel // W, -1)
    step = torch.where(sel >= 0, sel % W, 0)
    st = packed.reshape(-1)[sel.clamp(min=0).long()] & (
        (1 << FLAG_SHIFT) - 1
    )
    return win, step, st, total


#: haystack bytes per coarse verification group.  The per-byte fire mask is
#: OR-reduced over groups of this size before compaction, so position
#: extraction runs over N/COARSE elements and each verification window
#: covers COARSE candidate starts at once.
COARSE = 32
#: chunk width of the verification window gather in the JAX package; kept
#: so that both packages stage the same shapes (must divide COARSE).
VCHUNK = 32 if COARSE % 32 == 0 else 16


def _fire_verify(
    tables: torch.Tensor,
    vtable: torch.Tensor,
    classes: torch.Tensor,
    hay2d: torch.Tensor,
    n: int,
    cap: int,
    cap2: int,
    m: int,
    words: int,
    passes: int,
    W: int,
    use_classes: bool,
    packed: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Fire + coarse compact + verify, with no host round trip between.

    ``W`` is the *window* length (max_len + COARSE - 1); the host keeps
    only matches whose start falls inside the window's group.  Results are
    only trustworthy when ``ftotal <= cap`` and ``mtotal <= cap2`` — the
    caller retries with larger capacities otherwise.
    """
    mask = fire_mask(
        tables, hay2d, m, words, passes, packed=packed
    ).reshape(-1)
    fire_grp, ftotal = compact_sparse(fire_groups(mask, n), cap)
    fire_pos = torch.where(fire_grp >= 0, fire_grp * COARSE, -1)
    win, step, st, mtotal = _verify_body(
        vtable, classes, hay2d.reshape(-1), fire_pos, n, W, cap2,
        use_classes,
    )
    return fire_pos, ftotal, win, step, st, mtotal


def expand_verified(
    am: Automaton,
    ws: np.ndarray,
    step: np.ndarray,
    st: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host CSR expansion of verified window matches (unsorted).

    ``ws[i]`` is window ``i``'s (COARSE-aligned) start, ``step[i]`` the
    0-based walk step whose state ``st[i]`` had matches.  Expands each
    state's match CSR and keeps only matches whose start lies inside the
    window's COARSE group — each true occurrence fires at its start, so it
    is kept by exactly one window.
    """
    cnt = am.match_count[st].astype(np.int64)
    tot = int(cnt.sum())
    if tot == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z
    rep = np.repeat(np.arange(len(st)), cnt)
    csum = np.cumsum(cnt)
    inner = np.arange(tot, dtype=np.int64) - np.repeat(csum - cnt, cnt)
    flat_csr = am.match_offsets[st[rep]] + inner
    pids = am.match_pids[flat_csr]
    lens = am.match_lens[flat_csr]
    wsr = ws[rep]
    ends = wsr + step[rep] + 1
    starts = ends - lens
    keep = (starts >= wsr) & (starts < wsr + COARSE)
    return pids[keep].astype(np.int32), starts[keep], ends[keep]


class TeddyScanner:
    """Per-automaton prefiltered scanner (device tables + adaptive state)."""

    def __init__(
        self, am: Automaton, pf: Prefilter, tables: DeviceTables
    ) -> None:
        """``tables`` are the automaton's dense tables (DFA or classed) on
        the scanner's device; the verify walk reads their flagged table."""
        if am.num_states >= (1 << FLAG_SHIFT):
            # automata this big route to the sparse engine and never get a
            # prefilter; guard anyway for direct constructions
            raise ValueError(
                "prefiltered scan needs state ids < 2**24"
            )
        self.am = am
        self.device = tables.device
        self.m = pf.m
        self.words = pf.words
        self.passes = pf.passes
        self.tables = torch.from_numpy(
            np.ascontiguousarray(pf.tables, dtype=np.int32)
        ).to(self.device)
        #: K1's packed copy of ``tables`` (one 16-byte load per nibble)
        self.packed = pack_fire_tables(
            self.tables, self.m, self.words, self.passes
        )
        # verify table: transition target | has_match(target) << FLAG_SHIFT
        # — the verification walk reads match flags with the next state;
        # the same table K2 reads, shared with the dense tables.
        self.vtable = tables.lane_table()
        self.classes = tables.classes
        self.use_classes = tables.use_classes
        self.fire_cap = 1 << 14
        self.match_cap = 1 << 12
        #: set False after a scan observes a pathological fire rate
        self.worthwhile = True
        #: side stream of the streamed pipeline's copies (CUDA, made once)
        self._copy_stream: torch.cuda.Stream | None = None
        self._pf, self._dense = pf, tables
        self._copies: dict[torch.device, TeddyScanner] = {}

    def on(self, device: torch.device | str) -> "TeddyScanner":
        """This scanner on ``device``: ``self`` on its own device, else a
        copy with the same prefilter over the dense tables' copy there,
        made on first use and kept (its sticky capacities are its own)."""
        device = torch.device(device)
        if device == self.device:
            return self
        sc = self._copies.get(device)
        if sc is None:
            sc = self._copies[device] = TeddyScanner(
                self.am, self._pf, self._dense.on(device)
            )
        return sc

    def stage(
        self, hay: np.ndarray, stream: torch.cuda.Stream | None = None
    ):
        """Pad + reshape + transfer a haystack to the device layout.

        On CUDA the haystack is written once into a pinned block, whose
        tail alone is zeroed, and copied ``non_blocking`` on the current
        stream; the staged tensor is returned.  With a side ``stream`` the
        copy goes there and ``(tensor, ready event)`` is returned
        (``scan_cuda.stage_padded``), so that segment ``k+1``'s copy runs
        beside segment ``k``'s kernels (``occurrences_streamed``).
        """
        rows = -(-max(len(hay), 1) // 128)
        R = min(BLOCK_ROWS, _bucket(rows, lo=8))
        rows_p = max(R, _bucket(rows, lo=8))  # power-of-two block count
        with trace.span("stage"):
            return stage_padded(hay, (rows_p, 128), self.device, stream)

    def _stage_segment(
        self, hay: np.ndarray
    ) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Stage one segment of the streamed pipeline: on CUDA through the
        side copy stream, with the event its copy records; on the CPU in
        place, with no event."""
        if self.device.type != "cuda":
            return self.stage(hay), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self.stage(hay, self._copy_stream)

    def _segment_ready(
        self, hay2d: torch.Tensor, ready: torch.cuda.Event | None
    ) -> torch.Tensor:
        """Make the current stream wait for a segment's copy, and keep the
        caching allocator from reusing its memory while kernels queued on
        the current stream still read it."""
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            hay2d.record_stream(cur)
        return hay2d

    #: segment length of the double-buffered streamed pipeline
    SEG_BYTES = 64 << 20

    def occurrences_streamed(
        self, hay: np.ndarray, seg_bytes: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Segmented prefiltered scan with double-buffered staging.

        Splits the haystack into ``seg_bytes`` segments, each staged
        with a ``W``-byte right overlap so every match STARTING inside
        a segment is verified there; matches starting in the overlap are
        dropped and re-found by the next segment.  On CUDA segment
        ``k+1``'s host->device copy is issued on the side copy stream
        before segment ``k``'s kernels are queued on the current stream,
        so the copy runs beside them; the current stream waits for a
        segment's copy just before its kernels.  On the CPU the segments
        run one after another.
        """
        n = len(hay)
        seg = seg_bytes or self.SEG_BYTES
        if n <= seg:
            return self.occurrences(hay)
        W = self.am.max_len + COARSE - 1
        starts = list(range(0, n, seg))

        def window(i: int) -> np.ndarray:
            s0 = starts[i]
            return hay[s0 : min(n, s0 + seg + W)]

        out_p: list[np.ndarray] = []
        out_s: list[np.ndarray] = []
        out_e: list[np.ndarray] = []
        cur_win = window(0)
        cur = self._stage_segment(cur_win)
        for i, s0 in enumerate(starts):
            nxt_win = nxt = None
            if i + 1 < len(starts):
                nxt_win = window(i + 1)
                nxt = self._stage_segment(nxt_win)  # beside k's kernels
            occ = self.occurrences(cur_win, hay2d=self._segment_ready(*cur))
            if occ is None:
                return None  # fire rate says the dense tiers win
            pids, sts, ends = occ
            if i + 1 < len(starts):
                keep = sts < seg  # starts in the overlap belong to i+1
                pids, sts, ends = pids[keep], sts[keep], ends[keep]
            out_p.append(pids)
            out_s.append(sts + s0)
            out_e.append(ends + s0)
            cur_win, cur = nxt_win, nxt
        pids = np.concatenate(out_p)
        sts = np.concatenate(out_s)
        ends = np.concatenate(out_e)
        # boundary-spanning matches kept by segment k can END after
        # segment k+1's first matches — restore the canonical
        # (end asc, len desc, pid asc) order the resolvers require
        order = np.lexsort((pids, sts, ends))
        return pids[order], sts[order], ends[order]

    def occurrences(
        self, hay: np.ndarray, hay2d: torch.Tensor | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Complete (pids, starts, ends) for the haystack, or None when the
        observed fire rate says the dense scan should take over."""
        n = len(hay)
        W = self.am.max_len + COARSE - 1  # window covers COARSE starts
        if hay2d is None:
            hay2d = self.stage(hay)

        def run(cap: int, cap2: int) -> np.ndarray:
            with trace.span("fire_verify"):
                outs = _fire_verify(
                    self.tables,
                    self.vtable,
                    self.classes,
                    hay2d,
                    n,
                    cap,
                    cap2,
                    self.m,
                    self.words,
                    self.passes,
                    W,
                    self.use_classes,
                    self.packed,
                )
            # ONE device-to-host copy for every output (waits for the device)
            with trace.span("fetch"):
                return torch.cat(
                    [o.reshape(-1).to(torch.int64) for o in outs]
                ).cpu().numpy()[None]

        return self.collect(run, n, (self.fire_cap, self.match_cap))

    def collect(
        self,
        run: Callable[[int, int], np.ndarray],
        n: int,
        caps: tuple[int, int],
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """The capacity protocol and expand of a prefiltered scan, on one
        device or sharded.

        ``run(cap, cap2)`` runs fire, compaction and verify at the fire
        and match capacities and returns every rank's outputs as int64
        ``[ranks, cap + 3*cap2 + 2]`` (:func:`_fire_verify`'s six,
        flattened; one rank on one device), window starts global.  From
        ``caps``, a fire total (the largest rank's) past ``cap`` either
        abandons the scan, when the summed fire total says verification
        would rescan too much, or grows ``cap`` to its bucket; then a match
        total past ``cap2`` grows ``cap2``.  The fitted capacities are left
        in ``fire_cap`` and ``match_cap``.  Returns the complete (pids,
        starts, ends) in canonical order, or None with ``worthwhile``
        False when the dense scan should take over.
        """
        W = self.am.max_len + COARSE - 1  # window covers COARSE starts
        too_many = max(1 << 16, n // 2)  # groups×W beyond this: dense wins
        cap, cap2 = caps
        while True:
            got = run(cap, cap2)
            ftot, mtot = got[:, cap], got[:, -1]
            ftotal, mtotal = int(ftot.max()), int(mtot.max())
            if ftotal > cap:
                if int(ftot.sum()) * W > too_many:
                    # keep the sticky caps in step with what we observed so
                    # a retried corpus doesn't re-run the undersized kernel
                    self.fire_cap = max(
                        self.fire_cap, _bucket(ftotal, lo=1024)
                    )
                    self.worthwhile = False
                    return None
                cap = _bucket(ftotal, lo=1024)
            elif mtotal > cap2:  # trustworthy only once ftotal <= cap
                cap2 = _bucket(mtotal, lo=1024)
            else:
                break
        self.fire_cap = max(1 << 14, _bucket(ftotal, lo=1024))
        self.match_cap = max(1 << 12, _bucket(mtotal, lo=1024))
        # the in-loop abandon's threshold: the backend choice depends on
        # the corpus, not on incidental cap history
        if int(ftot.sum()) * W > too_many:
            self.worthwhile = False
            return None
        win, step, st = np.moveaxis(
            got[:, cap + 1 : -1].reshape(len(got), 3, cap2), 1, 0
        )
        with trace.span("expand"):
            parts = [
                expand_verified(self.am, got[d, :cap][win[d, :k]],
                                step[d, :k], st[d, :k])
                for d, k in enumerate(mtot) if k
            ]
            if not parts:
                z = np.zeros(0, dtype=np.int64)
                return z.astype(np.int32), z, z
            pids, starts, ends = (np.concatenate(x) for x in zip(*parts))
            order = np.lexsort((pids, starts, ends))
        return pids[order], starts[order], ends[order]
