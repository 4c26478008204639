"""Device scan tier: the halo'd dense lane scan in PyTorch and CUDA.

Single-device formulation of the halo'd lane scan (see ``scan_host.py`` for
the exactness argument).  The haystack crosses to the device as raw
``uint8``; then two hand-written kernels run:

1. **Lane scan** (K2, ``csrc/scan.cu``): the haystack is cut into ``L``
   lanes of ``T`` bytes.  Every lane starts at the root, walks the ``halo``
   bytes before its own segment, then its ``T`` bytes, one table load per
   byte.  Bytes before the start and at or past ``n`` read as
   ``PAD_BYTE``.  It writes the state stream and the match mask.
2. **Compaction** (K3): matched positions are compacted on the device into
   a fixed-capacity buffer plus an exact count; the caller retries with a
   larger capacity on overflow.  Only O(matches) bytes return to the host.

Each kernel has a plain PyTorch version of the same function beside its
wrapper.  The wrapper takes it for CPU tensors (the tests); for CUDA
tensors it launches the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..models.automaton import Automaton, PAD_BYTE
from .resolve import MatchDenseError

#: target time-axis length; lanes are derived from it.
TARGET_TIME = 512
#: lane-count bounds for the single-device scan.
MIN_LANES = 8
MAX_LANES = 1 << 16
#: haystack bytes per device segment; larger inputs stream through
#: independent halo'd segments, bounding device memory for the state stream.
SEGMENT_BYTES = 256 << 20
#: compaction-overflow totals past max(this, segment/8) raise
#: :class:`~.resolve.MatchDenseError` instead of growing the cap toward the
#: segment length (density bailout; api._find re-routes)
DENSE_BAILOUT_MIN = 1 << 22
#: mask bytes per block of the two-level compaction (the kernel's chunk)
COMPACT_BLOCK = 4096


def to_device(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host uint8 array to ``device`` (through pinned memory on CUDA).

    The copy is issued ``non_blocking`` from a pinned buffer, so the host
    can stage the next segment while the device still works; the caching
    host allocator keeps the pinned block alive until the copy is done.
    """
    if device.type != "cuda":
        return torch.from_numpy(np.array(buf, dtype=np.uint8, copy=True))
    pinned = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[...] = buf
    return pinned.to(device, non_blocking=True)


def build_lanes(
    flat: torch.Tensor, L: int, T: int, halo: int, n: int
) -> torch.Tensor:
    """Halo'd lanes ``[L, halo + T]`` (int64) from a flat byte stream.

    ``flat`` has length ``L*T``; positions >= ``n`` are forced to
    ``PAD_BYTE`` (whose transition column is all-root).  Requires
    ``halo <= T``.
    """
    idx = torch.arange(L * T, device=flat.device)
    flat = torch.where(idx < n, flat.long(), PAD_BYTE)
    pf = torch.cat(
        [torch.full((halo,), PAD_BYTE, dtype=torch.long, device=flat.device),
         flat]
    )
    halos = pf[: L * T].view(L, T)[:, :halo]
    return torch.cat([halos, flat.view(L, T)], dim=1)


def _lane_scan_plain(
    table: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    match_count: torch.Tensor, n: int, L: int, T: int, halo: int,
    use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: one vectorised step per time column."""
    ext = build_lanes(hay, L, T, halo, n)
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
    use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: (states int32 [L*T], match mask uint8 [L*T]) for a uint8
    haystack of ``L*T`` bytes of which the first ``n`` are real."""
    if hay.device.type == "cpu":
        return _lane_scan_plain(
            table, classes, hay, match_count, n, L, T, halo, use_classes
        )
    return _kernels.lane_scan(
        table, classes, hay, match_count, n, L, T, halo, use_classes
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 haystack [L*T] → compacted (positions[cap], states[cap], total)."""
    states, mask = scan_lanes(
        table, classes, hay, match_count, n, L, T, halo, use_classes
    )
    positions, total = compact_sparse(mask, cap)
    states_at = torch.where(
        positions >= 0, states[positions.clamp(min=0).long()], -1
    )
    return positions, states_at, total


class DeviceTables:
    """Per-automaton cache of device-resident tables + scan state."""

    def __init__(self, am: Automaton, engine: str,
                 device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self.engine = engine
        if engine == "dfa":
            table = am.delta
            classes = np.zeros(257, dtype=np.int32)  # unused placeholder
            self.use_classes = False
        elif engine == "classed":  # byte-classed (ContiguousNFA analogue)
            table = am.delta_classed
            classes = am.byte_classes
            self.use_classes = True
        else:
            raise NotImplementedError(
                f"the {engine!r} engine has no device scan in this package "
                "yet; use a host backend or the dfa/classed engines"
            )
        self.table = torch.from_numpy(np.ascontiguousarray(table)).to(
            self.device
        )
        self.classes = torch.from_numpy(
            np.ascontiguousarray(classes, dtype=np.int32)
        ).to(self.device)
        self.match_count = torch.from_numpy(
            np.ascontiguousarray(am.match_count)
        ).to(self.device)
        self._am = am
        #: adaptive initial compaction capacity (sticky across calls)
        self.last_cap = 4096

    def ensure_packed2(self) -> bool:
        """The stride-2 scan is not part of this package yet."""
        return False


def _bucket(x: int, lo: int = 16) -> int:
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
    Returns global (positions, states) as int64 NumPy arrays.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    halo = am.max_len - 1
    if tables.ensure_packed2():
        halo += halo & 1  # pairs must align across the halo boundary
    all_pos: list[np.ndarray] = []
    all_states: list[np.ndarray] = []
    seg = max(segment_bytes, 2 * max(1, halo))
    for seg_start in range(0, n, seg):
        seg_end = min(n, seg_start + seg)
        ctx_start = max(0, seg_start - halo)
        drop = seg_start - ctx_start  # leading context positions to discard
        m = seg_end - ctx_start
        L, T = choose_layout(m, halo)
        with torch.profiler.record_function("ahocorasick:stage"):
            buf = np.zeros(L * T, dtype=np.uint8)
            buf[:m] = hay[ctx_start:seg_end]
            hay_dev = to_device(buf, tables.device)
        cap = tables.last_cap
        while True:
            with torch.profiler.record_function("ahocorasick:lane_scan"):
                pos, st, total = _scan_compact(
                    tables.table,
                    tables.classes,
                    hay_dev,
                    tables.match_count,
                    m,
                    L,
                    T,
                    halo,
                    cap,
                    tables.use_classes,
                )
            # one host fetch for all outputs (waits for the device)
            with torch.profiler.record_function("ahocorasick:fetch"):
                out = torch.cat([pos, st, total]).cpu().numpy()
            pos, st, total = out[:cap], out[cap : 2 * cap], int(out[-1])
            if total <= cap:
                break
            if total > max(DENSE_BAILOUT_MIN, m // 8):
                # match-dense corpus: growing the compaction capacity
                # toward n and expanding occurrence sets on host is the
                # wrong complexity class — let the host resolver take it
                raise MatchDenseError(
                    f"{total} matched positions in a {m}-byte segment"
                )
            cap = _bucket(total, lo=4096)
        tables.last_cap = max(4096, _bucket(total, lo=4096))
        pos = pos[:total].astype(np.int64)
        st = st[:total].astype(np.int64)
        keep = pos >= drop
        all_pos.append(pos[keep] - drop + seg_start)
        all_states.append(st[keep])
    positions = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
    states = np.concatenate(all_states) if all_states else np.zeros(0, np.int64)
    return positions, states
