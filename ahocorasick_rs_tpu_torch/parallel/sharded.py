"""Data-parallel sharded haystack scan over ``torch.distributed`` (K8).

The counterpart of the JAX package's ``parallel/sharded.py``, which runs
one program over a device mesh.  Here every rank is a process with its own
device (the matcher's ``device=``) that runs the same Python:

* each rank holds the automaton's tables on its device and the whole
  haystack on the host, and stages only its own contiguous byte range;
* the one piece of remote context, a shard's neighbour bytes, crosses
  ranks in one ``all_gather`` of a fixed-size tensor per rank, from which
  each rank picks its neighbour's slot.  The reference uses ``ppermute``;
  gloo and NCCL both implement ``all_gather``, so the code gloo runs on
  the CPU is the code NCCL runs on the cards;
* each rank runs the port's kernels over its shard and compacts its
  matches on its device; the compacted outputs are gathered the same way,
  so every rank returns the complete result.

Each per-device body of the reference is split in two: a pure per-rank
function of (its shard, the neighbour bytes it receives, ``n_local``,
``offset``) -- :func:`shard_scan_body`, :func:`shard_teddy_body`,
:func:`shard_batch_body` -- and the exchange layer, :class:`ShardGroup`.
Layouts, capacities, bailouts and ownership are the reference's exactly:
in the dense scan the shard holding a match's end owns it and reads the
``max_len - 1`` bytes before it from its left neighbour; in Teddy the
shard holding a match's start owns it and reads the first ``Hr`` bytes of
its right neighbour.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from ..models.automaton import Automaton, PAD_BYTE
from ..ops.resolve import MatchDenseError
from ..ops.scan_cuda import (
    DENSE_BAILOUT_MIN,
    MIN_LANES,
    DeviceTables,
    _bucket,
    _compact_states,
    _scan_compact,
    compact_sparse,
    scan_batch,
    to_device,
)

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

    from ..ops.scan_teddy import TeddyScanner


class ShardGroup:
    """The ranks a sharded scan runs over.

    Wraps a ``torch.distributed`` process group, or stands for a world of
    one rank (``group=None``) that needs no collective.  A real group of
    one rank still runs its collectives, so a one-rank NCCL or gloo world
    takes the code path of a larger one.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None) -> None:
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` in rank order."""
        if self.group is None:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)


MeshLike = Union["DeviceMesh", dist.ProcessGroup, ShardGroup, None]


def make_mesh() -> ShardGroup:
    """Every rank of the default process group, or a world of one rank
    when ``torch.distributed`` is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return ShardGroup(dist.group.WORLD)
    return ShardGroup(None)


def as_group(mesh: MeshLike) -> ShardGroup:
    """A 1-D ``DeviceMesh``, a ``ProcessGroup`` or ``None`` (the default
    group, see :func:`make_mesh`) as a :class:`ShardGroup`."""
    if mesh is None:
        return make_mesh()
    if isinstance(mesh, ShardGroup):
        return mesh
    if isinstance(mesh, dist.ProcessGroup):
        return ShardGroup(mesh)
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        if mesh.ndim != 1:
            raise ValueError(
                f"the sharded scan needs a 1-D mesh, not {mesh.ndim}-D"
            )
        return ShardGroup(mesh.get_group())
    raise TypeError(
        "mesh must be a torch.distributed DeviceMesh or ProcessGroup, not "
        f"{type(mesh).__name__}"
    )


def _shard_of(hay: np.ndarray, rank: int, LT: int) -> np.ndarray:
    """Rank ``rank``'s ``LT`` bytes of the zero-padded haystack layout."""
    buf = np.zeros(LT, dtype=np.uint8)
    part = hay[rank * LT : (rank + 1) * LT]
    buf[: len(part)] = part
    return buf


def _count_body(t: torch.Tensor) -> None:
    """Count one K8 dispatch: a per-rank body that has just launched its
    kernels on a card (each kernel is also counted under its own name)."""
    if t.device.type == "cuda":
        _kernels.LAUNCHES["shard_body"] += 1


# -- dense scan ---------------------------------------------------------


def dense_layout(
    n: int, n_dev: int, halo: int, lanes_per_device: int = 512
) -> tuple[int, int]:
    """``(L, T)`` per rank: ``n_dev * L`` lanes of ``T`` bytes; rank ``d``
    owns bytes ``[d*L*T, (d+1)*L*T)``."""
    L = lanes_per_device
    return L, _bucket(max(-(-n // (n_dev * L)), halo, 16))


def shard_tail(shard: torch.Tensor, n_local: int, halo: int) -> torch.Tensor:
    """What a shard sends its right neighbour: its last ``halo`` bytes as
    int32, PAD at or past ``n_local`` (its own count of real bytes)."""
    LT = shard.numel()
    idx = torch.arange(LT - halo, LT, device=shard.device)
    return torch.where(
        idx < n_local, shard[LT - halo :].to(torch.int32), PAD_BYTE
    ).to(torch.int32)


def shard_scan_body(
    tables: DeviceTables,
    shard: torch.Tensor,
    head: Optional[torch.Tensor],
    n_local: int,
    offset: int,
    L: int,
    T: int,
    halo: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's dense scan: K2 over its ``L*T``-byte shard with the left
    neighbour's ``head`` (int32 ``[halo]``, from :func:`shard_tail`; all
    PAD on rank 0), then K3.  Returns global positions int64 ``[cap]``
    (-1 padded), the states int32 ``[cap]`` and the shard's total."""
    n_local = min(max(n_local, 0), L * T)
    pos, st, total = _scan_compact(
        tables.table, tables.classes, shard, tables.match_count, n_local,
        L, T, halo, cap, tables.use_classes, head, tables.lane_table(),
    )
    _count_body(shard)
    return torch.where(pos >= 0, pos.long() + offset, -1), st, total


def _gathered(
    g: ShardGroup, parts: list[torch.Tensor]
) -> np.ndarray:
    """Every rank's outputs as one host array ``[size, sum of lengths]``
    (one collective, one device-to-host copy)."""
    with torch.profiler.record_function("ahocorasick:gather"):
        flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
        return g.all_gather(flat).cpu().numpy()


def scan_sharded(
    am: Automaton,
    hay: np.ndarray,
    tables: DeviceTables,
    mesh: MeshLike = None,
    *,
    lanes_per_device: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """Scan ``hay`` sharded across the ranks; returns global ascending
    ``(positions, states)`` as int64, the same on every rank.

    Every rank must call it with the same haystack and equal tables.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    g = as_group(mesh)
    n_dev, rank = g.size, g.rank
    halo = am.max_len - 1
    L, T = dense_layout(n, n_dev, halo, lanes_per_device)
    LT = L * T
    n_local = n - rank * LT
    with torch.profiler.record_function("ahocorasick:stage"):
        shard = to_device(_shard_of(hay, rank, LT), tables.device)
    head = None
    if halo:
        with torch.profiler.record_function("ahocorasick:exchange"):
            tails = g.all_gather(shard_tail(shard, n_local, halo))
            head = (
                tails[rank - 1] if rank
                else torch.full_like(tails[0], PAD_BYTE)
            )
    # sticky compaction capacity shared with the single-device path
    cap = tables.last_cap
    while True:
        with torch.profiler.record_function("ahocorasick:shard_scan"):
            outs = shard_scan_body(
                tables, shard, head, n_local, rank * LT, L, T, halo, cap
            )
        got = _gathered(g, list(outs))
        totals = got[:, -1]
        worst = int(totals.max())
        if worst <= cap:
            break
        if worst > max(DENSE_BAILOUT_MIN, LT // 8):
            # density bailout, same contract as scan_device: the host
            # resolve paths own the match-dense regime (api._find)
            raise MatchDenseError(
                f"{worst} matched positions in a {LT}-byte shard"
            )
        cap = _bucket(worst, lo=4096)
    tables.last_cap = max(4096, _bucket(max(worst, 1), lo=4096))
    pos = [got[d, : totals[d]] for d in range(n_dev)]
    st = [got[d, cap : cap + totals[d]] for d in range(n_dev)]
    return np.concatenate(pos), np.concatenate(st)


# -- prefiltered (Teddy) scan -------------------------------------------


def teddy_layout(n: int, n_dev: int, W: int) -> tuple[int, int]:
    """``(rows, Hr)``: each rank stages ``[rows, 128]`` bytes and reads the
    first ``Hr`` bytes of its right neighbour.  A shard holds at least
    ``Hr`` bytes, so a verification window reaches at most one shard to
    the right."""
    from ..ops.scan_teddy import VCHUNK

    Hr = VCHUNK * (-(-W // VCHUNK))
    rows = _bucket(max(-(-n // (n_dev * 128)), -(-Hr // 128), 8), lo=8)
    return rows, Hr


def shard_teddy_body(
    scanner: "TeddyScanner",
    shard: torch.Tensor,
    right: torch.Tensor,
    n_local: int,
    offset: int,
    W: int,
    cap: int,
    cap2: int,
) -> tuple[torch.Tensor, ...]:
    """One rank's prefiltered scan: K1 over its ``[rows, 128]`` shard, K9
    and K3 over the fired COARSE groups, then K4 over ``[shard | right |
    VCHUNK zeros]``, where ``right`` is the right neighbour's first ``Hr``
    bytes (zeros on the last rank).  ``n_local`` is ``n - offset`` and may
    exceed the shard.  Returns (global window starts int64 ``[cap]``,
    ftotal, win, step, state, mtotal) as ``_fire_verify`` does."""
    from ..ops.scan_teddy import (
        COARSE,
        VCHUNK,
        _verify_body,
        fire_groups,
        fire_mask,
    )

    LT = shard.numel()
    mask = fire_mask(
        scanner.tables, shard.view(LT // 128, 128), scanner.m,
        scanner.words, scanner.passes, packed=scanner.packed,
    ).reshape(-1)
    fire_grp, ftotal = compact_sparse(fire_groups(mask, n_local), cap)
    fire_pos = torch.where(fire_grp >= 0, fire_grp * COARSE, -1)
    hay_pad = torch.cat([shard, right, shard.new_zeros(VCHUNK)])
    # every window ends inside hay_pad, so bytes past its end never count
    nv = min(max(n_local, 0), hay_pad.numel())
    win, step, st, mtotal = _verify_body(
        scanner.vtable, scanner.classes, hay_pad, fire_pos, nv, W, cap2,
        scanner.use_classes,
    )
    _count_body(shard)
    pos_global = torch.where(fire_pos >= 0, fire_pos.long() + offset, -1)
    return pos_global, ftotal, win, step, st, mtotal


def scan_sharded_teddy(
    am: Automaton,
    scanner: "TeddyScanner",
    hay: np.ndarray,
    mesh: MeshLike = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Prefiltered scan sharded across the ranks.

    Returns the complete (pids, starts, ends) occurrence set in canonical
    order, identical to ``TeddyScanner.occurrences``, or None when the
    observed fire rate says the dense sharded scan should take over (then
    ``scanner.worthwhile`` is False).  ``scanner``'s sticky capacities are
    shared with the single-device path.
    """
    from ..ops import scan_teddy as _teddy

    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z
    g = as_group(mesh)
    n_dev, rank = g.size, g.rank
    W = am.max_len + _teddy.COARSE - 1
    rows, Hr = teddy_layout(n, n_dev, W)
    LT = rows * 128
    with torch.profiler.record_function("ahocorasick:stage"):
        shard = to_device(_shard_of(hay, rank, LT), scanner.device)
    with torch.profiler.record_function("ahocorasick:exchange"):
        heads = g.all_gather(shard[:Hr])
        right = (
            heads[rank + 1] if rank + 1 < n_dev
            else torch.zeros_like(heads[0])
        )
    cap, cap2 = scanner.fire_cap, scanner.match_cap
    too_many = max(1 << 16, n // 2)
    while True:
        with torch.profiler.record_function("ahocorasick:shard_teddy"):
            outs = shard_teddy_body(
                scanner, shard, right, n - rank * LT, rank * LT, W, cap,
                cap2,
            )
        got = _gathered(g, list(outs))
        pos = got[:, :cap]
        ftot = got[:, cap]
        win, step, st = got[:, cap + 1 : -1].reshape(n_dev, 3, cap2).transpose(
            1, 0, 2
        )
        mtot = got[:, -1]
        ftotal = int(ftot.max())
        if ftotal > cap:
            if int(ftot.sum()) * max(W, 1) > too_many:
                scanner.fire_cap = max(
                    scanner.fire_cap, _teddy._bucket(ftotal)
                )
                scanner.worthwhile = False
                return None
            cap = _teddy._bucket(ftotal)
            continue
        mtotal = int(mtot.max())
        if mtotal > cap2:
            cap2 = _teddy._bucket(mtotal)
            continue
        break
    scanner.fire_cap = max(1 << 14, _teddy._bucket(max(ftotal, 1)))
    scanner.match_cap = max(1 << 12, _teddy._bucket(max(mtotal, 1)))
    # the in-loop abandon's threshold: the backend choice depends on the
    # corpus, not on incidental cap history
    if int(ftot.sum()) * max(W, 1) > too_many:
        scanner.worthwhile = False
        return None
    all_p: list[np.ndarray] = []
    all_s: list[np.ndarray] = []
    all_e: list[np.ndarray] = []
    with torch.profiler.record_function("ahocorasick:expand"):
        for d in range(n_dev):
            mt = int(mtot[d])
            if not mt:
                continue
            p_, s_, e_ = _teddy.expand_verified(
                am, pos[d][win[d, :mt]], step[d, :mt], st[d, :mt]
            )
            all_p.append(p_)
            all_s.append(s_)
            all_e.append(e_)
        if not all_p:
            z = np.zeros(0, dtype=np.int64)
            return z.astype(np.int32), z, z
        pids = np.concatenate(all_p)
        starts = np.concatenate(all_s)
        ends = np.concatenate(all_e)
        order = np.lexsort((pids, starts, ends))
    return pids[order], starts[order], ends[order]


# -- batched many-document scan -----------------------------------------


def batch_layout(lens: list[int], n_dev: int) -> tuple[int, int]:
    """``(Bb, T)``: ``Bb`` rows (a multiple of ``n_dev``; rank ``d`` owns
    rows ``[d*Bb/n_dev, (d+1)*Bb/n_dev)``) of ``T`` bytes."""
    T = _bucket(max(max(lens, default=1), 16), lo=16)
    Bb = _bucket(max(len(lens), MIN_LANES, n_dev), lo=MIN_LANES)
    if Bb % n_dev:  # rank counts are not always powers of two
        Bb = -(-Bb // n_dev) * n_dev
    return Bb, T


def shard_batch_body(
    tables: DeviceTables,
    hay2d: torch.Tensor,
    lens: torch.Tensor,
    offset: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's batch scan: K5 over its ``[B, T]`` row block (no halo:
    every document starts at the root), then K3.  Returns flat global
    positions ``offset + row*T + t`` int64 ``[cap]``, states and total."""
    pos, st, total = _compact_states(
        *scan_batch(
            tables.table, tables.classes, hay2d, lens, tables.match_count,
            tables.use_classes, tables.lane_table(), tables.halo,
        ),
        cap,
    )
    _count_body(hay2d)
    return torch.where(pos >= 0, pos.long() + offset, -1), st, total


def scan_sharded_batch(
    am: Automaton,
    docs: list[np.ndarray],
    tables: DeviceTables,
    mesh: MeshLike = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Batched many-document scan with the rows sharded across the ranks.

    The sharded counterpart of ``scan_cuda.scan_device_batch``, with the
    same contract: flat ascending ``(positions, states, T)``, document
    ``i`` at ``[i*T, i*T + len)``.  Padding rows have length 0 and never
    match.
    """
    B = len(docs)
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 1
    g = as_group(mesh)
    n_dev, rank = g.size, g.rank
    Bb, T = batch_layout([len(d) for d in docs], n_dev)
    Bl = Bb // n_dev
    with torch.profiler.record_function("ahocorasick:stage"):
        buf = np.zeros((Bl, T), dtype=np.uint8)
        lens = np.zeros(Bl, dtype=np.int32)
        for r, d in enumerate(docs[rank * Bl : (rank + 1) * Bl]):
            buf[r, : len(d)] = d
            lens[r] = len(d)
        hay2d = to_device(buf, tables.device)
        lens_dev = torch.from_numpy(lens).to(tables.device)
    cap = tables.last_cap
    while True:
        with torch.profiler.record_function("ahocorasick:shard_batch"):
            outs = shard_batch_body(
                tables, hay2d, lens_dev, rank * Bl * T, cap
            )
        got = _gathered(g, list(outs))
        totals = got[:, -1]
        worst = int(totals.max())
        if worst <= cap:
            break
        if worst > max(DENSE_BAILOUT_MIN, Bl * T // 8):
            # density bailout: the host resolve paths own the match-dense
            # regime (api._find_batch)
            raise MatchDenseError(
                f"{worst} matched positions in a {Bl}x{T} batch shard"
            )
        cap = _bucket(worst, lo=4096)
    tables.last_cap = max(4096, _bucket(max(worst, 1), lo=4096))
    pos = [got[d, : totals[d]] for d in range(n_dev)]
    st = [got[d, cap : cap + totals[d]] for d in range(n_dev)]
    return np.concatenate(pos), np.concatenate(st), T
