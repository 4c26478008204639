"""Data-parallel sharded haystack scan (K8).

The counterpart of the JAX package's ``parallel/sharded.py``, which runs
one program over a device mesh.  Here every rank runs the same Python on
its own device, in one of two forms:

* a process of a ``torch.distributed`` group (the matcher's ``device=``),
  whose exchange is :class:`ShardGroup`;
* a thread of this process, one per device of a :class:`LocalMesh`
  (:func:`make_mesh`: every local card, as the JAX package's mesh over
  ``jax.devices()``), whose exchange is :class:`ThreadGroup`.  The scan
  functions take such a mesh, run themselves on its thread ranks with
  the tables copied to each rank's device, and return rank 0's result.

In both forms:

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

import threading
from typing import TYPE_CHECKING, Callable, Optional, Sequence, TypeVar, Union

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
from ..utils import trace

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


class Ring:
    """The exchange of one call's thread ranks: a slot a rank and a
    barrier.  :meth:`abort` breaks the barrier: every rank waiting on it,
    or reaching it later, raises ``threading.BrokenBarrierError`` at once.
    A wait that every rank had already reached still returns, which
    ``threading.Barrier.abort`` does not promise, so a rank that fails
    after the last exchange does not fail the others."""

    def __init__(self, size: int) -> None:
        self.slots: list = [None] * size
        self._size = size
        self._arrived = 0
        self._round = 0
        self._broken = False
        self._cond = threading.Condition()

    def wait(self) -> None:
        with self._cond:
            if self._broken:
                raise threading.BrokenBarrierError
            mine = self._round
            self._arrived += 1
            if self._arrived == self._size:
                self._arrived = 0
                self._round += 1
                self._cond.notify_all()
                return
            while self._round == mine and not self._broken:
                self._cond.wait()
            if self._round == mine:
                raise threading.BrokenBarrierError

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()


class ThreadGroup(ShardGroup):
    """Rank ``rank`` of ``ring``'s ranks, one thread each, on ``device``:
    ``all_gather`` as a process group does it, through the ring's slots.

    A rank publishes a copy of its tensor with an event recorded on its
    current stream after the copy.  A reader's stream on the tensor's
    device waits for that event, and the tensor is ``record_stream``-ed to
    that stream, so that the caching allocator does not hand its memory
    out again while the read is queued; a tensor on another device is then
    copied to the reader's.  The second barrier keeps a rank from
    publishing again before every rank has queued its reads.
    """

    def __init__(
        self, ring: Ring, rank: int, device: Union[str, torch.device] = "cpu"
    ) -> None:
        self.group = None
        self.ring = ring
        self.rank = rank
        self.size = len(ring.slots)
        self.device = torch.device(device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        mine = t.clone()
        ready = None
        if mine.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(mine.device))
        self.ring.slots[self.rank] = (mine, ready)
        self.ring.wait()
        parts = []
        for src, ev in self.ring.slots:
            if ev is not None:
                reader = torch.cuda.current_stream(src.device)
                reader.wait_event(ev)
                src.record_stream(reader)
            parts.append(src.to(self.device, non_blocking=True))
        out = torch.stack(parts)
        self.ring.wait()  # nobody publishes again before all read
        return out


_R = TypeVar("_R")


class LocalMesh:
    """A mesh of this process's devices: rank ``r`` is a thread on
    ``devices[r]`` (repeats allowed: ranks that share a card each run on
    a stream of their own).

    :meth:`run` calls ``fn(group)`` on every rank at once, each with a
    :class:`ThreadGroup` of one :class:`Ring`, and returns every rank's
    result.  A rank that raises aborts the ring, so the other ranks fail
    at their next exchange instead of waiting for it; :meth:`run` joins
    every thread and raises the first rank's own error.  Calls on one mesh
    run one at a time.
    """

    def __init__(self, devices: Sequence[Union[str, torch.device]]) -> None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a local mesh needs at least one device")
        for d in devs:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"a local mesh takes CUDA or CPU devices, "
                                 f"not {d}")
        if any(d.type == "cuda" for d in devs) and (
            not torch.cuda.is_available()
        ):
            raise RuntimeError("CUDA is not available; name the CPU to run "
                               "a local mesh there")
        self.devices = [
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in devs
        ]
        self.size = len(self.devices)
        self._streams = [
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in self.devices
        ]
        self._lock = threading.Lock()

    def run(self, fn: Callable[[ThreadGroup], _R]) -> list[_R]:
        with self._lock:
            ring = Ring(self.size)
            out: list = [None] * self.size
            errors: list[Optional[BaseException]] = [None] * self.size
            # the ranks' streams start after the caller's queued work (the
            # tables' uploads) on each device
            ready = {}
            for d in self.devices:
                if d.type == "cuda" and d not in ready:
                    ready[d] = torch.cuda.Event()
                    ready[d].record(torch.cuda.current_stream(d))

            def rank(r: int) -> None:
                dev, stream = self.devices[r], self._streams[r]
                try:
                    if stream is None:
                        out[r] = fn(ThreadGroup(ring, r, dev))
                        return
                    # the runtime's current device is per host thread
                    torch.cuda.set_device(dev)
                    stream.wait_event(ready[dev])
                    with torch.cuda.stream(stream):
                        out[r] = fn(ThreadGroup(ring, r, dev))
                except BaseException as e:  # raised again by the caller
                    errors[r] = e
                    ring.abort()

            threads = [
                threading.Thread(target=rank, args=(r,),
                                 name=f"ahocorasick-rank-{r}")
                for r in range(self.size)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for d, s in zip(self.devices, self._streams):
                if s is not None:
                    torch.cuda.current_stream(d).wait_stream(s)
        failed = [e for e in errors if e is not None]
        if failed:
            raise next(
                (e for e in failed
                 if not isinstance(e, threading.BrokenBarrierError)),
                failed[0],
            )
        return out


MeshLike = Union["DeviceMesh", dist.ProcessGroup, ShardGroup, LocalMesh, None]


def _process_group() -> Optional[ShardGroup]:
    """Every rank of the default process group, if one is initialized."""
    if dist.is_available() and dist.is_initialized():
        return ShardGroup(dist.group.WORLD)
    return None


def make_mesh(
    num_devices: Optional[int] = None,
    *,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Union[ShardGroup, LocalMesh]:
    """The ranks of a sharded scan, as the JAX package's ``make_mesh``.

    ``devices`` names the devices of a :class:`LocalMesh`, one thread rank
    each, repeats allowed (``["cpu"] * 4`` on the CPU, ``["cuda:0"] * 2``
    for two ranks sharing a card).  Otherwise: every rank of the default
    process group when ``torch.distributed`` is initialized (then
    ``num_devices`` must be None or its size), else a :class:`LocalMesh`
    over the first ``num_devices`` CUDA devices, all of them by default.
    Without a card that raises: there is no silent CPU mesh.
    """
    if devices is not None:
        return LocalMesh(devices)
    group = _process_group()
    if group is not None:
        if num_devices not in (None, group.size):
            raise ValueError(
                f"num_devices={num_devices}, but the process group has "
                f"{group.size} ranks"
            )
        return group
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; name the devices of a local mesh, e.g. "
            "make_mesh(devices=['cpu'] * 4)"
        )
    count = torch.cuda.device_count()
    n = count if num_devices is None else num_devices
    if not 1 <= n <= count:
        raise ValueError(f"num_devices={n}, but {count} CUDA devices")
    return LocalMesh([torch.device("cuda", i) for i in range(n)])


def as_group(mesh: MeshLike) -> Union[ShardGroup, LocalMesh]:
    """A 1-D ``DeviceMesh``, a ``ProcessGroup``, a :class:`LocalMesh` or
    ``None`` (the default process group, or a world of one rank when none
    is initialized) as the ranks of a sharded scan."""
    if mesh is None:
        return _process_group() or ShardGroup(None)
    if isinstance(mesh, (ShardGroup, LocalMesh)):
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
        "mesh must be a torch.distributed DeviceMesh or ProcessGroup, or a "
        f"LocalMesh, not {type(mesh).__name__}"
    )


_S = TypeVar("_S")


def _on_ranks(
    mesh: LocalMesh, state: _S, fn: Callable[[_S, ThreadGroup], _R]
) -> tuple[_R, _S]:
    """``fn(state on the rank's device, group)`` on every thread rank of
    ``mesh``: rank 0's result and rank 0's ``state``.  ``state`` (tables or
    a scanner) is copied to each distinct device here, on the calling
    thread, before any rank starts, so no rank builds what another reads;
    ranks that share a device share its copy."""
    copies = {d: state.on(d) for d in mesh.devices}
    out = mesh.run(lambda g: fn(copies[g.device], g))
    return out[0], copies[mesh.devices[0]]


def _shard_of(hay: np.ndarray, rank: int, LT: int) -> np.ndarray:
    """Rank ``rank``'s ``LT`` bytes of the zero-padded haystack layout."""
    with trace.span("pad"):
        buf = np.zeros(LT, dtype=np.uint8)
        part = hay[rank * LT : (rank + 1) * LT]
        buf[: len(part)] = part
    trace.count("pad_bytes", buf.nbytes)
    return buf


def _count_body(t: torch.Tensor) -> None:
    """Count one K8 dispatch: a per-rank body that has just launched its
    kernels on a card (each kernel is also counted under its own name)."""
    if t.device.type == "cuda":
        _kernels.count_launch("shard_body")


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
    with trace.span("gather"):
        flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
        return g.all_gather(flat).cpu().numpy()


def scan_sharded(
    am: Automaton,
    hay: np.ndarray,
    tables: DeviceTables,
    mesh: MeshLike = None,
    *,
    lanes_per_device: int = 512,
    cap: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Scan ``hay`` sharded across the ranks; returns global ascending
    ``(positions, states)`` as int64, the same on every rank.

    Every rank must call it with the same haystack, equal tables and the
    same ``cap``, the compaction capacity to start from (by default the
    tables' sticky ``last_cap``).  On a :class:`LocalMesh` it is one call
    that runs every rank.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    g = as_group(mesh)
    if cap is None:
        # one read for every rank of a local mesh: ranks that share these
        # tables write them at their end
        cap = tables.last_cap
    if isinstance(g, LocalMesh):
        out, t0 = _on_ranks(g, tables, lambda t, rg: scan_sharded(
            am, hay, t, rg, lanes_per_device=lanes_per_device, cap=cap
        ))
        tables.last_cap = t0.last_cap
        return out
    n_dev, rank = g.size, g.rank
    halo = am.max_len - 1
    L, T = dense_layout(n, n_dev, halo, lanes_per_device)
    LT = L * T
    n_local = n - rank * LT
    with trace.span("stage"):
        shard = to_device(_shard_of(hay, rank, LT), tables.device)
    head = None
    if halo:
        with trace.span("exchange"):
            tails = g.all_gather(shard_tail(shard, n_local, halo))
            head = (
                tails[rank - 1] if rank
                else torch.full_like(tails[0], PAD_BYTE)
            )
    while True:
        with trace.span("shard_scan"):
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
    *,
    caps: Optional[tuple[int, int]] = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Prefiltered scan sharded across the ranks.

    Returns the complete (pids, starts, ends) occurrence set in canonical
    order, identical to ``TeddyScanner.occurrences``, or None when the
    observed fire rate says the dense sharded scan should take over (then
    ``scanner.worthwhile`` is False).  ``caps``, the same on every rank, are
    the fire and match capacities to start from, by default ``scanner``'s
    sticky ones, which it shares with the single-device path.  On a
    :class:`LocalMesh` it is one call that runs every rank.
    """
    from ..ops import scan_teddy as _teddy

    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z
    g = as_group(mesh)
    if caps is None:
        # one read for every rank, as in scan_sharded
        caps = scanner.fire_cap, scanner.match_cap
    if isinstance(g, LocalMesh):
        occ, s0 = _on_ranks(g, scanner, lambda sc, rg: scan_sharded_teddy(
            am, sc, hay, rg, caps=caps
        ))
        scanner.fire_cap, scanner.match_cap = s0.fire_cap, s0.match_cap
        scanner.worthwhile = s0.worthwhile
        return occ
    n_dev, rank = g.size, g.rank
    W = am.max_len + _teddy.COARSE - 1
    rows, Hr = teddy_layout(n, n_dev, W)
    LT = rows * 128
    with trace.span("stage"):
        shard = to_device(_shard_of(hay, rank, LT), scanner.device)
    with trace.span("exchange"):
        heads = g.all_gather(shard[:Hr])
        right = (
            heads[rank + 1] if rank + 1 < n_dev
            else torch.zeros_like(heads[0])
        )
    cap, cap2 = caps
    too_many = max(1 << 16, n // 2)
    while True:
        with trace.span("shard_teddy"):
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
    with trace.span("expand"):
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
    *,
    cap: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Batched many-document scan with the rows sharded across the ranks.

    The sharded counterpart of ``scan_cuda.scan_device_batch``, with the
    same contract: flat ascending ``(positions, states, T)``, document
    ``i`` at ``[i*T, i*T + len)``.  Padding rows have length 0 and never
    match.  ``cap`` and a :class:`LocalMesh` as in :func:`scan_sharded`.
    """
    B = len(docs)
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 1
    g = as_group(mesh)
    if cap is None:
        # one read for every rank of a local mesh: ranks that share these
        # tables write them at their end
        cap = tables.last_cap
    if isinstance(g, LocalMesh):
        out, t0 = _on_ranks(g, tables, lambda t, rg: scan_sharded_batch(
            am, docs, t, rg, cap=cap
        ))
        tables.last_cap = t0.last_cap
        return out
    n_dev, rank = g.size, g.rank
    Bb, T = batch_layout([len(d) for d in docs], n_dev)
    Bl = Bb // n_dev
    with trace.span("stage"):
        with trace.span("pad"):
            buf = np.zeros((Bl, T), dtype=np.uint8)
            lens = np.zeros(Bl, dtype=np.int32)
            for r, d in enumerate(docs[rank * Bl : (rank + 1) * Bl]):
                buf[r, : len(d)] = d
                lens[r] = len(d)
        trace.count("pad_bytes", buf.nbytes + lens.nbytes)
        hay2d = to_device(buf, tables.device)
        lens_dev = torch.from_numpy(lens).to(tables.device)
        trace.count("h2d_bytes", lens.nbytes)
    while True:
        with trace.span("shard_batch"):
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
