"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source under ``csrc/`` is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, for
``sm_90a``.  The libraries land in ``_build/<hash>/``, where the hash
covers the flags and every file of ``csrc/`` (the shared headers
``sublane.cuh`` and ``lookback.cuh`` too, :func:`source_hash`), so a
changed file rebuilds and an unchanged tree loads at once.  ``ctypes``
binds them, with ``c_void_p`` for every pointer and for the stream.

The launchers below check device, dtype, shape and contiguity, allocate
every output and scratch buffer with ``torch.empty``, launch on the
current stream of the tensors' device under :func:`device_guard` and
raise if the entry point reports a CUDA error.  Each adds one to its entry
in :data:`LAUNCHES` (:func:`count_launch`), and nothing else does, so a
run can show which kernels a path went through.  Nothing here is imported
or built until a CUDA tensor reaches a launcher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
SOURCES = (
    "scan.cu", "teddy.cu", "verify.cu", "stride2.cu", "sparse.cu", "batch.cu",
    "probe.cu", "groups.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last :func:`reset_launches`;
#: ``lane_scan_head`` counts the K2 launches that carry a neighbour's head
#: (also counted under ``lane_scan``), ``verify`` K4's launches (the
#: whole verify body, or its walk alone), ``shard_body`` the per-rank bodies
#: of the sharded scan (K8) that ran on a card, ``probe_*`` the layout
#: probes P1 and P2, ``fire_groups`` the Teddy group stage K9
LAUNCHES: dict[str, int] = {
    "fire": 0, "fire_groups": 0, "lane_scan": 0, "lane_scan_head": 0,
    "compact": 0,
    "verify": 0, "batch_scan": 0, "stride2_scan": 0, "sparse_scan": 0,
    "shard_body": 0, "probe_reduce": 0, "probe_rollrows": 0,
}
#: K1 launches by prefilter shape ``(m, words, passes)`` since the last
#: :func:`reset_launches` (``tune()`` launches K1 at every candidate's)
FIRE_CONFIGS: dict[tuple[int, int, int], int] = {}
#: positions a K1 block stages unless the caller names another tile
FIRE_TILE = 4096
#: the tiles K1 takes: multiples of its 256 threads, up to 65,536
FIRE_TILE_STEP, FIRE_TILE_MAX = 256, 1 << 16
#: rows per block of the layout probes' ``[R, 128]`` arrays
PROBE_BLOCK_ROWS = 1024
#: compiler output per source (ptxas register and shared-memory report)
BUILD_LOG: dict[str, str] = {}
#: wall seconds of the last build (0.0 when every library was cached)
BUILD_SECONDS = 0.0

_lock = threading.Lock()
_libs: Optional[dict[str, ctypes.CDLL]] = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "ac_lane_scan": [_P, _I32, _P, _I32, _P, _I64, _P, _I32, _I32, _I32,
                     _I32, _I32, _P, _P, _P],
    "ac_compact": [_P, _I64, _I32, _P, _P, _P, _I32, _P],
    "ac_compact_chunk": [],
    "ac_fire": [_P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _P, _P],
    "ac_verify": [_P, _I32, _P, _I32, _P, _I64, _I64, _P, _I32, _I32, _I32,
                  _I32, _I32, _I32, _P, _P],
    "ac_verify_body": [_P, _I32, _P, _I32, _P, _I64, _I64, _P, _I32, _I32,
                       _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P,
                       _I32, _P],
    "ac_verify_blocks": [_I32, _I32],
    "ac_stride2_scan": [_P, _P, _I32, _P, _P, _I64, _I32, _I32, _I32, _I32,
                        _I32, _P, _P, _P],
    "ac_sparse_scan": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                       _P, _P, _P],
    "ac_batch_scan": [_P, _I32, _P, _I32, _P, _P, _I32, _I32, _I32, _I32,
                      _I32, _P, _P, _P],
    "ac_probe_reduce": [_P, _I64, _P, _P],
    "ac_probe_rollrows": [_P, _I64, _P, _P],
    "ac_fire_groups": [_P, _I64, _I64, _P, _P],
}


_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        FIRE_CONFIGS.clear()


def count_launch(name: str, config: Optional[tuple] = None) -> None:
    """Add one to ``LAUNCHES[name]`` (and to ``FIRE_CONFIGS[config]``):
    under a lock, since the thread ranks of a local mesh launch at once."""
    with _count_lock:
        LAUNCHES[name] += 1
        if config is not None:
            FIRE_CONFIGS[config] = FIRE_CONFIGS.get(config, 0) + 1


def device_guard(dev: torch.device) -> torch.cuda.device:
    """The guard every launch runs under.  A ``<<<>>>`` launch,
    ``cudaGetDevice`` and ``cudaFuncSetAttribute`` (K1's dynamic shared
    memory, the sub-lane scans' carveout) act on the CUDA runtime's current
    device, which belongs to the host thread, not on the tensors' device."""
    return torch.cuda.device(dev)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash(csrc: str = _CSRC) -> str:
    """Hash of the compiler flags and of every file in ``csrc`` (sources
    and headers, by name and content): the build directory's name."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        path = os.path.join(csrc, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library."""
    global _libs, BUILD_SECONDS
    with _lock:
        if _libs is not None:
            return _libs
        out_dir = os.path.join(_BUILD, source_hash())
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in SOURCES:
            so = os.path.join(out_dir, f"lib{src[:-3]}.so")
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[src] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(_CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for src, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[src] = out
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        BUILD_SECONDS = time.perf_counter() - t0 if procs else 0.0
        libs = {}
        for src in SOURCES:
            lib = ctypes.CDLL(os.path.join(out_dir, f"lib{src[:-3]}.so"))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            libs[src[:-3]] = lib
        _libs = libs
        return libs


def _check(
    name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
    ndim: Optional[int] = None,
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed with error {err}")


#: bit of the flagged K2 table that carries "the next state has matches"
FLAG_SHIFT = 24
#: threads an SM holds at once (Hopper), the sub-lanes K2, K5, K6 and K7
#: aim to give each
SM_THREADS = 2048
_SM_COUNT: dict[int, int] = {}


def flag_table(table: torch.Tensor, match_count: torch.Tensor) -> torch.Tensor:
    """K2's and K4's table: ``next | (match_count[next] > 0) << 24``
    (int32), so a scan step reads the match flag with the next state."""
    if table.shape[0] >= 1 << FLAG_SHIFT:
        raise ValueError(
            f"{table.shape[0]} states do not fit the flagged table (below "
            f"2**{FLAG_SHIFT})"
        )
    return table | (
        (match_count[table.long()] > 0).to(torch.int32) << FLAG_SHIFT
    )


def pack_fire_tables(
    tables: torch.Tensor, m: int, words: int, passes: int
) -> torch.Tensor:
    """K1's packed tables: int32 ``[passes, m, 2, 16, WP]`` with entry
    ``[p, k, lohi, nibble, w]`` = lane ``nibble`` of the raw row
    ``((p*m + k)*2 + lohi)*words + w``, and ``WP`` = 4 for ``words`` <= 4,
    else 8 (planes past ``words`` are 0, so they never hit).  One entry is
    one or two 16-byte loads in the kernel."""
    wp = 4 if words <= 4 else 8
    raw = tables[:, :16].reshape(passes, m, 2, words, 16).transpose(3, 4)
    out = tables.new_zeros((passes, m, 2, 16, wp))
    out[..., :words] = raw
    return out


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = device.index if device.index is not None else (
        torch.cuda.current_device()
    )
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx
        ).multi_processor_count
    return _SM_COUNT[idx]


def plan_sublanes(L: int, T: int, halo: int, sms: int) -> int:
    """The sub-lane length ``S`` of K2, K6 and K7 (and, through
    :func:`batch_sublanes`, K5) for ``L`` lanes of ``T`` bytes.

    ``S`` divides ``T``, is at least ``halo`` (and 1) and, where ``T`` is a
    multiple of 16, a multiple of 16 (the kernel stages 16-byte pieces).
    It is the largest such length whose ``L*T/S`` sub-lanes still reach
    7/8 of ``sms * SM_THREADS`` walks, or the smallest one if none does.
    """
    divisors = set()
    for i in range(1, int(T ** 0.5) + 1):
        if T % i == 0:
            divisors.update((i, T // i))
    cands = sorted(d for d in divisors if d >= max(halo, 1))
    aligned = [d for d in cands if d % 16 == 0]
    cands = aligned or cands
    best = cands[0]
    for d in cands:
        if (L * T // d) * 8 >= 7 * sms * SM_THREADS:
            best = d
    return best


def lane_scan(
    flagged: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor, n: int,
    L: int, T: int, halo: int, use_classes: bool,
    head: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: states int32 [L*T] and match mask uint8 [L*T] of a uint8
    haystack of ``L*T`` bytes (the first ``n`` real) walked as ``L`` lanes
    of ``T`` bytes; ``head`` (int32 [halo], values 0-256) is read in place
    of PAD before position 0.

    ``flagged`` is :func:`flag_table` of the automaton's table.  ``states``
    holds the state only where ``mask`` is 1; elsewhere it is undefined.
    The kernel walks sub-lanes of :func:`plan_sublanes` bytes for this
    card; the outputs do not depend on their length.
    """
    if hay.device.type != "cuda":
        raise ValueError("lane_scan kernel needs CUDA tensors")
    S = plan_sublanes(L, T, halo, sm_count(hay.device))
    return _lane_scan_at(
        S, flagged, classes, hay, n, L, T, halo, use_classes, head
    )


def _lane_scan_at(
    S: int, flagged: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    n: int, L: int, T: int, halo: int, use_classes: bool,
    head: Optional[torch.Tensor] = None, carveout: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`lane_scan` with sub-lanes of ``S`` bytes (``S`` = ``T`` walks
    each lane in one thread) and the kernel's shared-memory ``carveout``
    (the percent of an SM's shared memory it asks for, which leaves the
    rest of the SM's 256 KB to L1; -1 takes the kernel's own)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("lane_scan kernel needs CUDA tensors")
    _check("flagged", flagged, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    if head is not None:
        _check("head", head, torch.int32, dev, 1)
        if head.numel() != halo:
            raise ValueError(f"lane_scan: head of {head.numel()}, not {halo}")
    if classes.numel() != 257 or hay.numel() != L * T or halo > T:
        raise ValueError("lane_scan: bad classes, layout or halo")
    if not 0 <= n <= L * T:
        raise ValueError(f"lane_scan: n={n} outside [0, {L * T}]")
    if flagged.shape[0] >= 1 << FLAG_SHIFT:
        raise ValueError(
            f"lane_scan: {flagged.shape[0]} states do not fit the flagged "
            f"table (below 2**{FLAG_SHIFT})"
        )
    if T % 16:
        raise ValueError(f"lane_scan: T={T} is not a multiple of 16")
    if S % 16 or T % S or S < halo or S < 16:
        raise ValueError(
            f"lane_scan: sub-lanes of {S} bytes do not fit T={T}, halo={halo}"
        )
    with device_guard(dev):
        states = torch.empty(L * T, dtype=torch.int32, device=dev)
        mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
        lib = build()["scan"]
        _raise_on(lib.ac_lane_scan(
            flagged.data_ptr(), flagged.shape[1], classes.data_ptr(),
            int(use_classes), hay.data_ptr(), n,
            None if head is None else head.data_ptr(), L, T, halo, S,
            carveout, states.data_ptr(), mask.data_ptr(),
            _stream(dev),
        ), "lane_scan")
    count_launch("lane_scan")
    if head is not None:
        count_launch("lane_scan_head")
    return states, mask


#: epochs a compaction scratch takes before it is cleared anew (the
#: status words keep 30 bits of it)
COMPACT_EPOCH_MAX = (1 << 30) - 1
#: the look-back scratch of K3 and K4 by (device index, stream): [uint64
#: buffer, epoch of its last launch]; kept across calls so that none
#: clears it
_COMPACT_SCRATCH: dict[tuple[int, int], list] = {}
_compact_lock = threading.Lock()


def _launch_with_lookback(dev: torch.device, nb: int, launch) -> int:
    """Call ``launch(scratch, epoch, stream)`` with the look-back scratch of
    this device and current stream, grown to ``1 + nb`` words (zeroed when
    it is made or grown), and a new epoch; return its error code.  The
    lock keeps the epochs in the launches' order."""
    stream = _stream(dev)
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           stream)
    with _compact_lock:
        entry = _COMPACT_SCRATCH.get(key)
        if (entry is None or entry[0].numel() < 1 + nb
                or entry[1] >= COMPACT_EPOCH_MAX):
            size = max(1 + nb, 1024,
                       2 * entry[0].numel() if entry is not None else 0)
            entry = _COMPACT_SCRATCH[key] = [
                torch.zeros(size, dtype=torch.int64, device=dev), 0
            ]
        entry[1] += 1
        return launch(entry[0].data_ptr(), entry[1], stream)


def compact(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: ascending indexes int32 [cap] (-1 padded) and total int32 [1],
    in one launch.

    The look-back scratch (a ticket counter and a status word a chunk) is
    kept per device and stream and zeroed only when it is made or grown;
    every call tags its status words with a new epoch, so an earlier
    call's words never read as ready."""
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError("compact kernel needs CUDA tensors")
    _check("mask", mask, torch.uint8, dev, 1)
    N = mask.numel()
    if N >= 1 << 31 or cap < 1:
        raise ValueError(f"compact: N={N}, cap={cap} out of range")
    with device_guard(dev):
        lib = build()["scan"]
        nb = -(-N // lib.ac_compact_chunk())
        idx = torch.empty(cap, dtype=torch.int32, device=dev)
        total = torch.empty(1, dtype=torch.int32, device=dev)
        err = _launch_with_lookback(dev, nb, lambda scratch, epoch, stream: (
            lib.ac_compact(mask.data_ptr(), N, cap, idx.data_ptr(),
                           total.data_ptr(), scratch, epoch, stream)
        ))
    _raise_on(err, "compact")
    count_launch("compact")
    return idx, total


def fire(
    packed: torch.Tensor, hay: torch.Tensor, m: int, words: int,
    passes: int, tile: Optional[int] = None,
) -> torch.Tensor:
    """K1: uint8 fire mask, the shape of ``hay``, over ``packed`` =
    :func:`pack_fire_tables` of the prefilter's tables; a block stages
    ``tile`` positions a step (default :data:`FIRE_TILE`; the mask is the
    same for every tile)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("fire kernel needs CUDA tensors")
    _check("packed", packed, torch.int32, dev)
    _check("hay", hay, torch.uint8, dev)
    rows = passes * 2 * m * words
    if rows > 256 or not 1 <= m <= 8 or not 1 <= words <= 8:
        raise ValueError(
            f"fire: m={m}, words={words}, passes={passes} need more than "
            f"256 rows, m > 8 or words > 8"
        )
    wp = 4 if words <= 4 else 8
    if packed.shape != (passes, m, 2, 16, wp) or packed.data_ptr() % 16:
        raise ValueError(
            f"fire: packed tables {tuple(packed.shape)} are not "
            f"{(passes, m, 2, 16, wp)} or not 16-byte aligned"
        )
    tile = FIRE_TILE if tile is None else tile
    if tile % FIRE_TILE_STEP or not FIRE_TILE_STEP <= tile <= FIRE_TILE_MAX:
        raise ValueError(
            f"fire: tile {tile} is not a multiple of {FIRE_TILE_STEP} in "
            f"[{FIRE_TILE_STEP}, {FIRE_TILE_MAX}]"
        )
    with device_guard(dev):
        out = torch.empty_like(hay)
        lib = build()["teddy"]
        _raise_on(lib.ac_fire(
            packed.data_ptr(), rows, hay.data_ptr(), hay.numel(), m, words,
            passes, tile, out.data_ptr(), _stream(dev),
        ), "fire")
    count_launch("fire", (m, words, passes))
    return out


#: mask bytes a Teddy group (the Teddy scan's ``COARSE``)
FIRE_GROUP = 32


def fire_groups(mask: torch.Tensor, n: int) -> torch.Tensor:
    """K9: uint8 ``[N / 32]``, 1 where a 32-byte group of K1's uint8 mask
    ``[N]`` holds a nonzero byte and starts below ``n`` (any int: a
    sharded rank passes ``n - offset``), else 0.  A mask view that is not
    16-byte aligned is read a byte at a time."""
    if mask.dtype != torch.uint8 or mask.dim() != 1:
        raise ValueError(
            f"fire_groups: mask is {mask.dtype} with {mask.dim()} dims, not "
            "uint8 [N]"
        )
    N = mask.numel()
    if N % FIRE_GROUP or not 0 < N < 1 << 31:
        raise ValueError(
            f"fire_groups: N={N} is not a positive multiple of {FIRE_GROUP} "
            "below 2**31"
        )
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError("fire_groups kernel needs CUDA tensors")
    _check("mask", mask, torch.uint8, dev, 1)
    with device_guard(dev):
        out = torch.empty(N // FIRE_GROUP, dtype=torch.uint8, device=dev)
        _raise_on(build()["groups"].ac_fire_groups(
            mask.data_ptr(), N, int(n), out.data_ptr(), _stream(dev),
        ), "fire_groups")
    count_launch("fire_groups")
    return out


#: most pieces :func:`plan_pieces` cuts a K4 window into
VERIFY_MAX_PIECES = 8


def verify_split(W: int, halo: int, k: int) -> tuple[int, int]:
    """K4's cut of a ``W``-step window into ``k`` pieces, as ``(L, D)``:
    piece 0 owns steps ``[0, L)``, piece ``p >= 1`` owns ``[L + (p-1)*D,
    L + p*D)`` clipped to ``W`` and walks from the root at ``halo`` steps
    before its first (never before step 0).  ``D = L - halo``, so every
    piece walks ``L`` steps: ``L`` is the least with ``k*L - (k-1)*halo
    >= W``."""
    L = -(-(W + (k - 1) * halo) // k)
    return L, L - halo


def verify_piece_bounds(
    W: int, halo: int, k: int
) -> list[tuple[int, int, int]]:
    """Each piece's ``(first step walked, first step owned, end)`` under
    :func:`verify_split`, as the kernel computes them."""
    L, D = verify_split(W, halo, k)
    out = []
    for p in range(k):
        lo = 0 if p == 0 else min(W, L + (p - 1) * D)
        out.append((max(0, lo - halo), lo, min(W, L + p * D)))
    return out


def plan_pieces(M: int, W: int, halo: int, sms: int) -> int:
    """K4's pieces a window for ``M`` windows: the least ``k`` whose
    ``M*k`` walks reach 7/8 of ``sms * SM_THREADS`` (as
    :func:`plan_sublanes` fills the card), at most
    :data:`VERIFY_MAX_PIECES`, and only while every piece owns a step and
    the pieces walk at most twice the window's steps in all (each piece
    past the first walks ``halo`` steps it does not own)."""
    best = 1
    for k in range(2, VERIFY_MAX_PIECES + 1):
        if M * (k - 1) * 8 >= 7 * sms * SM_THREADS:
            break
        L, D = verify_split(W, halo, k)
        if D < 1 or L + (k - 2) * D >= W or k * L > 2 * W:
            break
        best = k
    return best


def _verify_args(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, halo: Optional[int],
    pieces: Optional[int], name: str,
) -> tuple[int, int, int, int, int]:
    """Check K4's inputs; return ``(M, halo, k, L, D)``."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors")
    _check("vtable", vtable, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    _check("fire_pos", fire_pos, torch.int32, dev, 1)
    if classes.numel() != 257 or not 0 <= n <= hay.numel() or W < 1:
        raise ValueError(f"{name}: bad classes, n or W")
    M = fire_pos.numel()
    if M < 1 or M * W >= 1 << 31:
        raise ValueError(f"{name}: {M} windows of {W} steps out of range")
    if vtable.shape[0] >= 1 << FLAG_SHIFT:
        raise ValueError(
            f"{name}: {vtable.shape[0]} states do not fit the flagged table "
            f"(below 2**{FLAG_SHIFT})"
        )
    halo = W - 1 if halo is None else halo
    k = plan_pieces(M, W, halo, sm_count(dev)) if pieces is None else pieces
    if halo < 0 or not 1 <= k <= 64 or M * k >= 1 << 31:
        raise ValueError(f"{name}: halo={halo}, pieces={k} out of range")
    L, D = verify_split(W, halo, k)
    if k > 1 and D < 1:
        raise ValueError(f"{name}: {k} pieces of a {W}-step window need a "
                         f"halo below {W}, not {halo}")
    return M, halo, k, L, D


def verify(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, use_classes: bool,
    halo: Optional[int] = None, pieces: Optional[int] = None,
) -> torch.Tensor:
    """K4's walk alone: packed walk int32 [cap, W] (next state | has_match
    << 24), from the walk-only instantiation of :func:`verify_body`'s
    kernel.  ``halo`` (the automaton's ``max_len - 1``; by default ``W -
    1``, which any walk satisfies) and ``pieces`` (by default
    :func:`plan_pieces`) cut each window as :func:`verify_split` says; the
    walk does not depend on them."""
    dev = hay.device
    M, halo, k, L, D = _verify_args(
        vtable, classes, hay, fire_pos, n, W, halo, pieces, "verify"
    )
    with device_guard(dev):
        out = torch.empty((M, W), dtype=torch.int32, device=dev)
        lib = build()["verify"]
        _raise_on(lib.ac_verify(
            vtable.data_ptr(), vtable.shape[1], classes.data_ptr(),
            int(use_classes), hay.data_ptr(), hay.numel(), n,
            fire_pos.data_ptr(), M, W, halo, k, L, D, out.data_ptr(),
            _stream(dev),
        ), "verify")
    count_launch("verify")
    return out


def verify_body(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, cap2: int, use_classes: bool,
    halo: Optional[int] = None, pieces: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: the whole Teddy verify body in one launch.  Walks the ``W``-step
    window at each ``fire_pos`` (-1: an empty window) and returns the
    matched steps in ascending ``window*W + step`` order as ``(win, step,
    st)`` int32 [cap2] and their exact count ``total`` int32 [1]; entries
    past ``min(total, cap2)`` hold ``(-1, 0, packed[0] & 0xFFFFFF)``, as
    ``ops/scan_teddy.py`` ``_verify_body`` gives them.  ``halo`` and
    ``pieces`` as :func:`verify`; the outputs do not depend on them as
    long as ``halo`` is at least the automaton's ``max_len - 1``.  The
    look-back scratch and its epochs are K3's (:func:`compact`)."""
    dev = hay.device
    M, halo, k, L, D = _verify_args(
        vtable, classes, hay, fire_pos, n, W, halo, pieces, "verify_body"
    )
    if cap2 < 1:
        raise ValueError(f"verify_body: cap2={cap2} < 1")
    with device_guard(dev):
        lib = build()["verify"]
        out = torch.empty(3 * cap2 + 1, dtype=torch.int32, device=dev)
        win, step, st, total = out.split((cap2, cap2, cap2, 1))
        nb = lib.ac_verify_blocks(M, k)
        err = _launch_with_lookback(dev, nb, lambda scratch, epoch, stream: (
            lib.ac_verify_body(
                vtable.data_ptr(), vtable.shape[1], classes.data_ptr(),
                int(use_classes), hay.data_ptr(), hay.numel(), n,
                fire_pos.data_ptr(), M, W, halo, k, L, D, cap2,
                win.data_ptr(), step.data_ptr(), st.data_ptr(),
                total.data_ptr(), scratch, epoch, stream,
            )
        ))
    _raise_on(err, "verify_body")
    count_launch("verify")
    return win, step, st, total


def stride2_scan(
    packed2: torch.Tensor, table_classed: torch.Tensor, classes: torch.Tensor,
    hay: torch.Tensor, n: int, L: int, T: int, halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: states int32 [L*T] and match mask uint8 [L*T] of a uint8
    haystack of ``L*T`` bytes (the first ``n`` real) walked as ``L`` lanes
    of ``T`` bytes, two bytes a step through ``packed2`` (int32 ``[states,
    C*C]``); ``table_classed`` (int32 ``[states, C]``) gives the mid-pair
    state at a matched first byte.  ``T`` and ``halo`` are even.

    ``states`` holds the state only where ``mask`` is 1, as K2's does.
    The kernel walks sub-lanes of :func:`plan_sublanes` bytes.
    """
    if hay.device.type != "cuda":
        raise ValueError("stride2_scan kernel needs CUDA tensors")
    S = plan_sublanes(L, T, halo, sm_count(hay.device))
    return _stride2_scan_at(
        S, packed2, table_classed, classes, hay, n, L, T, halo
    )


def _stride2_scan_at(
    S: int, packed2: torch.Tensor, table_classed: torch.Tensor,
    classes: torch.Tensor, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int, carveout: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`stride2_scan` with sub-lanes of ``S`` bytes (``S`` = ``T``
    walks each lane in one thread) and the kernel's shared-memory
    ``carveout`` (as :func:`_lane_scan_at`)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("stride2_scan kernel needs CUDA tensors")
    _check("packed2", packed2, torch.int32, dev, 2)
    _check("table_classed", table_classed, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    C = table_classed.shape[1]
    if (packed2.shape != (table_classed.shape[0], C * C)
            or classes.numel() != 257):
        raise ValueError(
            "stride2_scan: packed2 is not [states, C*C] of table_classed "
            "[states, C], or bad classes"
        )
    if hay.numel() != L * T or halo > T or T % 16 or halo % 2:
        raise ValueError(
            "stride2_scan: bad layout, T not a multiple of 16 or odd halo"
        )
    if not 0 <= n <= L * T:
        raise ValueError(f"stride2_scan: n={n} outside [0, {L * T}]")
    if S % 16 or T % S or S < halo or S < 16:
        raise ValueError(
            f"stride2_scan: sub-lanes of {S} bytes do not fit T={T}, "
            f"halo={halo}"
        )
    with device_guard(dev):
        states = torch.empty(L * T, dtype=torch.int32, device=dev)
        mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
        lib = build()["stride2"]
        _raise_on(lib.ac_stride2_scan(
            packed2.data_ptr(), table_classed.data_ptr(), C,
            classes.data_ptr(), hay.data_ptr(), n, L, T, halo, S, carveout,
            states.data_ptr(), mask.data_ptr(), _stream(dev),
        ), "stride2_scan")
    count_launch("stride2_scan")
    return states, mask


class SparseTables(NamedTuple):
    """K7's tables, derived from the sparse automaton by
    :func:`sparse_tables`: O(S + E) bytes, no dense row."""

    #: int32 [S, 4]: edge start, edge count, fail link, has-match flag
    records: torch.Tensor
    #: uint8 [E + 32]: each edge's byte, in key order; 32 zero bytes after
    #: them, so a 16-byte window past a state's run stays inside
    labels: torch.Tensor
    #: int32 [E]: each edge's target, in key order
    targets: torch.Tensor
    #: int32 [257]: the root's next state on each byte (PAD: the root)
    root_next: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def sparse_tables(
    keys: torch.Tensor, targets: torch.Tensor, fail: torch.Tensor,
    match_count: torch.Tensor,
) -> SparseTables:
    """K7's tables from the sorted int64 edge keys ``state*257 + byte``,
    their int32 targets, the int32 fail links and the match counts (one
    per state), on their device.  State ``s``'s edges are
    ``keys[start:start + count]`` with ``start`` the keys' ``searchsorted``
    of ``s*257``."""
    S, E = fail.numel(), keys.numel()
    if match_count.numel() != S or targets.numel() != E:
        raise ValueError("sparse_tables: keys/targets or fail/match_count "
                         "differ in length")
    if E + 32 >= 1 << 31:
        raise ValueError(f"sparse_tables: {E} edges do not fit int32")
    dev = keys.device
    bounds = torch.searchsorted(
        keys, torch.arange(S + 1, dtype=torch.int64, device=dev) * 257
    )
    start, count = bounds[:-1], bounds[1:] - bounds[:-1]
    label = keys % 257
    if E and (int(bounds[-1]) != E or int(label.max()) > 255):
        raise ValueError("sparse_tables: an edge leaves a state past the "
                         "last, or is labelled PAD")
    records = torch.stack(
        [start, count, fail.long(), (match_count > 0).long()], dim=1
    ).to(torch.int32)
    labels = torch.zeros(E + 32, dtype=torch.uint8, device=dev)
    labels[:E] = label.to(torch.uint8)
    root_next = torch.zeros(257, dtype=torch.int32, device=dev)
    root_edges = int(count[0]) if S else 0
    root_next[label[:root_edges]] = targets[:root_edges].to(torch.int32)
    return SparseTables(records, labels, targets.to(torch.int32).contiguous(),
                        root_next)


def sparse_scan(
    tabs: SparseTables, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: states int32 [L*T] and match mask uint8 [L*T] of a uint8
    haystack of ``L*T`` bytes (the first ``n`` real) walked as ``L`` lanes
    of ``T`` bytes over :func:`sparse_tables`' tables.

    K2's contract: ``states`` holds the state only where ``mask`` is 1.
    The kernel walks sub-lanes of :func:`plan_sublanes` bytes for this
    card; the outputs do not depend on their length.
    """
    if hay.device.type != "cuda":
        raise ValueError("sparse_scan kernel needs CUDA tensors")
    S = plan_sublanes(L, T, halo, sm_count(hay.device))
    return _sparse_scan_at(S, tabs, hay, n, L, T, halo)


def _sparse_scan_at(
    S: int, tabs: SparseTables, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int, carveout: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sparse_scan` with sub-lanes of ``S`` bytes (``S`` = ``T``
    walks each lane in one thread) and the kernel's shared-memory
    ``carveout`` (as :func:`_lane_scan_at`)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("sparse_scan kernel needs CUDA tensors")
    _check("records", tabs.records, torch.int32, dev, 2)
    _check("labels", tabs.labels, torch.uint8, dev, 1)
    _check("targets", tabs.targets, torch.int32, dev, 1)
    _check("root_next", tabs.root_next, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    if (tabs.records.shape[1] != 4 or tabs.root_next.numel() != 257
            or tabs.labels.numel() != tabs.targets.numel() + 32
            or tabs.labels.data_ptr() % 16 or tabs.records.data_ptr() % 16):
        raise ValueError("sparse_scan: tables not as sparse_tables makes them")
    if hay.numel() != L * T or halo > T or not 0 <= n <= L * T:
        raise ValueError("sparse_scan: bad layout, halo or n")
    if T % 16 or S % 16 or T % S or S < halo or S < 16:
        raise ValueError(
            f"sparse_scan: sub-lanes of {S} bytes do not fit T={T}, "
            f"halo={halo}"
        )
    with device_guard(dev):
        states = torch.empty(L * T, dtype=torch.int32, device=dev)
        mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
        lib = build()["sparse"]
        _raise_on(lib.ac_sparse_scan(
            tabs.records.data_ptr(), tabs.labels.data_ptr(),
            tabs.targets.data_ptr(), tabs.root_next.data_ptr(),
            hay.data_ptr(), n, L, T, halo, S, carveout, states.data_ptr(),
            mask.data_ptr(), _stream(dev),
        ), "sparse_scan")
    count_launch("sparse_scan")
    return states, mask


def batch_sublanes(B: int, T: int, halo: int, sms: int) -> int:
    """K5's sub-lane length for ``B`` rows of ``T`` bytes: K2's plan with
    the warm-up a sub-lane can need inside its row (at most ``T``), so a
    halo of ``T`` or more leaves whole rows."""
    return plan_sublanes(B, T, min(halo, T), sms)


def batch_scan(
    flagged: torch.Tensor, classes: torch.Tensor, hay2d: torch.Tensor,
    lens: torch.Tensor, halo: int, use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: states int32 [B*T] and match mask uint8 [B*T] of a uint8
    [B, T] document buffer whose row b holds lens[b] real bytes; every
    row starts at the root and reads PAD from lens[b] on.

    ``flagged`` is :func:`flag_table` of the automaton's table and
    ``halo`` its ``max_len - 1``.  ``states`` holds the state only where
    ``mask`` is 1.  The kernel walks sub-lanes of :func:`batch_sublanes`
    bytes, each warmed inside its row; the outputs do not depend on their
    length.
    """
    if hay2d.device.type != "cuda":
        raise ValueError("batch_scan kernel needs CUDA tensors")
    B, T = hay2d.shape
    S = batch_sublanes(B, T, halo, sm_count(hay2d.device))
    return _batch_scan_at(S, flagged, classes, hay2d, lens, halo, use_classes)


def _batch_scan_at(
    S: int, flagged: torch.Tensor, classes: torch.Tensor,
    hay2d: torch.Tensor, lens: torch.Tensor, halo: int, use_classes: bool,
    carveout: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`batch_scan` with sub-lanes of ``S`` bytes (``S`` = ``T``
    walks each row in one thread) and the kernel's shared-memory
    ``carveout`` (as :func:`_lane_scan_at`)."""
    dev = hay2d.device
    if dev.type != "cuda":
        raise ValueError("batch_scan kernel needs CUDA tensors")
    _check("flagged", flagged, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay2d", hay2d, torch.uint8, dev, 2)
    _check("lens", lens, torch.int32, dev, 1)
    B, T = hay2d.shape
    if classes.numel() != 257 or lens.numel() != B or B * T >= 1 << 31:
        raise ValueError("batch_scan: bad classes, lens or layout")
    if flagged.shape[0] >= 1 << FLAG_SHIFT:
        raise ValueError(
            f"batch_scan: {flagged.shape[0]} states do not fit the flagged "
            f"table (below 2**{FLAG_SHIFT})"
        )
    if T % 16 or halo < 0:
        raise ValueError(f"batch_scan: T={T} is not a multiple of 16, or "
                         f"halo={halo} < 0")
    if S % 16 or T % S or S < min(halo, T - S) or S < 16:
        raise ValueError(
            f"batch_scan: sub-lanes of {S} bytes do not fit T={T}, "
            f"halo={halo}"
        )
    with device_guard(dev):
        states = torch.empty(B * T, dtype=torch.int32, device=dev)
        mask = torch.empty(B * T, dtype=torch.uint8, device=dev)
        lib = build()["batch"]
        _raise_on(lib.ac_batch_scan(
            flagged.data_ptr(), flagged.shape[1], classes.data_ptr(),
            int(use_classes), hay2d.data_ptr(), lens.data_ptr(), B, T, halo,
            S, carveout, states.data_ptr(), mask.data_ptr(),
            _stream(dev),
        ), "batch_scan")
    count_launch("batch_scan")
    return states, mask


def _probe_args(name: str, x: torch.Tensor) -> int:
    """Check a layout probe's input; return its row count."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors")
    _check("x", x, torch.uint8, dev, 2)
    rows = x.shape[0]
    if x.shape[1] != 128 or rows % PROBE_BLOCK_ROWS:
        raise ValueError(
            f"{name}: x is {list(x.shape)}, not [a multiple of "
            f"{PROBE_BLOCK_ROWS}, 128]"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")
    return rows


def probe_reduce(x: torch.Tensor) -> torch.Tensor:
    """P1: uint8 [R/16, 128], the max over each group of 16 rows of a
    uint8 [R, 128] array (R a multiple of 1024)."""
    rows = _probe_args("probe_reduce", x)
    with device_guard(x.device):
        out = torch.empty((rows // 16, 128), dtype=torch.uint8,
                          device=x.device)
        _raise_on(build()["probe"].ac_probe_reduce(
            x.data_ptr(), rows, out.data_ptr(), _stream(x.device),
        ), "probe_reduce")
    count_launch("probe_reduce")
    return out


def probe_rollrows(x: torch.Tensor) -> torch.Tensor:
    """P2: each row of a uint8 [R, 128] array ANDed with the next row of
    its 1024-row block (wrapping inside the block)."""
    rows = _probe_args("probe_rollrows", x)
    with device_guard(x.device):
        out = torch.empty_like(x)
        _raise_on(build()["probe"].ac_probe_rollrows(
            x.data_ptr(), rows, out.data_ptr(), _stream(x.device),
        ), "probe_rollrows")
    count_launch("probe_rollrows")
    return out
