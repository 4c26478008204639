"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source under ``csrc/`` is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, for
``sm_90a``.  The libraries land in ``_build/<hash of the sources>/``, so a
changed source rebuilds and an unchanged one loads at once.  ``ctypes``
binds them, with ``c_void_p`` for every pointer and for the stream.

The launchers below check device, dtype, shape and contiguity, allocate
every output and scratch buffer with ``torch.empty``, launch on the
current stream and raise if the entry point reports a CUDA error.  Each
adds one to its entry in :data:`LAUNCHES`, and nothing else does, so a run
can show which kernels a path went through.  Nothing here is imported or
built until a CUDA tensor reaches a launcher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
SOURCES = (
    "scan.cu", "teddy.cu", "stride2.cu", "sparse.cu", "batch.cu", "probe.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last :func:`reset_launches`;
#: ``lane_scan_head`` counts the K2 launches that carry a neighbour's head
#: (also counted under ``lane_scan``), ``shard_body`` the per-rank bodies
#: of the sharded scan (K8) that ran on a card, ``probe_*`` the layout
#: probes P1 and P2
LAUNCHES: dict[str, int] = {
    "fire": 0, "lane_scan": 0, "lane_scan_head": 0, "compact": 0,
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
    "ac_lane_scan": [_P, _I32, _P, _I32, _P, _I64, _P, _P, _I32, _I32, _I32,
                     _P, _P, _P],
    "ac_compact": [_P, _I64, _I32, _P, _P, _P, _P, _P],
    "ac_compact_chunk": [],
    "ac_fire": [_P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _P, _P],
    "ac_verify": [_P, _I32, _P, _I32, _P, _I64, _P, _I32, _I32, _P, _P],
    "ac_stride2_scan": [_P, _I32, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P,
                        _P],
    "ac_sparse_scan": [_P, _I64, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P,
                       _P, _P],
    "ac_batch_scan": [_P, _I32, _P, _I32, _P, _P, _P, _I32, _I32, _P, _P, _P],
    "ac_probe_reduce": [_P, _I64, _P, _P],
    "ac_probe_rollrows": [_P, _I64, _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FIRE_CONFIGS.clear()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library."""
    global _libs, BUILD_SECONDS
    with _lock:
        if _libs is not None:
            return _libs
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            with open(os.path.join(_CSRC, src), "rb") as f:
                h.update(src.encode() + f.read())
        out_dir = os.path.join(_BUILD, h.hexdigest()[:16])
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


def lane_scan(
    table: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    match_count: torch.Tensor, n: int, L: int, T: int, halo: int,
    use_classes: bool, head: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: states int32 [L*T] and match mask uint8 [L*T]; ``head`` (int32
    [halo], values 0-256) is read in place of PAD before position 0."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("lane_scan kernel needs CUDA tensors")
    _check("table", table, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    _check("match_count", match_count, torch.int32, dev, 1)
    if head is not None:
        _check("head", head, torch.int32, dev, 1)
        if head.numel() != halo:
            raise ValueError(f"lane_scan: head of {head.numel()}, not {halo}")
    if classes.numel() != 257 or hay.numel() != L * T or halo > T:
        raise ValueError("lane_scan: bad classes, layout or halo")
    if not 0 <= n <= L * T:
        raise ValueError(f"lane_scan: n={n} outside [0, {L * T}]")
    states = torch.empty(L * T, dtype=torch.int32, device=dev)
    mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
    lib = build()["scan"]
    _raise_on(lib.ac_lane_scan(
        table.data_ptr(), table.shape[1], classes.data_ptr(),
        int(use_classes), hay.data_ptr(), n,
        None if head is None else head.data_ptr(), match_count.data_ptr(),
        L, T, halo, states.data_ptr(), mask.data_ptr(), _stream(dev),
    ), "lane_scan")
    LAUNCHES["lane_scan"] += 1
    if head is not None:
        LAUNCHES["lane_scan_head"] += 1
    return states, mask


def compact(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: ascending indexes int32 [cap] (-1 padded) and total int32 [1]."""
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError("compact kernel needs CUDA tensors")
    _check("mask", mask, torch.uint8, dev, 1)
    N = mask.numel()
    if N >= 1 << 31 or cap < 1:
        raise ValueError(f"compact: N={N}, cap={cap} out of range")
    lib = build()["scan"]
    nb = -(-N // lib.ac_compact_chunk())
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * max(nb, 1), dtype=torch.int32, device=dev)
    _raise_on(lib.ac_compact(
        mask.data_ptr(), N, cap, idx.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), scratch[max(nb, 1):].data_ptr(), _stream(dev),
    ), "compact")
    LAUNCHES["compact"] += 1
    return idx, total


def fire(
    tables: torch.Tensor, hay: torch.Tensor, m: int, words: int,
    passes: int, tile: Optional[int] = None,
) -> torch.Tensor:
    """K1: uint8 fire mask, the shape of ``hay``; a block stages ``tile``
    positions (default :data:`FIRE_TILE`; the mask is the same for every
    tile)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("fire kernel needs CUDA tensors")
    _check("tables", tables, torch.int32, dev, 2)
    _check("hay", hay, torch.uint8, dev)
    rows = passes * 2 * m * words
    if tables.shape != (rows, 128) or rows > 256 or not 1 <= m <= 8:
        raise ValueError(
            f"fire: tables {tuple(tables.shape)} do not fit m={m}, "
            f"words={words}, passes={passes} (at most 256 rows, m <= 8)"
        )
    tile = FIRE_TILE if tile is None else tile
    if tile % FIRE_TILE_STEP or not FIRE_TILE_STEP <= tile <= FIRE_TILE_MAX:
        raise ValueError(
            f"fire: tile {tile} is not a multiple of {FIRE_TILE_STEP} in "
            f"[{FIRE_TILE_STEP}, {FIRE_TILE_MAX}]"
        )
    out = torch.empty_like(hay)
    lib = build()["teddy"]
    _raise_on(lib.ac_fire(
        tables.data_ptr(), rows, hay.data_ptr(), hay.numel(), m, words,
        passes, tile, out.data_ptr(), _stream(dev),
    ), "fire")
    LAUNCHES["fire"] += 1
    key = (m, words, passes)
    FIRE_CONFIGS[key] = FIRE_CONFIGS.get(key, 0) + 1
    return out


def verify(
    vtable: torch.Tensor, classes: torch.Tensor, hay: torch.Tensor,
    fire_pos: torch.Tensor, n: int, W: int, use_classes: bool,
) -> torch.Tensor:
    """K4: packed walk int32 [cap, W] (next state | has_match << 24)."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("verify kernel needs CUDA tensors")
    _check("vtable", vtable, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    _check("fire_pos", fire_pos, torch.int32, dev, 1)
    if classes.numel() != 257 or not 0 <= n <= hay.numel() or W < 1:
        raise ValueError("verify: bad classes, n or W")
    cap = fire_pos.numel()
    out = torch.empty((cap, W), dtype=torch.int32, device=dev)
    lib = build()["teddy"]
    _raise_on(lib.ac_verify(
        vtable.data_ptr(), vtable.shape[1], classes.data_ptr(),
        int(use_classes), hay.data_ptr(), n, fire_pos.data_ptr(), cap, W,
        out.data_ptr(), _stream(dev),
    ), "verify")
    LAUNCHES["verify"] += 1
    return out


def stride2_scan(
    packed2: torch.Tensor, C: int, classes: torch.Tensor, hay: torch.Tensor,
    n: int, L: int, T: int, halo: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: pair end states int32 [L*T/2], after-halo states int32 [L] and
    match mask uint8 [L*T]."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("stride2_scan kernel needs CUDA tensors")
    _check("packed2", packed2, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    if packed2.shape[1] != C * C or classes.numel() != 257:
        raise ValueError("stride2_scan: packed2 is not [S, C*C] or bad classes")
    if hay.numel() != L * T or halo > T or T % 2 or halo % 2:
        raise ValueError("stride2_scan: bad layout, or T or halo is odd")
    if not 0 <= n <= L * T:
        raise ValueError(f"stride2_scan: n={n} outside [0, {L * T}]")
    ends = torch.empty(L * T // 2, dtype=torch.int32, device=dev)
    after_halo = torch.empty(L, dtype=torch.int32, device=dev)
    mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
    lib = build()["stride2"]
    _raise_on(lib.ac_stride2_scan(
        packed2.data_ptr(), C, classes.data_ptr(), hay.data_ptr(), n, L, T,
        halo, ends.data_ptr(), after_halo.data_ptr(), mask.data_ptr(),
        _stream(dev),
    ), "stride2_scan")
    LAUNCHES["stride2_scan"] += 1
    return ends, after_halo, mask


def sparse_scan(
    keys: torch.Tensor, targets: torch.Tensor, fail: torch.Tensor,
    match_count: torch.Tensor, hay: torch.Tensor, n: int, L: int, T: int,
    halo: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: states int32 [L*T] and match mask uint8 [L*T]."""
    dev = hay.device
    if dev.type != "cuda":
        raise ValueError("sparse_scan kernel needs CUDA tensors")
    _check("keys", keys, torch.int64, dev, 1)
    _check("targets", targets, torch.int32, dev, 1)
    _check("fail", fail, torch.int32, dev, 1)
    _check("match_count", match_count, torch.int32, dev, 1)
    _check("hay", hay, torch.uint8, dev, 1)
    if targets.numel() != keys.numel() or fail.numel() != match_count.numel():
        raise ValueError("sparse_scan: keys/targets or fail/match_count differ")
    if hay.numel() != L * T or halo > T or not 0 <= n <= L * T:
        raise ValueError("sparse_scan: bad layout, halo or n")
    states = torch.empty(L * T, dtype=torch.int32, device=dev)
    mask = torch.empty(L * T, dtype=torch.uint8, device=dev)
    lib = build()["sparse"]
    _raise_on(lib.ac_sparse_scan(
        keys.data_ptr(), keys.numel(), targets.data_ptr(), fail.data_ptr(),
        match_count.data_ptr(), hay.data_ptr(), n, L, T, halo,
        states.data_ptr(), mask.data_ptr(), _stream(dev),
    ), "sparse_scan")
    LAUNCHES["sparse_scan"] += 1
    return states, mask


def batch_scan(
    table: torch.Tensor, classes: torch.Tensor, hay2d: torch.Tensor,
    lens: torch.Tensor, match_count: torch.Tensor, use_classes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: states int32 [B*T] and match mask uint8 [B*T] of a uint8
    [B, T] document buffer whose row b holds lens[b] real bytes."""
    dev = hay2d.device
    if dev.type != "cuda":
        raise ValueError("batch_scan kernel needs CUDA tensors")
    _check("table", table, torch.int32, dev, 2)
    _check("classes", classes, torch.int32, dev, 1)
    _check("hay2d", hay2d, torch.uint8, dev, 2)
    _check("lens", lens, torch.int32, dev, 1)
    _check("match_count", match_count, torch.int32, dev, 1)
    B, T = hay2d.shape
    if classes.numel() != 257 or lens.numel() != B or B * T >= 1 << 31:
        raise ValueError("batch_scan: bad classes, lens or layout")
    states = torch.empty(B * T, dtype=torch.int32, device=dev)
    mask = torch.empty(B * T, dtype=torch.uint8, device=dev)
    lib = build()["batch"]
    _raise_on(lib.ac_batch_scan(
        table.data_ptr(), table.shape[1], classes.data_ptr(),
        int(use_classes), hay2d.data_ptr(), lens.data_ptr(),
        match_count.data_ptr(), B, T, states.data_ptr(), mask.data_ptr(),
        _stream(dev),
    ), "batch_scan")
    LAUNCHES["batch_scan"] += 1
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
    out = torch.empty((rows // 16, 128), dtype=torch.uint8, device=x.device)
    _raise_on(build()["probe"].ac_probe_reduce(
        x.data_ptr(), rows, out.data_ptr(), _stream(x.device),
    ), "probe_reduce")
    LAUNCHES["probe_reduce"] += 1
    return out


def probe_rollrows(x: torch.Tensor) -> torch.Tensor:
    """P2: each row of a uint8 [R, 128] array ANDed with the next row of
    its 1024-row block (wrapping inside the block)."""
    rows = _probe_args("probe_rollrows", x)
    out = torch.empty_like(x)
    _raise_on(build()["probe"].ac_probe_rollrows(
        x.data_ptr(), rows, out.data_ptr(), _stream(x.device),
    ), "probe_rollrows")
    LAUNCHES["probe_rollrows"] += 1
    return out
