"""Layout probes (P1, P2) and the fire kernel's tile sweep, on the card.

The counterpart of the JAX package's ``tools/probe_transpose_kernel.py``.
It answers, on the card, what a transposed fire layout would cost and
whether a larger fire-kernel block pays:

1. P1, the max over each group of 16 rows of a uint8 ``[R, 128]`` array
   (the COARSE reduction of a transposed layout), and P2, each row ANDed
   with the next row of its 1024-row block (its fingerprint shift), at the
   reference's 32 blocks (4 MiB) and at K1's main-path layout
   (``[524288, 128]``, 64 MiB); each checked bit-equal to its plain
   PyTorch version and timed;
2. the time of a 64 MiB uint8 transpose ``[nb, 128, 2048] -> [nb*2048,
   128]`` (an XLA transpose in the JAX package, ``torch``'s own copy here);
3. K1 (the Teddy fire mask) at each tile of :data:`SWEEP_TILES` on a
   64 MiB names corpus: every tile's mask must equal the default tile's.

Run from the repository root:

    python -m ahocorasick_rs_tpu_torch.tools.probe_transpose_kernel [--device cpu] [--mib 64]

It runs on the card unless ``--device cpu`` is given, and raises without a
card otherwise.  A wrong bit or a failed launch raises; nothing is caught.
Times are CUDA-event means on the card and host-clock times on the CPU
(which say nothing of the card).  It prints one JSON line for the probes
and one for the sweep.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import _kernels
from ..api import _resolve_device
from ..models.automaton import build_automaton
from ..models.prefilter import build_prefilter
from ..ops import probe, scan_cuda, scan_teddy
from ._synth import synth_corpus, synth_names

#: the reference's block count for P1 and P2 (4 MiB at 1024 rows a block)
NBLK = 32
#: K1's tiles swept: positions a block stages (the default is 4096)
SWEEP_TILES = (2048, 4096, 8192, 16384, 32768, 65536)
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: rows per block of the transpose (the reference's ``Rb``)
TRANSPOSE_ROWS = 2048


def time_ms(fn: Callable[[], object], dev: torch.device, reps: int) -> float:
    """Mean ms of ``fn``: CUDA events on the card after one warm-up call,
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    the CPU's label."""
    if dev.type != "cuda":
        return "cpu (host clock)"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def probe_layout(x: torch.Tensor, reps: int) -> dict:
    """P1 and P2 on ``x`` (uint8 ``[R, 128]``), each checked bit-equal to
    its plain version and timed; bounds count each input byte read and
    each output byte written once."""
    dev = x.device
    rows = x.shape[0]
    out = {}
    for key, fn, plain, out_rows in (
        ("reduce", probe.reduce16, probe._reduce16_plain, rows // 16),
        ("rollrows", probe.rollrows, probe._rollrows_plain, rows),
    ):
        if not torch.equal(fn(x), plain(x)):
            raise AssertionError(
                f"{key} at {rows} rows differs from its plain version"
            )
        out[key] = {
            "rows": rows,
            "ms": time_ms(lambda: fn(x), dev, reps),
            "bound_ms": (rows + out_rows) * 128 / HBM_BYTES_PER_S * 1e3,
        }
    return out


def main(
    device: Union[str, torch.device, None] = None, mib: int = 64,
    reps: int = 20,
) -> dict:
    """The layout probes at 4 MiB and at ``mib`` MiB, and the transpose."""
    dev = _resolve_device(device)
    rng = np.random.default_rng(0)
    report: dict = {"device": device_label(dev), "probes": {}}
    for rows in (NBLK * probe.BLOCK_ROWS, (mib << 20) // 128):
        x = torch.from_numpy(
            rng.integers(0, 256, (rows, 128), dtype=np.uint8)
        ).to(dev)
        report["probes"][f"{rows * 128 >> 20}MiB"] = probe_layout(x, reps)
    nb = (mib << 20) // (TRANSPOSE_ROWS * 128)
    h = torch.from_numpy(
        rng.integers(0, 256, (nb, 128, TRANSPOSE_ROWS), dtype=np.uint8)
    ).to(dev)

    def transpose() -> torch.Tensor:
        return h.transpose(1, 2).contiguous().view(nb * TRANSPOSE_ROWS, 128)

    t = transpose()
    if not torch.equal(t[:TRANSPOSE_ROWS], h[0].T):
        raise AssertionError("the transpose put bytes in the wrong place")
    report["transpose"] = {
        "shape": [nb, 128, TRANSPOSE_ROWS],
        "ms": time_ms(transpose, dev, reps),
        "bound_ms": 2 * h.numel() / HBM_BYTES_PER_S * 1e3,
    }
    return report


def fire_tile_sweep(
    device: Union[str, torch.device, None] = None, mib: int = 64,
    reps: int = 10, tiles: tuple[int, ...] = SWEEP_TILES,
) -> dict:
    """K1 at each tile on a ``mib`` MiB names corpus (1,000 names, seed
    1234): fires and ms per tile; every tile's mask must equal the default
    tile's."""
    dev = _resolve_device(device)
    rng = np.random.default_rng(1234)
    names = synth_names(1000, rng)
    am = build_automaton(names)
    pf = build_prefilter(names)
    corpus = synth_corpus(mib << 20, names, rng)
    tables = scan_cuda.DeviceTables(am, "dfa", dev)
    sc = scan_teddy.TeddyScanner(
        am, pf, tables.table, tables.classes, tables.match_count,
        tables.use_classes,
    )
    h2 = sc.stage(corpus)

    def fire(tile: Optional[int]) -> torch.Tensor:
        return scan_teddy.fire_mask(
            sc.tables, h2, sc.m, sc.words, sc.passes, tile
        )

    want = fire(_kernels.FIRE_TILE)
    report: dict = {
        "device": device_label(dev),
        "shape": f"hay uint8 {list(h2.shape)}, m={sc.m} words={sc.words} "
                 f"passes={sc.passes}",
        "default_tile": _kernels.FIRE_TILE, "tiles": {},
    }
    for tile in tiles:
        got = fire(tile)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 at tile {tile} differs from the default tile's mask"
            )
        report["tiles"][tile] = {
            "fires": int(got.sum(dtype=torch.int64)),
            "ms": time_ms(lambda: fire(tile), dev, reps),
        }
    return report


def _cli(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--mib", type=int, default=64,
                   help="size of the large layout and the sweep's corpus")
    a = p.parse_args(argv)
    print(json.dumps({"probe": main(a.device, a.mib)}), flush=True)
    print(json.dumps({"fire_tile_sweep": fire_tile_sweep(a.device, a.mib)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
