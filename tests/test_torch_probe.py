"""PyTorch port, layout probes: P1 (``reduce16``) and P2 (``rollrows``) on
the CPU equal the JAX package's Pallas probes ``k_reduce`` and
``k_rollrows`` (``tools/probe_transpose_kernel.py``), run in interpret mode
with the reference's grid and block specs, bit for bit.  The port's probe
tool runs end to end on the CPU at a cut size, and the fire mask is the
same for every tile of its sweep.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ahocorasick_rs_tpu.utils.cache
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.models.prefilter import build_prefilter_config
from ahocorasick_rs_tpu_torch.ops import probe, scan_teddy
from ahocorasick_rs_tpu_torch.tools import probe_transpose_kernel as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = probe.BLOCK_ROWS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_tool():
    """The reference's probe module, loaded from its file (``tools/`` is
    not a package) with its persistent-cache hook switched off, so that
    importing it does not repoint JAX's cache for the whole worker."""
    path = os.path.join(ROOT, "tools", "probe_transpose_kernel.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ahocorasick_rs_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location("_ref_probe_tool", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert mod.R == R
    return mod


def _ref_call(kernel, x: np.ndarray, out_rows: int) -> np.ndarray:
    """A reference probe kernel through ``pl.pallas_call`` in interpret
    mode, with the reference's grid and block specs."""
    nblk = x.shape[0] // R
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(nblk,),
        in_specs=[pl.BlockSpec((R, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((out_rows // nblk, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((out_rows, 128), jnp.uint8),
        interpret=True,
    )(jnp.asarray(x)))


def _bytes(nblk: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (nblk * R, 128), dtype=np.uint8
    )


@pytest.mark.parametrize("nblk", [1, 2, 4])
def test_reduce16_equals_reference(ref_tool, nblk: int) -> None:
    x = _bytes(nblk, nblk)
    want = _ref_call(ref_tool.k_reduce, x, nblk * R // 16)
    got = probe.reduce16(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x.reshape(-1, 16, 128).max(axis=1))


@pytest.mark.parametrize("nblk", [1, 2, 4])
def test_rollrows_equals_reference(ref_tool, nblk: int) -> None:
    x = _bytes(nblk, 10 + nblk)
    want = _ref_call(ref_tool.k_rollrows, x, nblk * R)
    got = probe.rollrows(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    xb = x.reshape(nblk, R, 128)
    np.testing.assert_array_equal(
        want, (xb & np.roll(xb, -1, axis=1)).reshape(-1, 128)
    )


def test_probe_kernels_refuse_cpu_tensors() -> None:
    """The launchers take CUDA tensors only; the dispatchers send CPU
    tensors to the plain versions."""
    x = torch.zeros((R, 128), dtype=torch.uint8)
    for launcher in (_kernels.probe_reduce, _kernels.probe_rollrows):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            launcher(x)
    assert torch.equal(probe.reduce16(x), probe._reduce16_plain(x))
    assert torch.equal(probe.rollrows(x), probe._rollrows_plain(x))


@pytest.mark.parametrize(
    "config", [(6, 4, 2), (3, 1, 1), (8, 8, 2)], ids=str
)
def test_fire_mask_same_for_every_tile(config) -> None:
    m, words, passes = config
    rng = np.random.default_rng(sum(config))
    names = [bytes(rng.integers(97, 105, int(rng.integers(m, 12))))
             for _ in range(60)]
    pf = build_prefilter_config(names, m, words, passes)
    hay = rng.integers(97, 106, 100_000, dtype=np.uint8)
    hay[1000 : 1000 + len(names[0])] = np.frombuffer(names[0], np.uint8)
    hay2d = scan_teddy.TeddyScanner.stage(
        type("S", (), {"device": torch.device("cpu")})(), hay
    )
    tables = torch.from_numpy(pf.tables)
    want = scan_teddy.fire_mask(tables, hay2d, m, words, passes)
    assert int(want.sum()) > 0
    for tile in tool.SWEEP_TILES:
        got = scan_teddy.fire_mask(tables, hay2d, m, words, passes, tile)
        assert torch.equal(got, want)
    assert _kernels.FIRE_TILE in tool.SWEEP_TILES


def test_tool_main_on_cpu() -> None:
    report = tool.main("cpu", mib=1, reps=1)
    assert report["device"] == "cpu (host clock)"
    assert set(report["probes"]) == {"4MiB", "1MiB"}
    for sizes in report["probes"].values():
        assert set(sizes) == {"reduce", "rollrows"}
        for row in sizes.values():
            assert row["ms"] > 0 and row["bound_ms"] > 0
    assert report["transpose"]["shape"] == [4, 128, 2048]


def test_tool_tile_sweep_on_cpu() -> None:
    report = tool.fire_tile_sweep("cpu", mib=1, reps=1)
    tiles = report["tiles"]
    assert sorted(tiles) == sorted(tool.SWEEP_TILES)
    fires = {row["fires"] for row in tiles.values()}
    assert len(fires) == 1 and fires.pop() > 0
    assert report["default_tile"] == 4096


def test_tool_needs_a_card_unless_cpu_is_asked(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tool.main, tool.fire_tile_sweep):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool._cli([])
