"""PyTorch port, kernel level: K1 (fire mask), K2 (lane scan), K3
(compaction) and K4 (verify walk) equal the JAX package's functions on the
same inputs.

Here, on the CPU, each port wrapper runs its kernel's plain PyTorch
version (the wrapper picks it because the tensors lie on the CPU); the
reference's Pallas fire kernel runs in interpret mode, as
``tests/test_teddy.py`` runs it.  Inputs are made from a seed with numpy
and every comparison is exact (tolerance 0: all values are integers).
The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import (
    build_prefilter,
    build_prefilter_config,
)
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Stager:
    device = torch.device("cpu")


def _stage_both(hay: bytes) -> tuple[np.ndarray, torch.Tensor]:
    arr = np.frombuffer(hay, dtype=np.uint8)
    ref = np.asarray(ref_teddy.TeddyScanner.stage(None, arr))
    port = port_teddy.TeddyScanner.stage(_Stager(), arr)
    np.testing.assert_array_equal(ref, port.numpy())
    return ref, port


def _ref_fire(pf, hay2d: np.ndarray) -> np.ndarray:
    """The reference's fire mask as ``_fire_verify`` forms it: one Pallas
    call per pass, AND-combined."""
    rows_pp = 2 * pf.m * pf.words
    mask = None
    for p in range(pf.passes):
        sub = jnp.asarray(pf.tables[p * rows_pp : (p + 1) * rows_pp])
        mp = np.asarray(
            ref_teddy.fire_mask(sub, jnp.asarray(hay2d), pf.m, pf.words, 1)
        )
        mask = mp if mask is None else (mask & mp)
    return mask


def _names_hay(seed: int, n: int, names: list[bytes], plant: int) -> bytes:
    rng = random.Random(seed)
    hay = bytearray(bytes(rng.choice(b"zyxwvuts ") for _ in range(n)))
    for _ in range(plant):
        nm = names[rng.randrange(len(names))]
        off = rng.randrange(n - len(nm))
        hay[off : off + len(nm)] = nm
    return bytes(hay)


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


@pytest.mark.parametrize("passes", [1, 2])
def test_fire_mask_equals_reference(passes: int) -> None:
    names = _names(passes, 60)
    pf = build_prefilter_config(names, m=4, words=2, passes=passes)
    hay = _names_hay(passes, 20_000, names, 50)
    ref2d, port2d = _stage_both(hay)
    want = _ref_fire(pf, ref2d)
    got = port_teddy.fire_mask(
        torch.from_numpy(pf.tables), port2d, pf.m, pf.words, pf.passes
    )
    assert got.dtype == torch.uint8 and got.shape == port2d.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_fire_mask_multi_block_halo() -> None:
    """m=8, words=8, one pass: the reference's block is 256 rows, so a
    ~100 KB haystack spans four blocks and exercises its block halo.
    Names straddle block and row boundaries."""
    names = _names(11, 40)
    pf = build_prefilter_config(names, m=8, words=8, passes=1)
    assert ref_teddy._block_rows(pf.m, pf.words, 1) == 256
    hay = bytearray(_names_hay(12, 100_000, names, 40))
    for cut in (256 * 128, 512 * 128, 768 * 128, 128 * 7, 128 * 300):
        nm = names[cut % len(names)]
        hay[cut - 3 : cut - 3 + len(nm)] = nm
    ref2d, port2d = _stage_both(bytes(hay))
    assert ref2d.shape[0] // 256 == 4
    want = _ref_fire(pf, ref2d)
    got = port_teddy.fire_mask(
        torch.from_numpy(pf.tables), port2d, pf.m, pf.words, pf.passes
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_fire_mask_block_boundary_placement() -> None:
    """The placement of test_teddy.py::test_teddy_block_boundary_matches."""
    pattern = b"boundary"
    hay = bytearray(b"." * 8192)
    for off in (1022, 2045, 4094, 8184):
        hay[off : off + len(pattern)] = pattern
    pf = build_prefilter([pattern])
    ref2d, port2d = _stage_both(bytes(hay))
    want = _ref_fire(pf, ref2d)
    got = port_teddy.fire_mask(
        torch.from_numpy(pf.tables), port2d, pf.m, pf.words, pf.passes
    )
    np.testing.assert_array_equal(got.numpy(), want)
    flat = want.reshape(-1)
    assert all(flat[off] for off in (1022, 2045, 4094, 8184))


@pytest.mark.parametrize("density", [0.0005, 0.02, 0.3])
@pytest.mark.parametrize("cap", [64, 1 << 15])
def test_compact_sparse_equals_reference(density: float, cap: int) -> None:
    rng = np.random.default_rng(int(density * 1e4) + cap)
    mask = rng.random(100_003) < density
    ref_compact = jax.jit(ref_scan.compact_sparse, static_argnums=(1,))
    idx_r, tot_r = ref_compact(jnp.asarray(mask), cap)
    idx_p, tot_p = port_scan.compact_sparse(torch.from_numpy(mask), cap)
    assert idx_p.dtype == torch.int32 and idx_p.shape == (cap,)
    assert int(tot_p) == int(tot_r) == int(mask.sum())
    if int(tot_r) <= cap:
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    else:  # overflow: the first cap indexes, ascending
        np.testing.assert_array_equal(
            idx_p.numpy(), np.nonzero(mask)[0][:cap]
        )


def test_compact_sparse_uint8_and_empty() -> None:
    mask = np.zeros(5000, dtype=np.uint8)
    mask[[0, 4095, 4096, 4999]] = 1
    idx, total = port_scan.compact_sparse(torch.from_numpy(mask), 8)
    assert int(total) == 4
    np.testing.assert_array_equal(idx.numpy(), [0, 4095, 4096, 4999] + [-1] * 4)
    idx, total = port_scan.compact_sparse(torch.zeros(0, dtype=torch.bool), 4)
    assert int(total) == 0 and idx.tolist() == [-1] * 4


def _ref_lane_scan(am, engine, hay_buf, n, L, T, halo):
    t = ref_scan.DeviceTables(am, engine, packed2_max_bytes=0)
    ext = ref_scan.build_lanes(
        jnp.asarray(hay_buf).astype(jnp.int32), L, T, halo, n
    )
    if t.use_classes:
        ext = t.classes[ext]
    out = np.asarray(ref_scan.scan_lanes(t.table, ext, halo)).reshape(-1)
    mask = (am.match_count[out] > 0) & (np.arange(L * T) < n)
    return out, mask


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("n", [1, 5000, 8192])
def test_lane_scan_equals_reference(engine: str, n: int) -> None:
    names = _names(21, 30) + [b"h", b"abcdefghabcdefgh"]
    am = build_automaton(names)
    halo = am.max_len - 1
    L, T = port_scan.choose_layout(n, halo)
    assert (L, T) == ref_scan.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(_names_hay(n, n + 20, names, n // 100), np.uint8)[:n]
    want_states, want_mask = _ref_lane_scan(am, engine, buf, n, L, T, halo)
    tabs = port_scan.DeviceTables(am, engine, "cpu")
    states, mask = port_scan.scan_lanes(
        tabs.table, tabs.classes, torch.from_numpy(buf), tabs.match_count,
        n, L, T, halo, tabs.use_classes,
    )
    np.testing.assert_array_equal(states.numpy(), want_states)
    np.testing.assert_array_equal(mask.numpy().astype(bool), want_mask)


def _vtable(am, engine: str) -> tuple[np.ndarray, np.ndarray]:
    table = am.delta if engine == "dfa" else am.delta_classed
    classes = (
        np.zeros(257, np.int32) if engine == "dfa" else am.byte_classes
    )
    vt = table | ((am.match_count[table] > 0).astype(np.int32) << 24)
    return vt.astype(np.int32), classes.astype(np.int32)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_body_equals_reference(engine: str) -> None:
    names = _names(31, 40)
    am = build_automaton(names)
    hay = _names_hay(32, 9000, names, 60)
    ref2d, port2d = _stage_both(hay)
    n = len(hay)
    W = am.max_len + ref_teddy.COARSE - 1
    rng = np.random.default_rng(5)
    groups = rng.choice(n // 32 + 1, 150, replace=False) * 32
    fire_pos = np.full(256, -1, dtype=np.int32)
    fire_pos[: len(groups)] = np.sort(groups)
    fire_pos[len(groups)] = (n // 32) * 32  # a window running past n
    vt, classes = _vtable(am, engine)
    pad = (-(-W // ref_teddy.VCHUNK)) * ref_teddy.VCHUNK
    hay_pad = jnp.concatenate(
        [jnp.asarray(ref2d.reshape(-1)), jnp.zeros((pad,), jnp.uint8)]
    )
    ref_verify = jax.jit(
        ref_teddy._verify_body, static_argnums=(5, 6, 7)
    )  # as _fire_verify runs it, compiled
    for cap2 in (8, 4096):
        want = ref_verify(
            jnp.asarray(vt), jnp.asarray(classes), hay_pad,
            jnp.asarray(fire_pos), jnp.int32(n), W, cap2, engine != "dfa",
        )
        got = port_teddy._verify_body(
            torch.from_numpy(vt), torch.from_numpy(classes),
            port2d.reshape(-1), torch.from_numpy(fire_pos), n, W, cap2,
            engine != "dfa",
        )
        assert int(got[3]) == int(want[3]) > 8
        if cap2 >= int(want[3]):
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
