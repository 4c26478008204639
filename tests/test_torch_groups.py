"""PyTorch port: the Teddy group stage (K9, ``csrc/groups.cu``) on the CPU.

The JAX package computes the stage inside its jitted ``_fire_verify``
(``ahocorasick_rs_tpu/ops/scan_teddy.py``) and ``_shard_teddy_fn``
(``ahocorasick_rs_tpu/parallel/sharded.py``) as three lines of ``jnp``: the
max of K1's mask over 32-byte groups, nonzero, and the group's start below
``n``.  Here the port's plain version (``scan_teddy._fire_groups_plain``)
equals that expression, evaluated with ``jnp`` on the same mask, bit for
bit, on seeded masks and on the JAX package's own fire mask (its Pallas
kernel in interpret mode); both Teddy bodies route the stage through the
dispatcher once a call; and the kernel's wrapper refuses what it does not
take.  Tolerance 0: every value is a flag.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import build_prefilter
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy
from ahocorasick_rs_tpu_torch.parallel import sharded as port_sharded
from ahocorasick_rs_tpu_torch.utils import convert

COARSE = ref_teddy.COARSE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_groups(mask: np.ndarray, n: int) -> np.ndarray:
    """The JAX package's group stage, as ``_fire_verify`` writes it."""
    m = jnp.asarray(mask)
    G = m.shape[0] // COARSE
    grp = jnp.max(m.reshape(G, COARSE), axis=1)
    gidx = jnp.arange(G, dtype=jnp.int32)
    return np.asarray((grp != 0) & (gidx * COARSE < jnp.int32(n)))


def _assert_equal_to_jax(mask: np.ndarray, n: int) -> np.ndarray:
    got = port_teddy._fire_groups_plain(torch.from_numpy(mask.copy()), n)
    want = _jax_groups(mask, n)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def _mask(seed: int, N: int, density: float, byte: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(rng.random(N) < density, byte, 0).astype(np.uint8)


# n around the edges of a 4 KiB mask (128 groups): none, negative, a
# group boundary and one either side of it, the last group's start, the
# end and past it
N_EDGES = [0, -1, -(1 << 20), 1, 31, 32, 33, 2047, 2048, 2049, 4064, 4065,
           4096, 4097, 1 << 30]


@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 1.0])
@pytest.mark.parametrize("byte", [1, 0x80])
def test_plain_equals_jax_expression(density: float, byte: int) -> None:
    """Densities 0 to 1 and mask bytes of 1 and 0x80 (any nonzero byte
    fires, not only bit 0), at every ``n`` edge and on a 1 MiB mask."""
    mask = _mask(int(density * 1e4) + byte, 4096, density, byte)
    for n in N_EDGES:
        want = _assert_equal_to_jax(mask, n)
        if density == 1.0:
            assert int(want.sum()) == min(max(-(-n // COARSE), 0), 128)
    big = _mask(7, 1 << 20, density, byte)
    for n in (1 << 20, (1 << 20) - 100, 12345):
        _assert_equal_to_jax(big, n)


@pytest.mark.parametrize("n", [-5, 0, 1, 31, 32, 33, 1000])
@pytest.mark.parametrize("byte", [0, 1, 0x80, 0xFF])
def test_plain_single_group(n: int, byte: int) -> None:
    """A mask of one group, with its one nonzero byte at either end."""
    for at in (0, COARSE - 1):
        mask = np.zeros(COARSE, np.uint8)
        mask[at] = byte
        want = _assert_equal_to_jax(mask, n)
        assert bool(want[0]) == (byte != 0 and n > 0)


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


def _ref_fire_mask(pf, hay2d: np.ndarray) -> np.ndarray:
    """The JAX package's K1 mask, its passes ANDed as ``_fire_verify``
    does (the Pallas kernel in interpret mode)."""
    rows_pp = 2 * pf.m * pf.words
    mask = None
    for p in range(pf.passes):
        sub = jnp.asarray(pf.tables[p * rows_pp : (p + 1) * rows_pp])
        mp = np.asarray(
            ref_teddy.fire_mask(sub, jnp.asarray(hay2d), pf.m, pf.words, 1)
        )
        mask = mp if mask is None else (mask & mp)
    return mask.reshape(-1)


@pytest.mark.parametrize("n", [900, 992, 993, 1024])
def test_always_fire_tail_past_n(n: int) -> None:
    """K1 fires the staged buffer's last ``m - 1`` positions whatever they
    hold; a group there that starts at or past ``n`` must not fire.  The
    mask is the JAX package's own fire mask of a staged haystack, which
    the port's plain K1 also gives."""
    names = _names(3, 30)
    pf = build_prefilter(names)
    hay = np.frombuffer(b"zyxwvuts" * 128, np.uint8)[:n].copy()
    rows = 8  # the layout stage() makes for up to 1,024 bytes
    buf = np.zeros(rows * 128, np.uint8)
    buf[:n] = hay
    hay2d = buf.reshape(rows, 128)
    mask = _ref_fire_mask(pf, hay2d)
    port_mask = port_teddy._fire_mask_plain(
        torch.from_numpy(pf.tables.astype(np.int32)),
        torch.from_numpy(hay2d), pf.m, pf.words, pf.passes,
    )
    np.testing.assert_array_equal(port_mask.reshape(-1).numpy(), mask)
    assert mask[-(pf.m - 1):].all() and not mask[: 512].any()
    want = _assert_equal_to_jax(mask, n)
    last = len(want) - 1
    assert bool(want[last]) == (last * COARSE < n)


def test_dispatcher_takes_plain_on_cpu() -> None:
    """On a CPU tensor ``fire_groups`` is the plain version (bool, the
    compaction's input today), and K9's group is the Teddy scan's."""
    mask = torch.from_numpy(_mask(5, 8192, 0.01, 1))
    got = port_teddy.fire_groups(mask, 5000)
    assert torch.equal(got, port_teddy._fire_groups_plain(mask, 5000))
    assert got.dtype == torch.bool
    assert _kernels.FIRE_GROUP == port_teddy.COARSE == COARSE
    idx, total = port_scan.compact_sparse(got, 64)
    want = np.flatnonzero(_jax_groups(mask.numpy(), 5000))
    assert int(total) == len(want)
    np.testing.assert_array_equal(idx[: len(want)].numpy(), want)


def _port_scanner(names: list[bytes]):
    am = build_automaton(names)
    pf = build_prefilter(names)
    port_am = convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )
    return port_teddy.TeddyScanner(
        port_am,
        convert.prefilter_from_arrays(
            pf.m, pf.words, pf.passes, pf.tables, pf.bucket_of,
            pf.est_fire_rate,
        ),
        port_scan.DeviceTables(port_am, "dfa", "cpu"),
    )


@pytest.fixture
def spy(monkeypatch):
    """Calls of ``scan_teddy.fire_groups``, as (mask size, n)."""
    calls: list[tuple[int, int]] = []
    real = port_teddy.fire_groups

    def counted(mask, n):
        calls.append((mask.numel(), n))
        return real(mask, n)

    monkeypatch.setattr(port_teddy, "fire_groups", counted)
    return calls


def _haystack(names: list[bytes], n: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    hay = np.frombuffer(b"zyxwvuts", np.uint8)[rng.integers(0, 8, n)].copy()
    for i in range(0, n - 16, 997):
        nm = names[i % len(names)]
        hay[i : i + len(nm)] = np.frombuffer(nm, np.uint8)
    return hay


def test_fire_verify_calls_fire_groups_once(spy) -> None:
    names = _names(4, 40)
    sc = _port_scanner(names)
    hay = _haystack(names, 20_000)
    hay2d = sc.stage(hay)
    W = sc.am.max_len + COARSE - 1
    outs = port_teddy._fire_verify(
        sc.tables, sc.vtable, sc.classes, hay2d, len(hay), 1 << 14, 1 << 12,
        sc.m, sc.words, sc.passes, W, sc.use_classes,
    )
    assert spy == [(hay2d.numel(), len(hay))]
    assert int(outs[1]) > 10


def test_shard_teddy_body_calls_fire_groups_once(spy) -> None:
    names = _names(6, 40)
    sc = _port_scanner(names)
    hay = _haystack(names, 20_000)
    W = sc.am.max_len + COARSE - 1
    rows, Hr = port_sharded.teddy_layout(len(hay), 2, W)
    LT = rows * 128
    shard = port_sharded._shard_of(hay, 1, LT, torch.device("cpu"))
    right = torch.zeros(Hr, dtype=torch.uint8)
    outs = port_sharded.shard_teddy_body(
        sc, shard, right, len(hay) - LT, LT, W, 1 << 14, 1 << 12
    )
    assert spy == [(LT, len(hay) - LT)]
    assert int(outs[1]) > 0


@pytest.mark.parametrize("case", ["cpu", "int32", "bool", "2d", "n33", "n0"])
def test_kernel_wrapper_refuses(case: str) -> None:
    """``_kernels.fire_groups`` launches only on a uint8 [N] CUDA tensor
    with N a positive multiple of 32; anything else raises ValueError
    before a build (the plain version serves the CPU one layer up)."""
    bad = {
        "cpu": (torch.zeros(64, dtype=torch.uint8), "needs CUDA tensors"),
        "int32": (torch.zeros(64, dtype=torch.int32), "not uint8"),
        "bool": (torch.zeros(64, dtype=torch.bool), "not uint8"),
        "2d": (torch.zeros(2, 32, dtype=torch.uint8), "not uint8"),
        "n33": (torch.zeros(33, dtype=torch.uint8), "multiple of 32"),
        "n0": (torch.zeros(0, dtype=torch.uint8), "multiple of 32"),
    }
    mask, msg = bad[case]
    before = _kernels.LAUNCHES["fire_groups"]
    with pytest.raises(ValueError, match=msg):
        _kernels.fire_groups(mask, 64)
    assert _kernels.LAUNCHES["fire_groups"] == before
