"""PyTorch port: what the redesigned K2 and K1 kernels rest on, held on the
CPU through their plain versions.

K2 cuts the caller's ``L`` lanes of ``T`` bytes into sub-lanes of ``S``
bytes (``_kernels.plan_sublanes``), each warmed by the ``halo`` bytes
before it.  That changes no output because an automaton's state depends
only on the last ``max_len`` bytes: the plain K2 at ``(L, T)`` equals the
plain K2 at ``(L*T/S, S)`` at every position, with and without a head, and
equals the JAX package's ``scan_lanes``.  K1 reads its tables packed as
``[passes][m][2][16]`` entries of ``words`` planes
(``_kernels.pack_fire_tables``): the mask over the packed tables equals
the mask over the raw ones and the JAX package's Pallas fire kernel (in
interpret mode).  Inputs are made from a seed with numpy; every comparison
is exact (tolerance 0: all values are integers).
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import build_prefilter_config
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE
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


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


def _hay(seed: int, n: int, names: list[bytes], plant: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hay = np.frombuffer(b"abcdefgh zyx", np.uint8)[rng.integers(0, 12, n)]
    hay = hay.copy()
    for _ in range(plant):
        nm = names[int(rng.integers(len(names)))]
        off = int(rng.integers(max(n - len(nm), 1)))
        hay[off : off + len(nm)] = np.frombuffer(nm, np.uint8)[: n - off]
    return hay


# (L, T, halo, sm_count, the S wanted): the single-device layout of 64 MiB,
# the sharded rank layouts of two ranks and one (512 lanes), both with a
# 601-byte pattern (halo 600), one lane, small inputs, halo 0, T = halo,
# and a T that is not a multiple of 16
PLANS = [
    (65536, 1024, 10, 132, 256),
    (512, 65536, 10, 132, 128),
    (512, 131072, 10, 132, 256),
    (65536, 1024, 600, 132, 1024),
    (512, 65536, 600, 132, 1024),
    (1, 1024, 10, 132, 16),
    (16, 512, 15, 132, 16),
    (1024, 4096, 0, 4, 512),
    (8, 64, 64, 132, 64),
    (3, 100, 5, 2, 5),
]


@pytest.mark.parametrize("L,T,halo,sms,want", PLANS, ids=str)
def test_plan_sublanes(L: int, T: int, halo: int, sms: int, want: int) -> None:
    S = _kernels.plan_sublanes(L, T, halo, sms)
    assert S == want
    assert T % S == 0 and S >= halo
    if T % 16 == 0:
        assert S % 16 == 0
    target = 7 * sms * _kernels.SM_THREADS
    fills = (L * T // S) * 8 >= target
    smallest = min(
        d for d in range(max(halo, 1), T + 1)
        if T % d == 0 and (T % 16 or d % 16 == 0)
    )
    # it fills the card, or no allowed length does and it is the smallest
    assert fills or S == smallest
    # and no longer allowed length fills it too
    for d in range(S + 1, T + 1):
        if T % d == 0 and (T % 16 or d % 16 == 0):
            assert (L * T // d) * 8 < target


def _ref_lanes(am, engine: str, buf: np.ndarray, n: int, L: int, T: int,
               halo: int) -> tuple[np.ndarray, np.ndarray]:
    t = ref_scan.DeviceTables(am, engine, packed2_max_bytes=0)
    ext = ref_scan.build_lanes(
        jnp.asarray(buf).astype(jnp.int32), L, T, halo, n
    )
    if t.use_classes:
        ext = t.classes[ext]
    out = np.asarray(ref_scan.scan_lanes(t.table, ext, halo)).reshape(-1)
    return out, (am.match_count[out] > 0) & (np.arange(L * T) < n)


L_CALLER, T_CALLER = 8, 64


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("head_kind", ["none", "tail", "random"])
@pytest.mark.parametrize("n", [1, 37, 301, L_CALLER * T_CALLER])
def test_split_lanes_equal_caller_layout(
    engine: str, head_kind: str, n: int
) -> None:
    """The plain K2 at the caller's (L, T) equals it at (L*T/S, S) for
    every sub-lane length S the kernel may take, at every position; with
    no head, both equal the reference's scan_lanes."""
    names = _names(5, 30) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    halo = am.max_len - 1
    L, T = L_CALLER, T_CALLER
    buf = np.zeros(L * T, np.uint8)
    buf[:n] = _hay(n, n, names, n // 20 + 1)
    rng = np.random.default_rng(n + 1)
    head = {
        "none": None,
        "tail": _hay(n + 2, halo, names, 0).astype(np.int32),
        "random": rng.integers(0, PAD_BYTE + 1, halo).astype(np.int32),
    }[head_kind]
    head_t = None if head is None else torch.from_numpy(head)
    tabs = port_scan.DeviceTables(am, engine, "cpu")
    hay = torch.from_numpy(buf)

    def plain(lanes: int, width: int):
        return port_scan._lane_scan_plain(
            tabs.table, tabs.classes, hay, tabs.match_count, n, lanes,
            width, halo, tabs.use_classes, head_t,
        )

    states, mask = plain(L, T)
    assert int(mask.sum()) > 0 or n < 40
    for S in (16, 32):
        assert S >= halo and T % S == 0
        st_s, mask_s = plain(L * T // S, S)
        assert torch.equal(mask_s, mask)
        assert torch.equal(st_s, states)
    if head is None:
        want_states, want_mask = _ref_lanes(am, engine, buf, n, L, T, halo)
        np.testing.assert_array_equal(states.numpy(), want_states)
        np.testing.assert_array_equal(mask.numpy().astype(bool), want_mask)


def _ref_fire(pf, hay2d: np.ndarray) -> np.ndarray:
    """The reference's fire mask as ``_fire_verify`` forms it: one Pallas
    call per pass (interpret mode on the CPU), AND-combined."""
    rows_pp = 2 * pf.m * pf.words
    mask = None
    for p in range(pf.passes):
        sub = jnp.asarray(pf.tables[p * rows_pp : (p + 1) * rows_pp])
        mp = np.asarray(
            ref_teddy.fire_mask(sub, jnp.asarray(hay2d), pf.m, pf.words, 1)
        )
        mask = mp if mask is None else (mask & mp)
    return mask


@pytest.mark.parametrize(
    "config", [(6, 4, 2), (8, 8, 2), (3, 1, 1), (1, 2, 1)], ids=str
)
@pytest.mark.parametrize("n", [1, 7, 1001, 4095])
def test_fire_packed_equals_plain_and_reference(config, n: int) -> None:
    """K1 over the packed tables equals K1 over the raw tables on a flat
    haystack of n bytes (n not a multiple of 4 or 16, and below one
    4,096-position tile), and the reference's fire mask on the staged
    ``[R, 128]`` layout."""
    m, words, passes = config
    names = _names(m * 10 + words + passes, 60)
    pf = build_prefilter_config(names, m, words, passes)
    tables = torch.from_numpy(pf.tables)
    packed = port_teddy.pack_fire_tables(tables, m, words, passes)
    wp = 4 if words <= 4 else 8
    assert packed.shape == (passes, m, 2, 16, wp)
    assert not packed[..., words:].any()
    arr = _hay(n * 3 + m, n, names, n // 40 + 1)
    flat = torch.from_numpy(arr)
    want = port_teddy._fire_mask_plain(tables, flat, m, words, passes)
    got = port_teddy._fire_mask_packed_plain(packed, flat, m, words, passes)
    assert torch.equal(got, want)
    ref2d = np.array(ref_teddy.TeddyScanner.stage(None, arr))
    staged = torch.from_numpy(ref2d)
    got2d = port_teddy._fire_mask_packed_plain(
        packed, staged, m, words, passes
    )
    np.testing.assert_array_equal(got2d.numpy(), _ref_fire(pf, ref2d))
    assert torch.equal(
        got2d, port_teddy._fire_mask_plain(tables, staged, m, words, passes)
    )


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_teddy_scanner_shares_flagged_table(engine: str) -> None:
    """The Teddy verify walk (K4) and K2 read one flagged table: the
    scanner's ``vtable`` is its dense tables' ``lane_table()``, equal to
    the reference scanner's ``vtable``."""
    names = _names(9, 40)
    am = build_automaton(names)
    pf = build_prefilter_config(names, 6, 4, 2)
    tabs = port_scan.DeviceTables(am, engine, "cpu")
    sc = port_teddy.TeddyScanner(am, pf, tabs)
    assert sc.vtable is tabs.lane_table()
    assert torch.equal(
        sc.vtable, _kernels.flag_table(tabs.table, tabs.match_count)
    )
    rt = ref_scan.DeviceTables(am, engine, packed2_max_bytes=0)
    ref = ref_teddy.TeddyScanner(
        am, pf, rt.table, rt.classes, rt.match_count, rt.use_classes
    )
    np.testing.assert_array_equal(sc.vtable.numpy(), np.asarray(ref.vtable))
    assert torch.equal(
        sc.packed, _kernels.pack_fire_tables(sc.tables, 6, 4, 2)
    )


@pytest.mark.parametrize("kernel", ["lane_scan", "_lane_scan_at", "fire"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel: str) -> None:
    """K2's and K1's wrappers launch only on CUDA tensors; a CPU tensor
    raises (the plain versions serve the CPU one layer up)."""
    names = _names(10, 20)
    am = build_automaton(names)
    tabs = port_scan.DeviceTables(am, "classed", "cpu")
    hay = torch.zeros(1024, dtype=torch.uint8)
    halo = am.max_len - 1
    scan = (tabs.lane_table(), tabs.classes, hay, 1024, 4, 256, halo,
            tabs.use_classes)
    calls = {
        "lane_scan": lambda: _kernels.lane_scan(*scan),
        "_lane_scan_at": lambda: _kernels._lane_scan_at(64, *scan),
        "fire": lambda: _kernels.fire(
            torch.zeros((1, 1, 2, 16, 4), dtype=torch.int32),
            hay.view(8, 128), 1, 1, 1,
        ),
    }
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        calls[kernel]()
