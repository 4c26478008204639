"""PyTorch port on the card: each CUDA kernel equals its plain PyTorch
version on the same CUDA tensors, and the device paths equal their CPU
runs.  Exact comparisons (all values are integers).

Every test here carries the ``gpu`` marker and takes the ``cuda`` fixture,
which skips when no card is present: here, on the CPU, they all skip.  The
file imports only the port (not JAX), so that it runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from ahocorasick_rs_tpu_torch import AhoCorasick, Implementation, MatchKind
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch.models.prefilter import (
    build_prefilter,
    build_prefilter_config,
)
from ahocorasick_rs_tpu_torch.ops import scan_cuda, scan_teddy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


def _corpus(seed: int, n: int, names: list[bytes], plant: int) -> bytes:
    rng = np.random.default_rng(seed)
    hay = bytearray(
        np.frombuffer(b"zyxwvuts ", np.uint8)[rng.integers(0, 9, n)].tobytes()
    )
    for _ in range(plant):
        nm = names[int(rng.integers(len(names)))]
        off = int(rng.integers(n - len(nm)))
        hay[off : off + len(nm)] = nm
    return bytes(hay)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 100_003])
@pytest.mark.parametrize("density", [0.001, 0.3])
def test_compact_kernel_equals_plain(cuda, n: int, density: float) -> None:
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random(n) < density).to(cuda)
    for cap in (1, 64, 1 << 17):
        idx, total = scan_cuda.compact_sparse(mask, cap)
        want_idx, want_total = scan_cuda._compact_plain(mask, cap)
        torch.cuda.synchronize()
        assert int(total) == int(want_total)
        assert torch.equal(idx, want_idx)


def test_compact_kernel_unaligned_view(cuda) -> None:
    base = torch.zeros(9001, dtype=torch.uint8, device=cuda)
    base[torch.arange(3, 9001, 7, device=cuda)] = 1
    view = base[3:]  # 3 bytes off the allocation's alignment
    idx, total = _kernels.compact(view, 2048)
    want_idx, want_total = scan_cuda._compact_plain(view, 2048)
    assert int(total) == int(want_total) == 1286
    assert torch.equal(idx, want_idx)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("n", [1, 5000, 70_000])
def test_lane_scan_kernel_equals_plain(cuda, engine: str, n: int) -> None:
    names = _names(1, 40) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    halo = am.max_len - 1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(_corpus(n, n + 16, names, n // 50), np.uint8)[:n]
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    hay = torch.from_numpy(buf).to(cuda)
    args = (tabs.table, tabs.classes, hay, tabs.match_count, n, L, T, halo,
            tabs.use_classes)
    st, mask = scan_cuda.scan_lanes(*args)
    st_p, mask_p = scan_cuda._lane_scan_plain(*args)
    assert torch.equal(st, st_p) and torch.equal(mask, mask_p)


@pytest.mark.parametrize(
    "config", [(4, 2, 1), (6, 4, 2), (8, 8, 1), (3, 1, 2), (8, 8, 2)], ids=str
)
@pytest.mark.parametrize("n", [100, 9000, 300_001])
def test_fire_kernel_equals_plain(cuda, config, n: int) -> None:
    m, words, passes = config
    names = _names(m * words + passes, 80)
    pf = build_prefilter_config(names, m, words, passes)
    arr = np.frombuffer(_corpus(n, n, names, n // 300 + 1), np.uint8)
    scanner_stage = scan_teddy.TeddyScanner.stage
    hay2d = scanner_stage(type("S", (), {"device": cuda})(), arr)
    tables = torch.from_numpy(pf.tables).to(cuda)
    got = scan_teddy.fire_mask(tables, hay2d, m, words, passes)
    want = scan_teddy._fire_mask_plain(tables, hay2d, m, words, passes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_kernel_equals_plain(cuda, engine: str) -> None:
    names = _names(7, 40)
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    pf = build_prefilter(names)
    sc = scan_teddy.TeddyScanner(
        am, pf, tabs.table, tabs.classes, tabs.match_count, tabs.use_classes
    )
    hay = _corpus(8, 50_000, names, 200)
    n = len(hay)
    hay2d = sc.stage(np.frombuffer(hay, np.uint8))
    W = am.max_len + scan_teddy.COARSE - 1
    rng = np.random.default_rng(3)
    fp = np.full(2048, -1, np.int32)
    groups = np.sort(rng.choice(n // 32, 1000, replace=False)) * 32
    fp[:1000] = groups
    fp[1000] = (n // 32) * 32  # the last group: its window runs past n
    fire_pos = torch.from_numpy(fp).to(cuda)
    flat = hay2d.reshape(-1)
    got = scan_teddy.verify_walk(
        sc.vtable, sc.classes, flat, fire_pos, n, W, sc.use_classes
    )
    want = scan_teddy._verify_walk_plain(
        sc.vtable, sc.classes, flat, fire_pos, n, W, sc.use_classes
    )
    assert torch.equal(got, want)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_device_paths_equal_cpu(cuda, engine: str) -> None:
    names = _names(9, 60)
    am = build_automaton(names)
    hay = np.frombuffer(_corpus(10, 400_000, names, 500), np.uint8)
    cpu_t = scan_cuda.DeviceTables(am, engine, "cpu")
    gpu_t = scan_cuda.DeviceTables(am, engine, cuda)
    for seg in (1 << 20, 50_000):
        want = scan_cuda.scan_device(am, hay, cpu_t, segment_bytes=seg)
        got = scan_cuda.scan_device(am, hay, gpu_t, segment_bytes=seg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pf = build_prefilter(names)
    mk = [
        scan_teddy.TeddyScanner(
            am, pf, t.table, t.classes, t.match_count, t.use_classes
        )
        for t in (cpu_t, gpu_t)
    ]
    want = mk[0].occurrences(hay)
    got = mk[1].occurrences(hay)
    streamed = mk[1].occurrences_streamed(hay, seg_bytes=70_000)
    for a, b, c in zip(got, want, streamed):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_api_device_tier_counts_launches(cuda) -> None:
    names = [n.decode() for n in _names(11, 50)]
    hay = _corpus(12, 3 << 20, [n.encode() for n in names], 3000).decode()
    want = AhoCorasick(
        names, matchkind=MatchKind.LeftmostLongest, backend="numpy",
        device=cuda,
    ).find_matches_as_indexes(hay)
    _kernels.reset_launches()
    ac = AhoCorasick(
        names, matchkind=MatchKind.LeftmostLongest, backend="device",
        device=cuda,
    )
    assert ac.find_matches_as_indexes(hay) == want
    assert ac.stats()["last_backend"] == "teddy"
    assert _kernels.LAUNCHES["fire"] > 0 and _kernels.LAUNCHES["verify"] > 0
    _kernels.reset_launches()
    dense = AhoCorasick(
        names, implementation=Implementation.ContiguousNFA,
        backend="device", device=cuda,
    )
    dense._teddy_state = "off"
    got = dense.find_matches_as_indexes(hay, overlapping=True)
    assert got == AhoCorasick(
        names, backend="numpy", device=cuda
    ).find_matches_as_indexes(hay, overlapping=True)
    assert dense.stats()["last_backend"] == "device"
    assert _kernels.LAUNCHES["lane_scan"] > 0
    assert _kernels.LAUNCHES["compact"] > 0
