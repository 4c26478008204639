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
    # the pair table of 50 names fits, so the dense tier runs K6
    assert _kernels.LAUNCHES["stride2_scan"] > 0
    assert _kernels.LAUNCHES["lane_scan"] == 0
    assert _kernels.LAUNCHES["compact"] > 0


# name sets whose halo (max_len - 1) is odd, even, and 0 (one-byte names)
HALO_NAMES = {
    "odd": _names(21, 40) + [b"abcdefghabcdefgh"],
    "even": _names(22, 40) + [b"abcdefghabcdefg"],
    "zero": [b"a", b"c", b"h"],
}


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("halo_kind", sorted(HALO_NAMES))
@pytest.mark.parametrize("n", [1, 5001, 70_000])
def test_stride2_kernel_equals_plain(
    cuda, engine: str, halo_kind: str, n: int
) -> None:
    names = HALO_NAMES[halo_kind]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    assert tabs.ensure_packed2()
    halo = am.max_len - 1
    halo += halo & 1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(_corpus(n, n + 16, names, n // 50), np.uint8)[:n]
    hay = torch.from_numpy(buf).to(cuda)
    C = tabs.table_classed.shape[1]
    args = (tabs.packed2, C, tabs.classes2, hay, n, L, T, halo)
    got = scan_cuda.stride2_scan(*args)
    want = scan_cuda._stride2_scan_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cpu = scan_cuda._scan_compact2(
        tabs.packed2.cpu(), tabs.table_classed.cpu(), tabs.classes2.cpu(),
        hay.cpu(), n, L, T, halo, 4096,
    )
    dev = scan_cuda._scan_compact2(
        tabs.packed2, tabs.table_classed, tabs.classes2, hay, n, L, T, halo,
        4096,
    )
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [1, 4097, 60_000])
def test_sparse_kernel_equals_plain(cuda, n: int) -> None:
    # "abcd" then "bcx": the walk reaches depth 3 in "abc", misses on "x"
    # and follows fail links ("bc", then "c", then the root) before it
    # finds the edge of "bcx"; "q" misses everywhere and ends at the root
    names = _names(31, 30) + [b"abcd", b"bcx", b"cdq"]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, "sparse", cuda)
    halo = am.max_len - 1
    L, T = scan_cuda.choose_layout(n, halo)
    body = (_corpus(n, n, names, n // 40) + b"abcxabcqbcx" * 8)[-n:]
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(body, np.uint8)
    hay = torch.from_numpy(buf).to(cuda)
    args = (tabs.keys, tabs.targets, tabs.fail, tabs.match_count, hay, n, L,
            T, halo)
    st, mask = scan_cuda.sparse_scan(*args)
    st_p, mask_p = scan_cuda._sparse_scan_plain(*args)
    assert torch.equal(st, st_p) and torch.equal(mask, mask_p)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("B", [1, 13, 200])
def test_batch_kernel_equals_plain(cuda, engine: str, B: int) -> None:
    names = _names(41, 40)
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    rng = np.random.default_rng(B)
    docs = [
        np.frombuffer(_corpus(i, int(rng.integers(20, 300)), names, 3),
                      np.uint8)
        for i in range(B)
    ]
    docs[0] = docs[0][:0]  # an empty document: an all-PAD row
    T = scan_cuda._bucket(max(max(len(d) for d in docs), 16), lo=16)
    Bb = scan_cuda._bucket(max(B, scan_cuda.MIN_LANES),
                           lo=scan_cuda.MIN_LANES)
    buf = np.zeros((Bb, T), dtype=np.uint8)
    buf[:, :] = ord("a")  # padding bytes must read as PAD, not as 'a'
    lens = np.zeros(Bb, dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = d
        lens[i] = len(d)
    args = (tabs.table, tabs.classes, torch.from_numpy(buf).to(cuda),
            torch.from_numpy(lens).to(cuda), tabs.match_count,
            tabs.use_classes)
    st, mask = scan_cuda.scan_batch(*args)
    st_p, mask_p = scan_cuda._batch_scan_plain(*args)
    assert torch.equal(st, st_p) and torch.equal(mask, mask_p)
    want = scan_cuda.scan_device_batch(
        am, docs, scan_cuda.DeviceTables(am, engine, "cpu")
    )
    got = scan_cuda.scan_device_batch(am, docs, tabs)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)


def test_sparse_device_path_equals_cpu(cuda) -> None:
    names = _names(51, 60)
    am = build_automaton(names)
    hay = np.frombuffer(_corpus(52, 200_000, names, 400), np.uint8)
    for seg in (1 << 20, 50_000):
        want = scan_cuda.scan_device(
            am, hay, scan_cuda.DeviceTables(am, "sparse", "cpu"),
            segment_bytes=seg,
        )
        got = scan_cuda.scan_device(
            am, hay, scan_cuda.DeviceTables(am, "sparse", cuda),
            segment_bytes=seg,
        )
        assert len(want[0]) > 100
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_api_batch_and_sparse_count_launches(cuda) -> None:
    names = [n.decode() for n in _names(61, 50)]
    rng = np.random.default_rng(62)
    docs = [
        _corpus(i, int(rng.integers(60, 700)), [n.encode() for n in names],
                2).decode()
        for i in range(3000)
    ]
    host = AhoCorasick(names, backend="native", device=cuda)
    want = [host.find_matches_as_indexes(d) for d in docs]
    for teddy, tier, kernel in (
        ("force", "teddy_batch", "fire"), ("off", "device_batch", "batch_scan")
    ):
        _kernels.reset_launches()
        ac = AhoCorasick(names, backend="device", device=cuda)
        ac._teddy_state = teddy
        assert ac.find_matches_as_indexes_batch(docs) == want
        assert ac.stats()["last_backend"] == tier
        assert _kernels.LAUNCHES[kernel] > 0
    _kernels.reset_launches()
    sparse = AhoCorasick(
        names, implementation=Implementation.NoncontiguousNFA,
        backend="device", device=cuda,
    )
    text = "".join(docs[:300])
    assert sparse.find_matches_as_indexes(text, overlapping=True) == (
        host.find_matches_as_indexes(text, overlapping=True)
    )
    assert sparse.stats()["last_backend"] == "device"
    assert _kernels.LAUNCHES["sparse_scan"] > 0


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("n", [1, 5000, 70_000])
def test_lane_scan_head_equals_plain(cuda, engine: str, n: int) -> None:
    """K2 with a neighbour's head: an all-PAD head is bit-equal to K2
    without one, and a random head (bytes and PAD) equals the plain
    version."""
    from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE

    names = _names(71, 40) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    halo = am.max_len - 1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(_corpus(n, n + 16, names, n // 50), np.uint8)[:n]
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    hay = torch.from_numpy(buf).to(cuda)
    args = (tabs.table, tabs.classes, hay, tabs.match_count, n, L, T, halo,
            tabs.use_classes)
    pad = torch.full((halo,), PAD_BYTE, dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    with_pad = _kernels.lane_scan(*args, head=pad)
    without = _kernels.lane_scan(*args)
    for a, b in zip(with_pad, without):
        assert torch.equal(a, b)
    assert _kernels.LAUNCHES["lane_scan_head"] == 1
    rng = np.random.default_rng(n)
    tail = np.frombuffer(b"abcdefghabcdefgh", np.uint8)[-halo:].astype(np.int32)
    for head_np in (tail, rng.integers(0, 257, halo).astype(np.int32)):
        head = torch.from_numpy(head_np).to(cuda)
        got = scan_cuda.scan_lanes(*args, head=head)
        want = scan_cuda._lane_scan_plain(*args, head=head)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_shard_bodies_equal_cpu(cuda) -> None:
    """The sharded scan's per-rank bodies (K8) on the card equal the same
    bodies on CPU copies of their inputs, for 3 ranks by hand."""
    from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE
    from ahocorasick_rs_tpu_torch.parallel import sharded

    names = _names(81, 50) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    pf = build_prefilter(names)
    hay = np.frombuffer(_corpus(82, 300_001, names, 900), np.uint8)
    n, n_dev, halo = len(hay), 3, am.max_len - 1
    tabs = {d: scan_cuda.DeviceTables(am, "classed", d) for d in ("cpu", cuda)}
    _kernels.reset_launches()
    # dense: each rank's head is its left neighbour's tail
    L, T = sharded.dense_layout(n, n_dev, halo, lanes_per_device=64)
    LT = L * T
    shards = [torch.from_numpy(sharded._shard_of(hay, d, LT))
              for d in range(n_dev)]
    for d in range(n_dev):
        head = (sharded.shard_tail(shards[d - 1], n - (d - 1) * LT, halo)
                if d else torch.full((halo,), PAD_BYTE, dtype=torch.int32))
        outs = [
            sharded.shard_scan_body(
                tabs[dev], shards[d].to(dev), head.to(dev), n - d * LT,
                d * LT, L, T, halo, 1 << 14,
            )
            for dev in ("cpu", cuda)
        ]
        for a, b in zip(*outs):
            assert torch.equal(a, b.cpu())
    # Teddy: each rank reads its right neighbour's head
    scanners = {
        dev: scan_teddy.TeddyScanner(
            am, pf, t.table, t.classes, t.match_count, t.use_classes
        )
        for dev, t in tabs.items()
    }
    W = am.max_len + scan_teddy.COARSE - 1
    rows, Hr = sharded.teddy_layout(n, n_dev, W)
    LT = rows * 128
    shards = [torch.from_numpy(sharded._shard_of(hay, d, LT))
              for d in range(n_dev)]
    for d in range(n_dev):
        right = (shards[d + 1][:Hr] if d + 1 < n_dev
                 else torch.zeros(Hr, dtype=torch.uint8))
        outs = [
            sharded.shard_teddy_body(
                scanners[dev], shards[d].to(dev), right.to(dev), n - d * LT,
                d * LT, W, 1 << 14, 1 << 13,
            )
            for dev in ("cpu", cuda)
        ]
        for a, b in zip(*outs):
            assert torch.equal(a, b.cpu())
    # batch: row blocks, no halo
    rng = np.random.default_rng(83)
    docs = [np.frombuffer(_corpus(i, int(rng.integers(20, 600)), names, 2),
                          np.uint8) for i in range(301)]
    Bb, T = sharded.batch_layout([len(x) for x in docs], n_dev)
    Bl = Bb // n_dev
    for d in range(n_dev):
        buf = np.zeros((Bl, T), dtype=np.uint8)
        lens = np.zeros(Bl, dtype=np.int32)
        for r, x in enumerate(docs[d * Bl : (d + 1) * Bl]):
            buf[r, : len(x)] = x
            lens[r] = len(x)
        outs = [
            sharded.shard_batch_body(
                tabs[dev], torch.from_numpy(buf).to(dev),
                torch.from_numpy(lens).to(dev), d * Bl * T, 1 << 14,
            )
            for dev in ("cpu", cuda)
        ]
        for a, b in zip(*outs):
            assert torch.equal(a, b.cpu())
    assert _kernels.LAUNCHES["shard_body"] == 3 * n_dev
    assert _kernels.LAUNCHES["lane_scan_head"] == n_dev


def test_api_sharded_one_rank_on_card(cuda) -> None:
    """backend="sharded" with no process group: a world of one rank on the
    card, through K2 with a head, Teddy and the batch kernel."""
    names = [n.decode() for n in _names(91, 50)]
    hay = _corpus(92, 3 << 20, [n.encode() for n in names], 3000).decode()
    docs = [hay[i : i + 600] for i in range(0, 600 * 4000, 600)]
    host = AhoCorasick(names, backend="native", device=cuda)
    for teddy, tier, btier in (("auto", "teddy_sharded", "teddy_sharded_batch"),
                               ("off", "sharded", "sharded_batch")):
        _kernels.reset_launches()
        ac = AhoCorasick(names, backend="sharded", device=cuda)
        ac._teddy_state = teddy
        assert ac.find_matches_as_indexes(hay) == host.find_matches_as_indexes(
            hay
        )
        assert ac.stats()["last_backend"] == tier
        assert ac.find_matches_as_indexes_batch(docs) == [
            host.find_matches_as_indexes(d) for d in docs
        ]
        assert ac.stats()["last_backend"] == btier
        assert _kernels.LAUNCHES["shard_body"] >= 2
        if teddy == "off":
            assert _kernels.LAUNCHES["lane_scan_head"] > 0
            assert _kernels.LAUNCHES["batch_scan"] > 0


@pytest.mark.parametrize("nblk", [1, 3, 32])
def test_probe_kernels_equal_plain(cuda, nblk: int) -> None:
    """P1 and P2 against their plain versions; P1 also against
    ``torch.amax``, and a misshapen input raises."""
    from ahocorasick_rs_tpu_torch.ops import probe

    rng = np.random.default_rng(nblk)
    x = torch.from_numpy(
        rng.integers(0, 256, (nblk * 1024, 128), dtype=np.uint8)
    ).to(cuda)
    _kernels.reset_launches()
    got = probe.reduce16(x)
    assert torch.equal(got, probe._reduce16_plain(x))
    assert torch.equal(got, torch.amax(x.view(-1, 16, 128), 1))
    assert torch.equal(probe.rollrows(x), probe._rollrows_plain(x))
    assert _kernels.LAUNCHES["probe_reduce"] == 1
    assert _kernels.LAUNCHES["probe_rollrows"] == 1
    with pytest.raises(ValueError, match="multiple of 1024"):
        probe.reduce16(x[:1000].contiguous())


@pytest.mark.parametrize("config", [(6, 4, 2), (8, 8, 2), (3, 1, 1)], ids=str)
def test_fire_kernel_every_tile_equals_plain(cuda, config) -> None:
    from ahocorasick_rs_tpu_torch.tools.probe_transpose_kernel import (
        SWEEP_TILES,
    )

    m, words, passes = config
    names = _names(m * words + passes + 100, 80)
    pf = build_prefilter_config(names, m, words, passes)
    for n in (100, 300_001):
        arr = np.frombuffer(_corpus(n, n, names, n // 300 + 1), np.uint8)
        hay2d = scan_teddy.TeddyScanner.stage(
            type("S", (), {"device": cuda})(), arr
        )
        tables = torch.from_numpy(pf.tables).to(cuda)
        want = scan_teddy._fire_mask_plain(tables, hay2d, m, words, passes)
        for tile in SWEEP_TILES:
            got = scan_teddy.fire_mask(tables, hay2d, m, words, passes, tile)
            assert torch.equal(got, want), tile
    for bad in (100, 4097, 1 << 17):
        with pytest.raises(ValueError, match="tile"):
            _kernels.fire(tables, hay2d, m, words, passes, bad)


def test_streamed_equals_whole_buffer_five_times(cuda) -> None:
    """Streamed Teddy (segments staged on the side copy stream) against
    one whole-buffer pass on the card, five times in a row."""
    names = _names(101, 200)
    am = build_automaton(names)
    hay = np.frombuffer(_corpus(102, 8 << 20, names, 20_000), np.uint8)
    tabs = scan_cuda.DeviceTables(am, "dfa", cuda)
    sc = scan_teddy.TeddyScanner(
        am, build_prefilter(names), tabs.table, tabs.classes,
        tabs.match_count, tabs.use_classes,
    )
    want = sc.occurrences(hay)
    assert want is not None and len(want[0]) > 10_000
    for _ in range(5):
        got = sc.occurrences_streamed(hay, seg_bytes=2 << 20)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert sc._copy_stream is not None


def test_tune_and_load_on_card(cuda, tmp_path) -> None:
    """tune() on the card launches K1 at every candidate's shape, and a
    saved matcher loads on the card by default with the same tuples."""
    from ahocorasick_rs_tpu_torch import load_matcher, save_matcher

    names = [n.decode() for n in _names(111, 50)]
    hay = _corpus(112, 3 << 20, [n.encode() for n in names], 3000).decode()
    ac = AhoCorasick(names, backend="device", device=cuda)
    _kernels.reset_launches()
    report = ac.tune(hay)
    assert isinstance(report["chosen"], dict)
    for c in report["candidates"]:
        assert _kernels.FIRE_CONFIGS[(c["m"], c["words"], c["passes"])] > 0
    want = AhoCorasick(names, backend="native", device=cuda)
    assert ac.find_matches_as_indexes(hay) == want.find_matches_as_indexes(hay)
    path = str(tmp_path / "m.npz")
    save_matcher(path, ac)
    loaded = load_matcher(path)
    assert loaded._device.type == "cuda"
    assert loaded.find_matches_as_indexes(hay) == ac.find_matches_as_indexes(
        hay
    )
    assert loaded.stats()["last_backend"] == "teddy"
