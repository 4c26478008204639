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
from ahocorasick_rs_tpu_torch.parallel import sharded

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


#: K3's chunk: the mask bytes of one block
K3_CHUNK = 16384
#: traces :func:`_traced_kernels` takes again after one with no kernel
#: event at all (``torch.profiler`` returned such a trace once in two full
#: runs of this file)
TRACE_RETRIES = 3


def _traced_kernels(fn) -> tuple[list[str], dict[str, int]]:
    """The CUDA kernels (copies and fills left out) that ``torch.profiler``
    saw one call of ``fn`` run, and the launch counters' change over that
    call.  A trace with no kernel event at all is taken again, with a new
    call, at most :data:`TRACE_RETRIES` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(1 + TRACE_RETRIES):
        before = dict(_kernels.LAUNCHES)
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
    return kernels, {k: v - before[k] for k, v in _kernels.LAUNCHES.items()}


@pytest.mark.parametrize(
    "n", [0, 1, 15, 16, K3_CHUNK - 1, K3_CHUNK, K3_CHUNK + 1, 100_003]
)
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


def test_compact_kernel_chunk_and_one_launch(cuda) -> None:
    """The kernel's chunk is the one the tests assume, and a call is one
    kernel on the card (the profiler sees nothing else once the look-back
    scratch exists)."""
    assert _kernels.build()["scan"].ac_compact_chunk() == K3_CHUNK
    mask = torch.from_numpy(
        np.random.default_rng(3).random(1 << 20) < 0.01
    ).to(cuda).view(torch.uint8)
    _kernels.compact(mask, 4096)
    torch.cuda.synchronize()
    kernels, launched = _traced_kernels(lambda: _kernels.compact(mask, 4096))
    assert kernels == ["compact_kernel"] or (
        len(kernels) == 1 and "compact_kernel" in kernels[0]
    ), kernels
    assert launched["compact"] == 1


def test_compact_kernel_repeated_calls(cuda) -> None:
    """Fifty calls in a row on random masks, sizes and caps reuse one
    look-back scratch: an earlier call's status words (the same chunks,
    now stale) must never read as ready."""
    rng = np.random.default_rng(77)
    for i in range(50):
        n = int(rng.integers(0, 400_000)) if i % 5 else 300_000
        mask = torch.from_numpy(
            rng.random(n) < float(rng.choice([0.0005, 0.02, 0.5]))
        ).to(cuda)
        cap = int(rng.choice([1, 64, 4096, 1 << 17]))
        idx, total = scan_cuda.compact_sparse(mask, cap)
        want_idx, want_total = scan_cuda._compact_plain(mask, cap)
        assert int(total) == int(want_total), i
        assert torch.equal(idx, want_idx), i


def test_compact_kernel_epoch_wraps(cuda) -> None:
    """At the last epoch the scratch is made anew (zeroed), and the calls
    on either side of it stay exact."""
    mask = torch.from_numpy(
        np.random.default_rng(5).random(200_000) < 0.01
    ).to(cuda)
    want = scan_cuda._compact_plain(mask, 4096)
    _kernels.compact(mask.view(torch.uint8), 4096)
    key = next(k for k in _kernels._COMPACT_SCRATCH if k[0] == cuda.index)
    _kernels._COMPACT_SCRATCH[key][1] = _kernels.COMPACT_EPOCH_MAX - 2
    for _ in range(4):
        idx, total = _kernels.compact(mask.view(torch.uint8), 4096)
        assert int(total) == int(want[1]) and torch.equal(idx, want[0])
    assert _kernels._COMPACT_SCRATCH[key][1] < 10


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
    st, mask = scan_cuda.scan_lanes(*args, flagged=tabs.lane_table())
    st_p, mask_p = scan_cuda._lane_scan_plain(*args)
    _assert_lane_scan_equal((st, mask), (st_p, mask_p))


def _assert_lane_scan_equal(got, want) -> None:
    """K2's contract: the mask bit-equal, the states equal where it is 1
    (the kernel writes states nowhere else)."""
    (st, mask), (st_p, mask_p) = got, want
    assert torch.equal(mask, mask_p)
    hit = mask_p.bool()
    assert torch.equal(st[hit], st_p[hit])


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
    packed = _kernels.pack_fire_tables(tables, m, words, passes)
    got = scan_teddy.fire_mask(tables, hay2d, m, words, passes, packed=packed)
    want = scan_teddy._fire_mask_plain(tables, hay2d, m, words, passes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_kernel_equals_plain(cuda, engine: str) -> None:
    names = _names(7, 40)
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    pf = build_prefilter(names)
    sc = scan_teddy.TeddyScanner(am, pf, tabs)
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


def _verify_setup(cuda, names, engine: str, n: int, seed: int,
                  windows: int = 1000, plant: int | None = None):
    """K4's inputs on the card: the automaton's flagged table, an ``n``-byte
    corpus with ``plant`` names (``n // 150`` by default), and ``windows``
    fired groups (ascending, the last group among them) in a -1 padded
    ``fire_pos``."""
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    plant = n // 150 + 2 if plant is None else plant
    buf = np.frombuffer(_corpus(seed, n, names, plant), np.uint8).copy()
    G = -(-n // scan_teddy.COARSE)
    rng = np.random.default_rng(seed)
    groups = np.sort(rng.choice(G - 1, min(windows, G - 1), replace=False))
    fp = np.full(scan_teddy._bucket(len(groups) + 1), -1, np.int32)
    fp[: len(groups)] = groups * scan_teddy.COARSE
    fp[len(groups)] = (G - 1) * scan_teddy.COARSE  # holds byte n - 1
    W = am.max_len + scan_teddy.COARSE - 1
    hay = torch.from_numpy(buf).to(cuda)
    return am, tabs, hay, torch.from_numpy(fp).to(cuda), W


def _assert_body_equals_plain(tabs, hay, fire_pos, n, W, cap2, got=None):
    """The card's ``_verify_body`` (K4, one launch) equals the plain one on
    CPU copies of the same inputs, in all four outputs (padding too)."""
    if got is None:
        got = scan_teddy._verify_body(
            tabs.lane_table(), tabs.classes, hay, fire_pos, n, W, cap2,
            tabs.use_classes,
        )
    want = scan_teddy._verify_body(
        tabs.lane_table().cpu(), tabs.classes.cpu(), hay.cpu(),
        fire_pos.cpu(), n, W, cap2, tabs.use_classes,
    )
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    return int(want[3])


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_body_kernel_equals_plain(cuda, engine: str) -> None:
    """One ``verify`` launch and no ``compact`` a call; bit-equal at cap2
    above and below the total, at the planned pieces and at every count
    the wrapper takes up to 8."""
    names = _names(7, 40)
    n = 50_001
    am, tabs, hay, fire_pos, W = _verify_setup(cuda, names, engine, n, 8)
    before = dict(_kernels.LAUNCHES)
    total = _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 4096)
    assert _kernels.LAUNCHES["verify"] == before["verify"] + 1
    assert _kernels.LAUNCHES["compact"] == before["compact"]
    assert 8 < total < 4096
    _assert_body_equals_plain(tabs, hay, fire_pos, n, W, total // 3)
    for k in range(1, 9):
        got = _kernels.verify_body(
            tabs.lane_table(), tabs.classes, hay, fire_pos, n, W, 4096,
            tabs.use_classes, halo=am.max_len - 1, pieces=k,
        )
        _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 4096, got)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_walk_kernel_every_piece_count(cuda, engine: str) -> None:
    """The walk-only instantiation of the fused kernel equals the plain
    walk at every piece count, fire_pos < 0 windows included."""
    names = _names(17, 40)
    n = 30_000
    am, tabs, hay, fire_pos, W = _verify_setup(cuda, names, engine, n, 9)
    args = (tabs.lane_table(), tabs.classes, hay, fire_pos, n, W,
            tabs.use_classes)
    want = scan_teddy._verify_walk_plain(*args)
    for k in range(1, 9):
        got = _kernels.verify(*args, halo=am.max_len - 1, pieces=k)
        assert torch.equal(got, want), k
    assert torch.equal(_kernels.verify(*args), want)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_verify_body_kernel_unaligned_view(cuda, offset: int) -> None:
    """A haystack view off the 16-byte alignment takes byte loads."""
    names = _names(27, 40)
    n = 40_000
    _, tabs, base, fire_pos, W = _verify_setup(
        cuda, names, "dfa", n + offset, 10)
    hay = base[offset:]
    _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 4096)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_body_kernel_window_ends_at_buffer_end(cuda, engine) -> None:
    """The last window ends at the buffer's last byte (n equal to the
    buffer, not a multiple of 16), so its last 16-byte piece would run
    past it; and a sharded rank's ``hay_pad``, which ends ``VCHUNK`` bytes
    after the right neighbour's head."""
    names = _names(37, 40)
    am = build_automaton(names)
    W = am.max_len + scan_teddy.COARSE - 1
    n = 32 * 700 + W
    _, tabs, hay, fire_pos, _ = _verify_setup(cuda, names, engine, n, 11)
    fp = fire_pos.clone()
    fp[-1] = 32 * 700  # its window ends at byte n - 1
    assert n % 16 and int(fp[-1]) + W == hay.numel()
    _assert_body_equals_plain(tabs, hay, fp, n, W, 4096)
    LT = 32 * 512
    _, Hr = sharded.teddy_layout(2 * LT, 2, W)
    shard, right = hay[:LT], hay[LT : LT + Hr]
    hay_pad = torch.cat([shard, right, shard.new_zeros(scan_teddy.VCHUNK)])
    nv = hay_pad.numel()
    fp2 = torch.full((1024,), -1, dtype=torch.int32, device=cuda)
    fp2[:512] = torch.arange(512, device=cuda, dtype=torch.int32) * 32
    fp2[512] = nv - W  # ends at hay_pad's last byte
    _assert_body_equals_plain(tabs, hay_pad, fp2, nv, W, 8192)


def test_verify_body_kernel_overflow_and_retry(cuda) -> None:
    """cap2 below the total: the total stays exact and the first cap2
    matched steps are written; ``TeddyScanner.occurrences`` grows cap2
    from 4,096 and ends equal to the CPU scanner."""
    names = _names(47, 60)
    n = 300_000
    _, tabs, hay, fire_pos, W = _verify_setup(
        cuda, names, "dfa", n, 12, windows=9000, plant=n // 40)
    total = _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 1 << 15)
    assert total > 4096
    for cap2 in (1, 4096, total - 1):
        _assert_body_equals_plain(tabs, hay, fire_pos, n, W, cap2)
    am = build_automaton(names)
    pf = build_prefilter(names)
    # 20,000 names in 2 MB: about 25,000 matched steps, fired groups well
    # under the dense tier's threshold
    dense = np.frombuffer(_corpus(13, 2_000_000, names, 20_000), np.uint8)
    scanners = [scan_teddy.TeddyScanner(am, pf, scan_cuda.DeviceTables(
        am, "dfa", d)) for d in ("cpu", cuda)]
    want, got = (sc.occurrences(dense) for sc in scanners)
    assert scanners[1].match_cap > 4096
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("streams", [1, 2])
def test_verify_body_kernel_interleaved_with_compact(cuda, streams) -> None:
    """Twenty calls interleaved with K3 on one stream, then alternating
    between two: K3's and K4's launches share each stream's look-back
    scratch, and their epochs must follow the launches' order."""
    names = _names(57, 40)
    n = 60_000
    _, tabs, hay, fire_pos, W = _verify_setup(cuda, names, "classed", n, 14)
    args = (tabs.lane_table(), tabs.classes, hay, fire_pos, n, W)
    want = [scan_teddy._verify_body(
        *(a.cpu() if torch.is_tensor(a) else a for a in args), cap2,
        tabs.use_classes) for cap2 in (64, 4096)]
    rng = np.random.default_rng(15)
    mask = torch.from_numpy(rng.random(200_000) < 0.01).to(cuda)
    want_c = [x.cpu() for x in scan_cuda._compact_plain(mask, 4096)]
    side = [torch.cuda.current_stream(cuda)] + [
        torch.cuda.Stream(cuda) for _ in range(streams - 1)]
    outs = []
    for i in range(20):
        s = side[i % streams]
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            body = scan_teddy._verify_body(
                *args, (64, 4096)[i % 2], tabs.use_classes)
            comp = _kernels.compact(mask.view(torch.uint8), 4096)
        outs.append((i, body, comp))
    torch.cuda.synchronize()
    for i, body, comp in outs:
        for a, b in zip(body, want[i % 2]):
            assert torch.equal(a.cpu(), b), i
        assert torch.equal(comp[0].cpu(), want_c[0]), i
        assert int(comp[1]) == int(want_c[1]), i


@pytest.mark.parametrize("case", ["long", "halo0"])
@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_verify_body_kernel_long_and_one_byte(cuda, case, engine) -> None:
    """max_len above COARSE (W = 71 > 63, the halo 39) and one-byte
    patterns (halo 0, match-dense: pieces walk again past their slots)."""
    names = (_names(67, 30) + [b"abcdefgh" * 5] if case == "long"
             else [b"a", b"c", b"h"])
    n = 20_000
    am, tabs, hay, fire_pos, W = _verify_setup(
        cuda, names, engine, n, 16, windows=400)
    assert (W > 63) if case == "long" else am.max_len == 1
    total = _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 1 << 15)
    _assert_body_equals_plain(tabs, hay, fire_pos, n, W, max(1, total // 2))
    for k in (1, 2, 5, 8):
        got = _kernels.verify_body(
            tabs.lane_table(), tabs.classes, hay, fire_pos, n, W, 1 << 15,
            tabs.use_classes, halo=am.max_len - 1, pieces=k,
        )
        _assert_body_equals_plain(tabs, hay, fire_pos, n, W, 1 << 15, got)


def test_verify_body_kernel_is_one_launch(cuda) -> None:
    """Ten ``_verify_body`` calls on the card are ten ``verify`` launches
    and no ``compact``, and the profiler sees K4's kernel alone, at most
    once a call (it can lose the record of a kernel this short)."""
    names = _names(77, 40)
    n = 50_000
    _, tabs, hay, fire_pos, W = _verify_setup(cuda, names, "dfa", n, 17)
    args = (tabs.lane_table(), tabs.classes, hay, fire_pos, n, W, 4096,
            tabs.use_classes)
    scan_teddy._verify_body(*args)
    torch.cuda.synchronize()

    def ten_calls() -> None:
        for _ in range(10):
            scan_teddy._verify_body(*args)

    kernels, launched = _traced_kernels(ten_calls)
    assert 1 <= len(kernels) <= 10, kernels
    assert all("verify_kernel" in k for k in kernels), kernels
    assert launched["verify"] == 10
    assert launched["compact"] == 0


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
        scan_teddy.TeddyScanner(am, pf, t) for t in (cpu_t, gpu_t)
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
    args = (tabs.packed2, tabs.table_classed, tabs.classes2, hay, n, L, T,
            halo)
    got = scan_cuda.stride2_scan(*args)
    want = scan_cuda._stride2_scan_plain(*args)
    _assert_lane_scan_equal(got, want)
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
    args = (tabs.sparse, hay, n, L, T, halo)
    _assert_lane_scan_equal(
        scan_cuda.sparse_scan(*args), scan_cuda._sparse_scan_plain(*args)
    )


#: K7's search paths: "wide" gives states of 26 edges (several 16-byte
#: windows) and one of 70 (binary search), also inside fail chains
#: ("xd", "yab"), "window" runs of 1-8 edges that cross 16-byte boundaries
#: of the label array, "bytes" edges on all 256 bytes at the root with NUL
#: and 0xff inside patterns
K7_NAMES = {
    "wide": [bytes([a, b]) + b"q" for a in b"abc" for b in
             b"abcdefghijklmnopqrstuvwxyz"]
    + [b"d" + bytes([c]) + b"z" for c in range(40, 110)]
    + [b"xd", b"yab"] + _names(33, 40),
    "window": _names(34, 300),
    "bytes": [bytes([i, (i * 5 + 1) % 256]) for i in range(256)]
    + [b"\x00\xffab", b"\xff\x00"],
}
#: haystack bytes of each K7 case
K7_ALPHABET = {
    "wide": bytes(range(40, 123)) + b" ",
    "window": b"abcdefghijklmnopqrstuvwxyz q",
    "bytes": bytes(range(256)),
}


@pytest.mark.parametrize("case", sorted(K7_NAMES))
def test_sparse_kernel_equals_k2_every_sublane(cuda, case: str) -> None:
    """K7 at every sub-lane length its wrapper takes, equal to its plain
    version and to K2 over the classed table of the same automaton at the
    same layout and halo (mask bit-equal, states at the mask), also on a
    haystack one byte off its alignment."""
    names = K7_NAMES[case]
    am = build_automaton(names)
    sp = scan_cuda.DeviceTables(am, "sparse", cuda)
    cls = scan_cuda.DeviceTables(am, "classed", cuda)
    halo = am.max_len - 1
    L, T = 64, 512
    n = L * T - 333
    alphabet = K7_ALPHABET[case]
    rng = np.random.default_rng(len(names))
    buf = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), L * T)].copy()
    longest = np.frombuffer(max(names, key=len), np.uint8)
    for m in range(1, L * T // 64):  # matches across sub-lane starts
        end = 64 * m + (m % 3)
        buf[end + 1 - len(longest) : end + 1] = longest
    hay = torch.from_numpy(buf).to(cuda)
    args = (sp.sparse, hay, n, L, T, halo)
    want = scan_cuda._sparse_scan_plain(*args)
    assert int(want[1].sum()) > 100
    for S in _sublane_lengths(T, halo, batch=False):
        _assert_lane_scan_equal(_kernels._sparse_scan_at(S, *args), want)
    got = _kernels.sparse_scan(*args)
    _assert_lane_scan_equal(got, want)
    _assert_lane_scan_equal(
        _kernels.lane_scan(cls.lane_table(), cls.classes, hay, n, L, T, halo,
                           cls.use_classes),
        got,
    )
    _assert_lane_scan_equal(
        _kernels.sparse_scan(sp.sparse, _byte_off(hay), n, L, T, halo), want
    )
    with pytest.raises(ValueError, match="sub-lanes"):
        _kernels._sparse_scan_at(24, *args)


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
    got = scan_cuda.scan_batch(*args, tabs.lane_table(), tabs.halo)
    _assert_lane_scan_equal(got, scan_cuda._batch_scan_plain(*args))
    want = scan_cuda.scan_device_batch(
        am, docs, scan_cuda.DeviceTables(am, engine, "cpu")
    )
    got = scan_cuda.scan_device_batch(am, docs, tabs)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)


def _sublane_lengths(T: int, halo: int, batch: bool) -> list[int]:
    """Every sub-lane length the K5 (``batch``) or K2/K6 wrapper takes."""
    return [
        S for S in range(16, T + 1, 16)
        if T % S == 0 and S >= (min(halo, T - S) if batch else halo)
    ]


def _byte_off(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` viewed one byte off its allocation's alignment."""
    base = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    base[1:] = x.reshape(-1)
    view = base[1:].view(x.shape)
    assert view.data_ptr() % 16
    return view


#: (T, names) of the K5 layouts: T = 16, halo 0 (one-byte names), halo
#: T - 1, a halo past T, odd and even halos over longer rows
BATCH_CASES = {
    "T16-halo0": (16, [b"a", b"c", b"h"]),
    "T16-halo15": (16, _names(42, 30) + [b"abcdefghabcdefgh"]),
    "T64-halo63": (64, _names(43, 30) + [b"abcdefgh" * 8]),
    "T64-halo80": (64, _names(44, 30) + [b"abcdefgh" * 10 + b"a"]),
    "T256-halo15": (256, _names(45, 30) + [b"abcdefghabcdefgh"]),
    "T1024-halo14": (1024, _names(46, 30) + [b"abcdefghabcdefg"]),
}


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_kernel_every_sublane(cuda, engine: str, case: str) -> None:
    """K5 at every sub-lane length its wrapper takes for the row length,
    with lens 0, 1, odd and T and padding bytes that are not zero, equal
    to the plain version (mask bit-equal, states at the mask), also on a
    buffer one byte off its alignment (the kernel's byte-copy path)."""
    T, names = BATCH_CASES[case]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    B = 45
    rng = np.random.default_rng(T + len(names))
    buf = np.frombuffer(_corpus(T, B * T, names, B * T // 40 + 1),
                        np.uint8).reshape(B, T).copy()
    # in row b the longest name ends at the b-th multiple of 16 (cycling):
    # a match whose first byte is the last a sub-lane's warm-up reaches
    longest = np.frombuffer(max(names, key=len), np.uint8)
    for b in range(B):
        end = 16 * (b % (T // 16))
        if end + 1 >= len(longest):
            buf[b, end + 1 - len(longest) : end + 1] = longest
    lens = rng.integers(0, T + 1, B).astype(np.int32)
    lens[4::2] = T
    lens[:4] = (0, 1, T, T - 1)  # T - 1 is odd
    hay = torch.from_numpy(buf).to(cuda)
    lens_d = torch.from_numpy(lens).to(cuda)
    want = scan_cuda._batch_scan_plain(
        tabs.table, tabs.classes, hay, lens_d, tabs.match_count,
        tabs.use_classes,
    )
    assert int(want[1].sum()) > 0
    kern = (tabs.lane_table(), tabs.classes, hay, lens_d, tabs.halo,
            tabs.use_classes)
    for S in _sublane_lengths(T, tabs.halo, batch=True):
        _assert_lane_scan_equal(_kernels._batch_scan_at(S, *kern), want)
    _assert_lane_scan_equal(_kernels.batch_scan(*kern), want)
    view = (kern[0], kern[1], _byte_off(hay), *kern[3:])
    _assert_lane_scan_equal(_kernels.batch_scan(*view), want)
    with pytest.raises(ValueError, match="sub-lanes"):
        _kernels._batch_scan_at(24, *kern)


def test_batch_kernel_sharded_row_block(cuda) -> None:
    """K5 over one rank's row block (a view into the whole buffer, at an
    offset and one byte off) equals the same rows of the whole launch."""
    names = _names(47, 40) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, "dfa", cuda)
    B, T = 4096, 256
    rng = np.random.default_rng(47)
    buf = np.frombuffer(_corpus(48, B * T, names, 4000), np.uint8).reshape(
        B, T).copy()
    lens = rng.integers(0, T + 1, B).astype(np.int32)
    hay = torch.from_numpy(buf).to(cuda)
    lens_d = torch.from_numpy(lens).to(cuda)
    flagged = tabs.lane_table()
    st, mask = _kernels.batch_scan(flagged, tabs.classes, hay, lens_d,
                                   tabs.halo, tabs.use_classes)
    lo, hi = B // 4, B // 2
    rows = slice(lo * T, hi * T)
    for block in (hay[lo:hi], _byte_off(hay[lo:hi])):
        got = _kernels.batch_scan(flagged, tabs.classes, block,
                                  lens_d[lo:hi], tabs.halo, tabs.use_classes)
        _assert_lane_scan_equal(got, (st[rows], mask[rows]))
    assert int(mask[rows].sum()) > 100


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("halo_kind", sorted(HALO_NAMES))
def test_stride2_kernel_every_sublane_and_k2(
    cuda, engine: str, halo_kind: str
) -> None:
    """K6 at every sub-lane length its wrapper takes, equal to its plain
    version and to K2 at the same layout and even halo (mask bit-equal,
    states at the mask), also on a haystack one byte off its alignment;
    n odd."""
    names = HALO_NAMES[halo_kind]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    assert tabs.ensure_packed2()
    halo = am.max_len - 1
    halo += halo & 1
    L, T = 64, 512
    n = L * T - 777
    buf = np.frombuffer(_corpus(91, L * T, names, 600), np.uint8).copy()
    # the longest name ending at sub-lane starts (multiples of 16) and one
    # byte after them: matches whose first bytes the warm-up must reach
    longest = np.frombuffer(max(names, key=len), np.uint8)
    for m in range(1, L * T // 48):
        end = 48 * m + (m % 2)
        buf[end + 1 - len(longest) : end + 1] = longest
    hay = torch.from_numpy(buf).to(cuda)
    args = (tabs.packed2, tabs.table_classed, tabs.classes2, hay, n, L, T,
            halo)
    want = scan_cuda._stride2_scan_plain(*args)
    assert int(want[1].sum()) > 100
    for S in _sublane_lengths(T, halo, batch=False):
        _assert_lane_scan_equal(_kernels._stride2_scan_at(S, *args), want)
    got = _kernels.stride2_scan(*args)
    _assert_lane_scan_equal(got, want)
    _assert_lane_scan_equal(
        _kernels.lane_scan(tabs.lane_table(), tabs.classes, hay, n, L, T,
                           halo, tabs.use_classes),
        got,
    )
    view = (*args[:3], _byte_off(hay), *args[4:])
    _assert_lane_scan_equal(_kernels.stride2_scan(*view), want)
    with pytest.raises(ValueError, match="sub-lanes"):
        _kernels._stride2_scan_at(24, *args)


def test_stride2_kernel_match_dense(cuda) -> None:
    """K6 where almost every byte matches (nested patterns over 'a'): a
    state at nearly every position, equal to the plain version and K2,
    and scan_device still raises MatchDenseError."""
    from ahocorasick_rs_tpu_torch.ops.resolve import MatchDenseError

    am = build_automaton([b"a" * k for k in range(1, 21)])
    tabs = scan_cuda.DeviceTables(am, "dfa", cuda)
    assert tabs.ensure_packed2()
    halo = am.max_len - 1 + ((am.max_len - 1) & 1)
    L, T = 256, 512
    n = L * T - 5
    hay = torch.full((L * T,), ord("a"), dtype=torch.uint8, device=cuda)
    args = (tabs.packed2, tabs.table_classed, tabs.classes2, hay, n, L, T,
            halo)
    got = _kernels.stride2_scan(*args)
    _assert_lane_scan_equal(got, scan_cuda._stride2_scan_plain(*args))
    _assert_lane_scan_equal(
        _kernels.lane_scan(tabs.lane_table(), tabs.classes, hay, n, L, T,
                           halo, tabs.use_classes),
        got,
    )
    assert int(got[1].sum()) == n
    text = np.full(8 << 20, ord("a"), np.uint8)
    with pytest.raises(MatchDenseError):
        scan_cuda.scan_device(am, text, tabs)


def test_lane_scans_every_carveout(cuda) -> None:
    """K2, K5, K6 and K7 at each shared-memory carveout (the L1 split changes
    only their speed) equal their own default launch; a carveout past
    100 percent is refused."""
    names = _names(49, 40) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, "classed", cuda)
    assert tabs.ensure_packed2()
    halo = am.max_len - 1 + ((am.max_len - 1) & 1)
    L, T = 64, 1024
    n = L * T - 99
    hay = torch.from_numpy(
        np.frombuffer(_corpus(50, L * T, names, 800), np.uint8).copy()
    ).to(cuda)
    lens = torch.from_numpy(
        np.random.default_rng(50).integers(0, T + 1, L).astype(np.int32)
    ).to(cuda)
    calls = {
        "K2": (_kernels._lane_scan_at, 64, (
            tabs.lane_table(), tabs.classes, hay, n, L, T, halo,
            tabs.use_classes)),
        "K5": (_kernels._batch_scan_at, 64, (
            tabs.lane_table(), tabs.classes, hay.view(L, T), lens, tabs.halo,
            tabs.use_classes)),
        "K6": (_kernels._stride2_scan_at, 64, (
            tabs.packed2, tabs.table_classed, tabs.classes2, hay, n, L, T,
            halo)),
        "K7": (_kernels._sparse_scan_at, 64, (
            scan_cuda.DeviceTables(am, "sparse", cuda).sparse, hay, n, L, T,
            am.max_len - 1)),
    }
    for name, (kernel, S, args) in calls.items():
        want = kernel(S, *args)
        assert int(want[1].sum()) > 100, name
        for c in (0, 28, 43, 57, 71, 85, 100):
            _assert_lane_scan_equal(kernel(S, *args, carveout=c), want)
        with pytest.raises(RuntimeError, match="failed with error"):
            kernel(S, *args, carveout=101)


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
    kargs = (tabs.lane_table(), tabs.classes, hay, n, L, T, halo,
             tabs.use_classes)
    pad = torch.full((halo,), PAD_BYTE, dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    with_pad = _kernels.lane_scan(*kargs, head=pad)
    without = _kernels.lane_scan(*kargs)
    _assert_lane_scan_equal(with_pad, without)
    assert _kernels.LAUNCHES["lane_scan_head"] == 1
    rng = np.random.default_rng(n)
    tail = np.frombuffer(b"abcdefghabcdefgh", np.uint8)[-halo:].astype(np.int32)
    for head_np in (tail, rng.integers(0, 257, halo).astype(np.int32)):
        head = torch.from_numpy(head_np).to(cuda)
        got = scan_cuda.scan_lanes(*args, head=head, flagged=kargs[0])
        want = scan_cuda._lane_scan_plain(*args, head=head)
        _assert_lane_scan_equal(got, want)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_lane_scan_sharded_layout_with_head(cuda, engine: str) -> None:
    """K2 at a rank's sharded layout (8 lanes of 2**16 bytes) with a head:
    equal to the plain version at the split layout (4,096 lanes of 128
    bytes, which the CPU tests prove equal to the caller's), to the
    kernel with one walk a lane (sub-lanes of ``T`` bytes), and on an
    unaligned view."""
    names = _names(72, 40) + [b"abcdefghabcdefgh"]
    am = build_automaton(names)
    halo = am.max_len - 1
    L, T = 8, 1 << 16
    n = L * T - 12_345
    buf = np.frombuffer(_corpus(73, L * T, names, 3000), np.uint8).copy()
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    hay = torch.from_numpy(buf).to(cuda)
    head = torch.from_numpy(buf[-halo:].astype(np.int32)).to(cuda)
    common = (tabs.match_count, n)
    args = (tabs.table, tabs.classes, hay, *common, L, T, halo,
            tabs.use_classes)
    got = scan_cuda.scan_lanes(*args, head=head, flagged=tabs.lane_table())
    S = 128
    want = scan_cuda._lane_scan_plain(
        tabs.table, tabs.classes, hay, *common, L * T // S, S, halo,
        tabs.use_classes, head,
    )
    assert int(want[1].sum()) > 1000
    _assert_lane_scan_equal(got, want)
    flagged = tabs.lane_table()
    _assert_lane_scan_equal(_kernels._lane_scan_at(
        T, flagged, tabs.classes, hay, n, L, T, halo, tabs.use_classes, head
    ), want)
    base = torch.zeros(L * T + 1, dtype=torch.uint8, device=cuda)
    base[1:] = hay
    view = base[1:]  # one byte off the allocation's alignment
    assert view.data_ptr() % 16
    _assert_lane_scan_equal(
        _kernels.lane_scan(flagged, tabs.classes, view, n, L, T, halo,
                           tabs.use_classes, head=head),
        want,
    )
    with pytest.raises(ValueError, match="sub-lanes"):
        _kernels._lane_scan_at(
            24, flagged, tabs.classes, hay, n, L, T, halo, tabs.use_classes
        )


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_lane_scan_long_halo(cuda, engine: str) -> None:
    """K2 with a 601-byte pattern (halo 600, many warm-up rounds a
    sub-lane) at the single-device and a rank's sharded layout, with and
    without a head, against the plain version at sub-lanes of 1,024
    bytes; then backend="sharded" (one rank, K2 with a head) against the
    host tier."""
    rng = np.random.default_rng(74)
    long = bytes(rng.choice(np.frombuffer(b"abcdefgh", np.uint8), 601))
    names = _names(74, 40) + [long]
    am = build_automaton(names)
    halo = am.max_len - 1
    assert halo == 600
    tabs = scan_cuda.DeviceTables(am, engine, cuda)
    for L, T, n in ((128, 1024, 100_001), (8, 1 << 16, (8 << 16) - 777)):
        buf = bytearray(_corpus(75, L * T, names, n // 100))
        for off in range(0, n - 601, n // 7):
            buf[off : off + 601] = long  # whole long matches, seams included
        hay = torch.from_numpy(np.frombuffer(bytes(buf), np.uint8).copy()).to(
            cuda
        )
        head = torch.from_numpy(
            rng.integers(0, 257, halo).astype(np.int32)
        ).to(cuda)
        for h in (None, head):
            got = _kernels.lane_scan(tabs.lane_table(), tabs.classes, hay, n,
                                     L, T, halo, tabs.use_classes, h)
            want = scan_cuda._lane_scan_plain(
                tabs.table, tabs.classes, hay, tabs.match_count, n,
                L * T // 1024, 1024, halo, tabs.use_classes, h,
            )
            assert int(want[1].sum()) > 100
            _assert_lane_scan_equal(got, want)
    text = _corpus(76, 2 << 20, names, 2000).decode()
    text = text[:5000] + long.decode() + text[5000:]
    host = AhoCorasick([nm.decode() for nm in names], backend="native")
    ac = AhoCorasick([nm.decode() for nm in names], backend="sharded",
                     device=cuda)
    ac._teddy_state = "off"
    _kernels.reset_launches()
    assert ac.find_matches_as_indexes(text) == host.find_matches_as_indexes(
        text
    )
    assert ac.stats()["last_backend"] == "sharded"
    assert _kernels.LAUNCHES["lane_scan_head"] > 0


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
        dev: scan_teddy.TeddyScanner(am, pf, t) for dev, t in tabs.items()
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
        packed = scan_teddy.pack_fire_tables(tables, m, words, passes)
        for tile in SWEEP_TILES:
            got = scan_teddy.fire_mask(tables, hay2d, m, words, passes, tile,
                                       packed)
            assert torch.equal(got, want), tile
    # N a tile less or more one, on an aligned buffer and on a view one
    # byte off (the kernel's byte-copy path)
    for tile in SWEEP_TILES:
        for n in (tile - 1, tile + 1):
            arr = np.frombuffer(_corpus(n, n, names, n // 300 + 1), np.uint8)
            flat = torch.from_numpy(arr.copy()).to(cuda)
            base = torch.zeros(n + 1, dtype=torch.uint8, device=cuda)
            base[1:] = flat
            want = scan_teddy._fire_mask_plain(tables, flat, m, words, passes)
            for hay in (flat, base[1:]):
                got = _kernels.fire(packed, hay, m, words, passes, tile)
                assert torch.equal(got, want), (tile, n, hay.data_ptr() % 16)
    for bad in (100, 4097, 1 << 17):
        with pytest.raises(ValueError, match="tile"):
            _kernels.fire(packed, hay2d, m, words, passes, bad)
    with pytest.raises(ValueError, match="packed tables"):
        scan_teddy.fire_mask(tables, hay2d, m, words, passes)


def test_streamed_equals_whole_buffer_five_times(cuda) -> None:
    """Streamed Teddy (segments staged on the side copy stream) against
    one whole-buffer pass on the card, five times in a row."""
    names = _names(101, 200)
    am = build_automaton(names)
    hay = np.frombuffer(_corpus(102, 8 << 20, names, 20_000), np.uint8)
    tabs = scan_cuda.DeviceTables(am, "dfa", cuda)
    sc = scan_teddy.TeddyScanner(am, build_prefilter(names), tabs)
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


def test_conformance_sweep_first_cases(cuda, tmp_path) -> None:
    """The conformance tool on the card: parts A and B and the first 50
    cases of part C (seed 0), with its coverage check: no mismatch, and
    every kernel of the matcher's paths launched."""
    from ahocorasick_rs_tpu_torch.tools import gpu_conformance

    rec = gpu_conformance.run(cuda, cases=50, out=str(tmp_path / "c.json"),
                              verbose=False)
    assert rec["mismatches"] == []
    assert rec["uncovered"] == []
    assert rec["cases"] == 50
