"""PyTorch port, the one-process local mesh: ``make_mesh(devices=...)``
(``parallel/sharded.py`` ``LocalMesh``) runs the sharded scans on one
thread rank per device, and the public API with ``mesh=`` gives the JAX
package's sharded answers over ``make_mesh(k)`` on the conftest's virtual
CPU mesh (its Teddy fire kernel in Pallas interpret mode).

Inputs come from a seed; every comparison is exact tuple equality (all
outputs are integers).  The haystacks fill every rank, and a pattern
straddles every shard seam of the dense and the Teddy layouts.  Also
here: a rank that fails ends the call at once, ``make_mesh()`` raises
without a card, a matcher on the CPU keeps its one rank, and every
kernel launcher enters a guard for its tensors' device.
"""

from __future__ import annotations

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
import ahocorasick_rs_tpu.parallel.sharded as ref_sharded
import ahocorasick_rs_tpu_torch as port
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import build_prefilter
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy
from ahocorasick_rs_tpu_torch.parallel import sharded as port_sharded
from ahocorasick_rs_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the rank threads inherit it): the test files
    run in parallel worker processes that share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


KS = [1, 2, 3, 4, 8]
KINDS = ["Standard", "LeftmostFirst", "LeftmostLongest"]
ENGINES = ["DFA", "ContiguousNFA"]
PATTERNS = ["content", "disco", "disc", "discontent", "winter", "lo wo",
            "héllo", "wörld"]
#: planted across every shard seam; also a pattern itself
SEAM = "discontent"
#: each rank's bytes at the smallest dense and Teddy layouts: 512 lanes
#: of 16 bytes; 64 rows of 128 bytes
RANK_BYTES = 8192


def _text(seed: int, k: int) -> str:
    """About ``k`` ranks' bytes of seeded text (a partly filled last
    rank), with :data:`SEAM` across every seam of the dense and Teddy
    layouts (the same at this size)."""
    rng = random.Random(seed)
    n = k * RANK_BYTES - 100
    parts: list[str] = []
    while sum(len(p.encode()) for p in parts) < n:
        parts.append(rng.choice([
            "the winter of my discontent ", "hello world ", "disco disco ",
            "héllo wörld ",
        ] + ["filler text with no hits ", "quartz sphinx ", "jumbo "] * 4))
    hay = bytearray("".join(parts).encode()[:n])
    while hay[-1] >= 0x80:  # no cut code point at the end
        hay.pop()
    seam = SEAM.encode()
    halo = max(len(p.encode()) for p in PATTERNS) - 1
    W = halo + 1 + port_teddy.COARSE - 1
    dense_lt = 512 * port_sharded.dense_layout(len(hay), k, halo)[1]
    teddy_lt = 128 * port_sharded.teddy_layout(len(hay), k, W)[0]
    assert dense_lt == teddy_lt == RANK_BYTES
    assert (k - 1) * RANK_BYTES < len(hay) <= k * RANK_BYTES
    for d in range(1, k):
        off = d * RANK_BYTES - rng.randint(1, len(seam) - 1)
        # whole code points around it become 'x', then SEAM goes in
        a, b = off - 1, off + len(seam)
        while hay[a] & 0xC0 == 0x80:
            a -= 1
        while hay[b] & 0xC0 == 0x80:
            b += 1
        hay[a:b] = bytes(c if c < 0x80 else ord("x") for c in hay[a:b])
        hay[off : off + len(seam)] = seam
    return hay.decode()


def _docs(text: str) -> list[str]:
    """A batch: 0-700 characters a document, two of them empty."""
    rng = np.random.default_rng(len(text))
    cuts = np.sort(rng.integers(0, len(text), 40))
    docs = [text[a:b][:700] for a, b in zip(cuts[:-1], cuts[1:])]
    return docs + ["", "discontent"] + docs[:3] + [""]


def _seam_starts(text: str, k: int) -> set[int]:
    """The byte starts of the matches of :data:`SEAM` that straddle a
    seam."""
    hay = text.encode()
    seam = SEAM.encode()
    out = set()
    for d in range(1, k):
        s = d * RANK_BYTES
        i = hay.find(seam, s - len(seam) + 1)
        assert 0 <= i < s
        out.add(i)
    return out


def _ref_matcher(cls, pats, kind, engine, k, teddy):
    ac = cls(
        pats, matchkind=ref.MatchKind[kind],
        implementation=ref.Implementation[engine], backend="sharded",
        mesh=ref_sharded.make_mesh(k),
    )
    if teddy:
        ac._teddy_state = "force"
    return ac


def _port_matcher(cls, pats, kind, engine, mesh, teddy):
    ac = cls(
        pats, matchkind=port.MatchKind[kind],
        implementation=port.Implementation[engine], backend="sharded",
        mesh=mesh, device="cpu",
    )
    if teddy:
        ac._teddy_state = "force"
    return ac


@pytest.mark.parametrize("teddy", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", KS)
def test_api_local_mesh_equals_reference(k: int, engine: str, teddy: bool):
    """``AhoCorasick`` with ``mesh=make_mesh(devices=["cpu"] * k)``: the
    three match kinds, ``overlapping`` and a batch give the reference's
    tuples and tiers over ``make_mesh(k)``, matches across every seam
    included."""
    text = _text(10 * k + teddy, k)
    docs = _docs(text)
    mesh = port_sharded.make_mesh(devices=["cpu"] * k)
    assert isinstance(mesh, port_sharded.LocalMesh) and mesh.size == k
    tier = "teddy_sharded" if teddy else "sharded"
    for kind in KINDS:
        want_ac = _ref_matcher(ref.AhoCorasick, PATTERNS, kind, engine, k,
                               teddy)
        ac = _port_matcher(port.AhoCorasick, PATTERNS, kind, engine, mesh,
                           teddy)
        calls = [lambda a: a.find_matches_as_indexes(text)]
        if kind == "Standard":
            calls += [
                lambda a: a.find_matches_as_indexes(text, overlapping=True),
                lambda a: a.find_matches_as_indexes_batch(docs),
            ]
        tiers = []
        for call in calls:
            want = call(want_ac)
            assert call(ac) == want and want
            tiers.append(ac.stats()["last_backend"])
            assert tiers[-1] == want_ac.stats()["last_backend"]
        # the batch may leave Teddy where the reference does (fire rate)
        assert tiers[0] == tier and ac._mesh is mesh
    if k > 1:
        # every straddling SEAM is found (byte offsets: the bytes matcher)
        got = _port_matcher(
            port.BytesAhoCorasick, [p.encode() for p in PATTERNS],
            "Standard", engine, mesh, teddy,
        ).find_matches_as_indexes(text.encode(), overlapping=True)
        assert _seam_starts(text, k) <= {s for p, s, _ in got
                                         if p == PATTERNS.index(SEAM)}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", [2, 3])
def test_bytes_local_mesh_equals_reference(k: int, engine: str) -> None:
    """``BytesAhoCorasick`` on a local mesh, Teddy off and forced: the
    reference's tuples for both kinds of call."""
    hay = _text(40 + k, k).encode()
    docs = [d.encode() for d in _docs(hay.decode())]
    pats = [p.encode() for p in PATTERNS]
    mesh = port_sharded.make_mesh(devices=["cpu"] * k)
    for teddy in (False, True):
        want_ac = _ref_matcher(ref.BytesAhoCorasick, pats, "LeftmostLongest",
                               engine, k, teddy)
        ac = _port_matcher(port.BytesAhoCorasick, pats, "LeftmostLongest",
                           engine, mesh, teddy)
        assert ac.find_matches_as_indexes(hay) == (
            want_ac.find_matches_as_indexes(hay)
        )
        assert ac.find_matches_as_indexes_batch(docs) == (
            want_ac.find_matches_as_indexes_batch(docs)
        )
        assert ac.stats()["last_backend"] == (
            want_ac.stats()["last_backend"]
        )


def _port_automaton(am):
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


@pytest.mark.parametrize("k", [2, 4])
def test_scan_functions_take_a_local_mesh(k: int) -> None:
    """The scan functions called with a local mesh run every rank in one
    call: from small sticky caps, their outputs and the caps they leave
    equal the reference's; every rank copies the tables of its device
    (here the one CPU: the caller's own)."""
    pats = [p.encode() for p in PATTERNS]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    hay = np.frombuffer(_text(60 + k, k).encode(), np.uint8)
    mesh = port_sharded.make_mesh(devices=["cpu"] * k)
    rt = ref_scan.DeviceTables(ref_am, "dfa", packed2_max_bytes=0)
    rt.last_cap = 16
    want = ref_sharded.scan_sharded(ref_am, hay, rt, ref_sharded.make_mesh(k))
    tables = port_scan.DeviceTables(am, "dfa", "cpu")
    tables.last_cap = 16
    got = port_sharded.scan_sharded(am, hay, tables, mesh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tables.last_cap == rt.last_cap and tables.on("cpu") is tables

    rs = ref_teddy.TeddyScanner(
        ref_am, build_prefilter(pats), rt.table, rt.classes, rt.match_count,
        rt.use_classes,
    )
    rs.fire_cap, rs.match_cap = 64, 32
    want = ref_sharded.scan_sharded_teddy(
        ref_am, rs, hay, ref_sharded.make_mesh(k)
    )
    pf = build_prefilter(pats)
    sc = port_teddy.TeddyScanner(am, convert.prefilter_from_arrays(
        pf.m, pf.words, pf.passes, pf.tables, pf.bucket_of, pf.est_fire_rate,
    ), tables)
    sc.fire_cap, sc.match_cap = 64, 32
    got = port_sharded.scan_sharded_teddy(am, sc, hay, mesh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (sc.fire_cap, sc.match_cap, sc.worthwhile) == (
        rs.fire_cap, rs.match_cap, rs.worthwhile
    )
    assert sc.on("cpu") is sc


def _rank_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate()
            if t.name.startswith("ahocorasick-rank-")]


def _within(seconds: float, fn):
    """``fn()`` in a daemon thread that must end within ``seconds``: its
    result, or its exception raised here (a hang fails the test instead of
    stopping the run)."""
    out: dict = {}

    def work() -> None:
        try:
            out["value"] = fn()
        except Exception as e:  # raised below
            out["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    assert time.perf_counter() - t0 < seconds
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_failing_rank_ends_the_call_at_once() -> None:
    """A rank that raises fails ``run`` with its own error while the other
    ranks wait in an exchange: they stop at once (no timeout), and no rank
    thread is left."""
    mesh = port_sharded.make_mesh(devices=["cpu"] * 4)

    def fn(g):
        if g.rank == 2:
            time.sleep(0.2)  # the others are waiting in the exchange
            raise KeyError("rank 2 failed")
        for _ in range(3):
            g.all_gather(torch.zeros(3))
        return g.rank

    with pytest.raises(KeyError, match="rank 2 failed"):
        _within(10, lambda: mesh.run(fn))
    assert not _rank_threads()
    # the mesh runs again, and a rank's result comes back in rank order
    assert _within(10, lambda: mesh.run(
        lambda g: g.all_gather(torch.tensor([g.rank])).tolist()
    )) == [[[0], [1], [2], [3]]] * 4


def test_failing_rank_fails_the_api_call(monkeypatch) -> None:
    """Through the public API: one rank's body raises, and the call raises
    that error at once, with no rank thread left."""
    body = port_sharded.shard_scan_body

    def failing(tables, shard, head, n_local, offset, *args):
        if offset:  # rank 1 of 2
            raise RuntimeError("rank body failed")
        return body(tables, shard, head, n_local, offset, *args)

    monkeypatch.setattr(port_sharded, "shard_scan_body", failing)
    mesh = port_sharded.make_mesh(devices=["cpu"] * 2)
    ac = port.AhoCorasick(PATTERNS, backend="sharded", mesh=mesh, device="cpu")
    ac._teddy_state = "off"
    text = _text(1, 2)
    with pytest.raises(RuntimeError, match="rank body failed"):
        _within(10, lambda: ac.find_matches_as_indexes(text))
    assert not _rank_threads()


def test_make_mesh_needs_a_card_or_named_devices() -> None:
    """Without a card ``make_mesh()`` raises, as does a named CUDA device;
    named CPU devices make a local mesh of that many ranks."""
    assert not torch.cuda.is_available()
    for call in (lambda: port_sharded.make_mesh(),
                 lambda: port_sharded.make_mesh(2),
                 lambda: port_sharded.make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="at least one device"):
        port_sharded.make_mesh(devices=[])
    with pytest.raises(ValueError, match="CUDA or CPU devices"):
        port_sharded.make_mesh(devices=["meta"])
    mesh = port_sharded.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == [torch.device("cpu")] * 3
    assert port_sharded.as_group(mesh) is mesh


def test_cpu_matcher_keeps_one_rank() -> None:
    """``backend="sharded"`` on a matcher put on the CPU, with no mesh and
    no process group: a world of one rank, the reference's answer over a
    mesh of one device."""
    text = _text(3, 1)
    want_ac = _ref_matcher(ref.AhoCorasick, PATTERNS, "Standard", "DFA", 1,
                           False)
    ac = port.AhoCorasick(PATTERNS, backend="sharded", device="cpu")
    assert ac.find_matches_as_indexes(text) == (
        want_ac.find_matches_as_indexes(text)
    )
    assert ac.stats()["last_backend"] == "sharded"
    g = ac._shard_group()
    assert isinstance(g, port_sharded.ShardGroup)
    assert (g.group, g.rank, g.size) == (None, 0, 1)


def test_make_mesh_with_a_process_group(tmp_path) -> None:
    """With ``torch.distributed`` initialized, ``make_mesh()`` is the
    default group, as before, and a CPU matcher's fallback takes it;
    named devices still make a local mesh."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        g = port_sharded.make_mesh()
        assert isinstance(g, port_sharded.ShardGroup)
        assert g.group is dist.group.WORLD and g.size == 1
        assert port_sharded.make_mesh(1).group is dist.group.WORLD
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            port_sharded.make_mesh(2)
        assert isinstance(port_sharded.make_mesh(devices=["cpu"] * 2),
                          port_sharded.LocalMesh)
        ac = port.AhoCorasick(PATTERNS, backend="sharded", device="cpu")
        text = _text(4, 1)
        assert ac.find_matches_as_indexes(text) == port.AhoCorasick(
            PATTERNS, backend="native", device="cpu"
        ).find_matches_as_indexes(text)
        assert ac._shard_group().group is dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_concurrent_calls_of_one_matcher() -> None:
    """Two threads call one matcher with a local mesh of 4 ranks at once;
    the mesh runs the calls one after the other, and each equals the
    single-device answer."""
    mesh = port_sharded.make_mesh(devices=["cpu"] * 4)
    ac = port.AhoCorasick(PATTERNS, backend="sharded", mesh=mesh, device="cpu")
    one = port.AhoCorasick(PATTERNS, backend="device", device="cpu")
    texts = [_text(70, 4), _text(71, 4)]
    wants = [one.find_matches_as_indexes(t) for t in texts]
    got: list = [None, None]

    def call(i: int) -> None:
        got[i] = [ac.find_matches_as_indexes(texts[i]) for _ in range(2)]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for g, w in zip(got, wants):
        assert g == [w, w] and w


def test_count_launch_loses_no_count(monkeypatch) -> None:
    """``count_launch`` from 16 threads with a short switch interval: no
    count is lost (the thread ranks of a local mesh launch at once)."""
    monkeypatch.setattr(_kernels, "LAUNCHES", dict(_kernels.LAUNCHES))
    monkeypatch.setattr(_kernels, "FIRE_CONFIGS", {})
    _kernels.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work() -> None:
            for _ in range(2000):
                _kernels.count_launch("fire", (1, 2, 3))
                _kernels.count_launch("shard_body")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert _kernels.LAUNCHES["fire"] == _kernels.LAUNCHES["shard_body"] == (
        32_000
    )
    assert _kernels.FIRE_CONFIGS == {(1, 2, 3): 32_000}


class _Fake:
    """Stands for a CUDA tensor up to the launchers' checks: device, dtype,
    shape and contiguity (this machine has no card)."""

    def __init__(self, shape, dtype, device="cuda:1"):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


class _Guarded(Exception):
    pass


def _u8(*shape):
    return _Fake(shape, torch.uint8)


def _i32(*shape):
    return _Fake(shape, torch.int32)


#: each launcher with fake inputs that pass its checks
LAUNCHERS = {
    "lane_scan": lambda: _kernels._lane_scan_at(
        16, _i32(7, 257), _i32(257), _u8(64), 64, 4, 16, 3, False,
        _i32(3)),
    "compact": lambda: _kernels.compact(_u8(64), 8),
    "fire": lambda: _kernels.fire(_i32(2, 6, 2, 16, 4), _u8(8, 128), 6, 4, 2),
    "fire_groups": lambda: _kernels.fire_groups(_u8(64), 64),
    "verify": lambda: _kernels.verify(
        _i32(7, 257), _i32(257), _u8(64), _i32(4), 64, 8, False, 7, 1),
    "verify_body": lambda: _kernels.verify_body(
        _i32(7, 257), _i32(257), _u8(64), _i32(4), 64, 8, 16, False, 7, 1),
    "stride2_scan": lambda: _kernels._stride2_scan_at(
        16, _i32(7, 9), _i32(7, 3), _i32(257), _u8(64), 64, 4, 16, 2),
    "sparse_scan": lambda: _kernels._sparse_scan_at(
        16, _kernels.SparseTables(_i32(7, 4), _u8(42), _i32(10), _i32(257)),
        _u8(64), 64, 4, 16, 3),
    "batch_scan": lambda: _kernels._batch_scan_at(
        16, _i32(7, 257), _i32(257), _u8(4, 16), _i32(4), 3, False),
    "probe_reduce": lambda: _kernels.probe_reduce(_u8(1024, 128)),
    "probe_rollrows": lambda: _kernels.probe_rollrows(_u8(1024, 128)),
}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launcher_enters_device_guard(monkeypatch, launcher: str) -> None:
    """Every launcher enters ``device_guard`` for its tensors' device (here
    ``cuda:1``) before it builds, allocates or launches anything: the CUDA
    runtime launches on the thread's current device."""
    seen = []

    def guard(dev):
        seen.append(dev)
        raise _Guarded

    def no_build():
        raise AssertionError("built before entering the guard")

    monkeypatch.setattr(_kernels, "device_guard", guard)
    monkeypatch.setattr(_kernels, "build", no_build)
    with pytest.raises(_Guarded):
        LAUNCHERS[launcher]()
    assert seen == [torch.device("cuda:1")]
