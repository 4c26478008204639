"""PyTorch port, sharded scan (K8): the per-rank bodies and the sharded
scan functions of ``parallel/sharded.py`` equal the JAX package's sharded scan
(``ahocorasick_rs_tpu/parallel/sharded.py``) on the same inputs.

The reference runs one program over ``make_mesh(n_dev)`` on the
conftest's virtual CPU mesh (its Teddy fire kernel in Pallas interpret
mode).  The port runs its pure per-rank functions for the same ``n_dev``
ranks in a loop, feeding each rank its neighbour's bytes by hand; and its
scan functions (and the public API with ``mesh=``) in ``n_dev`` threads of this
process, whose ``ThreadGroup`` (the exchange of the package's local mesh)
stands in for a process group.  The
dense and batch bodies' raw outputs (positions, states, totals) are
compared array for array; Teddy by occurrences, since the fire masks of
shards are not the reference's across shard seams.  Inputs come from a
seed; every comparison is exact (all outputs are integers).
``tests/test_torch_multihost.py`` runs the same code in real processes.
"""

from __future__ import annotations

import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.api as ref_api
import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
import ahocorasick_rs_tpu.parallel.sharded as ref_sharded
import ahocorasick_rs_tpu_torch as port
import ahocorasick_rs_tpu_torch.api as port_api
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import build_prefilter
from ahocorasick_rs_tpu.ops.resolve import MatchDenseError as RefDenseError
from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy
from ahocorasick_rs_tpu_torch.ops.resolve import MatchDenseError
from ahocorasick_rs_tpu_torch.parallel import sharded as port_sharded
from ahocorasick_rs_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


AXIS = "data"
ENGINES = ["dfa", "classed"]


def _run_ranks(n_dev: int, fn) -> list:
    """``fn(group)`` on ``n_dev`` thread ranks; their results, or their
    exceptions.  A rank that fails aborts the ring, so the others fail at
    their next exchange (``LocalMesh.run`` does the same, but raises)."""
    ring = port_sharded.Ring(n_dev)
    out: list = [None] * n_dev

    def work(r: int) -> None:
        torch.set_num_threads(1)
        try:
            out[r] = fn(port_sharded.ThreadGroup(ring, r))
        except Exception as e:  # handed to the caller
            out[r] = e
            ring.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n_dev)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a thread rank hung"
    return out


def _ok(results: list) -> list:
    for r in results:
        if isinstance(r, Exception):
            raise r
    return results


def _names(seed: int, count: int, lo: int = 3, hi: int = 9) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(lo, hi)))
        for _ in range(count)
    ]


def _corpus(seed: int, n: int, names: list[bytes], plant: int) -> bytes:
    rng = np.random.default_rng(seed)
    hay = bytearray(
        np.frombuffer(b"zyxwvutsa", np.uint8)[rng.integers(0, 9, n)].tobytes()
    )
    for _ in range(plant):
        nm = names[int(rng.integers(len(names)))]
        off = int(rng.integers(n - len(nm)))
        hay[off : off + len(nm)] = nm
    return bytes(hay)


def _port_automaton(am):
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


def _port_scanner(am, pf, engine: str):
    pt = port_scan.DeviceTables(am, engine, "cpu")
    return port_teddy.TeddyScanner(
        am,
        convert.prefilter_from_arrays(
            pf.m, pf.words, pf.passes, pf.tables, pf.bucket_of,
            pf.est_fire_rate,
        ),
        pt,
    )


# name sets whose halo (max_len - 1) is long, short, and 0
NAME_SETS = {
    "names": _names(1, 40) + [b"abcdefghabcdefgh"],
    "short": _names(2, 12, 1, 3),
    "bytes": [b"a", b"c", b"h"],
}


# --- per-rank bodies in a loop vs the reference's in-program bodies -----


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("names", sorted(NAME_SETS))
def test_dense_bodies_equal_reference(names: str, n_dev: int, engine: str):
    """``shard_scan_body`` per rank, with the left neighbour's tail as its
    head, gives the reference's gathered (positions, states, totals).  At
    n_dev 8 the last ranks hold no byte (n < n_dev*L*T)."""
    pats = NAME_SETS[names]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    hay = np.frombuffer(_corpus(n_dev, 5000, pats, 150), np.uint8)
    n, halo, cap = len(hay), ref_am.max_len - 1, 1 << 12
    L, T = port_sharded.dense_layout(n, n_dev, halo, lanes_per_device=8)
    LT = L * T
    rt = ref_scan.DeviceTables(ref_am, engine)
    mesh = ref_sharded.make_mesh(n_dev)
    buf = np.zeros(n_dev * LT, dtype=np.uint8)
    buf[:n] = hay
    want = ref_sharded._fetch(ref_sharded._sharded_scan(
        rt.table, rt.classes, ref_sharded._put_sharded(buf, mesh, P(AXIS)),
        rt.match_count, jnp.int32(n), L, T, halo, cap, rt.use_classes,
        mesh, AXIS,
    ))
    pt = port_scan.DeviceTables(am, engine, "cpu")
    shards = [
        port_sharded._shard_of(hay, d, LT, torch.device("cpu"))
        for d in range(n_dev)
    ]
    assert n < n_dev * LT
    if n_dev == 8:
        assert n <= 5 * LT  # ranks 5-7 hold padding only
    for d in range(n_dev):
        head = None
        if halo:
            head = (
                port_sharded.shard_tail(shards[d - 1], n - (d - 1) * LT, halo)
                if d else torch.full((halo,), PAD_BYTE, dtype=torch.int32)
            )
        pos, st, total = port_sharded.shard_scan_body(
            pt, shards[d], head, n - d * LT, d * LT, L, T, halo, cap
        )
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want[0][d]))
        np.testing.assert_array_equal(st.numpy(), np.asarray(want[1][d]))
        assert int(total) == int(np.asarray(want[2]).reshape(n_dev)[d])
    assert int(np.asarray(want[2]).sum()) > 20


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_batch_bodies_equal_reference(n_dev: int, engine: str) -> None:
    """``shard_batch_body`` per rank over its row block gives the
    reference's gathered outputs; rows past the documents have length 0
    and their bytes (here 'a') never match."""
    pats = NAME_SETS["names"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    rng = np.random.default_rng(n_dev)
    docs = [
        np.frombuffer(_corpus(i, int(rng.integers(20, 200)), pats, 2), np.uint8)
        for i in range(19)
    ]
    docs[3] = docs[3][:0]
    Bb, T = port_sharded.batch_layout([len(d) for d in docs], n_dev)
    assert Bb % n_dev == 0 and Bb >= len(docs)
    buf = np.full((Bb, T), ord("a"), dtype=np.uint8)
    lens = np.zeros(Bb, dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, :] = 0
        buf[i, : len(d)] = d
        lens[i] = len(d)
    cap = 1 << 12
    rt = ref_scan.DeviceTables(ref_am, engine)
    mesh = ref_sharded.make_mesh(n_dev)
    want = ref_sharded._fetch(ref_sharded._sharded_batch(
        rt.table, rt.classes,
        ref_sharded._put_sharded(buf, mesh, P(AXIS, None)),
        ref_sharded._put_sharded(lens, mesh, P(AXIS)),
        rt.match_count, cap, rt.use_classes, mesh, AXIS,
    ))
    pt = port_scan.DeviceTables(am, engine, "cpu")
    Bl = Bb // n_dev
    for d in range(n_dev):
        pos, st, total = port_sharded.shard_batch_body(
            pt, torch.from_numpy(buf[d * Bl : (d + 1) * Bl].copy()),
            torch.from_numpy(lens[d * Bl : (d + 1) * Bl].copy()),
            d * Bl * T, cap,
        )
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want[0][d]))
        np.testing.assert_array_equal(st.numpy(), np.asarray(want[1][d]))
        assert int(total) == int(np.asarray(want[2]).reshape(n_dev)[d])
    assert int(np.asarray(want[2]).sum()) > 10


@pytest.mark.parametrize("n_dev", [2, 4])
def test_teddy_bodies_equal_reference(n_dev: int) -> None:
    """``shard_teddy_body`` per rank, with the right neighbour's head (and
    zeros after the last rank), then the host expansion: the reference's
    occurrence set, matches straddling every shard seam included."""
    pats = NAME_SETS["names"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    pf = build_prefilter(pats)
    text = bytearray(_corpus(7 + n_dev, 20_000, pats, 60))
    W = ref_am.max_len + port_teddy.COARSE - 1
    rows, Hr = port_sharded.teddy_layout(len(text), n_dev, W)
    LT = rows * 128
    for d in range(1, n_dev):  # a 16-byte name across each shard seam
        if d * LT < len(text):
            text[d * LT - 7 : d * LT + 9] = b"abcdefghabcdefgh"
    hay = np.frombuffer(bytes(text), np.uint8)
    n = len(hay)
    rt = ref_scan.DeviceTables(ref_am, "dfa", packed2_max_bytes=0)
    rs = ref_teddy.TeddyScanner(
        ref_am, pf, rt.table, rt.classes, rt.match_count, rt.use_classes
    )
    want = ref_sharded.scan_sharded_teddy(
        ref_am, rs, hay, ref_sharded.make_mesh(n_dev)
    )
    sc = _port_scanner(am, pf, "dfa")
    shards = [
        port_sharded._shard_of(hay, d, LT, torch.device("cpu"))
        for d in range(n_dev)
    ]
    got = []
    for d in range(n_dev):
        right = (
            shards[d + 1][:Hr] if d + 1 < n_dev
            else torch.zeros(Hr, dtype=torch.uint8)
        )
        pos, ftot, win, step, st, mtot = port_sharded.shard_teddy_body(
            sc, shards[d], right, n - d * LT, d * LT, W, 1 << 14, 1 << 12
        )
        assert int(ftot) <= 1 << 14 and int(mtot) <= 1 << 12
        mt = int(mtot)
        ws = pos.numpy()[win.numpy()[:mt]]
        got.append(port_teddy.expand_verified(
            am, ws, step.numpy()[:mt].astype(np.int64),
            st.numpy()[:mt].astype(np.int64),
        ))
    pids, starts, ends = (np.concatenate(x) for x in zip(*got))
    order = np.lexsort((pids, starts, ends))
    for a, b in zip((pids[order], starts[order], ends[order]), want):
        np.testing.assert_array_equal(a, b)
    seams = {d * LT - 7 for d in range(1, n_dev) if d * LT < n}
    assert seams and seams <= set(want[1].tolist())
    assert len(want[0]) > 60


# --- the scan functions, n_dev thread ranks -----------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_scan_sharded_equals_reference(n_dev: int, engine: str) -> None:
    """The whole dense scan: halo exchange, cap retry from a small
    sticky cap, gather and assembly; every rank returns the reference's
    (positions, states), and the sticky cap moves as the reference's."""
    pats = NAME_SETS["names"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    hay = np.frombuffer(_corpus(20 + n_dev, 30_000, pats, 900), np.uint8)
    rt = ref_scan.DeviceTables(ref_am, engine)
    rt.last_cap = 16
    want = ref_sharded.scan_sharded(
        ref_am, hay, rt, ref_sharded.make_mesh(n_dev), lanes_per_device=8
    )
    tables = [port_scan.DeviceTables(am, engine, "cpu") for _ in range(n_dev)]
    for t in tables:
        t.last_cap = 16
    got = _ok(_run_ranks(n_dev, lambda g: port_sharded.scan_sharded(
        am, hay, tables[g.rank], g, lanes_per_device=8
    )))
    for pos, st in got:
        assert pos.dtype == st.dtype == np.int64
        np.testing.assert_array_equal(pos, want[0])
        np.testing.assert_array_equal(st, want[1])
    assert len(want[0]) > 800
    assert {t.last_cap for t in tables} == {rt.last_cap}


@pytest.mark.parametrize("n_dev", [2, 4])
def test_scan_sharded_straddling_matches_found_once(n_dev: int) -> None:
    """A pattern across every lane and shard boundary (2 lanes a rank) is
    found exactly once, as by the reference and the python walk."""
    pattern = b"abcdefghij"
    n = n_dev * 2 * 64
    hay = bytearray(b"." * n)
    for lane in range(1, n_dev * 2):
        off = lane * 64 - 5
        hay[off : off + len(pattern)] = pattern
    hay = np.frombuffer(bytes(hay), np.uint8)
    ref_am = build_automaton([pattern])
    am = _port_automaton(ref_am)
    want = ref_sharded.scan_sharded(
        ref_am, hay, ref_scan.DeviceTables(ref_am, "dfa"),
        ref_sharded.make_mesh(n_dev), lanes_per_device=2,
    )
    got = _ok(_run_ranks(n_dev, lambda g: port_sharded.scan_sharded(
        am, hay, port_scan.DeviceTables(am, "dfa", "cpu"), g,
        lanes_per_device=2,
    )))
    ends = [lane * 64 - 5 + len(pattern) - 1 for lane in range(1, n_dev * 2)]
    for pos, st in got:
        np.testing.assert_array_equal(pos, want[0])
        np.testing.assert_array_equal(st, want[1])
        assert pos.tolist() == ends


@pytest.mark.parametrize("n_dev", [2, 4])
def test_scan_sharded_teddy_equals_reference(n_dev: int) -> None:
    """The whole Teddy scan: head exchange, fire/verify cap retries from
    small caps, expansion; the occurrences and the scanner's sticky caps
    equal the reference's."""
    pats = NAME_SETS["names"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    pf = build_prefilter(pats)
    hay = np.frombuffer(_corpus(30 + n_dev, 24_000, pats, 500), np.uint8)
    rt = ref_scan.DeviceTables(ref_am, "classed", packed2_max_bytes=0)
    rs = ref_teddy.TeddyScanner(
        ref_am, pf, rt.table, rt.classes, rt.match_count, rt.use_classes
    )
    rs.fire_cap, rs.match_cap = 64, 32
    want = ref_sharded.scan_sharded_teddy(
        ref_am, rs, hay, ref_sharded.make_mesh(n_dev)
    )
    scanners = [_port_scanner(am, pf, "classed") for _ in range(n_dev)]
    for sc in scanners:
        sc.fire_cap, sc.match_cap = 64, 32
    got = _ok(_run_ranks(n_dev, lambda g: port_sharded.scan_sharded_teddy(
        am, scanners[g.rank], hay, g
    )))
    for occ in got:
        for a, b in zip(occ, want):
            np.testing.assert_array_equal(a, b)
    assert len(want[0]) > 400
    for sc in scanners:
        assert (sc.fire_cap, sc.match_cap, sc.worthwhile) == (
            rs.fire_cap, rs.match_cap, rs.worthwhile
        )


def test_scan_sharded_teddy_declines_as_reference() -> None:
    """A corpus that fires everywhere: both scans give up (None) and
    mark the scanner not worthwhile."""
    pats = [b"aaaa", b"aaab"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    pf = build_prefilter(pats)
    hay = np.frombuffer(b"a" * 70_000, np.uint8)
    rt = ref_scan.DeviceTables(ref_am, "dfa", packed2_max_bytes=0)
    rs = ref_teddy.TeddyScanner(
        ref_am, pf, rt.table, rt.classes, rt.match_count, rt.use_classes
    )
    assert ref_sharded.scan_sharded_teddy(
        ref_am, rs, hay, ref_sharded.make_mesh(2)
    ) is None
    scanners = [_port_scanner(am, pf, "dfa") for _ in range(2)]
    got = _ok(_run_ranks(2, lambda g: port_sharded.scan_sharded_teddy(
        am, scanners[g.rank], hay, g
    )))
    assert got == [None, None]
    for sc in scanners:
        assert not sc.worthwhile and sc.fire_cap == rs.fire_cap


@pytest.mark.parametrize("n_dev", [2, 3])
def test_scan_sharded_batch_equals_reference(n_dev: int) -> None:
    pats = NAME_SETS["names"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    rng = np.random.default_rng(40 + n_dev)
    docs = [
        np.frombuffer(_corpus(i, int(rng.integers(30, 400)), pats, 3), np.uint8)
        for i in range(37)
    ]
    rt = ref_scan.DeviceTables(ref_am, "dfa")
    rt.last_cap = 16
    want = ref_sharded.scan_sharded_batch(
        ref_am, docs, rt, ref_sharded.make_mesh(n_dev)
    )
    tables = [port_scan.DeviceTables(am, "dfa", "cpu") for _ in range(n_dev)]
    for t in tables:
        t.last_cap = 16
    got = _ok(_run_ranks(n_dev, lambda g: port_sharded.scan_sharded_batch(
        am, docs, tables[g.rank], g
    )))
    for pos, st, T in got:
        assert T == want[2]
        np.testing.assert_array_equal(pos, want[0])
        np.testing.assert_array_equal(st, want[1])
    assert len(want[0]) > 50
    assert {t.last_cap for t in tables} == {rt.last_cap}


@pytest.mark.parametrize("path", ["dense", "batch"])
def test_dense_error_on_same_inputs(monkeypatch, path: str) -> None:
    """A match-dense shard: both raise MatchDenseError with the same
    message, on every rank; a sparse corpus returns equal results."""
    monkeypatch.setattr(ref_sharded, "DENSE_BAILOUT_MIN", 64)
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", 64)
    pats = [b"a" * k for k in range(1, 5)]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    mesh = ref_sharded.make_mesh(2)
    for fill in (b"a", b"b"):
        if path == "dense":
            hay = np.frombuffer(fill * 4096, np.uint8)

            def run_ref(t):
                return ref_sharded.scan_sharded(
                    ref_am, hay, t, mesh, lanes_per_device=8
                )

            def run_port(t, g):
                return port_sharded.scan_sharded(
                    am, hay, t, g, lanes_per_device=8
                )
        else:
            docs = [np.frombuffer(fill * 100, np.uint8)] * 9

            def run_ref(t):
                return ref_sharded.scan_sharded_batch(ref_am, docs, t, mesh)

            def run_port(t, g):
                return port_sharded.scan_sharded_batch(am, docs, t, g)

        rt = ref_scan.DeviceTables(ref_am, "dfa")
        rt.last_cap = 64
        try:
            want = run_ref(rt)
        except RefDenseError as e:
            want = str(e)
        tables = [port_scan.DeviceTables(am, "dfa", "cpu") for _ in range(2)]
        for t in tables:
            t.last_cap = 64
        got = _run_ranks(2, lambda g: run_port(tables[g.rank], g))
        if fill == b"a":
            assert want == {
                "dense": "2048 matched positions in a 2048-byte shard",
                "batch": "800 matched positions in a 8x128 batch shard",
            }[path]
            for e in got:
                assert isinstance(e, MatchDenseError) and str(e) == want
        else:
            for res in _ok(got):
                for a, b in zip(res, want):
                    np.testing.assert_array_equal(a, b)


# --- grouping and the public API ---------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_plan_batch_groups_equals_reference(monkeypatch, n_dev: int) -> None:
    rng = np.random.default_rng(50 + n_dev)
    cases = [
        [int(x) for x in rng.integers(0, 300, 400)],
        [60_000] + [int(x) for x in rng.integers(20, 200, 500)],
        [3] * 1000,
        [10 * (1 << 20)] * 12,
        [int(x) for x in rng.lognormal(6, 2, 3000).astype(np.int64)],
        [],
    ]
    for budget in (1 << 12, 1 << 16, None):
        if budget is not None:
            monkeypatch.setattr(ref_api, "BATCH_STAGE_BYTES", budget)
            monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", budget)
        for lens in cases:
            assert port_api._plan_batch_groups(lens, n_dev=n_dev) == (
                ref_api._plan_batch_groups(lens, n_dev=n_dev)
            )
    monkeypatch.undo()
    lens = [int(x) for x in rng.integers(0, 300, 400)]
    assert port_api._plan_batch_groups(lens, 1) == (
        port_api._plan_batch_groups(lens)
    )


KINDS = ["Standard", "LeftmostFirst", "LeftmostLongest"]
PATTERNS = ["content", "disco", "disc", "discontent", "winter", "lo wo"]


def _text(n: int) -> str:
    rng = random.Random(17)
    parts: list[str] = []
    while sum(map(len, parts)) < n:
        parts.append(rng.choice([
            "the winter of my discontent ", "hello world ", "disco disco ",
            "filler text with no hits ", "héllo wörld ",
        ]))
    return "".join(parts)


@pytest.mark.parametrize("teddy", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_api_mesh_equals_reference(kind: str, teddy: bool) -> None:
    """``AhoCorasick(..., mesh=)`` on 4 thread ranks: single documents
    (tier ``sharded``, or ``teddy_sharded`` with the prefilter forced) and
    batches (``sharded_batch``, ``teddy_sharded_batch``) give the
    reference's tuples and tiers over ``make_mesh(4)``."""
    text = _text(30_000)
    docs = [text[i : i + 700] for i in range(0, 12_000, 700)] + ["", "disc"]
    mk = ref.MatchKind[kind]
    want_ac = ref.AhoCorasick(
        PATTERNS, matchkind=mk, backend="sharded",
        mesh=ref_sharded.make_mesh(4),
    )
    if teddy:
        want_ac._teddy_state = "force"
    want = want_ac.find_matches_as_indexes(text)
    want_tier = want_ac.stats()["last_backend"]
    want_b = want_ac.find_matches_as_indexes_batch(docs)
    want_b_tier = want_ac.stats()["last_backend"]
    want_o = want_ac.find_matches_as_indexes(text, overlapping=True) if (
        kind == "Standard") else None

    def rank(g):
        ac = port.AhoCorasick(
            PATTERNS, matchkind=port.MatchKind[kind], backend="sharded",
            mesh=g, device="cpu",
        )
        if teddy:
            ac._teddy_state = "force"
        out = [ac.find_matches_as_indexes(text), ac.stats()["last_backend"]]
        out += [ac.find_matches_as_indexes_batch(docs),
                ac.stats()["last_backend"]]
        if kind == "Standard":
            out.append(ac.find_matches_as_indexes(text, overlapping=True))
        return out

    for got in _ok(_run_ranks(4, rank)):
        assert got[0] == want and len(want) > 500
        assert got[1] == want_tier == ("teddy_sharded" if teddy else "sharded")
        assert got[2] == want_b
        assert got[3] == want_b_tier == (
            "teddy_sharded_batch" if teddy else "sharded_batch"
        )
        if kind == "Standard":
            assert got[4] == want_o


def test_api_bytes_sharded_engines_and_fallback() -> None:
    """``BytesAhoCorasick`` with ``backend="sharded"`` on 2 thread ranks:
    ContiguousNFA shards like the DFA; NoncontiguousNFA falls back to the
    host tier, as in the reference."""
    hay = _text(20_000).encode()
    pats = [p.encode() for p in PATTERNS]
    for engine in ("ContiguousNFA", "NoncontiguousNFA"):
        want_ac = ref.BytesAhoCorasick(
            pats, implementation=ref.Implementation[engine],
            backend="sharded", mesh=ref_sharded.make_mesh(2),
        )
        want = want_ac.find_matches_as_indexes(hay)

        def rank(g, engine=engine):
            ac = port.BytesAhoCorasick(
                pats, implementation=port.Implementation[engine],
                backend="sharded", mesh=g, device="cpu",
            )
            return ac.find_matches_as_indexes(hay), ac.stats()["last_backend"]

        for got, tier in _ok(_run_ranks(2, rank)):
            assert got == want and len(want) > 300
            assert tier == want_ac.stats()["last_backend"]
            if engine == "ContiguousNFA":
                assert tier == "sharded"
            else:
                assert tier in ("native", "numpy")


def test_api_mesh_argument_checked() -> None:
    """``mesh=`` takes a DeviceMesh, a ProcessGroup or a local mesh;
    anything else is a TypeError at construction.  Without a process
    group ``as_group(None)`` is a world of one rank (``make_mesh()`` needs
    a card or named devices: ``tests/test_torch_local_mesh.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh or ProcessGroup"):
        port.AhoCorasick(["x"], mesh="data", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh or ProcessGroup"):
        port.BytesAhoCorasick([b"x"], mesh=[0, 1], device="cpu")
    g = port_sharded.as_group(None)
    assert (g.group, g.rank, g.size) == (None, 0, 1)
    ac = port.AhoCorasick(["x"], mesh=g, device="cpu")
    assert ac._mesh is g
    # a short haystack stays on the host tiers, as in the reference
    assert ac.find_matches_as_indexes("axxa") == [(0, 1, 2), (0, 2, 3)]
    assert ac.stats()["last_backend"] == "native"


def test_group_of_one_rank_runs_its_collective(monkeypatch) -> None:
    """A real process group of one rank gathers through
    ``torch.distributed`` (so a one-rank NCCL world runs the exchange);
    only ``group=None``, the world with no process group, skips it."""
    calls = []

    def all_gather(parts, t, group=None):
        calls.append(group)
        parts[0].copy_(t)

    monkeypatch.setattr(port_sharded.dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(port_sharded.dist, "get_world_size", lambda g: 1)
    monkeypatch.setattr(port_sharded.dist, "all_gather", all_gather)
    t = torch.arange(5)
    group = object()
    assert torch.equal(port_sharded.ShardGroup(group).all_gather(t), t[None])
    assert calls == [group]
    assert torch.equal(port_sharded.ShardGroup(None).all_gather(t), t[None])
    assert calls == [group]
