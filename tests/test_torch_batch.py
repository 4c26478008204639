"""PyTorch port, batch path: the batched per-document scan (K5,
``scan_device_batch``), the batch grouping (``_plan_batch_groups``) and
the three ``*_batch`` methods equal the JAX package's on the same inputs,
and the per-document loop.  The port runs with ``device="cpu"``, so its
device tier takes the kernels' plain PyTorch versions; the reference's
Teddy tier runs its Pallas kernel in interpret mode.  Every comparison is
exact.  The non-mesh cases of ``tests/test_batch.py`` are mirrored here.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.api as ref_api
import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu_torch as port
import ahocorasick_rs_tpu_torch.api as port_api
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.ops.resolve import MatchDenseError as RefDenseError
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops.resolve import MatchDenseError
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


KINDS = ["Standard", "LeftmostFirst", "LeftmostLongest"]
#: batch tiers: the backend, and "teddy" = backend "device" with the
#: prefiltered pipeline forced
TIERS = ["auto", "native", "device", "teddy"]

DOCS = [
    "the winter of my discontent",
    "",
    "no hits here at all",
    "disco disco disco",
    "made glorious summer by this sun of york",
    "content discontent disc",
    "x" * 200,
    "winter winter",
    "héllo wörld: a discö in wïnter, discontent",
    "☃ summer ☃ disc",
]
PATTERNS = ["content", "disco", "disc", "discontent", "winter", "summer"]


def _make(pkg, cls: str, patterns, kind: str, tier: str, **kw):
    kwargs = dict(
        matchkind=pkg.MatchKind[kind],
        backend="device" if tier == "teddy" else tier,
        **kw,
    )
    if pkg is port:
        kwargs["device"] = "cpu"
    ac = getattr(pkg, cls)(patterns, **kwargs)
    if tier == "teddy":
        ac._teddy_state = "force"
    return ac


def _loop(patterns, kind: str, docs, overlapping: bool = False):
    """The per-document loop on the JAX package's python tier."""
    ac = ref.AhoCorasick(
        patterns, matchkind=ref.MatchKind[kind], backend="python"
    )
    return [ac.find_matches_as_indexes(d, overlapping) for d in docs]


def _port_automaton(am):
    """The reference's very automaton, carried across as arrays."""
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


def _docs(seed: int, count: int, names: list[bytes]) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(0, 90)) if i % 5 else 0  # some empty
        body = bytearray(
            np.frombuffer(b"zyxwvuts", np.uint8)[rng.integers(0, 8, n)]
        )
        for _ in range(int(rng.integers(0, 3))):
            nm = names[int(rng.integers(len(names)))]
            off = int(rng.integers(0, len(body) + 1))
            body[off:off] = nm
        out.append(np.frombuffer(bytes(body), dtype=np.uint8))
    return out


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(2, 7)))
        for _ in range(count)
    ]


# --- K5 and scan_device_batch ----------------------------------------


@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_scan_batch_compact_equals_reference(engine: str) -> None:
    names = _names(1, 30)
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    docs = _docs(2, 13, names)
    T = 128
    buf = np.zeros((16, T), dtype=np.uint8)
    lens = np.zeros(16, dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = d
        lens[i] = len(d)
    buf[13:] = ord("a")  # rows past B: lens 0, so these must read as PAD
    rt = ref_scan.DeviceTables(ref_am, engine)
    pt = port_scan.DeviceTables(am, engine, "cpu")
    for cap in (8, 4096):
        want = ref_scan._scan_batch_compact(
            rt.table, rt.classes, jnp.asarray(buf), jnp.asarray(lens),
            rt.match_count, cap, rt.use_classes,
        )
        got = port_scan._scan_batch_compact(
            pt.table, pt.classes, torch.from_numpy(buf),
            torch.from_numpy(lens), pt.match_count, cap, pt.use_classes,
        )
        assert int(got[2]) == int(want[2]) > 8
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("B", [0, 1, 13, 40])
def test_scan_device_batch_equals_reference(engine: str, B: int) -> None:
    """B not a power of two, empty documents, sticky cap."""
    names = _names(3, 30)
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    docs = _docs(4 + B, B, names)
    rt = ref_scan.DeviceTables(ref_am, engine)
    pt = port_scan.DeviceTables(am, engine, "cpu")
    rt.last_cap = pt.last_cap = 16  # forces the overflow retry
    want = ref_scan.scan_device_batch(ref_am, docs, rt)
    got = port_scan.scan_device_batch(am, docs, pt)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert pt.last_cap == rt.last_cap
    if B > 1:
        assert len(want[0]) > 8


@pytest.mark.parametrize("dense", [True, False])
def test_scan_device_batch_dense_error_on_same_inputs(
    monkeypatch, dense: bool
) -> None:
    monkeypatch.setattr(ref_scan, "DENSE_BAILOUT_MIN", 64)
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", 64)
    ref_am = build_automaton([b"a" * k for k in range(1, 5)])
    am = _port_automaton(ref_am)
    fill = b"a" if dense else b"b"
    docs = [np.frombuffer(fill * 100, np.uint8)] * 9
    outcomes = []
    for scan, a, tabs, err in (
        (ref_scan.scan_device_batch, ref_am,
         ref_scan.DeviceTables(ref_am, "dfa"), RefDenseError),
        (port_scan.scan_device_batch, am,
         port_scan.DeviceTables(am, "dfa", "cpu"), MatchDenseError),
    ):
        tabs.last_cap = 64  # the bailout is checked on a cap overflow
        try:
            outcomes.append(scan(a, docs, tabs))
        except err as e:
            outcomes.append(str(e))
    if dense:
        assert outcomes[0] == outcomes[1] == (
            "900 matched positions in a 16x128 batch"
        )
    else:
        assert outcomes[0][2] == outcomes[1][2]
        for x, y in zip(outcomes[0][:2], outcomes[1][:2]):
            np.testing.assert_array_equal(x, y)


# --- grouping ---------------------------------------------------------


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16, None])
def test_plan_batch_groups_equals_reference(monkeypatch, budget) -> None:
    rng = np.random.default_rng(5)
    cases = [
        [int(x) for x in rng.integers(0, 300, 400)],
        [60_000] + [int(x) for x in rng.integers(20, 200, 500)]
        + [0, 1, 15, 16, 17],
        [3] * 1000,
        [17] + [3] * 100,
        [679, 582, 97, 0, 291, 45],
        [10 * (1 << 20)] * 12,
        [60_000] + [100] * 40_000,
        [int(x) for x in rng.lognormal(6, 2, 3000).astype(np.int64)],
        [],
    ]
    if budget is not None:
        monkeypatch.setattr(ref_api, "BATCH_STAGE_BYTES", budget)
        monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", budget)
    for lens in cases:
        assert port_api._plan_batch_groups(lens) == (
            ref_api._plan_batch_groups(lens)
        )


def test_plan_batch_groups_budget_and_waste(monkeypatch) -> None:
    """Mirrors test_batch.py::test_plan_batch_groups_budget_and_waste."""
    rng = np.random.default_rng(3)
    lens = (
        [60_000]
        + [int(x) for x in rng.integers(20, 200, 500)]
        + [0, 1, 15, 16, 17]
    )
    budget = 1 << 16
    monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", budget)
    groups = port_api._plan_batch_groups(lens)
    monkeypatch.undo()
    assert sorted(i for g in groups for i in g) == list(range(len(lens)))
    for g in groups:
        Tp = 1 << (max(max(lens[i] for i in g), 16) - 1).bit_length()
        rows = 1 << max(len(g) - 1, 7).bit_length()
        if len(g) > 1:
            assert rows * Tp <= budget
        for k, i in enumerate(g):
            tmin = 1 << (max(lens[i], 16) - 1).bit_length()
            assert (
                tmin * port_api._BATCH_WASTE >= Tp
                or (k + 1) * Tp < port_api._WASTE_MIN_BYTES
            )
    assert len(port_api._plan_batch_groups([70] * 1000)) == 1
    assert len(port_api._plan_batch_groups([3] * 1000)) == 1
    assert len(port_api._plan_batch_groups([17] + [3] * 100)) <= 2
    skew = port_api._plan_batch_groups([60_000] + [100] * 40_000)
    assert len(skew) > 1 and max(len(g) for g in skew) > 1000
    groups = port_api._plan_batch_groups([10 * (1 << 20)] * 12)
    assert max(len(g) for g in groups) == 8


# --- the public batch methods ----------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", KINDS)
def test_str_batch_equals_reference(kind: str, tier: str) -> None:
    """indexes and strings batches, with non-ASCII documents."""
    want_ac = _make(ref, "AhoCorasick", PATTERNS, kind, tier)
    got_ac = _make(port, "AhoCorasick", PATTERNS, kind, tier)
    want = want_ac.find_matches_as_indexes_batch(DOCS)
    got = got_ac.find_matches_as_indexes_batch(DOCS)
    assert got == want == _loop(PATTERNS, kind, DOCS)
    assert sum(map(len, got)) > 10
    assert got_ac.stats()["last_backend"] == want_ac.stats()["last_backend"]
    assert got_ac.find_matches_as_strings_batch(DOCS) == (
        want_ac.find_matches_as_strings_batch(DOCS)
    )
    if kind == "Standard":
        got_o = got_ac.find_matches_as_indexes_batch(DOCS, overlapping=True)
        assert got_o == want_ac.find_matches_as_indexes_batch(
            DOCS, overlapping=True
        ) == _loop(PATTERNS, kind, DOCS, True)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", KINDS)
def test_bytes_batch_equals_reference(kind: str, tier: str) -> None:
    names = _names(7, 25) + [b"\x00\x01", b"c\xffd"]
    docs = _docs(8, 30, names) + [np.frombuffer(b"c\xffd\x00\x01", np.uint8)]
    want_ac = _make(ref, "BytesAhoCorasick", names, kind, tier)
    got_ac = _make(port, "BytesAhoCorasick", names, kind, tier)
    want = want_ac.find_matches_as_indexes_batch(docs)
    got = got_ac.find_matches_as_indexes_batch(docs)
    assert got == want and sum(map(len, got)) > 20
    assert got_ac.stats()["last_backend"] == want_ac.stats()["last_backend"]
    if kind == "Standard":
        assert got_ac.find_matches_as_indexes_batch(docs, overlapping=True) == (
            want_ac.find_matches_as_indexes_batch(docs, overlapping=True)
        )


@pytest.mark.parametrize("engine", ["ContiguousNFA", "NoncontiguousNFA"])
@pytest.mark.parametrize("tier", ["auto", "device"])
def test_batch_engines_equal_reference(engine: str, tier: str) -> None:
    """The classed engine batches like the DFA; the sparse engine never
    takes the batch kernel (each document runs the sparse device scan)."""
    ref_ac = ref.AhoCorasick(
        PATTERNS, implementation=ref.Implementation[engine], backend=tier
    )
    got_ac = port.AhoCorasick(
        PATTERNS, implementation=port.Implementation[engine], backend=tier,
        device="cpu",
    )
    want = ref_ac.find_matches_as_indexes_batch(DOCS)
    assert got_ac.find_matches_as_indexes_batch(DOCS) == want
    assert got_ac.stats()["last_backend"] == ref_ac.stats()["last_backend"]


def test_batch_type_errors_and_overlapping_gate() -> None:
    ac = port.AhoCorasick(PATTERNS, device="cpu")
    for meth in ("find_matches_as_indexes_batch",
                 "find_matches_as_strings_batch"):
        with pytest.raises(
            TypeError,
            match="argument 'haystack': 'bytes' object cannot be converted "
            "to 'PyString'",
        ):
            getattr(ac, meth)(["ok", b"not a str"])
    lf = port.AhoCorasick(
        PATTERNS, matchkind=port.MatchKind.LeftmostFirst, device="cpu"
    )
    with pytest.raises(ValueError, match="overlapping searches require"):
        lf.find_matches_as_indexes_batch(DOCS, overlapping=True)
    bac = port.BytesAhoCorasick([b"ab"], device="cpu")
    with pytest.raises(TypeError) as e:
        bac.find_matches_as_indexes_batch([b"ab", np.zeros((2, 2), np.uint8)])
    assert "Only one-dimensional sequences are supported" in str(e.value)
    docs = [memoryview(b"xxabx"), bytearray(b"\x00ab"), b""]
    assert bac.find_matches_as_indexes_batch(docs) == [
        bac.find_matches_as_indexes(d) for d in docs
    ]


def test_batch_unicode_codepoint_indexes() -> None:
    docs = ["héllo wörld", "ﬃ wörld", "plain ascii world", "wörldwörld"]
    for tier in ("device", "teddy", "native"):
        ac = _make(port, "AhoCorasick", ["wörld", "world"], "Standard", tier)
        want = ref.AhoCorasick(
            ["wörld", "world"], backend="python"
        ).find_matches_as_indexes_batch(docs)
        assert ac.find_matches_as_indexes_batch(docs) == want
        assert ac.find_matches_as_strings_batch(docs) == [
            ac.find_matches_as_strings(d) for d in docs
        ]
    unstored = port.AhoCorasick(
        ["wörld", "☃"], store_patterns=False, backend="device", device="cpu"
    )
    assert unstored.find_matches_as_strings_batch(["☃ wörld", "x"]) == [
        ["☃", "wörld"], []
    ]


def test_batch_teddy_doc_edges() -> None:
    """Tight COARSE-aligned staging: patterns at exact doc ends, lengths
    on and off 16-byte boundaries, no match across padding."""
    pats = ["endx", "xxendx", "aaaa"]
    docs = [
        "a" * 12 + "endx", "b" * 16, "endx", "c" * 29 + "end",
        "x" * 3 + "endx" + "y" * 25, "aaaa" * 10,
    ]
    ac = _make(port, "AhoCorasick", pats, "Standard", "teddy")
    want_ac = ref.AhoCorasick(pats, backend="python")
    for ov in (False, True):
        assert ac.find_matches_as_indexes_batch(docs, overlapping=ov) == [
            want_ac.find_matches_as_indexes(d, overlapping=ov) for d in docs
        ]
    assert ac.stats()["last_backend"] == "teddy_batch"


def test_batch_many_docs_wide_lengths() -> None:
    """Length spread across bucket boundaries; per-doc split correctness;
    the Teddy branch and the K5 branch agree."""
    rng = np.random.default_rng(11)
    pats = ["needle", "pin", "haystackneedle"]
    docs = []
    for i in range(300):
        n = int(rng.integers(0, 500))
        body = "".join(chr(rng.integers(97, 123)) for _ in range(n))
        if i % 5 == 0:
            body = body + "needle" + body[: max(0, 20 - n)]
        if i % 7 == 0:
            body = "pin" + body
        docs.append(body)
    want = ref.AhoCorasick(pats, backend="native").find_matches_as_indexes_batch(
        docs
    )
    for tier in ("device", "teddy"):
        ac = _make(port, "AhoCorasick", pats, "Standard", tier)
        assert ac.find_matches_as_indexes_batch(docs) == want


def test_batch_skewed_lengths_grouped(monkeypatch) -> None:
    """One long + many short documents under a tiny staging budget: the
    grouped dispatch path stays exact (test_batch.py's skew case)."""
    monkeypatch.setattr(ref_api, "BATCH_STAGE_BYTES", 1 << 14)
    monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", 1 << 14)
    rng = np.random.default_rng(5)
    docs = ["x" * 1000 + "needle" + "y" * 1000]
    for i in range(150):
        n = int(rng.integers(0, 50))
        body = "".join(chr(rng.integers(97, 123)) for _ in range(n))
        docs.append(body + ("pin" if i % 4 == 0 else ""))
    assert len(port_api._plan_batch_groups([len(d) for d in docs])) > 1
    pats = ["needle", "pin", "abc"]
    for tier in ("device", "teddy"):
        got_ac = _make(port, "AhoCorasick", pats, "Standard", tier)
        want_ac = _make(ref, "AhoCorasick", pats, "Standard", tier)
        for ov in (False, True):
            got = got_ac.find_matches_as_indexes_batch(docs, overlapping=ov)
            assert got == want_ac.find_matches_as_indexes_batch(
                docs, overlapping=ov
            ) == _loop(pats, "Standard", docs, ov)
            assert got_ac.stats()["last_backend"] == (
                want_ac.stats()["last_backend"]
            )


def test_single_doc_forced_device_batch_streams(monkeypatch) -> None:
    """A 1-document batch over the staging budget streams through the
    single-doc path (the batch kernel would stage MIN_LANES x pow2(T)),
    as does an over-budget document among others."""
    monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", 1 << 12)
    calls = []
    real = port_scan.scan_device_batch
    monkeypatch.setattr(
        port_scan, "scan_device_batch",
        lambda am, docs, t: calls.append(len(docs)) or real(am, docs, t),
    )
    doc = "z" * 5000 + "needle" + "z" * 2000
    ac = port.AhoCorasick(["needle", "pin"], backend="device", device="cpu")
    want = [ac.find_matches_as_indexes(doc)]
    assert ac.find_matches_as_indexes_batch([doc]) == want == [
        [(0, 5000, 5006)]
    ]
    assert calls == []  # never the batch kernel
    docs = [doc, "pin here", "nothing", "needle at start"]
    got = ac.find_matches_as_indexes_batch(docs)
    assert calls == [3]
    assert ac.stats()["last_backend"] == "device_batch"
    assert got == [ac.find_matches_as_indexes(d) for d in docs]


def test_grouped_batch_tier_not_overwritten_by_singleton(monkeypatch) -> None:
    monkeypatch.setattr(port_api, "BATCH_STAGE_BYTES", 1 << 16)
    monkeypatch.setattr(port_api, "_WASTE_MIN_BYTES", 1 << 10)
    docs = ["a" * 3000 + "needle", "b" * 3000, "pin"]  # [[0, 1], [2]] plan
    plan = port_api._plan_batch_groups([len(d) for d in docs])
    assert [len(g) for g in plan] == [2, 1]
    ac = port.AhoCorasick(["needle", "pin"], backend="device", device="cpu")
    want = [ac.find_matches_as_indexes(d) for d in docs]
    assert ac.find_matches_as_indexes_batch(docs) == want
    assert ac.stats()["last_backend"] == "device_batch"


def test_batch_teddy_staged_size_gate() -> None:
    """The prefiltered batch path gates on staged B*T, not sum(len): the
    batch falls through to the K5 path and stays exact."""
    pats = ["endx", "aaaa"]
    docs = ["q" * 1996 + "endx"] * 10 + ["aaaa" * 128] * 400
    ac = _make(port, "AhoCorasick", pats, "Standard", "teddy")
    ac._TEDDY_MAX_BYTES = 400_000
    total = sum(len(d) for d in docs)
    assert total <= 400_000 < len(docs) * (-(-2000 // 32) * 32)
    assert len(port_api._plan_batch_groups([len(d) for d in docs])) == 1
    want = ref.AhoCorasick(pats, backend="native").find_matches_as_indexes_batch(
        docs
    )
    assert ac.find_matches_as_indexes_batch(docs) == want
    assert ac.stats()["last_backend"] == "device_batch"


@pytest.mark.parametrize("tier", ["device", "native"])
def test_batch_match_dense_reroutes_per_document(monkeypatch, tier) -> None:
    """A batch-level MatchDenseError (device compaction past the bailout,
    or a would-be-huge occurrence expansion) re-routes every document
    through the single-document path; answers stay the reference's."""
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", 64)
    monkeypatch.setattr(port_api._MatcherBase, "_STREAM_OCC", 1 << 8)
    pats = ["a" * k for k in range(1, 9)]
    docs = ["a" * 3000, "b" * 10 + "aaa", "", "xaaaax"]
    seen = []
    real = port_api._MatcherBase._find
    monkeypatch.setattr(
        port_api._MatcherBase, "_find",
        lambda self, h, ov: seen.append(len(h)) or real(self, h, ov),
    )
    for kind in ("Standard", "LeftmostLongest"):
        ac = _make(port, "AhoCorasick", pats, kind, tier)
        want = ref.AhoCorasick(
            pats, matchkind=ref.MatchKind[kind], backend="python"
        ).find_matches_as_indexes_batch(docs)
        seen.clear()
        assert ac.find_matches_as_indexes_batch(docs) == want
        assert seen == [len(d.encode()) for d in docs]


def test_stats_counters_accumulate() -> None:
    ac = port.AhoCorasick(PATTERNS, device="cpu")
    s0 = ac.stats()
    assert s0["scan_calls"] == 0 and s0["last_backend"] is None
    ac.find_matches_as_indexes("the winter of my discontent")
    ac.find_matches_as_indexes_batch(DOCS)
    s = ac.stats()
    assert s["scan_calls"] >= 2 and s["scan_bytes"] > 0
    assert s["scan_seconds"] > 0 and s["scan_bytes_per_second"] > 0
    assert s["last_backend"] == "native_batch"
    assert s["implementation"] == "DFA"


def test_batch_random_equals_loop() -> None:
    """Random document mixes (empty documents, boundary matches, repeats)
    under tiny staging budgets that force the grouped multi-dispatch
    path: the batch equals the per-document loop (test_batch.py's
    property test, drawn from a seed)."""
    rng = random.Random(13)
    pats = ["a", "ab", "abc", "ca b", "bb"]
    budgets = [None, 64, 256]
    for trial in range(12):
        docs = [
            "".join(rng.choice("abc ") for _ in range(rng.randint(0, 60)))
            for _ in range(rng.randint(0, 20))
        ]
        kind = KINDS[trial % 3]
        backend = ("auto", "device")[trial % 2]
        budget = budgets[trial % 3]
        orig = port_api.BATCH_STAGE_BYTES
        if budget is not None:
            port_api.BATCH_STAGE_BYTES = budget
        try:
            ac = port.AhoCorasick(
                pats, matchkind=port.MatchKind[kind], backend=backend,
                device="cpu",
            )
            want = [ac.find_matches_as_indexes(d) for d in docs]
            assert ac.find_matches_as_indexes_batch(docs) == want
            if kind == "Standard":
                assert ac.find_matches_as_indexes_batch(
                    docs, overlapping=True
                ) == [ac.find_matches_as_indexes(d, overlapping=True)
                      for d in docs]
        finally:
            port_api.BATCH_STAGE_BYTES = orig
