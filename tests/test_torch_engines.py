"""PyTorch port, module level: the stride-2 dense scan (K6) and the sparse
CSR scan (K7) equal the JAX package's ``_scan_compact2``,
``_scan_compact_sparse`` and ``scan_device`` on the same inputs, run on
the CPU through the kernels' plain versions.  Every comparison is exact.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
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


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


def _corpus(seed: int, n: int, names: list[bytes], plant: int) -> bytes:
    rng = np.random.default_rng(seed)
    hay = bytearray(
        np.frombuffer(b"zyxwvuts", np.uint8)[rng.integers(0, 8, n)].tobytes()
    )
    for _ in range(plant):
        nm = names[int(rng.integers(len(names)))]
        off = int(rng.integers(n - len(nm)))
        hay[off : off + len(nm)] = nm
    return bytes(hay)


def _port_automaton(am):
    """The reference's very automaton, carried across as arrays."""
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


#: longest name 18 bytes (odd halo 17, rounded up to 18) or 17 (even 16)
LONGEST = {"odd-halo": b"abcdefghabcdefghab", "even-halo": b"abcdefghabcdefgha"}


def _layout(n: int, halo: int, hay: bytes) -> tuple[int, int, np.ndarray]:
    L, T = port_scan.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(hay, dtype=np.uint8)
    return L, T, buf


@pytest.mark.parametrize("halo_kind", sorted(LONGEST))
@pytest.mark.parametrize("engine", ["dfa", "classed"])
def test_scan_compact2_equals_reference(engine: str, halo_kind: str) -> None:
    names = _names(1, 40) + [LONGEST[halo_kind], b"zy"]
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    halo = ref_am.max_len - 1
    halo += halo & 1
    hay = _corpus(2, 7001, names, 40)
    n = len(hay)
    L, T, buf = _layout(n, halo, hay)
    rt = ref_scan.DeviceTables(ref_am, engine)
    pt = port_scan.DeviceTables(am, engine, "cpu")
    assert rt.ensure_packed2() and pt.ensure_packed2()
    np.testing.assert_array_equal(pt.packed2.numpy(), np.asarray(rt.packed2))
    for cap in (64, 4096):
        want = ref_scan._scan_compact2(
            rt.packed2, rt.table_classed, rt.classes2, jnp.asarray(buf),
            jnp.int32(n), L, T, halo, cap,
        )
        got = port_scan._scan_compact2(
            pt.packed2, pt.table_classed, pt.classes2, torch.from_numpy(buf),
            n, L, T, halo, cap,
        )
        assert int(got[2]) == int(want[2]) > 64
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("segment_bytes", [1 << 20, 2999, 1024])
def test_scan_device_stride2_equals_reference(
    engine: str, segment_bytes: int
) -> None:
    """Default tables on both sides (stride-2), odd halo, and small forced
    segments whose seams fall inside matches."""
    names = _names(3, 30) + [LONGEST["odd-halo"]]
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    hay = bytearray(_corpus(4, 12_001, names, 60))
    for seam in range(segment_bytes, len(hay), segment_bytes):
        hay[seam - 9 : seam + 9] = LONGEST["odd-halo"]
    hay = np.frombuffer(bytes(hay), dtype=np.uint8)
    want = ref_scan.scan_device(
        ref_am, hay, ref_scan.DeviceTables(ref_am, engine),
        segment_bytes=segment_bytes,
    )
    tabs = port_scan.DeviceTables(am, engine, "cpu")
    got = port_scan.scan_device(am, hay, tabs, segment_bytes=segment_bytes)
    assert tabs.packed2 is not None  # the stride-2 scan ran
    k2 = port_scan.scan_device(
        am, hay, port_scan.DeviceTables(am, engine, "cpu", packed2_max_bytes=0),
        segment_bytes=segment_bytes,
    )
    assert len(want[0]) > 40
    for a, b, c in zip(got, want, k2):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize(
    "engine,budget", [("dfa", None), ("dfa", 0), ("dfa", 5000),
                      ("classed", None), ("classed", 1 << 30),
                      ("classed", 0), ("sparse", None)],
)
def test_packed2_budget_rule_equals_reference(engine: str, budget) -> None:
    names = _names(5, 60)
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    kw = {} if budget is None else {"packed2_max_bytes": budget}
    rt = ref_scan.DeviceTables(ref_am, engine, **kw)
    pt = port_scan.DeviceTables(am, engine, "cpu", **kw)
    assert pt._packed2_ok == rt._packed2_ok
    assert pt.ensure_packed2() == rt.ensure_packed2()
    assert (pt.packed2 is None) == (rt.packed2 is None)


def test_packed2_classed_budget_caps_at_64_mib(monkeypatch) -> None:
    """The classed engine holds packed2 to min(budget, 64 MiB): a table
    just over 64 MiB is refused however large the caller's budget."""
    ref_am = build_automaton(_names(6, 20))
    am = _port_automaton(ref_am)
    over = (64 << 20) + 4
    for a in (ref_am, am):
        monkeypatch.setattr(type(a), "packed2_bytes", property(lambda s: over))
    for engine, ok in (("classed", False), ("dfa", True)):
        rt = ref_scan.DeviceTables(ref_am, engine, packed2_max_bytes=1 << 30)
        pt = port_scan.DeviceTables(am, engine, "cpu",
                                    packed2_max_bytes=1 << 30)
        assert pt._packed2_ok == rt._packed2_ok == ok


@pytest.mark.parametrize(
    "hay,dense",
    [(b"a" * (1 << 15), True), (b"xyz" * 3000, False)],
    ids=["all-a", "no-matches"],
)
def test_stride2_match_dense_error_on_same_inputs(
    monkeypatch, hay: bytes, dense: bool
) -> None:
    monkeypatch.setattr(ref_scan, "DENSE_BAILOUT_MIN", 64)
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", 64)
    ref_am = build_automaton([b"a" * k for k in range(1, 9)] + [b"ab"])
    am = _port_automaton(ref_am)
    arr = np.frombuffer(hay, dtype=np.uint8)
    outcomes = []
    for scan, a, tabs, err in (
        (ref_scan.scan_device, ref_am, ref_scan.DeviceTables(ref_am, "dfa"),
         RefDenseError),
        (port_scan.scan_device, am, port_scan.DeviceTables(am, "dfa", "cpu"),
         MatchDenseError),
    ):
        try:
            outcomes.append(scan(a, arr, tabs))
        except err as e:
            outcomes.append(str(e))
    if dense:
        assert outcomes[0] == outcomes[1]
        assert "matched positions in a" in outcomes[1]
    else:
        for x, y in zip(*outcomes):
            np.testing.assert_array_equal(x, y)


def _sparse_names() -> list[bytes]:
    # "abcd" then "bcx": a lane walks fail links ("bc", "c", the root)
    # before it finds the edge of "bcx"; "q" misses at every depth
    return _names(7, 25) + [b"abcd", b"bcx", b"cdq"]


def test_scan_compact_sparse_equals_reference() -> None:
    names = _sparse_names()
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    halo = ref_am.max_len - 1
    hay = _corpus(8, 3001, names, 30) + b"abcxabcqbcx" * 5
    n = len(hay)
    L, T, buf = _layout(n, halo, hay)
    rt = ref_scan.DeviceTables(ref_am, "sparse")
    pt = port_scan.DeviceTables(am, "sparse", "cpu")
    for cap in (16, 4096):
        want = ref_scan._scan_compact_sparse(
            rt.keys, rt.targets, rt.fail, rt.match_count, jnp.asarray(buf),
            jnp.int32(n), L, T, halo, cap,
        )
        got = port_scan._scan_compact_sparse(
            pt.sparse, torch.from_numpy(buf), n, L, T, halo, cap,
        )
        assert int(got[2]) == int(want[2]) > 16
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("segment_bytes", [1 << 20, 1500])
def test_scan_device_sparse_equals_reference(segment_bytes: int) -> None:
    names = _sparse_names()
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    hay = np.frombuffer(
        _corpus(9, 4000, names, 40) + b"abcxabcd" * 20, dtype=np.uint8
    )
    want = ref_scan.scan_device(
        ref_am, hay, ref_scan.DeviceTables(ref_am, "sparse"),
        segment_bytes=segment_bytes,
    )
    got = port_scan.scan_device(
        am, hay, port_scan.DeviceTables(am, "sparse", "cpu"),
        segment_bytes=segment_bytes,
    )
    assert len(want[0]) > 40
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sparse_scan_without_patterns() -> None:
    """No edges at all (E = 0): every state is the root and nothing
    matches.  The JAX package's sparse device scan raises a gather error
    here (it reads ``targets[0]`` of an empty array), so the port is held
    against the JAX package's python tier instead."""
    am = _port_automaton(build_automaton([]))
    hay = np.frombuffer(b"abc" * 100, dtype=np.uint8)
    pos, st = port_scan.scan_device(
        am, hay, port_scan.DeviceTables(am, "sparse", "cpu")
    )
    assert len(pos) == len(st) == 0
    got = port.BytesAhoCorasick(
        [], implementation=port.Implementation.NoncontiguousNFA,
        backend="device", device="cpu",
    ).find_matches_as_indexes(hay.tobytes())
    assert got == ref.BytesAhoCorasick(
        [], backend="python"
    ).find_matches_as_indexes(hay.tobytes()) == []


@pytest.mark.parametrize("kind", ["Standard", "LeftmostFirst", "LeftmostLongest"])
def test_sparse_device_api_equals_reference(monkeypatch, kind: str) -> None:
    """NoncontiguousNFA with backend='device' scans on the device (K7) in
    both packages; auto-routed sparse scans stay on the host."""
    pats = ["content", "disco", "disc", "discontent", "winter", "on"]
    hay = "this is the winter of my discontent, contented disco " * 40
    mk = {"matchkind": None, "implementation": None, "backend": "device"}
    got_ac = port.AhoCorasick(
        pats, **{**mk, "matchkind": port.MatchKind[kind],
                 "implementation": port.Implementation.NoncontiguousNFA},
        device="cpu",
    )
    want_ac = ref.AhoCorasick(
        pats, **{**mk, "matchkind": ref.MatchKind[kind],
                 "implementation": ref.Implementation.NoncontiguousNFA},
    )
    want = want_ac.find_matches_as_indexes(hay)
    assert len(want) > 40
    assert got_ac.find_matches_as_indexes(hay) == want
    assert got_ac.stats()["last_backend"] == "device"
    assert got_ac._get_device_tables().engine == "sparse"
    if kind == "Standard":
        assert got_ac.find_matches_as_indexes(hay, overlapping=True) == (
            want_ac.find_matches_as_indexes(hay, overlapping=True)
        )
    # a device-sized auto scan of the sparse engine stays on the host
    monkeypatch.setattr(port_api, "DEVICE_TIER_MIN", 64)
    auto = port.AhoCorasick(
        pats, matchkind=port.MatchKind[kind],
        implementation=port.Implementation.NoncontiguousNFA, device="cpu",
    )
    auto._device_amortized = lambda n: True
    assert auto.find_matches_as_indexes(hay) == want
    assert auto.stats()["last_backend"] in ("native", "numpy")
