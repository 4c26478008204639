"""PyTorch port, module level: the dense device scan (``scan_cuda``) and
the Teddy pipeline (``scan_teddy``) equal the JAX package's on the same
inputs, run on the CPU through the kernels' plain versions.

The dense path here is the one-byte scan (K2): both sides build their
``DeviceTables`` with ``packed2_max_bytes=0``, which turns the stride-2
scan off (``test_torch_engines.py`` holds the stride-2 scan).  Every
comparison is exact.
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
from ahocorasick_rs_tpu.models.prefilter import build_prefilter
from ahocorasick_rs_tpu.ops.resolve import MatchDenseError as RefDenseError
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy
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

ENGINES = ["dfa", "classed"]


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


def _corpus(seed: int, n: int, names: list[bytes], plant: int) -> bytes:
    rng = random.Random(seed)
    hay = bytearray(bytes(rng.choice(b"zyxwvuts") for _ in range(n)))
    for _ in range(plant):
        nm = names[rng.randrange(len(names))]
        off = rng.randrange(n - len(nm))
        hay[off : off + len(nm)] = nm
    return bytes(hay)


def _port_automaton(am):
    """The reference's very automaton, carried across as arrays."""
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_scan_compact_equals_reference(engine: str) -> None:
    names = _names(1, 40) + [b"zy"]
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    hay = np.frombuffer(_corpus(2, 7000, names, 40), dtype=np.uint8)
    n, halo = len(hay), ref_am.max_len - 1
    L, T = port_scan.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = hay
    rt = ref_scan.DeviceTables(ref_am, engine, packed2_max_bytes=0)
    pt = port_scan.DeviceTables(am, engine, "cpu")
    for cap in (64, 4096):
        want = ref_scan._scan_compact(
            rt.table, rt.classes, jnp.asarray(buf), rt.match_count,
            jnp.int32(n), L, T, halo, cap, rt.use_classes,
        )
        got = port_scan._scan_compact(
            pt.table, pt.classes, torch.from_numpy(buf), pt.match_count,
            n, L, T, halo, cap, pt.use_classes,
        )
        assert int(got[2]) == int(want[2]) > 64
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("segment_bytes", [1 << 20, 3000, 1024])
def test_scan_device_equals_reference(engine: str, segment_bytes: int) -> None:
    """Small forced segments make the scan cross seams mid-match."""
    names = _names(3, 30) + [b"abcdefghabcdefghab"]
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    hay = bytearray(_corpus(4, 12_000, names, 60))
    for seam in range(segment_bytes, len(hay), segment_bytes):
        hay[seam - 9 : seam + 9] = b"abcdefghabcdefghab"
    hay = np.frombuffer(bytes(hay), dtype=np.uint8)
    want = ref_scan.scan_device(
        ref_am, hay,
        ref_scan.DeviceTables(ref_am, engine, packed2_max_bytes=0),
        segment_bytes=segment_bytes,
    )
    got = port_scan.scan_device(
        am, hay,
        port_scan.DeviceTables(am, engine, "cpu", packed2_max_bytes=0),
        segment_bytes=segment_bytes,
    )
    assert len(want[0]) > 40
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_scan_device_empty_and_sticky_cap() -> None:
    am = build_automaton([b"ab", b"ba"])
    tabs = port_scan.DeviceTables(am, "dfa", "cpu", packed2_max_bytes=0)
    pos, st = port_scan.scan_device(am, np.zeros(0, np.uint8), tabs)
    assert len(pos) == len(st) == 0
    hay = np.frombuffer(b"ab" * 6000, dtype=np.uint8)
    pos, _ = port_scan.scan_device(am, hay, tabs)
    assert len(pos) == 11_999
    assert tabs.last_cap == 16384  # grown by the overflow retry, sticky


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize(
    "hay,bailout_min,dense",
    [
        (b"a" * (1 << 15), 64, True),
        (b"a" * 5000 + b"b" + b"a" * 3000, 64, True),
        (b"ab" * 4000, 1 << 22, False),
        (b"xyz" * 3000, 64, False),
    ],
    ids=["all-a", "nested", "under-min", "no-matches"],
)
def test_match_dense_error_on_same_inputs(
    monkeypatch, engine: str, hay: bytes, bailout_min: int, dense: bool
) -> None:
    """Mirrors the density cases of tests/test_resolve_stream.py."""
    monkeypatch.setattr(ref_scan, "DENSE_BAILOUT_MIN", bailout_min)
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", bailout_min)
    pats = [b"a" * k for k in range(1, 9)] + [b"ab"]
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    arr = np.frombuffer(hay, dtype=np.uint8)
    outcomes = []
    for scan, a, tabs, err in (
        (ref_scan.scan_device, ref_am,
         ref_scan.DeviceTables(ref_am, engine, packed2_max_bytes=0),
         RefDenseError),
        (port_scan.scan_device, am,
         port_scan.DeviceTables(am, engine, "cpu", packed2_max_bytes=0),
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


def _scanners(names: list[bytes], engine: str, pf=None):
    ref_am = build_automaton(names)
    am = _port_automaton(ref_am)
    pf = pf or build_prefilter(names)
    assert pf is not None
    rt = ref_scan.DeviceTables(ref_am, engine, packed2_max_bytes=0)
    ref = ref_teddy.TeddyScanner(
        ref_am, pf, rt.table, rt.classes, rt.match_count, rt.use_classes
    )
    pt = port_scan.DeviceTables(am, engine, "cpu")
    port = port_teddy.TeddyScanner(
        am,
        convert.prefilter_from_arrays(
            pf.m, pf.words, pf.passes, pf.tables, pf.bucket_of,
            pf.est_fire_rate,
        ),
        pt.table, pt.classes, pt.match_count, pt.use_classes,
    )
    return ref, port


@pytest.mark.parametrize("engine", ENGINES)
def test_fire_verify_equals_reference(engine: str) -> None:
    names = _names(5, 50)
    ref, port = _scanners(names, engine)
    np.testing.assert_array_equal(
        port.vtable.numpy(), np.asarray(ref.vtable)
    )
    hay = np.frombuffer(_corpus(6, 20_000, names, 60), dtype=np.uint8)
    n = len(hay)
    W = ref.am.max_len + ref_teddy.COARSE - 1
    for cap, cap2 in ((32, 16), (1 << 14, 1 << 12)):
        want = ref_teddy._fire_verify(
            ref.tables, ref.vtable, ref.classes, ref.stage(hay),
            jnp.int32(n), cap, cap2, ref.m, ref.words, ref.passes, W,
            ref.use_classes,
        )
        got = port_teddy._fire_verify(
            port.tables, port.vtable, port.classes, port.stage(hay), n,
            cap, cap2, port.m, port.words, port.passes, W, port.use_classes,
        )
        ftotal, mtotal = int(want[1]), int(want[5])
        assert int(got[1]) == ftotal and ftotal > 32
        trusted = ftotal <= cap and mtotal <= cap2
        if ftotal <= cap:
            assert int(got[5]) == mtotal
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if trusted:
            for i in (2, 3, 4):
                np.testing.assert_array_equal(
                    got[i].numpy(), np.asarray(want[i])
                )
        assert trusted == (cap == 1 << 14)


@pytest.mark.parametrize("engine", ENGINES)
def test_teddy_occurrences_equal_reference(engine: str) -> None:
    names = _names(7, 50) + [b"ab"]
    ref, port = _scanners(names, engine)
    hay = np.frombuffer(_corpus(8, 30_000, names, 80), dtype=np.uint8)
    want = ref.occurrences(hay)
    got = port.occurrences(hay)
    assert want is not None and got is not None
    assert len(want[0]) > 80
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (port.fire_cap, port.match_cap) == (ref.fire_cap, ref.match_cap)


def test_teddy_streamed_equals_single_dispatch() -> None:
    """occurrences_streamed with a small seg_bytes == one dispatch,
    including matches that straddle the segment cuts."""
    patterns = [b"hello", b"world", b"boundary"]
    rng = random.Random(4)
    hay = bytearray(bytes(rng.randrange(97, 123) for _ in range(40_000)))
    seg = 8192
    for cut in range(seg, len(hay), seg):
        hay[cut - 4 : cut + 4] = b"boundary"
    for i in range(0, len(hay) - 8, 1111):
        hay[i : i + 5] = b"hello"
    arr = np.frombuffer(bytes(hay), dtype=np.uint8)
    ref, port = _scanners(patterns, "dfa")
    whole = port.occurrences(arr)
    streamed = port.occurrences_streamed(arr, seg_bytes=seg)
    want = ref.occurrences(arr)
    assert whole is not None and streamed is not None
    for a, b, c in zip(whole, streamed, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert (whole[0] == 2).sum() >= 3


@pytest.mark.parametrize("seg", [3000, 4096, 10_007])
def test_teddy_streamed_match_across_every_seam(seg: int) -> None:
    """Each seam of the streamed pipeline cuts a planted match (both the
    longest pattern, which reaches into the next segment's window, and a
    short one); the streamed scan equals one dispatch and the reference."""
    patterns = [b"seamseamseam", b"xq", b"hello"]
    rng = random.Random(seg)
    hay = bytearray(bytes(rng.randrange(97, 123) for _ in range(5 * seg)))
    for cut in range(seg, len(hay), seg):
        hay[cut - 6 : cut + 6] = b"seamseamseam"
        hay[cut - 13 : cut - 11] = b"xq"
    arr = np.frombuffer(bytes(hay), dtype=np.uint8)
    ref, port = _scanners(patterns, "classed")
    whole = port.occurrences(arr)
    streamed = port.occurrences_streamed(arr, seg_bytes=seg)
    want = ref.occurrences(arr)
    assert streamed is not None
    for a, b, c in zip(whole, streamed, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    starts, ends = streamed[1], streamed[2]
    for cut in range(seg, len(hay), seg):
        assert ((starts < cut) & (ends > cut)).any()
    assert port._copy_stream is None  # the CPU stages in place


def test_teddy_dense_corpus_falls_back() -> None:
    """The corpus of test_teddy.py::test_teddy_dense_corpus_falls_back."""
    patterns = [bytes([c]) for c in b"abcdefgh"] + [b"abcdefghabcd"]
    hay = bytes(random.Random(1).choice(b"abcdefgh") for _ in range(200_000))
    ref, port = _scanners(patterns, "dfa")
    arr = np.frombuffer(hay, dtype=np.uint8)
    assert port.occurrences(arr) is None
    assert port.worthwhile is False
    assert ref.occurrences(arr) is None
    assert port.fire_cap == ref.fire_cap
