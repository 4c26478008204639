"""PyTorch port, host layer: tables, fingerprints and resolvers are
identical to the JAX package's on the same pattern sets.

Pattern sets are drawn as ``test_native_builder.py`` (random short words
over small alphabets) and ``test_properties.py`` (arbitrary unicode and
binary patterns, suffixed to stay distinct) draw them.  Everything compared
is an integer array, so every comparison is exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import ahocorasick_rs_tpu.models.automaton as ref_automaton
import ahocorasick_rs_tpu.models.engine as ref_engine
import ahocorasick_rs_tpu.models.native as ref_native
import ahocorasick_rs_tpu.models.prefilter as ref_prefilter
import ahocorasick_rs_tpu.ops.resolve as ref_resolve
import ahocorasick_rs_tpu.ops.scan_host as ref_scan_host
import ahocorasick_rs_tpu_torch.models.automaton as port_automaton
import ahocorasick_rs_tpu_torch.models.engine as port_engine
import ahocorasick_rs_tpu_torch.models.native as port_native
import ahocorasick_rs_tpu_torch.models.prefilter as port_prefilter
import ahocorasick_rs_tpu_torch.ops.resolve as port_resolve
import ahocorasick_rs_tpu_torch.ops.scan_host as port_scan_host
from ahocorasick_rs_tpu_torch.utils import convert

KINDS = ["standard", "leftmost_first", "leftmost_longest"]


def _words(seed: int, count: int, alphabet: bytes) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
        for _ in range(count)
    ]


def _unicode(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    out = []
    for i in range(count):
        s = "".join(
            chr(rng.choice([rng.randint(32, 126), rng.randint(160, 0x2FFF),
                            rng.randint(0x1F300, 0x1F64F)]))
            for _ in range(rng.randint(1, 6))
        )
        out.append(f"{s}_{i}_".encode("utf-8"))
    return out


def _binary(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.randrange(256) for _ in range(rng.randint(1, 9)))
        for _ in range(count)
    ]


PATTERN_SETS = {
    "abcd-300": lambda: _words(0, 300, b"abcd"),
    "abcdefgh-80": lambda: _words(1, 80, b"abcdefgh"),
    "unicode-60": lambda: _unicode(2, 60),
    "binary-50": lambda: _binary(3, 50),
    "dups": lambda: [b"\x00\xff", b"\xff", b"\x00\xff", b"\x00", b"ab\x00cd"],
    "nested": lambda: [b"a" * k for k in range(1, 17)],
}

AUTOMATON_ARRAYS = (
    "edge_keys", "edge_targets", "fail", "depth", "match_offsets",
    "match_pids", "match_lens", "match_count", "pattern_lens", "delta",
    "delta_classed", "byte_classes",
)


def _assert_automata_equal(a, b) -> None:
    assert a.num_states == b.num_states
    assert a.num_patterns == b.num_patterns
    assert a.max_len == b.max_len
    for name in AUTOMATON_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for x, y in zip(a.sparse, b.sparse):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(PATTERN_SETS))
def test_automaton_tables_identical(name: str) -> None:
    pats = PATTERN_SETS[name]()
    _assert_automata_equal(
        ref_automaton.build_automaton(pats),
        port_automaton.build_automaton(pats),
    )


@pytest.mark.skipif(not ref_native.available(), reason="no C++ toolchain")
@pytest.mark.parametrize("seed", range(2))
def test_native_builder_identical(seed: int) -> None:
    """The port's own native library builds the same tables (it compiles
    its own copy of ac_builder.cpp beside its package)."""
    assert port_native.available()
    assert port_native._LIB_PATH != ref_native._LIB_PATH
    pats = _words(seed, 3000, b"xyz0123")
    _assert_automata_equal(
        ref_native.build_automaton_native(pats),
        port_native.build_automaton_native(pats),
    )


@pytest.mark.parametrize("name", sorted(PATTERN_SETS))
def test_prefilter_identical(name: str) -> None:
    pats = PATTERN_SETS[name]()
    a = ref_prefilter.build_prefilter(pats)
    b = port_prefilter.build_prefilter(pats)
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.m, a.words, a.passes) == (b.m, b.words, b.passes)
    assert a.est_fire_rate == b.est_fire_rate
    np.testing.assert_array_equal(a.tables, b.tables)
    np.testing.assert_array_equal(a.bucket_of, b.bucket_of)


@pytest.mark.parametrize(
    "config", [(8, 8, 1), (4, 2, 2), (3, 1, 1)], ids=str
)
def test_prefilter_config_identical(config) -> None:
    m, words, passes = config
    pats = _words(5, 120, b"abcdefghij")
    a = ref_prefilter.build_prefilter_config(pats, m, words, passes)
    b = port_prefilter.build_prefilter_config(pats, m, words, passes)
    np.testing.assert_array_equal(a.tables, b.tables)
    np.testing.assert_array_equal(a.bucket_of, b.bucket_of)


def _occurrences(mod_automaton, mod_scan_host, mod_resolve, pats, hay):
    am = mod_automaton.build_automaton(pats)
    pos, st = mod_scan_host.scan_python(am, hay)
    return mod_resolve.expand_occurrences(am, pos, st)


@pytest.mark.parametrize("seed", range(3))
def test_resolvers_identical(seed: int) -> None:
    rng = np.random.default_rng(seed)
    alpha = int(rng.choice([2, 3, 5]))
    pats = list({
        bytes(rng.integers(0, alpha, int(rng.integers(1, 7)), dtype=np.uint8))
        for _ in range(10)
    })
    hay = bytes(rng.integers(0, alpha, 600, dtype=np.uint8))
    ref_occ = _occurrences(ref_automaton, ref_scan_host, ref_resolve, pats, hay)
    port_occ = _occurrences(
        port_automaton, port_scan_host, port_resolve, pats, hay
    )
    for x, y in zip(ref_occ, port_occ):
        np.testing.assert_array_equal(x, y)
    am_r = ref_automaton.build_automaton(pats)
    am_p = port_automaton.build_automaton(pats)
    pos, st = ref_scan_host.scan_numpy_lanes(am_r, np.frombuffer(hay, np.uint8))
    pos_p, st_p = port_scan_host.scan_numpy_lanes(
        am_p, np.frombuffer(hay, np.uint8)
    )
    np.testing.assert_array_equal(pos, pos_p)
    np.testing.assert_array_equal(st, st_p)
    for kind in KINDS:
        for overlapping in ([False, True] if kind == "standard" else [False]):
            want = ref_resolve.resolve(
                *ref_occ, kind=kind, overlapping=overlapping
            )
            assert port_resolve.resolve(
                *port_occ, kind=kind, overlapping=overlapping
            ) == want
            assert port_resolve.resolve_from_scan_small(
                am_p, pos_p, st_p, kind, overlapping
            ) == ref_resolve.resolve_from_scan_small(
                am_r, pos, st, kind, overlapping
            )
            cuts = sorted({0, len(ref_occ[2])} | {
                int(c) for c in rng.integers(0, len(ref_occ[2]) + 1, 4)
            })
            sr = {
                "ref": ref_resolve.StreamResolver(
                    kind, overlapping, am_r.max_len
                ),
                "port": port_resolve.StreamResolver(
                    kind, overlapping, am_p.max_len
                ),
            }
            ends = ref_occ[2]
            for a, b in zip(cuts, cuts[1:]):
                # cut only on end-position boundaries, as the scanners do
                while b < len(ends) and b > 0 and ends[b] == ends[b - 1]:
                    b += 1
                if b <= a:
                    continue
                bound = int(ends[b - 1])
                sr["ref"].feed(*(x[a:b] for x in ref_occ), bound)
                sr["port"].feed(*(x[a:b] for x in port_occ), bound)
            assert sr["port"].result() == sr["ref"].result()


@pytest.mark.skipif(not ref_native.available(), reason="no C++ toolchain")
@pytest.mark.parametrize("kind", KINDS)
def test_native_resolvers_identical(kind: str) -> None:
    pats = [b"a" * k for k in (1, 2, 3, 7)] + [b"ba", b"ab" * 4]
    rng = np.random.default_rng(7)
    hay = np.frombuffer(
        b"".join(b"a" * int(rng.integers(0, 30)) + b"b" for _ in range(300)),
        dtype=np.uint8,
    )
    am_r = ref_automaton.build_automaton(pats)
    am_p = port_automaton.build_automaton(pats)
    for x, y in zip(
        ref_native.resolve_scan_native(am_r, hay, kind),
        port_native.resolve_scan_native(am_p, hay, kind),
    ):
        np.testing.assert_array_equal(x, y)
    if kind != "standard":
        lt_r = ref_native.build_leftmost_table(pats)
        lt_p = port_native.build_leftmost_table(pats)
        np.testing.assert_array_equal(lt_r, lt_p)
        bl, bp = port_native.leftmost_best(am_p)
        for x, y in zip(
            ref_native.resolve_leftmost_native(
                lt_r, *ref_native.leftmost_best(am_r), hay, kind
            ),
            port_native.resolve_leftmost_native(lt_p, bl, bp, hay, kind),
        ):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["abcd-300", "unicode-60", "nested"])
def test_convert_round_trips_reference_arrays(name: str) -> None:
    pats = PATTERN_SETS[name]()
    ref = ref_automaton.build_automaton(pats)
    am = convert.automaton_from_arrays(
        ref.edge_keys, ref.edge_targets, ref.fail, ref.depth,
        ref.match_offsets, ref.match_pids, ref.pattern_lens,
    )
    _assert_automata_equal(ref, am)
    pf = ref_prefilter.build_prefilter(pats)
    if pf is not None:
        got = convert.prefilter_from_arrays(
            pf.m, pf.words, pf.passes, pf.tables, pf.bucket_of,
            pf.est_fire_rate,
        )
        np.testing.assert_array_equal(got.tables, pf.tables)
        np.testing.assert_array_equal(got.bucket_of, pf.bucket_of)
        np.testing.assert_array_equal(got.byte_allowed(), pf.byte_allowed())
        with pytest.raises(ValueError):
            convert.prefilter_from_arrays(
                pf.m + 1, pf.words, pf.passes, pf.tables, pf.bucket_of, 0.0
            )


@pytest.mark.parametrize("name", sorted(PATTERN_SETS))
def test_select_engine_agrees_on_cpu(name: str) -> None:
    pats = PATTERN_SETS[name]()
    am = port_automaton.build_automaton(pats)
    assert port_engine.auto_budgets() == (
        port_engine._FALLBACK_DENSE_BUDGET,
        port_engine._FALLBACK_CLASSED_BUDGET,
    )
    assert (
        port_engine.select_engine(am, "cpu").name
        == ref_engine.select_engine(ref_automaton.build_automaton(pats)).name
    )
