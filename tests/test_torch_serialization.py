"""PyTorch port, serialization: the cases of ``tests/test_serialization.py``
on the port (``device="cpu"``), then the file route between the packages
in both directions.  A matcher file written by either package holds the
same arrays and the same meta record as the other's for the same matcher
(compared key by key: ``np.savez_compressed`` stamps its zip entries with
the time), and loads in the other package with the saving side's tuples.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu_torch as port
from ahocorasick_rs_tpu.utils import serialization as ref_ser
from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch.utils.serialization import (
    load_automaton,
    load_matcher,
    save_automaton,
    save_matcher,
)

KINDS = ["Standard", "LeftmostFirst", "LeftmostLongest"]
IMPLS = ["DFA", "ContiguousNFA", "NoncontiguousNFA"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the cases of tests/test_serialization.py, on the port ----------------
def test_automaton_roundtrip(tmp_path) -> None:
    am = build_automaton([b"hello", b"world", b"lo wo"])
    path = str(tmp_path / "am.npz")
    save_automaton(path, am)
    am2 = load_automaton(path)
    assert am2.num_states == am.num_states
    assert np.array_equal(am2.edge_keys, am.edge_keys)
    assert np.array_equal(am2.fail, am.fail)
    assert np.array_equal(am2.match_pids, am.match_pids)
    assert np.array_equal(am2.delta, am.delta)
    assert am2.max_len == am.max_len


def test_matcher_roundtrip_str(tmp_path) -> None:
    patterns = ["winter", "disco", "discontent"]
    ac = port.AhoCorasick(
        patterns, matchkind=port.MatchKind.LeftmostLongest, device="cpu"
    )
    path = str(tmp_path / "m.npz")
    save_matcher(path, ac)
    ac2 = load_matcher(path, device="cpu")
    hay = "the winter of my discontent"
    assert ac2.find_matches_as_indexes(hay) == ac.find_matches_as_indexes(hay)
    assert ac2.find_matches_as_strings(hay) == ac.find_matches_as_strings(hay)
    with pytest.raises(ValueError):
        ac2.find_matches_as_indexes(hay, overlapping=True)


def test_matcher_roundtrip_bytes(tmp_path) -> None:
    b = port.BytesAhoCorasick([b"ab", b"bc", b"abcd"], device="cpu")
    path = str(tmp_path / "b.npz")
    save_matcher(path, b)
    b2 = load_matcher(path, device="cpu")
    hay = b"xxabcdxx"
    assert b2.find_matches_as_indexes(hay) == b.find_matches_as_indexes(hay)
    assert b2.find_matches_as_indexes(
        hay, overlapping=True
    ) == b.find_matches_as_indexes(hay, overlapping=True)


def test_matcher_roundtrip_keeps_patterns(tmp_path) -> None:
    raw = [b"\xff\xfe", b"ab\x00cd", b"hello"]
    b = port.BytesAhoCorasick(raw, device="cpu")
    path = str(tmp_path / "p.npz")
    save_matcher(path, b)
    b2 = load_matcher(path, device="cpu")
    assert b2._byte_patterns == raw
    assert b2._teddy_state == "auto"

    ac = port.AhoCorasick(["alpha", "beta"], store_patterns=False,
                          device="cpu")
    path2 = str(tmp_path / "p2.npz")
    save_matcher(path2, ac)
    ac2 = load_matcher(path2, device="cpu")
    assert ac2._patterns is None
    assert ac2._byte_patterns == [b"alpha", b"beta"]
    assert ac2.find_matches_as_strings("a beta alpha") == ["beta", "alpha"]


def test_version_check(tmp_path) -> None:
    am = build_automaton([b"x"])
    path = str(tmp_path / "v.npz")
    save_automaton(path, am)
    data = dict(np.load(path))
    data["__format__"] = np.int64(99)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="automaton format version 99"):
        load_automaton(path)


def test_matcher_version_checks(tmp_path) -> None:
    ac = port.AhoCorasick(["ab"], device="cpu")
    path = str(tmp_path / "m.npz")
    save_matcher(path, ac)
    data = dict(np.load(path))
    assert int(data["__format__"]) == 2

    bad = dict(data)
    bad["__format__"] = np.int64(99)
    np.savez(path, **bad)
    with pytest.raises(ValueError, match="version 99"):
        load_matcher(path, device="cpu")

    v1 = dict(data)
    v1["__format__"] = np.int64(1)
    del v1["pattern_blob"]
    np.savez(path, **v1)
    with pytest.raises(ValueError, match="re-save"):
        load_matcher(path, device="cpu")


def test_tuned_prefilter_config_roundtrips(tmp_path) -> None:
    ac = port.AhoCorasick(["hello", "world", "zebra", "quartz"], device="cpu")
    ac._pf_config = {"m": 4, "words": 1, "passes": 1}
    path = str(tmp_path / "m.npz")
    save_matcher(path, ac)
    loaded = load_matcher(path, device="cpu")
    assert loaded._pf_config == {"m": 4, "words": 1, "passes": 1}
    loaded._teddy_state = "force"
    teddy = loaded._get_teddy()
    assert (teddy.m, teddy.words, teddy.passes) == (4, 1, 1)
    got = loaded.find_matches_as_indexes("say hello to the zebra world")
    assert got == ac.find_matches_as_indexes("say hello to the zebra world")
    assert loaded.stats()["last_backend"] == "teddy"


def test_load_matcher_needs_a_card_unless_cpu_is_asked(
    tmp_path, monkeypatch
) -> None:
    """As the constructors: without CUDA the default device raises."""
    path = str(tmp_path / "m.npz")
    save_matcher(path, port.AhoCorasick(["ab"], device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_matcher(path, **kw)
    loaded = load_matcher(path, device="cpu")
    assert loaded._device == torch.device("cpu")
    assert loaded.find_matches_as_indexes("xabx") == [(0, 1, 3)]


# -- the file route between the packages -----------------------------------
def _words(seed: int, count: int) -> list[str]:
    rng = random.Random(seed)
    return ["".join(rng.choice("abcdeé") for _ in range(rng.randint(2, 6)))
            for _ in range(count)]


def _text(seed: int, patterns: list[str], n: int = 3000) -> str:
    rng = random.Random(seed)
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(rng.choice(patterns) if rng.random() < 0.3
                     else rng.choice("abcdeé xy"))
    return "".join(parts)


def _make(pkg, cls: str, patterns, kind: str, impl: str, **kw):
    if pkg is port:
        kw["device"] = "cpu"
    return getattr(pkg, cls)(
        patterns, matchkind=pkg.MatchKind[kind],
        implementation=pkg.Implementation[impl], **kw,
    )


def _answers(m, hay, kind: str) -> list:
    out = [m.find_matches_as_indexes(hay)]
    if kind == "Standard":
        out.append(m.find_matches_as_indexes(hay, overlapping=True))
    if hasattr(m, "find_matches_as_strings"):
        out.append(m.find_matches_as_strings(hay))
    return out


def _same_file_contents(path_a: str, path_b: str) -> None:
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert json.loads(bytes(a["__meta__"])) == json.loads(
            bytes(b["__meta__"])
        )


def _cross(tmp_path, cls, patterns, hay, kind, impl, pf_config=None, **kw):
    """Save the same matcher from both packages, hold the files equal, and
    load each file in the other package."""
    sides = {pkg: _make(pkg, cls, patterns, kind, impl, **kw)
             for pkg in (ref, port)}
    paths = {}
    for pkg, m in sides.items():
        m._pf_config = pf_config
        paths[pkg] = str(tmp_path / f"{pkg.__name__}.npz")
        (ref_ser.save_matcher if pkg is ref else save_matcher)(paths[pkg], m)
    _same_file_contents(paths[ref], paths[port])
    loaded = {
        port: load_matcher(paths[ref], device="cpu"),  # reference-saved
        ref: ref_ser.load_matcher(paths[port]),  # port-saved
    }
    for pkg, m in loaded.items():
        saver = sides[ref if pkg is port else port]
        assert type(m).__name__ == cls
        assert m._byte_patterns == saver._byte_patterns
        assert m._pf_config == pf_config
        assert m._implementation.name == impl
        assert getattr(m, "_patterns", None) == getattr(
            saver, "_patterns", None
        )
        assert _answers(m, hay, kind) == _answers(saver, hay, kind)
    return loaded, sides


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cls", ["AhoCorasick", "BytesAhoCorasick"])
def test_files_cross_between_packages(tmp_path, cls, kind, impl) -> None:
    seed = KINDS.index(kind) * 3 + IMPLS.index(impl)
    words = _words(seed, 25)
    text = _text(seed + 100, words)
    if cls == "AhoCorasick":
        patterns, hay = words, text
    else:
        patterns, hay = [w.encode() for w in words], text.encode()
    _, sides = _cross(tmp_path, cls, patterns, hay, kind, impl)
    assert _answers(sides[ref], hay, kind)[0]


@pytest.mark.parametrize("kind", KINDS)
def test_files_cross_store_patterns_false(tmp_path, kind) -> None:
    words = _words(40, 30)
    loaded, _ = _cross(tmp_path, "AhoCorasick", words, _text(41, words),
                       kind, "DFA", store_patterns=False)
    assert all(m._patterns is None for m in loaded.values())


def test_files_cross_non_utf8_byte_patterns(tmp_path) -> None:
    raw = [b"\xff\xfe", b"ab\x00cd", b"\x80\x81\x82", b"hello", b"\xfe"]
    hay = b"..\xff\xfe\xfe..ab\x00cd\x80\x81\x82hello\xff" * 20
    for kind in KINDS:
        loaded, _ = _cross(tmp_path, "BytesAhoCorasick", raw, hay, kind,
                           "DFA")
        assert all(m._byte_patterns == raw for m in loaded.values())


def test_files_cross_tuned_prefilter(tmp_path) -> None:
    """A tuned config written by either package rebuilds the same
    prefilter in the other, and the loaded matcher's Teddy tier gives the
    saving side's tuples."""
    words = ["hello", "world", "zebra", "quartz", "lantern", "marble"]
    text = _text(50, words, 4000)
    cfg = {"m": 4, "words": 2, "passes": 2}
    loaded, sides = _cross(tmp_path, "AhoCorasick", words, text,
                           "LeftmostLongest", "DFA", pf_config=cfg)
    want = sides[ref].find_matches_as_indexes(text)
    for m in loaded.values():
        m._teddy_state = "force"
        t = m._get_teddy()
        assert (t.m, t.words, t.passes) == (4, 2, 2)
        assert m.find_matches_as_indexes(text) == want
        assert m.stats()["last_backend"] == "teddy"
    np.testing.assert_array_equal(loaded[port]._teddy.tables.numpy(),
                                  np.asarray(loaded[ref]._teddy.tables))
