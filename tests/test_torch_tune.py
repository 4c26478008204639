"""PyTorch port, ``tune()``: the prefilter candidates it measures equal the
JAX package's (shapes, estimates and tables), each candidate's Teddy scan
gives the reference's occurrences on the same haystack, the tuned matcher
keeps the python tier's tuples, and the chosen config survives
``save_matcher``/``load_matcher``.  The port runs with ``device="cpu"``;
the reference's Teddy scan runs its Pallas kernel in interpret mode.  The
chosen config is a timing and may differ between the packages, so it is
not compared.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
import ahocorasick_rs_tpu_torch as port
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu.models.prefilter import (
    build_prefilter_candidates as ref_candidates,
)
from ahocorasick_rs_tpu_torch.models.prefilter import (
    build_prefilter_candidates as port_candidates,
)
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy
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


def _tune_case() -> tuple[list[str], str]:
    """The inputs of tests/test_teddy.py::test_tune_picks_a_config_and_stays_exact."""
    rng = random.Random(9)
    pats = [
        "".join(chr(rng.randint(97, 122)) for _ in range(5))
        for _ in range(80)
    ]
    hay = "".join(chr(rng.randint(97, 122)) for _ in range(4_000))
    hay = hay[:100] + pats[3] + hay[100:200] + pats[50] + hay[200:]
    return pats, hay


PATTERN_SETS = {
    "tune_case": [p.encode() for p in _tune_case()[0]],
    "names": [bytes(random.Random(3).choice(b"abcdefghij")
                    for _ in range(random.Random(i).randint(4, 9)))
              for i in range(200)],
    "short": [b"hello", b"world", b"zebra", b"quartz"],
}


def test_tune_picks_a_config_and_stays_exact() -> None:
    pats, hay = _tune_case()
    ac = port.AhoCorasick(pats, device="cpu")
    ac._teddy_state = "force"
    report = ac.tune(hay)
    assert isinstance(report["chosen"], dict)
    assert len(report["candidates"]) >= 2
    want = port.AhoCorasick(
        pats, backend="python", device="cpu"
    ).find_matches_as_indexes(hay)
    assert ac.find_matches_as_indexes(hay) == want
    assert ac.stats()["last_backend"] == "teddy"
    t = ac._teddy
    assert report["chosen"] == {"m": t.m, "words": t.words,
                                "passes": t.passes}
    assert ac._pf_config == report["chosen"]
    assert ac._teddy_state == "force"
    assert ref.AhoCorasick(
        pats, backend="python"
    ).find_matches_as_indexes(hay) == want


@pytest.mark.parametrize("name", sorted(PATTERN_SETS))
def test_candidates_equal_reference(name: str) -> None:
    pats = PATTERN_SETS[name]
    want = ref_candidates(pats)
    got = port_candidates(pats)
    assert len(want) >= 2
    assert [(p.m, p.words, p.passes, p.est_fire_rate) for p in got] == [
        (p.m, p.words, p.passes, p.est_fire_rate) for p in want
    ]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tables, b.tables)
        np.testing.assert_array_equal(a.bucket_of, b.bucket_of)


def test_each_candidate_scans_as_the_reference() -> None:
    """For every candidate, the port's ``TeddyScanner.occurrences`` equals
    the reference's on one haystack (the reference's kernel in interpret
    mode)."""
    pats = PATTERN_SETS["names"]
    rng = random.Random(7)
    hay = bytearray(rng.choice(b"abcdefghijklmnop ") for _ in range(30_000))
    for i in range(0, len(hay) - 10, 251):
        p = pats[rng.randrange(len(pats))]
        hay[i : i + len(p)] = p
    arr = np.frombuffer(bytes(hay), dtype=np.uint8)
    ref_am = build_automaton(pats)
    am = convert.automaton_from_arrays(
        ref_am.edge_keys, ref_am.edge_targets, ref_am.fail, ref_am.depth,
        ref_am.match_offsets, ref_am.match_pids, ref_am.pattern_lens,
    )
    rt = ref_scan.DeviceTables(ref_am, "dfa", packed2_max_bytes=0)
    pt = port_scan.DeviceTables(am, "dfa", "cpu")
    seen = set()
    for pf_ref, pf_port in zip(ref_candidates(pats), port_candidates(pats)):
        rs = ref_teddy.TeddyScanner(
            ref_am, pf_ref, rt.table, rt.classes, rt.match_count,
            rt.use_classes,
        )
        ps = port_teddy.TeddyScanner(
            am, pf_port, pt.table, pt.classes, pt.match_count,
            pt.use_classes,
        )
        want = rs.occurrences(arr)
        got = ps.occurrences(arr, hay2d=ps.stage(arr))
        assert (got is None) == (want is None)
        if want is not None:
            assert len(want[0]) > 50
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        seen.add((pf_port.m, pf_port.words, pf_port.passes))
    assert len(seen) >= 3


@pytest.mark.parametrize("cls", ["AhoCorasick", "BytesAhoCorasick"])
def test_tuned_tuples_equal_python_tier(cls: str) -> None:
    pats, hay = _tune_case()
    if cls == "BytesAhoCorasick":
        pats, hay = [p.encode() for p in pats], hay.encode()
    for kind in ("Standard", "LeftmostFirst", "LeftmostLongest"):
        mk = getattr(port, cls)
        ac = mk(pats, matchkind=port.MatchKind[kind], device="cpu")
        ac._teddy_state = "force"
        report = ac.tune(hay)
        assert [set(c) for c in report["candidates"]] == [
            {"m", "words", "passes", "est_fire_rate", "seconds"}
        ] * len(report["candidates"])
        want = mk(pats, matchkind=port.MatchKind[kind], backend="python",
                  device="cpu").find_matches_as_indexes(hay)
        assert ac.find_matches_as_indexes(hay) == want
        assert ac.stats()["last_backend"] == "teddy"


def test_tuned_config_survives_save_and_load(tmp_path) -> None:
    pats, hay = _tune_case()
    ac = port.AhoCorasick(pats, device="cpu")
    ac._teddy_state = "force"
    chosen = ac.tune(hay)["chosen"]
    path = str(tmp_path / "tuned.npz")
    port.save_matcher(path, ac)
    loaded = port.load_matcher(path, device="cpu")
    assert loaded._pf_config == chosen
    loaded._teddy_state = "force"
    assert loaded.find_matches_as_indexes(hay) == ac.find_matches_as_indexes(
        hay
    )
    t = loaded._teddy
    assert (t.m, t.words, t.passes) == tuple(chosen.values())


def test_tune_reports_as_the_reference_on_its_early_outs() -> None:
    """The sparse engine has no prefilter, and a corpus on which every
    candidate fires everywhere falls back: both give the reference's
    report, candidate for candidate."""
    sides = [
        pkg.AhoCorasick(
            ["ab", "cd"], implementation=pkg.Implementation.NoncontiguousNFA,
            **({"device": "cpu"} if pkg is port else {}),
        ).tune("abcd" * 100)
        for pkg in (ref, port)
    ]
    assert sides[0] == sides[1] == {
        "candidates": [], "chosen": "none (sparse engine has no prefilter)"
    }
    hay = "a" * 300_000
    sides = [
        pkg.AhoCorasick(
            ["a", "b"], **({"device": "cpu"} if pkg is port else {})
        ).tune(hay)
        for pkg in (ref, port)
    ]
    assert sides[0] == sides[1]
    assert sides[1]["chosen"] == "none (all candidates fell back)"
    assert len(sides[1]["candidates"]) >= 2
    assert all(c["seconds"] == float("inf") for c in sides[1]["candidates"])
