"""The ``pii100k_std_mesh4`` deployment on the CPU: 100,000 keywords,
Standard, ContiguousNFA, over a local mesh of four thread ranks
(``backend="sharded"``, the plain K2 and K3 on each rank), on the seamed
LONG text, against the benchmark's plain reference and the single-device
port; the shard seams' exchange, the engine the card would pick, the
seamed text and the cell's spec."""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ahocorasick_rs_tpu_torch import (  # noqa: E402
    AhoCorasick,
    Implementation,
    MatchKind,
)
from ahocorasick_rs_tpu_torch.models import engine  # noqa: E402
from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE  # noqa: E402
from ahocorasick_rs_tpu_torch.parallel import sharded  # noqa: E402
from portbench import config, run, traffic  # noqa: E402
from portbench.cell import make_matcher  # noqa: E402
from portbench.reference import Reference  # noqa: E402
from portbench.texts import long_lines, seamed_lines  # noqa: E402

CELL = "pii100k-doc1g-mesh4"
SEED = 2147527001
#: the document, and the seam that four ranks cut it at: ``dense_layout``
#: gives each rank 512 lanes of 512 bytes
DOC_BYTES = 1 << 20
SEAM = 1 << 18
SEAMS = [SEAM, 2 * SEAM, 3 * SEAM]
RANKS = 4


@pytest.fixture(scope="module")
def spec() -> dict:
    return run.cell_spec(run.load_bench(), CELL)


@pytest.fixture(scope="module")
def patterns(spec) -> list[str]:
    pats = config.patterns(spec["config"], SEED)
    assert len(pats) == 100_000
    return pats


@pytest.fixture(scope="module")
def doc(spec, patterns) -> str:
    params = dict(spec["traffic"], doc_chars=DOC_BYTES, seam_bytes=SEAM)
    (d,) = traffic.inputs(patterns, params, SEED)
    return d


@pytest.fixture(scope="module")
def mesh_matcher(spec, patterns):
    return make_matcher(spec["config"], patterns, ["cpu"] * RANKS)


@pytest.fixture(scope="module")
def want(patterns, doc) -> list:
    return Reference(patterns, "Standard").find(doc)


def test_cell_spec_reads_every_key(spec):
    cfg = spec["config"]
    assert set(cfg) == set(config.MATCHER_KEYS + config.CALL_KEYS
                           + config.RECORD_KEYS) - {"store_patterns"}
    assert (cfg["chips"], spec["chips"], cfg["mesh"]) == (4, 4, "local")
    assert (cfg["matcher"], cfg["matchkind"], cfg["implementation"],
            cfg["backend"], cfg["overlapping"]) == (
        "AhoCorasick", "Standard", "ContiguousNFA", "sharded", False)
    assert cfg["patterns"] == {"recipe": "names", "count": 100_000}
    assert cfg["reduced"] == ["chips", "doc_chars"]
    params = spec["traffic"]
    assert (params["call"], params["text"], params["distinct"]) == (
        "doc", "seamed_lines", 1)
    assert params["doc_chars"] == 4 * params["seam_bytes"] == 1 << 30
    assert set(params) - set(traffic.KEYS) == set(seamed_lines.KEYS)
    # the seams fall where four ranks cut a 1 GiB document, with no padding
    L, T = sharded.dense_layout(1 << 30, 4, 10)
    assert L * T == params["seam_bytes"]
    assert ("doc_mb_per_s", "MB/s") in spec["end_to_end"]
    layer = dict(spec["per_layer"])
    assert layer["exchange_ms.doc"] == "ms"
    assert layer["gather_bytes_per_byte.doc"] == "B/B"


def test_select_engine_picks_contiguous_nfa_on_an_80gb_card(
    mesh_matcher, monkeypatch
):
    am = mesh_matcher._automaton
    assert (am.num_states, am.num_classes, am.max_len) == (507_390, 28, 11)
    memory = 80 * 10**9
    monkeypatch.setattr(engine, "auto_budgets",
                        lambda device=None: (memory // 16, memory // 4))
    assert engine.select_engine(am, torch.device("cuda", 0)) is (
        Implementation.ContiguousNFA)
    # the DFA is over its cap, the byte-classed table well inside the budget
    assert am.num_states * 257 * 4 > engine._DENSE_AUTO_CAP
    assert am.num_states * am.num_classes * 4 < 60 * 10**6


def test_the_mesh_equals_the_reference_and_one_device(
    patterns, doc, mesh_matcher, want, monkeypatch
):
    layouts: list = []
    orig = sharded.dense_layout

    def spy(n, n_dev, halo, *a):
        layouts.append(orig(n, n_dev, halo, *a))
        return layouts[-1]

    monkeypatch.setattr(sharded, "dense_layout", spy)
    ac = mesh_matcher
    assert isinstance(ac._mesh, sharded.LocalMesh) and ac._mesh.size == RANKS
    got = ac.find_matches_as_indexes(doc)
    assert ac.stats()["last_backend"] == "sharded"
    assert {L * T for L, T in layouts} == {SEAM}
    assert got == want
    one = AhoCorasick(patterns, matchkind=MatchKind.Standard,
                      implementation=Implementation.ContiguousNFA,
                      backend="device", device="cpu")
    assert one.find_matches_as_indexes(doc) == want
    assert one.stats()["last_backend"] == "device"
    # the LONG text's names and the seams' plants
    assert len(want) >= DOC_BYTES // 640 // 90 + len(SEAMS)


def test_a_keyword_across_a_seam_needs_the_exchange(
    doc, mesh_matcher, want, monkeypatch
):
    for s in SEAMS:
        across = [m for m in want if m[1] < s < m[2]]
        assert len(across) == 1, (s, across)

    def no_exchange(shard, n_local, halo):
        return torch.full((halo,), PAD_BYTE, dtype=torch.int32,
                          device=shard.device)

    monkeypatch.setattr(sharded, "shard_tail", no_exchange)
    got = mesh_matcher.find_matches_as_indexes(doc)
    lost = set(want) - set(got)
    assert len(lost) >= len(SEAMS)
    for s in SEAMS:
        assert any(a < s < b for _p, a, b in lost), s


def test_seamed_lines_plant_a_keyword_across_every_seam(spec, patterns, doc):
    params = dict(spec["traffic"], doc_chars=DOC_BYTES, seam_bytes=SEAM)
    plain = long_lines.document(patterns, params, DOC_BYTES, 0, SEED)
    assert len(doc) == len(plain) == DOC_BYTES and doc.isascii()
    assert seamed_lines.seams(DOC_BYTES, SEAM) == SEAMS
    kept, edits = 0, []
    for s in SEAMS:
        # the plant and its two spaces: a pattern spanning the seam
        left = doc.rindex(" ", 0, s)
        right = doc.index(" ", s)
        word = doc[left + 1 : right]
        assert word in patterns
        assert left + 1 == s - len(word) // 2
        edits.append((left, right + 1))
    at = 0
    for a, b in edits:
        assert doc[at:a] == plain[at:a]
        kept += a - at
        at = b
    assert doc[at:] == plain[at:]
    assert kept + len(doc) - at >= DOC_BYTES - len(SEAMS) * 13
    # the same seed gives the same document, another seed other plants
    again = traffic.inputs(patterns, params, SEED)[0]
    assert again == doc
    other = seamed_lines.document(patterns, params, DOC_BYTES, 0, SEED + 1)
    assert other != doc and len(other) == DOC_BYTES


def test_seamed_lines_refuse_seams_too_close(patterns):
    params = {"name_every": 90, "seam_bytes": 8}
    with pytest.raises(ValueError, match="no room"):
        seamed_lines.document(patterns, params, 64, 0, SEED)
