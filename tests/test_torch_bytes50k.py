"""The ``bytes50k_ovl_cnfa`` deployment on the CPU: 50,000 random byte
signatures through ``BytesAhoCorasick``'s dense device path (the
byte-classed table, K2 and K3 as their plain versions), across segment
seams, against the benchmark's plain reference; and the binary text's
seeding, which must not replay the patterns' stream."""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ahocorasick_rs_tpu_torch import (  # noqa: E402
    BytesAhoCorasick,
    Implementation,
    MatchKind,
)
from ahocorasick_rs_tpu_torch.ops import scan_cuda  # noqa: E402
from portbench import config, run, traffic  # noqa: E402
from portbench.reference import Reference  # noqa: E402

CELL = "bytes50k-bin1g"
SEED = 2147500101
#: the segment length the tests cut ``scan_device`` to, and the document
SEGMENT = 64 << 10
DOC_BYTES = 256 << 10
#: the patterns' halo (the longest is 11 bytes): every context after the
#: first starts this many bytes before its first new byte
HALO = 10
#: the first new byte of every segment after the first: each context,
#: halo and new bytes, is ``SEGMENT`` bytes, the last one what is left
SEAMS = list(range(SEGMENT, DOC_BYTES, SEGMENT - HALO))


@pytest.fixture(scope="module")
def spec() -> dict:
    return run.cell_spec(run.load_bench(), CELL)


@pytest.fixture(scope="module")
def patterns(spec) -> list[bytes]:
    pats = config.patterns(spec["config"], SEED)
    assert len(pats) == 50_000
    return pats


@pytest.fixture(scope="module")
def matcher(patterns):
    """The matcher of a match kind, built once: Standard serves both
    overlapping modes.  One is held at a time (about 1.6 GB each)."""
    held: dict = {}

    def get(kind: str) -> BytesAhoCorasick:
        if kind not in held:
            held.clear()
            held[kind] = BytesAhoCorasick(
                patterns, matchkind=MatchKind[kind],
                implementation=Implementation.ContiguousNFA,
                backend="device", device="cpu")
        return held[kind]

    yield get
    held.clear()


def _document(spec, patterns) -> bytes:
    """A 256 KiB binary document of the cell's text, with one of the
    longest patterns planted across every segment seam."""
    params = dict(spec["traffic"], doc_chars=DOC_BYTES)
    doc = bytearray(traffic.inputs(patterns, params, SEED)[0])
    top = max(map(len, patterns))
    assert top - 1 == HALO
    longest = [p for p in patterns if len(p) == top]
    for k, seam in enumerate(SEAMS):
        p = longest[k]
        at = seam - len(p) // 2
        doc[at : at + len(p)] = p
    return bytes(doc)


@pytest.mark.parametrize("kind,overlapping", [
    ("Standard", True), ("Standard", False), ("LeftmostLongest", False)])
def test_segmented_dense_path_equals_the_reference(
    spec, patterns, matcher, kind, overlapping, monkeypatch
):
    cfg = spec["config"]
    assert (cfg["matcher"], cfg["implementation"], cfg["backend"]) == (
        "BytesAhoCorasick", "ContiguousNFA", "device")
    layouts: list = []
    orig_layout = scan_cuda.choose_layout

    def spy(m, halo):
        assert halo == HALO
        layouts.append((m, orig_layout(m, halo)))
        return layouts[-1][1]

    monkeypatch.setattr(scan_cuda, "choose_layout", spy)
    monkeypatch.setattr(scan_cuda, "scan_device", functools.partial(
        scan_cuda.scan_device, segment_bytes=SEGMENT))
    doc = _document(spec, patterns)
    ac = matcher(kind)
    got = ac.find_matches_as_indexes(doc, overlapping=overlapping)
    assert ac.stats()["last_backend"] == "device"
    tables = ac._get_device_tables()
    assert tables.engine == "classed" and tables.packed2 is None  # K2
    # five contexts, the last 40 bytes: no layout past the segment, and
    # padding of at most one minimal layout in all
    assert len(layouts) == len(SEAMS) + 1 == 5
    assert [m for m, _ in layouts] == [SEGMENT] * 4 + [DOC_BYTES - SEAMS[-1]
                                                      + HALO]
    assert all(L * T <= SEGMENT for _, (L, T) in layouts)
    assert sum(L * T - m for m, (L, T) in layouts) <= (
        scan_cuda.MIN_LANES * scan_cuda.TARGET_TIME)
    want = Reference(patterns, kind, overlapping=overlapping).find(doc)
    assert got == want
    # the planted signatures and the seams' plants, at least
    assert len(want) >= 64 + len(SEAMS)
    for seam in SEAMS:
        assert any(s < seam < e for _p, s, e in want), seam


@pytest.mark.parametrize("seed", [1, SEED])
def test_binary_document_zero_does_not_replay_the_patterns(spec, seed):
    """Document 0 of 1 MiB holds its 64 plants and at most a few chance
    matches: a text seeded as the recipe is would hold every pattern."""
    pats = config.patterns(spec["config"], seed)
    params = dict(spec["traffic"], doc_chars=1 << 20)
    assert params["planted"] == 64
    doc = traffic.inputs(pats, params, seed)[0]
    assert len(doc) == 1 << 20
    found = Reference(pats, "Standard", overlapping=True).find(doc)
    assert 64 - 2 <= len(found) <= 64 + 8
    # the same seed gives the same bytes; another index other bytes
    assert doc == traffic.inputs(pats, params, seed)[0]
    two = traffic.inputs(pats, dict(params, distinct=2), seed)
    assert two[0] == doc and two[1] != doc
    head = np.frombuffer(doc[:4096], dtype=np.uint8)
    assert len(np.unique(head)) > 200  # uniform bytes
