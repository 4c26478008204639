"""What decides ``correct``: the reference agrees with the port, the
control and each planted fault make ``correct`` false.  CPU, tiny sizes;
the card's own run is marked ``gpu``."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import pytest
import torch

import ahocorasick_rs_tpu_torch.api as api
from ahocorasick_rs_tpu_torch import (AhoCorasick, BytesAhoCorasick,
                                      Implementation, MatchKind)
from ahocorasick_rs_tpu_torch.ops import resolve as port_resolve
from ahocorasick_rs_tpu_torch.parallel import sharded
from portbench import config, control, run, traffic
from portbench.cell import run_cell
from portbench.reference import Reference

BENCH = run.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: each cell cut to a size the CPU's plain kernels run in a blink
TINY = {"doc": {"doc_chars": 120_000},
        "batch": {"corpus_lines": 900, "lines_per_call": 300}}


def tiny_spec(cell: str) -> dict:
    spec = run.cell_spec(BENCH, cell)
    spec["traffic"].update(TINY[spec["traffic"]["call"]])
    return spec


def synthetic(cfg: dict, params: dict) -> dict:
    """A spec of a cell that ``BENCHMARK.json`` does not hold: the ways a
    later cell may configure the harness, at a tiny size."""
    base = config.load(os.path.join(run.HERE, "configs",
                                    "names4k_std_dfa.json"))
    base.update(cfg)
    return {"workload": "synthetic", "config": config.check(base),
            "traffic": params, "chips": base["chips"],
            "end_to_end": [("setup_s", "s")],
            "per_layer": [("api_self_ms.doc", "ms"),
                          ("api_self_ms.batch", "ms")]}


#: the harness's other paths: several callers, bytes and overlapping
#: matches, a local mesh of four ranks, the SHORT recipe
SYNTHETIC = {
    "callers3-lines": synthetic(
        {"patterns": {"recipe": "names", "count": 300}},
        {"call": "batch", "text": "long_lines", "corpus_lines": 900,
         "lines_per_call": 150, "callers": 3}),
    "bytes-overlapping": synthetic(
        {"matcher": "BytesAhoCorasick", "overlapping": True,
         "patterns": {"recipe": "random_bytes", "count": 2000,
                      "min_len": 5, "max_len": 11}},
        {"call": "doc", "text": "random_bytes", "doc_chars": 200_000,
         "distinct": 2, "planted": 64}),
    "mesh4": synthetic(
        {"backend": "sharded", "mesh": "local", "chips": 4},
        {"call": "doc", "text": "long_lines", "doc_chars": 200_000,
         "distinct": 2}),
    "short-lines": synthetic(
        {"patterns": {"recipe": "short"}, "implementation": None,
         "backend": "native"},
        {"call": "batch", "text": "short_lines", "corpus_lines": 600,
         "lines_per_call": 200}),
}


def tiny_run(cell, seed: int = 5, trace: bool = False) -> dict:
    spec = SYNTHETIC[cell] if cell in SYNTHETIC else tiny_spec(cell)
    devices = ["cpu"] * spec["chips"]
    return run_cell(spec, seed, 0.3, trace, t_start=time.time(),
                    devices=devices, log=lambda s: None)


@pytest.mark.parametrize("kind", ["Standard", "LeftmostLongest"])
@pytest.mark.parametrize("count", [1000, 4244])
def test_reference_equals_the_port_on_the_cells_inputs(kind, count):
    names = config.patterns({"patterns": {"recipe": "names",
                                          "count": count}}, 17)
    ref = Reference(names, kind)
    port = AhoCorasick(names, matchkind=MatchKind[kind],
                       implementation=Implementation.DFA, backend="native",
                       device="cpu")
    params = dict(traffic.load("doc64m"), doc_chars=300_000, distinct=2)
    for doc in traffic.inputs(names, params, 17):
        want = port.find_matches_as_indexes(doc)
        assert want and ref.find(doc) == want
    bp = dict(traffic.load("lines20k"), corpus_lines=2000,
              lines_per_call=1000)
    for batch in traffic.inputs(names, bp, 17):
        want = port.find_matches_as_indexes_batch(batch)
        assert any(want) and ref.find_batch(batch) == want


def test_reference_equals_the_port_on_planted_bytes_overlapping():
    pats = config.patterns({"patterns": {"recipe": "random_bytes",
                                         "count": 5000, "min_len": 5,
                                         "max_len": 11}}, 8)
    ref = Reference(pats, "Standard", overlapping=True)
    port = BytesAhoCorasick(pats, implementation=Implementation.DFA,
                            backend="native", device="cpu")
    params = {"call": "doc", "text": "random_bytes", "doc_chars": 300_000,
              "distinct": 2, "planted": 200}
    for doc in traffic.inputs(pats, params, 8):
        want = port.find_matches_as_indexes(doc, overlapping=True)
        assert len(want) >= 200 and ref.find(doc) == want


@pytest.mark.parametrize("kind,overlapping", [
    ("Standard", False), ("LeftmostLongest", False), ("Standard", True)])
def test_reference_semantics_on_overlapping_patterns(kind, overlapping):
    """Nested and overlapping patterns, non-ASCII haystacks, bytes: the
    port's python tier is the upstream semantics."""
    rng = random.Random(f"{kind}{overlapping}")
    for trial in range(40):
        pats = sorted({"".join(rng.choice("abcé") for _ in
                               range(rng.randint(1, 5)))
                       for _ in range(rng.randint(1, 8))})
        ref = Reference(pats, kind, overlapping=overlapping)
        port = AhoCorasick(pats, matchkind=MatchKind[kind],
                           backend="python", device="cpu")
        bpats = [p.encode() for p in pats]
        bref = Reference(bpats, kind, overlapping=overlapping)
        bport = BytesAhoCorasick(bpats, matchkind=MatchKind[kind],
                                 backend="python", device="cpu")
        for _ in range(20):
            hay = "".join(rng.choice("abcé\n") for _ in
                          range(rng.randint(0, 60)))
            assert ref.find(hay) == port.find_matches_as_indexes(
                hay, overlapping=overlapping), (pats, hay)
            assert bref.find(hay.encode()) == bport.find_matches_as_indexes(
                hay.encode(), overlapping=overlapping), (pats, hay)
        docs = ["".join(rng.choice("abcé") for _ in range(rng.randint(0, 9)))
                for _ in range(12)]
        assert ref.find_batch(docs) == port.find_matches_as_indexes_batch(
            docs, overlapping=overlapping)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {n for n, _ in
                                   run.cell_spec(BENCH, cell)["end_to_end"]}


@pytest.mark.parametrize("cell", sorted(SYNTHETIC))
def test_the_harness_other_paths_run_correct(cell):
    out = tiny_run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["host"]["callers"] == traffic.callers(
        SYNTHETIC[cell]["traffic"])
    call = SYNTHETIC[cell]["traffic"]["call"]
    assert out["metrics"][f"api_self_ms.{call}"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS + ["bytes-overlapping"])
def test_the_control_fails(cell):
    """The reference without its byte check, at a tiny size, fails the
    numbers a run compares (the chip run reads it at the cell's size)."""
    spec = SYNTHETIC[cell] if cell in SYNTHETIC else tiny_spec(cell)
    got = control.readings(spec, seed=23)
    assert got["wrong_calls"] >= 1 and got["wrong_tuples"] >= 1


def _alter_first(res):
    if res and isinstance(res[0], tuple):
        p, s, e = res[0]
        return [(p, s, e + 1)] + res[1:]
    return res


def _plant(monkeypatch, fault: str) -> None:
    if fault == "scan_state_unchanged":
        # the scan hands back its output unfilled: no match anywhere
        monkeypatch.setattr(api._MatcherBase, "_find",
                            lambda self, hay, ov: [])
        monkeypatch.setattr(api._MatcherBase, "_find_batch",
                            lambda self, docs, ov: [[] for _ in docs])
    elif fault == "half_batch_left_out":
        orig = api._MatcherBase._find_batch

        def half(self, docs, ov):
            out = orig(self, docs[: len(docs) // 2], ov)
            return out + [[] for _ in docs[len(docs) // 2:]]

        monkeypatch.setattr(api._MatcherBase, "_find_batch", half)
    elif fault == "exchange_left_out":
        # every rank reads its own part in place of each other rank's
        monkeypatch.setattr(
            sharded.ThreadGroup, "all_gather",
            lambda self, t: torch.stack([t.clone()] * self.size))
    elif fault == "answer_altered":
        for name in ("resolve", "resolve_from_scan_small"):
            orig = getattr(port_resolve, name)
            monkeypatch.setattr(
                port_resolve, name,
                lambda *a, _o=orig, **k: _alter_first(_o(*a, **k)))
        orig_b = port_resolve.resolve_batch
        monkeypatch.setattr(
            port_resolve, "resolve_batch",
            lambda *a, **k: [_alter_first(r) for r in orig_b(*a, **k)])
    else:
        raise ValueError(fault)


FAULTS = [(c, f) for c in CELLS for f in
          ("scan_state_unchanged", "answer_altered")]
FAULTS += [("names4k-lines20k", "half_batch_left_out"),
           ("callers3-lines", "half_batch_left_out"),
           ("bytes-overlapping", "answer_altered"),
           ("mesh4", "exchange_left_out")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    _plant(monkeypatch, fault)
    out = tiny_run(cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = run.cell_spec(BENCH, cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    got = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ, PYTHONPATH=run.ROOT))
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"]
