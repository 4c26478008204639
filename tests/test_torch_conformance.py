"""PyTorch port, the device conformance tool
(``ahocorasick_rs_tpu_torch.tools.gpu_conformance``) on the CPU.

Its copied inputs equal the JAX package's conformance tool's
(``tools/tpu_conformance.py``, loaded from its file) byte for byte; its
brute-force oracle equals the JAX package's ``python`` tier; a run over
the kernels' plain versions, with the corpora and cases cut to 4 KiB, ends
with no mismatch and the TPU record's part A matrix; a planted fault in a
plain kernel makes the sweep report the mismatch with a smaller input, and
the command exit 1; and it needs a card unless the CPU is asked for.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import time

import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.utils.cache
from ahocorasick_rs_tpu_torch.models.engine import MatchKind
from ahocorasick_rs_tpu_torch.ops import scan_cuda
from ahocorasick_rs_tpu_torch.tools import gpu_conformance as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOOL = os.path.join(ROOT, "tools", "tpu_conformance.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_tool():
    """The reference's conformance module, loaded from its file with its
    persistent-cache hook switched off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ahocorasick_rs_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location("_ref_tpu_conformance",
                                                      REF_TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def test_corpora_equal_reference(ref_tool) -> None:
    want = ref_tool.corpora()
    got = tool.corpora()
    assert [c[0] for c in got] == [c[0] for c in want]
    for (_, gp, gh), (_, wp, wh) in zip(got, want):
        assert gp == wp
        assert gh == wh


def test_unicode_case_equals_reference() -> None:
    """The reference builds its ``str`` case inside ``main``: its two
    assignments, read from the file, equal the port's copy."""
    with open(REF_TOOL) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    values = {t.id: n.value for n in ast.walk(main)
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name)}
    upats = ast.literal_eval(values["upats"])
    body = eval(compile(ast.Expression(values["body"]), REF_TOOL, "eval"),
                {"__builtins__": {}})
    assert tool.unicode_case() == (upats, body)


def test_brute_oracle_equals_reference_python_tier() -> None:
    """200 seeded sweep cases (haystacks cut to 2 KiB), every semantics."""
    total = 0
    for i in range(200):
        pats, hay, _, _ = tool.gen_case(1, i, max_bytes=2048)
        for kind, ov in tool.SEMANTICS:
            want = ref.BytesAhoCorasick(
                pats, matchkind=ref.MatchKind[kind], backend="python"
            ).find_matches_as_indexes(hay, overlapping=ov)
            assert tool.oracle(pats, hay, MatchKind[kind], ov) == want, (
                i, kind, ov)
            total += len(want)
    assert total > 10_000


def test_sweep_reaches_the_shapes() -> None:
    """The first 200 cases of seed 0 hold the shapes the fixed inputs
    miss: max_len over COARSE, a state of over 48 edges, each haystack
    length class, every alphabet, batches of 1 and 64 documents."""
    metas = [tool.gen_case(0, i)[3] for i in range(200)]
    assert max(m["max_len"] for m in metas) > 32
    assert any(m["wide"] for m in metas)
    assert max(m["patterns"] for m in metas) > 400
    ns = {m["n"] for m in metas}
    assert {0, 1} <= ns
    assert any(n % 2 and n < 128 for n in ns)
    assert ns & {(1 << 14) - 1, 1 << 14, (1 << 14) + 1}
    assert max(ns) > 1 << 20
    assert {m["alphabet"] for m in metas} == {2, 4, 26, 256}
    assert {1, 64} <= {m["documents"] for m in metas}
    # the same case from the same seed and index, whatever ran before
    assert tool.gen_case(0, 7)[:3] == tool.gen_case(0, 7)[:3]
    pats, hay, cuts, meta = tool.gen_case(0, 7)
    assert b"".join(tool.split_docs(hay, cuts)) == hay
    assert len(tool.split_docs(hay, cuts)) == meta["documents"]


def test_cpu_run_has_no_mismatch(tmp_path) -> None:
    """Every part over the plain versions, the corpora and cases cut to
    4 KiB, the first 8 cases of part C: no mismatch, every device tier
    served, and part A is the TPU record's matrix."""
    out = tmp_path / "conformance.json"
    record = tool.run("cpu", cases=8, out=str(out), max_bytes=4096,
                      verbose=False)
    assert record["mismatches"] == []
    assert record["uncovered"] == []
    assert record["ok"]
    assert record["cases"] == 8
    assert json.loads(out.read_text())["ok"]
    with open(os.path.join(ROOT, "TPU_CONFORMANCE_r05.json")) as f:
        tpu = json.load(f)["cases"]
    keys = ("corpus", "matchkind", "overlapping", "teddy", "implementation")
    assert [tuple(r.get(k) for k in keys) for r in record["part_a"]] == [
        tuple(c.get(k) for k in keys) for c in tpu]
    checks = {r["check"] for r in record["part_b"]}
    assert {"sparse engine (K7)", "scan_device pairs", "dense seams",
            "streamed Teddy seams", "batch", "sharded, one rank",
            "sharded batch, one rank", "sharded, 2 gloo ranks"} <= checks
    assert record["part_c"]["special"]["overflow"] == 1
    assert record["part_c"]["oracle"]["brute"] > 0
    ranks = next(r for r in record["part_b"]
                 if r["check"] == "sharded, 2 gloo ranks")
    assert ranks["calls"] == 12 and not ranks.get("failed")


def test_batch_overflow_case() -> None:
    """Case 15 of seed 0 reuses case 14's matchers, its batch matcher too,
    on match-dense inputs: no mismatch."""
    sw = tool.Sweep(torch.device("cpu"), False)
    prev: dict = {}
    for index in (14, 15):
        tool.run_case(sw, 0, index, 4096, prev)
    assert sw.mismatches == []
    assert sw.c_special["overflow"] == 1
    assert sw.c_special["batch_overflow"] == 1


_COMPACT_PLAIN = scan_cuda._compact_plain
_COMPACT_STATES = scan_cuda._compact_states


def _drop_last_index(mask, cap):
    idx, total = _COMPACT_PLAIN(mask, cap)
    t = int(total)
    if 0 < t <= cap:
        idx = idx.clone()
        idx[t - 1] = -1
    return idx, total


def _flip_one_state(states, mask, cap):
    pos, st, total = _COMPACT_STATES(states, mask, cap)
    if int(total):
        st = st.clone()
        st[0] += 1
    return pos, st, total


@pytest.mark.parametrize("fault", ["drop_last_index", "flip_one_state"])
def test_planted_fault_is_caught(monkeypatch, fault) -> None:
    """A plain K3 that drops its last index, or a compaction that flips one
    state: the sweep records the mismatch with a smaller input."""
    name, fake = {
        "drop_last_index": ("_compact_plain", _drop_last_index),
        "flip_one_state": ("_compact_states", _flip_one_state),
    }[fault]
    monkeypatch.setattr(scan_cuda, name, fake)
    monkeypatch.setattr(tool, "SHRINK_RUNS", 4)
    sw = tool.Sweep(torch.device("cpu"), False)
    assert tool.part_c(sw, 0, 3, None, 4096, time.perf_counter()) == 3
    bad = {m["check"] for m in sw.mismatches}
    assert "scan_device pairs" in bad
    # the record keeps a smaller input than the case's that still fails
    assert any(
        m["smallest"]["window"][1] - m["smallest"]["window"][0] < m["n"]
        or m["smallest"]["pattern_count"] < m["patterns_total"]
        for m in sw.mismatches)


def test_cli_exits_1_on_a_planted_fault(tmp_path, monkeypatch,
                                        capsys) -> None:
    """The command over every part, with K3's plain version dropping its
    last index: its summary counts the mismatches and it exits 1; on the
    CPU it writes no record where ``--out`` names none."""
    monkeypatch.setattr(scan_cuda, "_compact_plain", _drop_last_index)
    monkeypatch.setattr(tool, "SHRINK_RUNS", 1)
    monkeypatch.setattr(tool, "OUT", str(tmp_path / "record.json"))
    rc = tool._cli(["--device", "cpu", "--cases", "1", "--max-bytes",
                    "1024"])
    assert rc == 1
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert not summary["ok"] and summary["mismatches"] > 0
    assert not (tmp_path / "record.json").exists()


def test_commit_is_none_outside_its_own_checkout(monkeypatch) -> None:
    """A copy of the tree inside another checkout records no commit: git
    would name the enclosing repository's."""
    monkeypatch.setattr(tool, "ROOT", os.path.join(ROOT, "tests"))
    assert tool._commit() is None


def test_tool_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool._cli(["--cases", "0", "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.run(cases=0, out=None)
    assert not (tmp_path / "x.json").exists()
