"""PyTorch port, the harnesses against the upstream binaries
(``ahocorasick_rs_tpu_torch.tools.conformance_vs_reference`` and
``.bench_vs_reference``) on the CPU.

The wheel is not installed here, so each runs its ``--self-test``: the
port's ``python`` tier on the CPU stands in for the reference, through an
adapter with the reference's constructor signature.  Both minimums of the
conformance harness are set small, so that its outcome does not depend on
the machine's load; no test asserts on a time.  The error-text section
pins as many paths as the JAX tool's, with its names, and the port's
exception types and messages equal the JAX package's on the same calls.
Without the wheel and without ``--self-test`` each harness exits non-zero
and names the module; a planted divergence exits 1, too few comparisons
exit 2.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import re
import sys

import pytest

from ahocorasick_rs_tpu_torch import api
from ahocorasick_rs_tpu_torch.tools import bench_vs_reference as bench
from ahocorasick_rs_tpu_torch.tools import conformance_vs_reference as conf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--self-test", "--device", "cpu", "--min-tuple-checks", "2000",
         "--min-list-checks", "500", "--dense-cases", "1", "--seed", "7"]


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conformance_self_test_passes(capsys) -> None:
    assert conf.main(SMALL) == 0
    out = capsys.readouterr().out
    assert "PASS: zero divergences" in out
    assert out.count("error-text OK") == len(conf.ERROR_CASES)
    assert "dense-adversarial OK" in out


def test_error_cases_are_the_jax_tools() -> None:
    src = inspect.getsource(_jax_tool("conformance_vs_reference")
                            .error_text_section)
    names = re.findall(r'^\s*\(?\s*"([a-z0-9-]+)",', src, re.M)
    assert len(names) == 10
    assert [n for n, _ in conf.ERROR_CASES] == names


def test_error_texts_equal_the_jax_package() -> None:
    import ahocorasick_rs_tpu as jax_port

    ours = conf.port_module("cpu")
    for name, trigger in conf.ERROR_CASES:
        got = conf.capture(lambda: trigger(ours))
        assert got[0] is not None, name
        assert got == conf.capture(lambda: trigger(jax_port)), name


def test_self_test_reference_is_the_python_tier() -> None:
    ref = conf.port_module("cpu", "python")
    ac = ref.AhoCorasick(["hello", "world"])
    assert ac.find_matches_as_indexes("hello world") == [(0, 0, 5),
                                                         (1, 6, 11)]
    assert ac.stats()["last_backend"] == "python"


def test_bench_self_test_passes(tmp_path, monkeypatch) -> None:
    md, js = tmp_path / "b.md", tmp_path / "b.json"
    monkeypatch.setattr(bench, "SHORT_DOCS", 500)  # the recipe's 10,000 / 20
    assert bench.main(["--self-test", "--device", "cpu", "--long-haystacks",
                       "200", "--out", str(md), "--json-out", str(js)]) == 0
    assert "Competitor benchmark" in md.read_text()
    rec = json.loads(js.read_text())
    assert rec["self_test"] and rec["device"]["ours"] == "cpu"
    assert (rec["short_haystacks"], rec["long_haystacks"]) == (500, 200)
    for ds in ("short", "long"):
        assert {"reference", "ours", "ours_batch"} <= set(rec["results"][ds])
        assert set(rec["missing"]) | set(rec["results"][ds]) >= {
            "pyahocorasick", "reference", "ours", "ours_batch"}
    assert "TPU" not in md.read_text()


def test_bench_datasets_are_the_jax_tools() -> None:
    import numpy as np

    ref = _jax_tool("bench_vs_reference")
    data = bench.datasets(300)
    assert data["short"] == (ref.PATTERNS_SHORT, ref.make_haystacks_short())
    rng = np.random.default_rng(42)
    pats = ref.make_patterns_long(rng)
    assert data["long"] == (pats, ref.make_haystacks_long(pats, 300, rng))


@pytest.mark.parametrize("tool", [conf, bench], ids=["conformance", "bench"])
def test_without_the_wheel_exits_nonzero(tool, monkeypatch, capsys) -> None:
    monkeypatch.setitem(sys.modules, "ahocorasick_rs", None)
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cpu"])
    assert e.value.code == 3
    assert "ahocorasick_rs is not installed" in capsys.readouterr().err


def test_planted_divergence_exits_1(monkeypatch, capsys) -> None:
    real = api._MatcherBase._find

    def dropped(self, hay, overlapping):
        out = real(self, hay, overlapping)
        return out[:-1] if self._backend == "auto" else out

    monkeypatch.setattr(api._MatcherBase, "_find", dropped)
    assert conf.main(SMALL) == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_too_few_checks_exits_2(capsys) -> None:
    assert conf.main(["--self-test", "--device", "cpu", "--dense-cases", "0",
                      "--max-seconds", "0", "--seed", "7"]) == 2
    assert "FAIL:" in capsys.readouterr().out
