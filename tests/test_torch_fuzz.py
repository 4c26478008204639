"""PyTorch port, the differential fuzzer
(``ahocorasick_rs_tpu_torch.tools.fuzz_differential``) on the CPU.

A seeded run of a few seconds passes and prints its seed; the match-dense
check passes on one seeded haystack; the brute-force oracle equals the
JAX package's ``python`` tier on 100 seeded cases of the fuzzer's
generator; a planted fault (the ``numpy`` tier's scan dropping its last
matched position) exits non-zero and prints the case and the seed.
"""

from __future__ import annotations

import numpy as np

from ahocorasick_rs_tpu_torch import api
from ahocorasick_rs_tpu_torch.models.engine import MatchKind
from ahocorasick_rs_tpu_torch.tools import fuzz_differential as tool
from ahocorasick_rs_tpu_torch.tools.gpu_conformance import oracle


def test_seeded_run_passes(capsys) -> None:
    assert tool.main(["3", "--seed", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "seed=5 device=cpu"
    assert "PASS:" in out and "seed=5" in out.splitlines()[-1]


def test_match_dense_check_passes() -> None:
    assert tool.big_nested_check(np.random.default_rng(2), "cpu") == 9


def test_oracle_equals_the_jax_python_tier() -> None:
    import ahocorasick_rs_tpu as jax_port

    rng = np.random.default_rng(1234)
    for _ in range(100):
        pats, hay = tool.gen_case(rng)
        for kind in tool.KINDS:
            ac = jax_port.BytesAhoCorasick(
                pats, matchkind=jax_port.MatchKind[kind.name],
                backend="python")
            assert oracle(pats, hay, kind, False) == (
                ac.find_matches_as_indexes(hay)), (pats, hay, kind)
            if kind is MatchKind.Standard:
                assert oracle(pats, hay, kind, True) == (
                    ac.find_matches_as_indexes(hay, overlapping=True))


def test_planted_fault_exits_nonzero_with_the_seed(capsys,
                                                    monkeypatch) -> None:
    real = api._MatcherBase._host_scan

    def dropped(self, hay, backend):
        pos, st = real(self, hay, backend)
        return (pos[:-1], st[:-1]) if backend == "numpy" else (pos, st)

    monkeypatch.setattr(api._MatcherBase, "_host_scan", dropped)
    assert tool.main(["30", "--seed", "11", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "tier=numpy" in out
    assert "FAIL: seed=11 (replay: --seed 11)" in out
