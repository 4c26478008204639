"""PyTorch port, the multi-process tool
(``ahocorasick_rs_tpu_torch.tools.multihost_run``) on the CPU.

A two-rank gloo run of the port's worker through the tool's own function
(``--device cpu``, one torch thread a rank, 1 MiB, under a deadline):
every rank's digests equal the host-tier truth, and the record has the
JAX tool's keys.  The truth's digests equal what the JAX package's
``parallel/multihost.py`` ``_match_digest`` gives on the JAX public API's
tuples for the same corpus.  A planted mismatch, in the checked run or
in a timed run of the weak scaling, makes the command exit non-zero; the
weak-scaling curve runs its pinned ranks and control pair at a tiny size,
each held to the truth; the default record is never one of the JAX
package's.
"""

from __future__ import annotations

import json
import os
import re

import pytest

from ahocorasick_rs_tpu_torch.parallel import multihost
from ahocorasick_rs_tpu_torch.tools import multihost_run as tool

NBYTES = 1 << 20
#: seconds a spawned run may take before its ranks are killed
DEADLINE = 120.0
#: keys of the JAX tool's record (``tools/multihost_run.py``) that keep
#: their meaning in the port's
REFERENCE_KEYS = {
    "what", "num_processes", "nbytes", "bit_exact_vs_single_process",
    "semantics_verified", "per_semantics_matches", "scan_seconds_best",
    "scan_gbps", "caveat", "weak_scaling", "weak_scaling_curve",
}


@pytest.fixture(scope="module")
def record() -> dict:
    return tool.run(2, NBYTES, device="cpu", weak=False, timeout=DEADLINE,
                    threads=1)


def test_two_gloo_ranks_equal_the_host_truth(record: dict) -> None:
    truth = tool.single_process_truth(NBYTES)
    assert REFERENCE_KEYS <= set(record)
    assert record["bit_exact_vs_single_process"], record["mismatches"]
    assert record["backend"] == "gloo"
    assert record["devices_by_rank"] == ["cpu", "cpu"]
    assert record["semantics_verified"] == sorted(truth)
    assert record["per_semantics_matches"] == {
        s: truth[s]["matches"] for s in truth}
    assert record["tier_by_semantics"]["Standard"] == "sharded"
    assert record["tier_by_semantics"]["Standard_batch"] == "sharded_batch"
    assert record["weak_scaling"] is None
    assert len(record["scan_seconds_by_rank"]) == 2
    # every rank's process names the kernels it launched: none on the CPU
    assert record["launches_by_rank"] == [{}, {}]


def test_truth_equals_the_jax_package_digests() -> None:
    import ahocorasick_rs_tpu as jax_port
    from ahocorasick_rs_tpu.parallel import multihost as jax_multihost

    nbytes = 1 << 18
    truth = tool.single_process_truth(nbytes)
    pats, hay = jax_multihost.demo_corpus(nbytes)
    assert (pats, hay) == multihost.demo_corpus(nbytes)
    for kind, overlapping in multihost.SEMANTICS:
        ac = jax_port.AhoCorasick(pats, matchkind=jax_port.MatchKind[kind])
        want = jax_multihost._match_digest(
            ac.find_matches_as_indexes(hay, overlapping=overlapping))
        name = kind + ("_overlapping" if overlapping else "")
        assert truth[name]["digest"] == want, name
    per_doc = jax_port.AhoCorasick(pats).find_matches_as_indexes_batch(
        multihost.demo_docs(hay))
    assert truth["Standard_batch"]["digest"] == jax_multihost._match_digest(
        [(i, *t) for i, doc in enumerate(per_doc) for t in doc])


def test_planted_mismatch_exits_nonzero(tmp_path, monkeypatch) -> None:
    real = tool.run_ranks

    def planted(*args, **kwargs):
        records = real(*args, **kwargs)
        records[1]["semantics"]["Standard"]["digest"] = "0" * 64
        return records

    monkeypatch.setattr(tool, "run_ranks", planted)
    out = tmp_path / "scaling.json"
    rc = tool.main(["--device", "cpu", "--nbytes", str(1 << 16),
                    "--threads", "1", "--no-weak-scaling",
                    "--timeout", str(DEADLINE), "--out", str(out)])
    assert rc != 0
    rec = json.loads(out.read_text())["multihost_run"]
    assert not rec["bit_exact_vs_single_process"]
    assert any(m.startswith("rank 1 Standard") for m in rec["mismatches"])


def _records(world: int, nbytes: int, **_) -> list[dict]:
    """What ``world`` ranks that scanned ``nbytes`` right would record."""
    truth = tool.single_process_truth(nbytes)
    return [{"rank": r, "nbytes": nbytes, "backend": "gloo", "device": "cpu",
             "scan_seconds_best": 0.01, "launches": {},
             "semantics": {k: dict(v) for k, v in truth.items()}}
            for r in range(world)]


def test_a_wrong_timed_run_fails_the_tool(tmp_path, monkeypatch) -> None:
    """The weak scaling's timed runs are held to the truth at their size:
    a wrong digest in the two-rank run alone makes the command exit
    non-zero and names the point and the run."""
    nbytes = 1 << 16

    def planted(world: int, n: int, **kw) -> list[dict]:
        records = _records(world, n)
        if n == 2 * nbytes:
            records[1]["semantics"]["Standard"]["digest"] = "0" * 64
        return records

    monkeypatch.setattr(tool, "run_ranks", planted)
    monkeypatch.setattr(tool, "independent_pair", lambda *a, **k: 0.01)
    out = tmp_path / "scaling.json"
    assert tool.main(["--device", "cpu", "--nbytes", str(nbytes),
                      "--out", str(out)]) != 0
    rec = json.loads(out.read_text())["multihost_run"]
    assert not rec["bit_exact_vs_single_process"]
    assert rec["weak_scaling"]["mismatches"]
    assert rec["mismatches"][0].startswith(
        f"{nbytes} bytes a rank, 2 ranks: rank 1 Standard:")
    assert all(m.startswith(f"{nbytes} bytes a rank, 2 ranks: rank 1 ")
               for m in rec["mismatches"])


def test_curve_point_and_control_pair() -> None:
    points = tool.weak_scaling_curve("gloo", "cpu", points=((1 << 16, 1, 1),))
    (pt,) = points
    assert pt["nbytes_per_process"] == 1 << 16
    assert pt["backend"] == "gloo"
    for key in ("seconds_1proc", "seconds_2proc", "seconds_independent_pair",
                "weak_scaling_efficiency", "memory_contention_efficiency",
                "communication_efficiency"):
        assert pt[key] > 0, key
    assert pt["weak_scaling_efficiency"] == pytest.approx(
        pt["memory_contention_efficiency"] * pt["communication_efficiency"])
    # the 1-rank run, the 2-rank run and both control ranks, each right
    assert pt["timed_runs_checked"] == 4 and pt["mismatches"] == []


def test_default_record_is_not_a_jax_package_record() -> None:
    name = os.path.basename(tool.OUT)
    assert name == "H100_SCALING.json"
    assert not re.fullmatch(r"SCALING_r0\d*\.json", name)
