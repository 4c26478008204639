"""PyTorch port, sharded scan in real processes: 2 and 4 ranks of
``python -m ahocorasick_rs_tpu_torch.parallel.multihost`` on the CPU over
gloo, each scanning a 1 MiB demo corpus through the public API with
``backend="sharded"`` and ``mesh=`` for the four semantics and a batch.
Every rank's digests must equal the other ranks' and a single-process run
of the port (the device tier on the CPU), and the result tier must be the
sharded one.

Each child gets its own ``file://`` rendezvous under ``tmp_path`` (no
fixed port), one torch thread and ``device="cpu"``; the ranks are started
and awaited by ``multihost.RankProcesses``, with a deadline, and killed
when it passes or a rank fails.  The JAX package's
own multi-process test is ``tests/test_multihost.py``.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

from ahocorasick_rs_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBYTES = 1 << 20
#: seconds a whole spawned run may take before its children are killed
DEADLINE = 120.0


@pytest.fixture(scope="module")
def truth() -> dict:
    """Digests of a single-process run of the port on the same corpus."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pats, hay = multihost.demo_corpus(NBYTES)
        return multihost.semantics_digests(
            pats, hay, backend="device", device="cpu"
        )
    finally:
        torch.set_num_threads(before)


def _spawn(tmp_path, world: int, *extra: str) -> list[dict]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p
    )

    def argv(rank: int, init: str, out: str) -> list[str]:
        return [
            sys.executable, "-m",
            "ahocorasick_rs_tpu_torch.parallel.multihost",
            "--init-method", init, "--world-size", str(world),
            "--rank", str(rank), "--device", "cpu", "--backend", "gloo",
            "--nbytes", str(NBYTES), "--repeats", "1", "--threads", "1",
            "--out", out, *extra,
        ]

    with multihost.RankProcesses(argv, world, str(tmp_path), cwd=REPO,
                                 env=env) as ranks:
        try:
            return ranks.records(DEADLINE)
        except RuntimeError as e:
            pytest.fail(f"spawned ranks failed: {e}")


def _check(records: list[dict], truth: dict, world: int) -> None:
    assert [r["rank"] for r in records] == list(range(world))
    assert {r["world_size"] for r in records} == {world}
    assert {r["backend"] for r in records} == {"gloo"}
    for r in records:
        assert set(r["semantics"]) == set(truth)
        for name, want in truth.items():
            got = r["semantics"][name]
            assert (got["matches"], got["digest"]) == (
                want["matches"], want["digest"]
            ), name
            assert got["backend"] == (
                "sharded_batch" if name.endswith("batch") else "sharded"
            )
        assert r["scan_seconds_best"] > 0
    assert truth["Standard"]["matches"] > 50
    assert truth["Standard_batch"]["matches"] > 30


def test_two_ranks_equal_single_process(tmp_path, truth) -> None:
    _check(_spawn(tmp_path, 2), truth, 2)


def test_four_ranks_equal_single_process(tmp_path, truth) -> None:
    _check(_spawn(tmp_path, 4), truth, 4)


def test_two_ranks_device_mesh(tmp_path, truth) -> None:
    """``mesh=`` a 1-D ``DeviceMesh`` in place of the process group."""
    _check(_spawn(tmp_path, 2, "--device-mesh"), truth, 2)


def test_runner_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch) -> None:
    """Without ``--device`` the runner raises when there is no card, before
    it joins a group; ``--device cpu`` is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.rank_device("gloo", 0, None)
    assert multihost.rank_device("gloo", 1, "cpu") == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.run_worker(f"file://{tmp_path}/rendezvous", 1, 0)
    assert not torch.distributed.is_initialized()


def test_rank_processes_stop_at_a_failed_rank(tmp_path) -> None:
    """A rank that exits non-zero ends the wait at once, with its log's
    tail, while its peer still runs; leaving the block kills the peer."""
    def argv(rank: int, init: str, out: str) -> list[str]:
        body = ("import sys; print('rank one fails'); sys.exit(3)"
                if rank == 1 else "import time; time.sleep(60)")
        return [sys.executable, "-c", body]

    with multihost.RankProcesses(argv, 2, str(tmp_path)) as ranks:
        with pytest.raises(RuntimeError, match="rank one fails"):
            ranks.records(30.0)
        peer = ranks.procs[0][0]
    assert peer.poll() is not None
