"""PyTorch port, the scaling tool (``ahocorasick_rs_tpu_torch.tools
.scaling_bench``) on the CPU: one rank and two ranks over gloo at 1 MiB a
rank, each a process.

The bytes each rank exchanged are counted in the run: the halo
(``max_len - 1`` bytes) plus 8 bytes per (position, state) pair the rank
contributed to the gathered outputs.  The pairs are held here to the host
scan's positions, split by the dense layout's shard owner; the collectives
a world of one rank sends in process are counted byte for byte.
"""

from __future__ import annotations

import numpy as np
import pytest

from ahocorasick_rs_tpu_torch.api import BytesAhoCorasick
from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch.ops.scan_cuda import DeviceTables
from ahocorasick_rs_tpu_torch.parallel import sharded
from ahocorasick_rs_tpu_torch.tools import scaling_bench as tool

PER_RANK = 1 << 20
DEADLINE = 120.0


@pytest.fixture(scope="module")
def record() -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # one torch thread a rank
        return tool.run(device="cpu", ranks=2, per_rank=PER_RANK,
                        timeout=DEADLINE)


def _host_pairs_by_shard(world: int) -> list[int]:
    names, hay = tool.corpus(world, PER_RANK)
    ac = BytesAhoCorasick(names, backend="native", device="cpu")
    pos, _ = ac._host_scan(hay, "native")
    halo = ac._automaton.max_len - 1
    L, T = sharded.dense_layout(len(hay), world, halo)
    owner = np.asarray(pos) // (L * T)
    return [int((owner == r).sum()) for r in range(world)]


@pytest.mark.parametrize("world", [1, 2])
def test_counted_exchange_bytes(record: dict, world: int) -> None:
    run = record["by_world"][world]
    halo = record["halo_bytes"]
    assert halo == max(map(len, tool.corpus(1, 4096)[0])) - 1
    pairs = _host_pairs_by_shard(world)
    assert run["pairs_by_rank"] == pairs
    assert run["comm_bytes_by_rank"] == [halo + 8 * p for p in pairs]
    assert run["devices_by_rank"] == ["cpu"] * world
    # the halo exchange and one gather of the compacted outputs a call
    assert run["collectives_by_rank"] == [2] * world
    assert all(w > halo + 8 * p for w, p in
               zip(run["wire_bytes_by_rank"], pairs))


def test_record(record: dict) -> None:
    assert record["exact_vs_host_tier"], record["mismatches"]
    assert record["backend"] == "gloo" and record["ranks"] == 2
    assert record["comm_bytes_per_shard"] == (
        record["by_world"][2]["comm_bytes_by_rank"])
    assert record["comm_byte_ratio"] == max(
        record["comm_bytes_per_shard"]) / PER_RANK
    assert record["weak_scaling_efficiency"] == pytest.approx(
        record["seconds_1dev"] / record["seconds_2dev"])
    assert record["bytes_per_s_2dev"] > 0 and record["bytes_per_s_1dev"] > 0


def test_counting_group_in_one_process() -> None:
    """A world of one rank without a group: the halo as int32 and the
    outputs as int64 at the compaction capacity, byte for byte."""
    names, hay = tool.corpus(1, 1 << 16)
    am = build_automaton(names)
    tables = DeviceTables(am, "dfa", "cpu")
    g = tool.CountingGroup(None)
    pos, st = sharded.scan_sharded(am, hay, tables, g)
    halo = am.max_len - 1
    cap = tables.last_cap
    assert g.sent == [4 * halo, (2 * cap + 1) * 8]
    assert g.totals == [len(pos)]
    want = BytesAhoCorasick(names, backend="native",
                            device="cpu")._host_scan(hay, "native")
    assert tool.pairs_digest(pos, st) == tool.pairs_digest(*want)
