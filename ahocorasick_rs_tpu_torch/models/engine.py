"""Match-kind and engine enums plus the auto-selection heuristic.

Mirrors the reference's enum bridges (upstream src/lib.rs:92-128) and its
heuristic engine selection (``implementation=None``, upstream
src/lib.rs:135,187; README.md:173-177).  On the device the three engines
are three table layouts for the same automaton:

* ``DFA``            — dense ``int32 [S, 257]`` transition table, fastest scan.
* ``ContiguousNFA``  — byte-class-compressed ``int32 [S, C]`` table + byte→class
                       map; near-DFA speed at a fraction of the memory.
* ``NoncontiguousNFA`` — sparse CSR goto + failure links; fastest build and
                       smallest memory, slowest scan (failure-chain walking).
"""

from __future__ import annotations

import enum

import torch

from .automaton import Automaton


class MatchKind(enum.Enum):
    """Which of several overlapping candidate matches is reported.

    Semantics per upstream README.md:84-162.
    """

    Standard = "standard"
    LeftmostFirst = "leftmost_first"
    LeftmostLongest = "leftmost_longest"


class Implementation(enum.Enum):
    """Automaton table layout (reference: src/lib.rs:110-128)."""

    NoncontiguousNFA = "noncontiguous_nfa"
    ContiguousNFA = "contiguous_nfa"
    DFA = "dfa"


#: budgets for a device that reports no memory size (the CPU): dense
#: table / byte-classed table byte caps.
_FALLBACK_DENSE_BUDGET = 64 << 20
_FALLBACK_CLASSED_BUDGET = 256 << 20

_cached_budgets: dict[str, tuple[int, int]] = {}


def auto_budgets(device: torch.device | None = None) -> tuple[int, int]:
    """(dense, classed) byte budgets derived from ``device``'s memory.

    The dense table is the fastest layout but the scan also needs device
    memory for the lane state stream and compaction scratch, so the dense
    budget is 1/16 of the card's memory and the classed budget 1/4.  A CPU
    device (or none) gets the fixed fallback budgets.
    """
    dev = torch.device("cpu") if device is None else torch.device(device)
    key = str(dev)
    if key not in _cached_budgets:
        limit = 0
        if dev.type == "cuda":
            _, limit = torch.cuda.mem_get_info(dev)
        if limit > 0:
            _cached_budgets[key] = (limit // 16, limit // 4)
        else:
            _cached_budgets[key] = (
                _FALLBACK_DENSE_BUDGET,
                _FALLBACK_CLASSED_BUDGET,
            )
    return _cached_budgets[key]


#: hard cap on the auto-selected dense table, independent of device
#: memory: above this the byte-classed layout scans as fast (the class map
#: is a 257-entry lookup) while building ~10x faster.  Mirrors the
#: reference crate's economy: it never auto-picks the DFA for large sets
#: (upstream README.md:173-177 — "exorbitant" memory).
_DENSE_AUTO_CAP = 128 << 20


def select_engine(
    am: Automaton, device: torch.device | None = None
) -> Implementation:
    """Pick a table layout balancing build time, memory and scan speed.

    Sized to ``device``'s memory (``auto_budgets``): dense if it
    comfortably fits, byte-classed next, sparse CSR for pattern sets whose
    tables would blow the budget.
    """
    dense_budget, classed_budget = auto_budgets(device)
    if am.num_states * 257 * 4 <= min(dense_budget, _DENSE_AUTO_CAP):
        return Implementation.DFA
    if am.num_states * am.num_classes * 4 <= classed_budget:
        return Implementation.ContiguousNFA
    return Implementation.NoncontiguousNFA
