"""Binary documents: uniform random bytes with ``planted`` occurrences of
patterns drawn from the seed at places drawn from it (``BASELINE.json``
configs[2]'s 1 GB binary haystack: a disk image, a memory dump or a
packet capture).  Every seed gives the same sizes and the same number of
plants.

Document ``index`` draws from ``default_rng([seed, index, 1])``, a stream
apart from a recipe's ``default_rng(seed)`` for every index, index 0
included: a ``SeedSequence`` does not change with trailing zeros, so
``[seed, 0]`` would replay the recipe's draws, and the patterns with
them, in document 0.
"""

from __future__ import annotations

from typing import Any

import numpy as np

KEYS = ("planted",)


def document(
    patterns: list, params: dict[str, Any], size: int, index: int,
    seed: int = 0,
) -> bytes:
    """Document ``index`` of ``size`` bytes."""
    rng = np.random.default_rng([seed, index, 1])
    buf = rng.integers(0, 256, size, dtype=np.uint8)
    pats = [p if isinstance(p, bytes) else p.encode() for p in patterns]
    for _ in range(int(params.get("planted", 0))):
        p = pats[int(rng.integers(0, len(pats)))]
        at = int(rng.integers(0, max(1, size - len(p))))
        buf[at : at + len(p)] = np.frombuffer(p, dtype=np.uint8)[: size - at]
    return buf.tobytes()
