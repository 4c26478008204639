"""Binary documents: uniform random bytes from the seed, with ``planted``
occurrences of patterns drawn from the seed at places drawn from it
(``BASELINE.json`` configs[2]'s 1 GB binary haystack).  Every seed gives
the same sizes and the same number of plants.
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
    rng = np.random.default_rng([seed, index])
    buf = rng.integers(0, 256, size, dtype=np.uint8)
    pats = [p if isinstance(p, bytes) else p.encode() for p in patterns]
    for _ in range(int(params.get("planted", 0))):
        p = pats[int(rng.integers(0, len(pats)))]
        at = int(rng.integers(0, max(1, size - len(p))))
        buf[at : at + len(p)] = np.frombuffer(p, dtype=np.uint8)[: size - at]
    return buf.tobytes()
