"""``count`` distinct random byte strings of ``min_len``-``max_len``
bytes (``BASELINE.json`` configs[2]: 50k random byte patterns)."""

from __future__ import annotations

import numpy as np


def make(seed: int, count: int, min_len: int, max_len: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out: set[bytes] = set()
    while len(out) < count:
        k = int(rng.integers(min_len, max_len + 1))
        out.add(rng.integers(0, 256, k, dtype=np.uint8).tobytes())
    return sorted(out)
