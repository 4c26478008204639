"""Seeded names and corpus after the upstream benchmark's LONG recipe.

Shared by ``chip_smoke.py``, ``profile_main_path.py`` and the probe tool,
so that they all scan the same bytes from the same seed.
"""

from __future__ import annotations

import string

import numpy as np


def synth_names(count: int, rng: np.random.Generator) -> list[bytes]:
    """Lowercase 'name' patterns of 5-11 bytes (the LONG recipe)."""
    letters = np.frombuffer(string.ascii_lowercase.encode(), dtype=np.uint8)
    names = set()
    while len(names) < count:
        k = int(rng.integers(5, 12))
        names.add(bytes(letters[rng.integers(0, 26, k)]))
    return sorted(names)


def synth_corpus(
    n_bytes: int, names: list[bytes], rng: np.random.Generator
) -> np.ndarray:
    """Random lowercase words + spaces with a name spliced into about one
    in 90 lines of 600 bytes (the LONG recipe)."""
    letters = np.frombuffer(
        (string.ascii_lowercase + "      ").encode(), dtype=np.uint8
    )
    corpus = letters[rng.integers(0, len(letters), n_bytes)]
    line_len = 600
    n_lines = n_bytes // line_len
    hit_lines = rng.integers(0, n_lines, max(1, n_lines // 90))
    for ln in hit_lines:
        name = names[int(rng.integers(0, len(names)))]
        off = int(ln) * line_len + int(rng.integers(0, line_len - 12))
        corpus[off : off + len(name)] = np.frombuffer(name, dtype=np.uint8)
    return corpus
