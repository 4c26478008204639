"""Lowercase names of 5-11 letters, the upstream LONG recipe.

``synth_names`` is a frozen copy of the port's ``tools/_synth.synth_names``;
the tests hold it to that.  :func:`make` drops any name that occurs in the
LONG line itself and draws again by the same recipe: a name inside the
line would match on every line, so every seed keeps the same density of
matches.
"""

from __future__ import annotations

import string

import numpy as np

from portbench.texts.long_lines import LONG_LINE, NO_NAME

_LETTERS = np.frombuffer(string.ascii_lowercase.encode(), dtype=np.uint8)


def synth_names(count: int, rng: np.random.Generator) -> list[bytes]:
    """Lowercase 'name' patterns of 5-11 bytes (the LONG recipe)."""
    names = set()
    while len(names) < count:
        k = int(rng.integers(5, 12))
        names.add(bytes(_LETTERS[rng.integers(0, 26, k)]))
    return sorted(names)


def make(seed: int, count: int) -> list[str]:
    """``count`` names from ``seed``."""
    rng = np.random.default_rng(seed)
    line = LONG_LINE.format(NO_NAME, "")
    kept = {n for n in synth_names(count, rng) if n.decode() not in line}
    while len(kept) < count:
        k = int(rng.integers(5, 12))
        n = bytes(_LETTERS[rng.integers(0, 26, k)])
        if n.decode() not in line:
            kept.add(n)
    return [n.decode() for n in sorted(kept)]
