"""``count`` nested patterns of one character: ``a``, ``aa``, ... (the
match-dense case)."""

from __future__ import annotations


def make(seed: int, count: int, char: str = "a") -> list[str]:
    return [char * n for n in range(1, count + 1)]
