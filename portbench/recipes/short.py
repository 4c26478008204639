"""The upstream SHORT recipe's ten patterns, a fixed list (a frozen copy
of the port's ``tools/_synth.SHORT_PATTERNS``)."""

from __future__ import annotations

SHORT_PATTERNS = (
    "abc", "hello", "world", "aardvark", "fish",
    "what", "arbitrarymonkey", "birds", "host7", "host76",
)


def make(seed: int) -> list[str]:
    return list(SHORT_PATTERNS)
