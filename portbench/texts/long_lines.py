"""The upstream LONG text (``ahocorasick_rs`` ``benchmarks/test_comparison.py``):
a line of about 600 characters in which line ``i`` carries pattern
``i mod len(patterns)`` when ``i`` is a multiple of ``name_every``, else
the word "notaperson".  ``LONG_LINE`` is a frozen copy of the line of the
port's ``tools/bench_vs_reference.make_haystacks_long``; the tests hold it
to that.  A document is the lines joined by newlines, cut to size.
"""

from __future__ import annotations

from typing import Any

KEYS = ("name_every",)

#: the upstream LONG line; its two slots take a name and the line number
LONG_LINE = (
    "no one who had ever seen {} in her infancy would have supposed "
    "her born to be an heroine. her situation in life, the character "
    "of her father and mother, her own person and disposition, were "
    "all equally against her. her father was a clergyman, without "
    "being neglected, or poor, and a very respectable man, though "
    "his name was whatevs - and he had never been handsome. he had a "
    "considerable independence besides two good livings - and he was "
    "not in the least addicted to locking up his daughters. her "
    "mother was a woman of useful plain sense, with a good temper, "
    "and, what is more remarkable, with a good constitution {}."
)
#: the word in the name slot of a line that carries no name
NO_NAME = "notaperson"


def lines(
    patterns: list[str], params: dict[str, Any], first: int, count: int,
    seed: int = 0,
) -> list[str]:
    """LONG lines ``first`` .. ``first + count - 1``."""
    k = len(patterns)
    every = int(params.get("name_every", 90))
    return [
        LONG_LINE.format(patterns[i % k] if i % every == 0 else NO_NAME, i)
        for i in range(first, first + count)
    ]


def document(
    patterns: list[str], params: dict[str, Any], size: int, index: int,
    seed: int = 0,
) -> str:
    """Document ``index``: its own run of lines, ``size`` characters."""
    per_doc = size // len(LONG_LINE.format(NO_NAME, 0)) + 2
    return "\n".join(lines(patterns, params, index * per_doc, per_doc))[:size]
