"""The upstream SHORT text: lines of 72-75 characters, line ``i`` ending
in its number.  A frozen copy of the port's ``tools/_synth.short_case``
line; the tests hold it to that.  A document is the lines joined by
newlines, cut to size.
"""

from __future__ import annotations

from typing import Any

KEYS: tuple[str, ...] = ()

SHORT_LINE = (
    "arbitrarymonkey says hello to fish host76, 0.123 my friend, "
    "but why??? {}"
)


def lines(
    patterns: list, params: dict[str, Any], first: int, count: int,
    seed: int = 0,
) -> list[str]:
    """SHORT lines ``first`` .. ``first + count - 1``."""
    return [SHORT_LINE.format(i) for i in range(first, first + count)]


def document(
    patterns: list, params: dict[str, Any], size: int, index: int,
    seed: int = 0,
) -> str:
    """Document ``index``: its own run of lines, ``size`` characters."""
    per_doc = size // len(SHORT_LINE.format(0)) + 2
    return "\n".join(lines(patterns, params, index * per_doc, per_doc))[:size]
