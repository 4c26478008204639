"""One character repeated: the match-dense text of nested patterns
(``char`` over the whole document or line)."""

from __future__ import annotations

from typing import Any

KEYS = ("char", "line_chars")


def document(
    patterns: list, params: dict[str, Any], size: int, index: int,
    seed: int = 0,
) -> str:
    return str(params.get("char", "a")) * size


def lines(
    patterns: list, params: dict[str, Any], first: int, count: int,
    seed: int = 0,
) -> list[str]:
    line = str(params.get("char", "a")) * int(params.get("line_chars", 70))
    return [line] * count
