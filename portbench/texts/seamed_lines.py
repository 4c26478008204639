"""The upstream LONG text with a keyword across every shard seam
(``BASELINE.json`` configs[3]: a corpus sharded over chips, its match
indexes gathered with shard-boundary stitching).

A document is :mod:`long_lines`' document of the same size and seed.  At
every positive multiple ``s`` of ``seam_bytes`` below its size, one
pattern drawn from the seed is written over the text so that it spans
``[s - len // 2, s - len // 2 + len)``, with a space on each side: a
match there is found only if the shard after the seam reads the end of
the shard before it.  Without the plants a match crosses a seam only
where a line's name happens to fall on one.  The text and the patterns
are ASCII, so a character is a byte and the seams are the byte offsets
at which a sharded scan cuts the document.

Document ``index`` draws from ``default_rng([seed, index, 2])``, a stream
apart from a recipe's ``default_rng(seed)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from portbench.texts import long_lines

KEYS = ("name_every", "seam_bytes")


def seams(size: int, seam_bytes: int) -> list[int]:
    """The positive multiples of ``seam_bytes`` below ``size``."""
    return list(range(seam_bytes, size, seam_bytes))


def document(
    patterns: list[str], params: dict[str, Any], size: int, index: int,
    seed: int = 0,
) -> str:
    """Document ``index``: ``size`` characters, a pattern across every
    seam."""
    text = long_lines.document(patterns, params, size, index, seed)
    rng = np.random.default_rng([seed, index, 2])
    pieces, at = [], 0
    for s in seams(size, int(params["seam_bytes"])):
        p = patterns[int(rng.integers(0, len(patterns)))]
        start = s - len(p) // 2
        if start - 1 < at or start + len(p) + 1 > size:
            raise ValueError(f"seam_bytes {params['seam_bytes']} leaves no "
                             f"room for a {len(p)}-character pattern")
        pieces += [text[at : start - 1], " ", p, " "]
        at = start + len(p) + 1
    pieces.append(text[at:])
    return "".join(pieces)
