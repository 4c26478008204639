"""Seeded names, corpus and document batches after the upstream
benchmark's LONG and SHORT recipes.

Shared by the bench tool, ``chip_smoke.py``, ``profile_main_path.py`` and
the probe tool, so that they all scan the same bytes from the same seed.
Each function makes the same bytes as root ``bench.py``'s of the same name
from the same generator state.
"""

from __future__ import annotations

import string

import numpy as np

#: the recipes' counts: LONG's names and documents, SHORT's documents
LONG_PATTERNS = 1000
LONG_DOCS = 20_000
SHORT_DOCS = 10_000
#: SHORT's ten patterns (a fixed list, not a count)
SHORT_PATTERNS = (
    "abc", "hello", "world", "aardvark", "fish",
    "what", "arbitrarymonkey", "birds", "host7", "host76",
)
#: LONG's line of about 600 characters: a name (or "nobody") and the
#: line's number fill the two slots
LONG_FILLER = (
    "no one who had ever seen {} in her infancy would have supposed "
    "her born to be an heroine; her situation in life, the character "
    "of her father and mother, her own person and disposition were "
    "all equally against her, and the rest of this line is ordinary "
    "prose of roughly six hundred characters so the haystack length "
    "matches the reference recipe with room to spare for the counter "
    "value {} at the end, padded with plain words that never match "
    "any generated name pattern because they are common english and "
    "the names are uniform random lowercase strings of length five "
    "to eleven which almost surely do not occur in this text"
)


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


def long_docs(names: list[bytes], count: int = LONG_DOCS) -> list[str]:
    """The LONG batch: ``count`` lines of 624-633 characters, one in 90
    carrying a name, the others "nobody"."""
    out = []
    for i in range(count):
        name = names[i % len(names)].decode() if i % 90 == 0 else "nobody"
        out.append(LONG_FILLER.format(name, i))
    return out


def short_case(count: int = SHORT_DOCS) -> tuple[list[str], list[str]]:
    """The SHORT batch: the ten patterns and ``count`` documents of 72-75
    characters."""
    docs = [
        f"arbitrarymonkey says hello to fish host76, 0.123 my friend, "
        f"but why??? {i}"
        for i in range(count)
    ]
    return list(SHORT_PATTERNS), docs


def make_datasets(
    rng: np.random.Generator, scale: int = 1
) -> dict[str, tuple[list[str], list[str]]]:
    """SHORT and LONG as ``(patterns, documents)``, LONG's names drawn
    from ``rng``; ``scale`` divides the name and document counts (the
    lengths stay)."""
    names = synth_names(max(1, LONG_PATTERNS // scale), rng)
    return {
        "short": short_case(max(1, SHORT_DOCS // scale)),
        "long": ([n.decode() for n in names],
                 long_docs(names, max(1, LONG_DOCS // scale))),
    }
