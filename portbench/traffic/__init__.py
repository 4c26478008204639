"""The one traffic generator.

A traffic mix is a data file ``<name>.json`` beside this module.  Its
parameters say what the cell's callers send:

* ``call``: ``"doc"``, one ``find_matches_as_indexes`` a call, or
  ``"batch"``, one ``find_matches_as_indexes_batch`` a call;
* ``text``: the text, a module of ``portbench/texts/`` found by this
  name, which reads parameters of its own (its ``KEYS``);
* doc: ``doc_chars`` and ``distinct`` (that many documents of one size),
  or ``doc_sizes`` (one document of each size listed); the documents are
  taken in turn;
* batch: ``corpus_lines`` and ``lines_per_call``: the corpus is cut into
  calls of ``lines_per_call`` lines, taken in turn;
* ``callers``: how many caller threads share the matcher, each in its
  own closed loop (default 1);
* ``why``: one line on what the mix is.

A key that neither this generator nor the text reads is refused.  Every
seed gives the same sizes; the seed picks the patterns, and a text may
draw from it too.
"""

from __future__ import annotations

import json
import os
from typing import Any

from portbench.config import plugin

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("call", "text", "doc_chars", "distinct", "doc_sizes",
        "corpus_lines", "lines_per_call", "callers", "why")
CALLS = ("doc", "batch")


def load(name: str) -> dict[str, Any]:
    """The parameters of traffic mix ``name``, every key checked."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        params = json.load(f)
    if params.get("call") not in CALLS:
        raise ValueError(f"{name}: call is not one of {CALLS}")
    text = plugin("texts", params.get("text"))
    unknown = sorted(set(params) - set(KEYS) - set(text.KEYS))
    if unknown:
        raise ValueError(f"{name}: unknown traffic keys {unknown}")
    return params


def sizes(params: dict[str, Any]) -> list[int]:
    """The distinct documents' sizes of a ``doc`` mix."""
    if "doc_sizes" in params:
        return [int(s) for s in params["doc_sizes"]]
    return [int(params["doc_chars"])] * int(params["distinct"])


def inputs(patterns: list, params: dict[str, Any], seed: int) -> list[Any]:
    """The distinct inputs of a mix, in the order the calls take them."""
    text = plugin("texts", params["text"])
    if params["call"] == "doc":
        return [text.document(patterns, params, size, d, seed)
                for d, size in enumerate(sizes(params))]
    total = int(params["corpus_lines"])
    per = int(params["lines_per_call"])
    corpus = text.lines(patterns, params, 0, total, seed)
    return [corpus[i : i + per] for i in range(0, total, per)]


def callers(params: dict[str, Any]) -> int:
    return int(params.get("callers", 1))


def input_bytes(item: Any) -> int:
    """Bytes of one input (a document, or every line of a batch), UTF-8
    for text."""
    if isinstance(item, str):
        return len(item.encode("utf-8"))
    if isinstance(item, (bytes, bytearray, memoryview)):
        return len(item)
    return sum(input_bytes(s) for s in item)
