"""Automaton and matcher serialization (.npz).

The reference offers no automaton persistence — construction is the only
way to get one.  Compiling a million-pattern set is expensive enough that
saving the compiled tables is a first-class subsystem here: everything in
an :class:`Automaton` is plain arrays, so a single compressed ``.npz``
round-trips it exactly.

The format is the JAX package's, key for key (bare automaton v1, matcher
v2 with the pattern blob and a JSON meta record), so a file written by
either package loads in the other.  The matcher-level wrappers also
persist matchkind/engine/pattern metadata and a tuned prefilter config, so
a saved matcher behaves identically after loading (including
``find_matches_as_strings`` with stored patterns).
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Union

import numpy as np

from ..models.automaton import Automaton, _finalize

if TYPE_CHECKING:
    import torch

    from ..api import AhoCorasick, BytesAhoCorasick

#: bare-automaton .npz format (arrays only, no matcher metadata)
_FORMAT_VERSION = 1
#: matcher .npz format; v2 added the mandatory ``pattern_blob`` array and
#: renamed the ``patterns`` meta key to ``patterns_stored``
_MATCHER_FORMAT_VERSION = 2


def save_automaton(path: str, am: Automaton) -> None:
    np.savez_compressed(
        path,
        __format__=np.int64(_FORMAT_VERSION),
        edge_keys=am.edge_keys,
        edge_targets=am.edge_targets,
        fail=am.fail,
        depth=am.depth,
        match_offsets=am.match_offsets,
        match_pids=am.match_pids,
        pattern_lens=am.pattern_lens,
    )


def _automaton_of(z) -> Automaton:
    return _finalize(
        z["edge_keys"],
        z["edge_targets"],
        z["fail"],
        z["depth"],
        z["match_offsets"],
        z["match_pids"],
        z["pattern_lens"],
        goto=None,
    )


def load_automaton(path: str) -> Automaton:
    with np.load(path) as z:
        version = int(z["__format__"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported automaton format version {version}"
            )
        return _automaton_of(z)


def save_matcher(
    path: str, matcher: Union[AhoCorasick, BytesAhoCorasick]
) -> None:
    """Persist an ``AhoCorasick``/``BytesAhoCorasick`` with its config.

    The raw byte patterns are always persisted (flat blob + lengths): the
    Teddy prefilter compiles from them, so a loaded matcher must keep them
    to stay performance-identical, not merely behaviorally identical.
    """
    meta = {
        "class": type(matcher).__name__,
        "matchkind": matcher._matchkind.name,
        "implementation": matcher._implementation.name,
        "patterns_stored": getattr(matcher, "_patterns", None) is not None,
    }
    # tuned prefilter config (tune()), rebuilt deterministically on load;
    # only a measured tune() result is persisted, never the heuristic pick
    if matcher._pf_config is not None:
        meta["prefilter"] = matcher._pf_config
    am = matcher._automaton
    blob = b"".join(matcher._byte_patterns)
    np.savez_compressed(
        path,
        __format__=np.int64(_MATCHER_FORMAT_VERSION),
        __meta__=np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ),
        pattern_blob=np.frombuffer(blob, dtype=np.uint8),
        edge_keys=am.edge_keys,
        edge_targets=am.edge_targets,
        fail=am.fail,
        depth=am.depth,
        match_offsets=am.match_offsets,
        match_pids=am.match_pids,
        pattern_lens=am.pattern_lens,
    )


def load_matcher(
    path: str, device: Union[str, "torch.device", None] = None
) -> Union[AhoCorasick, BytesAhoCorasick]:
    """Reconstruct a matcher saved by :func:`save_matcher`.

    ``device`` is the constructors' ``device=``: the card unless the
    caller names another (without a card, ``device="cpu"`` must be
    passed).  The matcher is set up by the constructors' own path, with
    the loaded automaton in place of a fresh build.
    """
    from ..api import AhoCorasick, BytesAhoCorasick
    from ..models.engine import Implementation, MatchKind

    with np.load(path) as z:
        version = int(z["__format__"])
        if version not in (1, _MATCHER_FORMAT_VERSION):
            raise ValueError(
                f"unsupported matcher format version {version}"
            )
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if version == 1 and "pattern_blob" not in z:
            raise ValueError(
                "unsupported matcher format version 1 (no pattern data; "
                "re-save with save_matcher)"
            )
        am = _automaton_of(z)
        blob = bytes(z["pattern_blob"])
    cls = {"AhoCorasick": AhoCorasick, "BytesAhoCorasick": BytesAhoCorasick}[
        meta["class"]
    ]
    byte_patterns: list[bytes] = []
    off = 0
    for ln in am.pattern_lens.tolist():
        byte_patterns.append(blob[off : off + ln])
        off += ln
    matcher = cls.__new__(cls)
    if cls is AhoCorasick:
        matcher._patterns = (
            [p.decode("utf-8") for p in byte_patterns]
            if meta.get("patterns_stored")
            else None
        )
    matcher._build(
        byte_patterns,
        MatchKind[meta["matchkind"]],
        Implementation[meta["implementation"]],
        "auto",
        device,
        None,
        automaton=am,
    )
    matcher._pf_config = meta.get("prefilter")
    return matcher
