"""Carry a compiled automaton and fingerprint across from plain arrays.

The JAX package and this one compile the same pattern set into the same
flat arrays.  These constructors take those arrays (the keys of the JAX
package's ``save_automaton`` and the fields of its ``Prefilter``) as NumPy
arrays and build this package's objects from them, so one automaton and
one fingerprint can be fed to both packages without rebuilding either.
"""

from __future__ import annotations

import numpy as np

from ..models.automaton import Automaton, _finalize
from ..models.prefilter import Prefilter


def automaton_from_arrays(
    edge_keys: np.ndarray,
    edge_targets: np.ndarray,
    fail: np.ndarray,
    depth: np.ndarray,
    match_offsets: np.ndarray,
    match_pids: np.ndarray,
    pattern_lens: np.ndarray,
) -> Automaton:
    """An :class:`Automaton` from its core CSR arrays (no goto dicts)."""
    return _finalize(
        np.ascontiguousarray(edge_keys, dtype=np.int64),
        np.ascontiguousarray(edge_targets, dtype=np.int32),
        np.ascontiguousarray(fail, dtype=np.int32),
        np.ascontiguousarray(depth, dtype=np.int32),
        np.ascontiguousarray(match_offsets, dtype=np.int64),
        np.ascontiguousarray(match_pids, dtype=np.int32),
        np.ascontiguousarray(pattern_lens, dtype=np.int32),
        goto=None,
    )


def prefilter_from_arrays(
    m: int,
    words: int,
    passes: int,
    tables: np.ndarray,
    bucket_of: np.ndarray,
    est_fire_rate: float,
) -> Prefilter:
    """A :class:`Prefilter` from its nibble tables and bucket map."""
    tables = np.ascontiguousarray(tables, dtype=np.int32)
    if tables.shape != (passes * 2 * m * words, 128):
        raise ValueError(
            f"tables shape {tables.shape} does not fit m={m}, "
            f"words={words}, passes={passes}"
        )
    return Prefilter(
        m=int(m),
        words=int(words),
        passes=int(passes),
        tables=tables,
        bucket_of=np.ascontiguousarray(bucket_of, dtype=np.int32),
        est_fire_rate=float(est_fire_rate),
    )
