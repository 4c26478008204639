"""Host (CPU/NumPy) scan tiers.

These are the low-latency front ends of the scan stack (the device tiers
live in ``scan_cuda.py`` / ``scan_teddy.py``).  They mirror the reference's
hot loop — one table lookup per haystack byte
(upstream src/lib.rs:240-246) — but in the same *parallel* formulation
the device kernels use, so every tier is golden-testable against every other:

* ``scan_python``: sequential dict-walk for tiny haystacks where per-call
  NumPy/torch overhead dominates.
* ``scan_numpy_lanes``: the halo'd lane scan.  The haystack is reshaped into
  ``L`` lanes of ``T`` bytes, each lane prefixed with ``max_len - 1`` bytes
  of left context (lane 0 gets PAD_BYTE fill, which pins the state to the
  root); every lane starts at the root and is *exactly* correct at all
  non-halo positions because an Aho-Corasick state never encodes more than
  ``max_len`` bytes of history.

Both return the matched ``(positions, states)`` pair consumed by
``ops.resolve``.
"""

from __future__ import annotations

import numpy as np

from ..models.automaton import Automaton, PAD_BYTE


def scan_python(am: Automaton, hay: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Sequential walk. O(n) with tiny constant-factor setup.

    Uses the builder's goto dicts when present (python-built automatons);
    otherwise walks the dense table if materialized, else the edge CSR.
    """
    fail = am.fail
    has_match = am.match_count
    positions: list[int] = []
    states: list[int] = []
    state = 0
    if am.goto is not None:
        goto = am.goto
        for i, b in enumerate(hay):
            nxt = goto[state].get(b)
            while nxt is None and state:
                state = int(fail[state])
                nxt = goto[state].get(b)
            state = nxt if nxt is not None else 0
            if has_match[state]:
                positions.append(i)
                states.append(state)
    elif am._delta is not None:
        delta = am._delta
        for i, b in enumerate(hay):
            state = delta[state, b]
            if has_match[state]:
                positions.append(i)
                states.append(int(state))
    else:
        keys, targets, _ = am.sparse
        keys_l = keys  # int64 sorted
        E = len(keys_l)
        for i, b in enumerate(hay):
            while True:
                k = state * 257 + b
                j = np.searchsorted(keys_l, k)
                if j < E and keys_l[j] == k:
                    state = int(targets[j])
                    break
                if state == 0:
                    break
                state = int(fail[state])
            if has_match[state]:
                positions.append(i)
                states.append(state)
    return (
        np.asarray(positions, dtype=np.int64),
        np.asarray(states, dtype=np.int64),
    )


def make_lanes(
    hay: np.ndarray, num_lanes: int, halo: int, pad_value: int = PAD_BYTE
) -> tuple[np.ndarray, int]:
    """Reshape a byte array into halo'd lanes ``[L, halo + T]`` (int32).

    Lane ``l`` covers global positions ``[l*T, (l+1)*T)`` and is prefixed
    with the ``halo`` bytes preceding its segment (``pad_value`` where those
    don't exist).  Tail padding also uses ``pad_value``.
    """
    n = len(hay)
    T = -(-n // num_lanes)  # ceil
    flat = np.full(halo + num_lanes * T, pad_value, dtype=np.int32)
    flat[halo : halo + n] = hay
    ext = np.empty((num_lanes, halo + T), dtype=np.int32)
    for l in range(num_lanes):
        ext[l] = flat[l * T : l * T + halo + T]
    return ext, T


def scan_numpy_lanes(
    am: Automaton,
    hay: np.ndarray,
    *,
    num_lanes: int = 256,
    table: np.ndarray | None = None,
    classes: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Halo'd parallel lane scan with vectorized NumPy gathers.

    ``table`` defaults to the dense DFA table; pass ``am.delta_classed`` with
    ``classes=am.byte_classes`` for the byte-class engine.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    if table is None:
        table = am.delta
    halo = am.max_len - 1
    L = max(1, min(num_lanes, -(-n // max(16, halo))))
    ext, T = make_lanes(np.asarray(hay, dtype=np.int32), L, halo)
    if classes is not None:
        ext = classes[ext]
    states = np.zeros(L, dtype=np.int64)
    out = np.empty((L, T), dtype=np.int32)
    for t in range(halo + T):
        states = table[states, ext[:, t]]
        if t >= halo:
            out[:, t - halo] = states
    flat = out.reshape(-1)[:n]
    counts = am.match_count[flat]
    positions = np.nonzero(counts)[0]
    return positions.astype(np.int64), flat[positions].astype(np.int64)


def scan_numpy_sparse(
    am: Automaton, hay: np.ndarray, *, num_lanes: int = 256
) -> tuple[np.ndarray, np.ndarray]:
    """Halo'd lane scan over the sparse CSR engine (NoncontiguousNFA).

    Per step, unresolved lanes walk their failure chains; the walk is
    vectorized across lanes and bounded by the trie depth.
    """
    n = len(hay)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    keys, targets, fail = am.sparse
    halo = am.max_len - 1
    L = max(1, min(num_lanes, -(-n // max(16, halo))))
    ext, T = make_lanes(np.asarray(hay, dtype=np.int32), L, halo)
    states = np.zeros(L, dtype=np.int64)
    out = np.empty((L, T), dtype=np.int32)

    def step(states: np.ndarray, col: np.ndarray) -> np.ndarray:
        # PAD_BYTE has no edges anywhere, so it resolves to root naturally.
        nxt = np.full(L, -1, dtype=np.int64)
        active = np.ones(L, dtype=bool)
        cur = states.copy()
        while True:
            key = cur * 257 + col
            idx = np.searchsorted(keys, key)
            idx_c = np.minimum(idx, len(keys) - 1) if len(keys) else idx * 0
            found = (
                (idx < len(keys)) & (keys[idx_c] == key)
                if len(keys)
                else np.zeros(L, dtype=bool)
            )
            hit = active & found
            if hit.any():
                nxt[hit] = targets[idx_c[hit]]
                active &= ~hit
            at_root = active & (cur == 0)
            if at_root.any():
                nxt[at_root] = 0
                active &= ~at_root
            if not active.any():
                break
            cur[active] = fail[cur[active]]
        return nxt

    for t in range(halo + T):
        states = step(states, ext[:, t])
        if t >= halo:
            out[:, t - halo] = states
    flat = out.reshape(-1)[:n]
    counts = am.match_count[flat]
    positions = np.nonzero(counts)[0]
    return positions.astype(np.int64), flat[positions].astype(np.int64)
