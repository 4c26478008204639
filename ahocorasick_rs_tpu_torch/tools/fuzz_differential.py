"""Bulk differential fuzzer: the port's host tiers against a brute-force
oracle.

The counterpart of the JAX package's ``tools/fuzz_differential.py``.
Random pattern sets (1-39 patterns of 1-11 bytes over alphabets of 2, 4,
26 or 256 symbols) and haystacks of 0-3,999 bytes (random, concatenated
patterns with noise, periodic) go through ``BytesAhoCorasick`` on every
host tier of :data:`TIERS`, every engine of :data:`IMPLS` and the three
match kinds, and ``overlapping=True`` under Standard.  Every result is
held to the brute-force oracle of ``tools/gpu_conformance.py``
(``bytes.find`` enumeration of every occurrence, then the semantics'
reduction).  ``native_resolve`` is the fused native scan and resolve that
the ``native`` tier takes on match-dense input, called on every case.

Every 120th case (from the 20th) also runs :func:`big_nested_check`: a
match-dense haystack of 1-1.5 MiB with nested patterns, where the
``native`` and ``numpy`` tiers stream (their ``_STREAM_*`` thresholds
lowered on the matcher) and the unstreamed ``numpy`` tier must equal the
``python`` walk.

Run from the repository root::

    python -m ahocorasick_rs_tpu_torch.tools.fuzz_differential [seconds] \
        [--seed N] [--device cpu]

``seconds`` defaults to 120.  Without ``--seed`` the seed is the clock's
seconds; the seed used is printed first, so that a failure can be
replayed.  The matchers are built for the card unless ``--device cpu`` is
given, and the tool exits non-zero without one.  The first mismatch
prints the case and the seed and exits 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from ..api import BytesAhoCorasick, _resolve_device
from ..models.engine import Implementation, MatchKind
from .gpu_conformance import oracle

KINDS = (MatchKind.Standard, MatchKind.LeftmostFirst,
         MatchKind.LeftmostLongest)
IMPLS = (None, Implementation.DFA, Implementation.ContiguousNFA,
         Implementation.NoncontiguousNFA)
#: the host tiers: ``backend=`` values, and the fused native resolver
TIERS = ("python", "numpy", "auto", "native", "native_resolve")
#: the big check's lowered streaming thresholds (the reference's)
BIG_STREAM = {"_STREAM_MIN": 1 << 18, "_STREAM_SEG": 1 << 17,
              "_STREAM_OCC": 1 << 15}


class Mismatch(AssertionError):
    """A tier's answer differs from the oracle's."""


def find(ac: BytesAhoCorasick, tier: str, hay: bytes,
         overlapping: bool = False) -> list:
    """``ac``'s answer on ``tier``; ``native_resolve`` calls the fused
    native resolver on a ``native`` matcher (non-overlapping only)."""
    if tier == "native_resolve":
        return ac._native_resolve_scan(np.frombuffer(hay, np.uint8))
    return ac.find_matches_as_indexes(hay, overlapping=overlapping)


def matcher(pats: list, kind: MatchKind, impl: Optional[Implementation],
            tier: str, device: str) -> BytesAhoCorasick:
    backend = "native" if tier == "native_resolve" else tier
    return BytesAhoCorasick(pats, matchkind=kind, implementation=impl,
                            backend=backend, device=device)


def gen_case(rng: np.random.Generator) -> tuple[list[bytes], bytes]:
    """One random ``(patterns, haystack)`` (the reference's recipe)."""
    alpha = int(rng.choice([2, 4, 26, 256]))
    npat = int(rng.integers(1, 40))
    pats = []
    seen = set()
    for _ in range(npat):
        k = int(rng.integers(1, 12))
        p = bytes(rng.integers(0, alpha, k, dtype=np.uint8))
        if p not in seen:
            seen.add(p)
            pats.append(p)
    n = int(rng.integers(0, 4000))
    style = int(rng.integers(0, 3))
    if style == 0:
        hay = bytes(rng.integers(0, alpha, n, dtype=np.uint8))
    elif style == 1 and pats:
        # concatenated patterns with noise: overlap pressure
        parts = []
        while sum(map(len, parts)) < n:
            if rng.random() < 0.7:
                parts.append(pats[int(rng.integers(0, len(pats)))])
            else:
                parts.append(bytes(rng.integers(0, alpha, 3, dtype=np.uint8)))
        hay = b"".join(parts)[:n]
    else:
        period = bytes(rng.integers(0, alpha, max(1, alpha // 2)))
        hay = (period * (n // max(len(period), 1) + 1))[:n]
    return pats, hay


def check_case(pats: list, hay: bytes, device: str) -> int:
    """Every tier x engine x kind (and overlapping under Standard) held
    to the oracle; the number of checks.  Raises :class:`Mismatch`."""
    checks = 0
    for kind in KINDS:
        want = oracle(pats, hay, kind, False)
        want_o = oracle(pats, hay, kind, True) if (
            kind is MatchKind.Standard) else None
        for impl in IMPLS:
            for tier in TIERS:
                ac = matcher(pats, kind, impl, tier, device)
                got = find(ac, tier, hay)
                if got != want:
                    raise Mismatch(
                        f"MISMATCH kind={kind} impl={impl} tier={tier} "
                        f"pats={pats!r} hay={hay!r}\ngot={got}\nwant={want}")
                checks += 1
                if want_o is not None and tier != "native_resolve":
                    got_o = find(ac, tier, hay, overlapping=True)
                    if got_o != want_o:
                        raise Mismatch(
                            f"OVERLAP MISMATCH impl={impl} tier={tier} "
                            f"pats={pats!r} hay={hay!r}\ngot={got_o}\n"
                            f"want={want_o}")
                    checks += 1
    return checks


def big_nested_check(rng: np.random.Generator, device: str) -> int:
    """A match-dense haystack of 1-1.5 MiB: nested prefixes of one letter
    (and a few random patterns) over that letter or a period of it.  The
    ``native`` and ``numpy`` tiers streamed, and ``numpy`` unstreamed,
    must equal the ``python`` walk (the oracle would enumerate the whole
    occurrence set itself).  The number of checks."""
    base = int(rng.integers(97, 123))
    depth = int(rng.integers(2, 9))
    pats = [bytes([base]) * k for k in range(1, depth + 1)]
    for _ in range(int(rng.integers(0, 4))):
        k = int(rng.integers(1, 6))
        p = bytes(rng.integers(97, 123, k, dtype=np.uint8))
        if p not in pats:
            pats.append(p)
    n = int(rng.integers(1 << 20, (1 << 20) + (1 << 19)))
    style = int(rng.integers(0, 2))
    if style == 0:
        hay = bytes([base]) * n
    else:
        period = bytes([base]) * int(rng.integers(1, 12)) + b"!"
        hay = (period * (n // len(period) + 1))[:n]
    checks = 0
    for kind in KINDS:
        want = matcher(pats, kind, None, "python",
                       device).find_matches_as_indexes(hay)
        for tier in ("native", "numpy"):
            ac = matcher(pats, kind, None, tier, device)
            for name, value in BIG_STREAM.items():
                setattr(ac, name, value)
            got = ac.find_matches_as_indexes(hay)
            if got != want:
                raise Mismatch(
                    f"BIG STREAM MISMATCH kind={kind} tier={tier} "
                    f"pats={pats!r} n={n} style={style} got={len(got)} "
                    f"want={len(want)}")
            checks += 1
        got = matcher(pats, kind, None, "numpy",
                      device).find_matches_as_indexes(hay)
        if got != want:
            raise Mismatch(f"BIG VECTOR MISMATCH kind={kind} pats={pats!r} "
                           f"n={n}")
        checks += 1
    return checks


def fuzz(seconds: float, seed: int, device: str) -> tuple[int, int]:
    """Cases until ``seconds`` have passed; ``(cases, checks)``.  Raises
    :class:`Mismatch` at the first difference."""
    rng = np.random.default_rng(seed)
    cases = checks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        if cases % 120 == 20:
            checks += big_nested_check(rng, device)
        pats, hay = gen_case(rng)
        cases += 1
        checks += check_case(pats, hay, device)
        if cases % 50 == 0:
            print(f"{cases} cases, {checks} checks, "
                  f"{time.time() - t0:.0f}s", flush=True)
    return cases, checks


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("seconds", nargs="?", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=None,
                   help="the cases' seed (default: the clock's seconds)")
    p.add_argument("--device", default=None,
                   help="the matchers' device (default: the card)")
    a = p.parse_args(argv)
    try:
        dev = str(_resolve_device(a.device))
    except RuntimeError as e:
        raise SystemExit(f"fuzz_differential: {e}; on the command line: "
                         "--device cpu")
    seed = a.seed if a.seed is not None else int(time.time())
    print(f"seed={seed} device={dev}", flush=True)
    try:
        cases, checks = fuzz(a.seconds, seed, dev)
    except Mismatch as e:
        print(f"{e}\nFAIL: seed={seed} (replay: --seed {seed})", flush=True)
        return 1
    print(f"PASS: {cases} cases, {checks} checks in {a.seconds:.0f}s, "
          f"seed={seed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
