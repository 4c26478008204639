"""SIMD-prefilter compiler (the device analogue of the crate's Teddy/FDR).

The reference's speed comes largely from SIMD prefilters buried in the
``aho-corasick`` crate (SURVEY.md §2.2 X10: memchr/Teddy).  On the
device, the bottleneck of the dense-DFA scan is the per-byte dependent
table load, while bitwise ops on 16-entry nibble tables are cheap.
This module compiles the pattern set into Teddy-style nibble tables the
fire kernel (``ops/scan_teddy.py``, ``csrc/teddy.cu``) consumes:

* patterns are grouped into ``32 * words`` buckets (one bit per bucket
  across ``words`` int32 mask planes) by sorted first-``m``-byte prefix, so
  co-bucketed patterns share fingerprints; more planes = fewer patterns per
  bucket = less cartesian inflation of the per-position nibble sets, which
  is what keeps large pattern sets selective (the FDR move);
* for each fingerprint position ``k < m`` and each plane there are two
  16-entry nibble tables (low/high); a byte is "allowed" for a bucket at
  ``k`` iff some member pattern has that nibble pair at ``k`` (or is
  shorter than ``k+1``, which makes the position unconstrained);
* a position *fires* when any plane of ``AND_k tables_k[h[i+k]]`` is
  non-zero.

Soundness: if pattern ``p`` occurs at position ``i``, every fingerprint
position matches exactly, so ``p``'s bucket bit survives all ANDs — no
false negatives.  False positives are discarded by exact windowed
verification.  Both ``m`` and ``words`` adapt to the pattern set via a
selectivity estimate under the byte distribution the patterns themselves
imply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

#: candidate fingerprint lengths; longer = more selective, more bitwise ops
MIN_FINGERPRINT = 3
MAX_FINGERPRINT = 8
#: maximum int32 mask planes (32 buckets each)
MAX_WORDS = 8
#: no prefilter is attempted above this many patterns: with at most
#: ``32 * MAX_WORDS`` buckets, >=256 patterns share every bucket and the
#: per-position nibble sets saturate information-theoretically (bucket
#: coverage ~ product of near-full nibble fractions — round-1 measurement:
#: beyond a few thousand random patterns the filter fires on most bytes).
#: The early-out also keeps construction O(1) in pattern count for huge
#: sets (building candidate tables for 10^6 patterns costs minutes of
#: Python for a filter that could never be selective).
MAX_PATTERNS = 65536


@dataclass
class Prefilter:
    m: int
    #: mask planes per pass (32 buckets each)
    words: int
    #: independent bucket assignments AND-combined per position.  A single
    #: nibble filter saturates around 0.5%/byte on large pattern sets;
    #: since windowed verification is the expensive stage (dependent loads),
    #: a second *independently bucketed* filter multiplies false-fire
    #: rates (~r^2) for one more cheap bitwise pass — the fire kernel ANDs the
    #: per-pass hits.  True matches pass every filter (soundness per pass).
    passes: int
    #: int32 [passes*2*m*words, 128]; row ((p*m + k)*2 + lohi)*words + w
    #: holds, for pass p and fingerprint position k, the low (lohi=0) /
    #: high (lohi=1) nibble table of mask plane w.  Lanes 0..15 meaningful.
    tables: np.ndarray
    bucket_of: np.ndarray  # int32 [passes, P]
    est_fire_rate: float

    def byte_allowed(self) -> np.ndarray:
        """bool [passes, m, 256, buckets]: byte allowed per (pass,
        position, bucket)?"""
        t = self.tables.view(np.uint32).reshape(
            self.passes, self.m, 2, self.words, 128
        )
        bytes_ = np.arange(256)
        B = 32 * self.words
        out = np.zeros((self.passes, self.m, 256, B), dtype=bool)
        for p in range(self.passes):
            for k in range(self.m):
                for w in range(self.words):
                    mask = (
                        t[p, k, 0, w, bytes_ & 15]
                        & t[p, k, 1, w, bytes_ >> 4]
                    )
                    out[p, k, :, 32 * w : 32 * (w + 1)] = (
                        (mask[:, None] >> np.arange(32)) & 1
                    ).astype(bool)
        return out


def _assign_buckets(
    patterns: Sequence[bytes],
    m: int,
    B: int,
    byte_freq: np.ndarray,
    order: Optional[list[int]] = None,
) -> np.ndarray:
    """Greedy min-coverage-increase clustering of patterns into buckets.

    A bucket's fire mass is ``Π_k lo_mass_k * hi_mass_k`` (the nibble
    tables are per-position cartesian products, so coverage multiplies);
    each pattern goes to the bucket whose mass grows least.  This is what
    keeps hundreds of patterns per plane selective — sorted-prefix chunking
    saturates positions ≥ 2 and fires on most of the corpus.
    """
    P = len(patterns)
    if order is None:
        order = sorted(range(P), key=lambda i: patterns[i][:m])
    if P > 20000:
        # greedy is O(P*B*m); past this size fall back to chunking the
        # visit order (the runtime fire-rate check protects perf)
        bucket_of = np.zeros(P, dtype=np.int32)
        per_bucket = -(-P // B)
        for rank, pid in enumerate(order):
            bucket_of[pid] = min(rank // per_bucket, B - 1)
        return bucket_of
    flo = np.zeros(16)
    fhi = np.zeros(16)
    for b in range(256):
        flo[b & 15] += byte_freq[b]
        fhi[b >> 4] += byte_freq[b]
    has_lo = np.zeros((B, m, 16), dtype=bool)
    has_hi = np.zeros((B, m, 16), dtype=bool)
    lo_mass = np.zeros((B, m))
    hi_mass = np.zeros((B, m))
    sizes = np.zeros(B, dtype=np.int64)
    cap = max(4, (4 * P) // B)
    bucket_of = np.zeros(P, dtype=np.int32)
    # the caller's visit order puts similar patterns adjacent so the
    # greedy sees them consecutively
    for pid in order:
        p = patterns[pid]
        # candidate masses per bucket if p joins  [B, m]
        nl = lo_mass.copy()
        nh = hi_mass.copy()
        for k in range(m):
            if k < len(p):
                lo_v, hi_v = p[k] & 15, p[k] >> 4
                nl[:, k] = np.where(
                    has_lo[:, k, lo_v], nl[:, k], nl[:, k] + flo[lo_v]
                )
                nh[:, k] = np.where(
                    has_hi[:, k, hi_v], nh[:, k], nh[:, k] + fhi[hi_v]
                )
            else:
                nl[:, k] = 1.0
                nh[:, k] = 1.0
        # minimize the *increase* in fire mass, so patterns pile into
        # buckets that already cover them instead of the least-full bucket
        cost = (nl * nh).prod(axis=1) - (lo_mass * hi_mass).prod(axis=1)
        cost = np.where(sizes >= cap, np.inf, cost)
        beta = int(np.argmin(cost))
        bucket_of[pid] = beta
        sizes[beta] += 1
        for k in range(m):
            if k < len(p):
                has_lo[beta, k, p[k] & 15] = True
                has_hi[beta, k, p[k] >> 4] = True
                lo_mass[beta, k] = nl[beta, k]
                hi_mass[beta, k] = nh[beta, k]
            else:
                lo_mass[beta, k] = 1.0
                hi_mass[beta, k] = 1.0
                has_lo[beta, k, :] = True
                has_hi[beta, k, :] = True
    return bucket_of


def _pass_orders(
    patterns: Sequence[bytes], m: int, passes: int
) -> list[list[int]]:
    """Greedy visit orders per pass — decorrelated so the two bucketings
    are (nearly) independent: pass 0 clusters by prefix, pass 1 by the
    reversed byte string (suffix-similar patterns co-bucket instead)."""
    P = len(patterns)
    orders = [sorted(range(P), key=lambda i: patterns[i][:m])]
    if passes > 1:
        orders.append(sorted(range(P), key=lambda i: patterns[i][::-1]))
    return orders[:passes]


def _build_for(
    patterns: Sequence[bytes],
    m: int,
    words: int,
    byte_freq: np.ndarray,
    passes: int = 1,
) -> Prefilter:
    P = len(patterns)
    B = 32 * words
    orders = _pass_orders(patterns, m, passes)
    bucket_of = np.stack(
        [
            _assign_buckets(patterns, m, B, byte_freq, order)
            for order in orders
        ]
    )

    # [P, m] fingerprint bytes (-1 beyond pattern length), built without a
    # per-(pattern, position) Python loop — construction cost matters for
    # tens of thousands of patterns
    lens = np.fromiter(
        (min(len(p), m) for p in patterns), np.int64, count=P
    )
    blob = np.frombuffer(
        b"".join(p[:m] for p in patterns), dtype=np.uint8
    ).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    col = np.arange(m, dtype=np.int64)[None, :]
    valid = col < lens[:, None]
    pmat = np.full((P, m), -1, np.int32)
    pmat[valid] = blob[
        (offs[:, None] + np.minimum(col, lens[:, None] - 1))[valid]
    ]
    tables = np.zeros((passes, m, 2, words, 128), dtype=np.uint32)
    for ps in range(passes):
        w = bucket_of[ps] // 32
        bit = np.uint32(1) << (bucket_of[ps] % 32).astype(np.uint32)
        for k in range(m):
            v = pmat[:, k] >= 0
            np.bitwise_or.at(
                tables[ps, k, 0], (w[v], pmat[v, k] & 15), bit[v]
            )
            np.bitwise_or.at(
                tables[ps, k, 1], (w[v], pmat[v, k] >> 4), bit[v]
            )
            if not v.all():
                # shorter patterns leave the position unconstrained
                np.bitwise_or.at(
                    tables[ps, k, 0][:, :16], (w[~v],), bit[~v, None]
                )
                np.bitwise_or.at(
                    tables[ps, k, 1][:, :16], (w[~v],), bit[~v, None]
                )

    pf = Prefilter(
        m=m,
        words=words,
        passes=passes,
        tables=tables.reshape(passes * 2 * m * words, 128).view(np.int32),
        bucket_of=bucket_of,
        est_fire_rate=0.0,
    )
    # Selectivity estimate under the byte distribution implied by the
    # patterns themselves (a decent stand-in for the corpus a user scans
    # with these patterns): per pass, P(fire) ≈ 1 - Π_β (1 - Π_k Σ freq);
    # passes are built from decorrelated bucketings, so the combined rate
    # is modeled as the product of per-pass rates.
    allowed = pf.byte_allowed()  # [passes, m, 256, B]
    rate = 1.0
    for ps in range(passes):
        frac = np.einsum(
            "kbc,b->kc", allowed[ps].astype(np.float64), byte_freq
        )
        per_bucket_rate = frac.prod(axis=0)
        rate *= float(1.0 - np.prod(1.0 - per_bucket_rate))
    pf.est_fire_rate = rate
    return pf


def build_prefilter_config(
    patterns: Sequence[bytes], m: int, words: int, passes: int
) -> Optional[Prefilter]:
    """Compile the prefilter for an explicit (m, words, passes) config.

    Used to reinstate a tuned/persisted configuration — tables rebuild
    deterministically from the pattern set and the three knobs.
    """
    P = len(patterns)
    if P == 0:
        return None
    counts = np.bincount(
        np.frombuffer(b"".join(patterns), dtype=np.uint8), minlength=256
    ).astype(np.float64)
    byte_freq = counts / max(counts.sum(), 1.0)
    return _build_for(patterns, m, words, byte_freq, passes)


def build_prefilter_candidates(
    patterns: Sequence[bytes],
) -> list[Prefilter]:
    """Distinct prefilter configurations worth measuring on a real corpus.

    The estimate model (`est_fire_rate`) ranks configurations under the
    pattern-implied byte distribution, but the observed rate on a user's
    corpus routinely differs 3x; `TeddyScanner` costs are dominated by the
    fired-window count, so measured wall time on a corpus sample is the
    only reliable objective.  Candidates vary plane count and pass count around the
    heuristic default.
    """
    P = len(patterns)
    if P == 0:
        return []
    default = build_prefilter(patterns)
    if default is None:
        return []
    counts = np.bincount(
        np.frombuffer(b"".join(patterns), dtype=np.uint8), minlength=256
    ).astype(np.float64)
    byte_freq = counts / max(counts.sum(), 1.0)
    out = [default]
    seen = {(default.m, default.words, default.passes)}
    for m, words, passes in (
        # toggle 1 <-> 2 passes
        (default.m, default.words, 3 - default.passes),
        (default.m, min(default.words * 2, MAX_WORDS), default.passes),
        (default.m, max(default.words // 2, 1), default.passes),
        # fingerprint length around the model's pick: the cost model's
        # constants are calibrated once, real corpora move the knee ±1
        (max(default.m - 1, MIN_FINGERPRINT), default.words,
         default.passes),
        (min(default.m + 1, MAX_FINGERPRINT), default.words,
         default.passes),
    ):
        key = (m, words, passes)
        if key in seen:
            continue
        seen.add(key)
        out.append(_build_for(patterns, m, words, byte_freq, passes))
    return out


#: relative cost of one verification-window gather-step vs one fire-kernel
#: bitwise op.  Kept at the JAX package's value so both packages pick the
#: same fingerprint (the differential tests hold ``tables`` identical);
#: re-tuning it for the H100 is later work and changes no match output.
GATHER_COST_RATIO = 600.0
#: coarse verification group size — must mirror ops/scan_teddy.py COARSE
#: (imported there; duplicated here would be a circular import).
_COARSE = 32


def _model_cost(m: int, words: int, passes: int, est_rate: float,
                max_len: int) -> float:
    """Estimated scan cost per haystack byte, in fire-kernel bitwise-op units.

    fire: every byte pays ``m * words * passes`` nibble-shuffle units.
    verify: a fired COARSE-byte group pays ``W = max_len + COARSE - 1``
    gather-steps, amortized over COARSE bytes; group fire probability is
    ``1 - (1 - r)^COARSE`` for per-byte rate ``r``.
    """
    group_rate = 1.0 - (1.0 - min(est_rate, 1.0)) ** _COARSE
    verify = group_rate * (max_len + _COARSE - 1) / _COARSE
    return m * words * passes + GATHER_COST_RATIO * verify


#: sample size for the saturation screen on large pattern sets
_SCREEN_SAMPLE = 2048
#: observed fire rates above this get the prefilter disabled at the API
#: layer anyway (api.py ``_get_teddy``), so nothing more selective than
#: this is worth paying a full greedy build to discover
_SCREEN_RATE = 0.05


def _screened_out(
    patterns: Sequence[bytes],
    words: int,
    passes: int,
    byte_freq: np.ndarray,
) -> bool:
    """Cheap saturation screen: can ANY config be selective enough?

    Builds one maximal-selectivity candidate on an evenly-spaced sample
    whose bucket load matches the full set's (plane count scaled down
    with the sample), at cost O(sample * buckets * m) — a full greedy
    build on a hopelessly saturated 20k-pattern set costs ~8s to discover
    an est_fire_rate the API gate then rejects; the screen finds that out
    ~20x cheaper.  Clusterable sets pass (an evenly-spaced sample
    preserves cluster structure, and matched bucket load keeps the
    estimate comparable).
    """
    P = len(patterns)
    stride = P / _SCREEN_SAMPLE
    sample = [patterns[int(i * stride)] for i in range(_SCREEN_SAMPLE)]
    words_s = max(1, round(words * _SCREEN_SAMPLE / P))
    pf = _build_for(sample, MAX_FINGERPRINT, words_s, byte_freq, passes=1)
    return pf.est_fire_rate**passes > _SCREEN_RATE


def build_prefilter(patterns: Sequence[bytes]) -> Optional[Prefilter]:
    """Compile nibble tables, choosing the fingerprint by a cost model.

    Plane count follows pattern count (≈8 patterns per bucket, capped at
    :data:`MAX_WORDS`); the fingerprint length ``m`` then minimizes the
    modeled scan cost — fire-kernel bitwise work grows linearly in ``m`` while
    the verification gather work shrinks with the estimated fire rate, so
    the optimum is the shortest fingerprint whose false fires are already
    cheap to verify.  Returns None for empty pattern sets.
    """
    P = len(patterns)
    if P == 0 or P > MAX_PATTERNS:
        return None
    max_len = max(len(p) for p in patterns)
    # target ≈8 patterns per bucket — beyond that the per-position nibble
    # sets of random-ish patterns saturate and the filter stops filtering
    words = 1
    while words < MAX_WORDS and P > 8 * 32 * words:
        words *= 2
    # the second, independently-bucketed pass squares the false-fire rate
    # for one more cheap bitwise pass; only worth the table/bitwise cost once a
    # single pass starts saturating (large pattern sets)
    passes = 2 if P > 64 else 1
    counts = np.bincount(
        np.frombuffer(b"".join(patterns), dtype=np.uint8), minlength=256
    ).astype(np.float64)
    byte_freq = counts / max(counts.sum(), 1.0)
    if P > _SCREEN_SAMPLE and _screened_out(
        patterns, words, passes, byte_freq
    ):
        return None
    best: Optional[Prefilter] = None
    best_cost = float("inf")
    rising = 0
    for m in range(MIN_FINGERPRINT, MAX_FINGERPRINT + 1):
        pf = _build_for(patterns, m, words, byte_freq, passes)
        cost = _model_cost(m, words, passes, pf.est_fire_rate, max_len)
        if cost < best_cost:
            best, best_cost = pf, cost
            rising = 0
        else:
            rising += 1
            if rising >= 2:
                break  # cost is convex in m; two rises = past the knee
    return best
