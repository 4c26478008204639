"""Device conformance: every CUDA kernel held to the port's host tier.

The counterpart of the JAX package's ``tools/tpu_conformance.py``, widened
to the tiers that tool predates and to a seeded random sweep.  Three
parts, each comparing a device answer with a host answer on the same
input, exactly:

A. the TPU tool's matrix on the same inputs: its three corpora (seed 77)
   x the four public semantics x its three device configurations (DFA
   with Teddy off, DFA with Teddy forced, ContiguousNFA with Teddy off),
   and its unicode ``str`` case; the oracle is the port's ``numpy`` tier;
B. tiers that tool predates, on those corpora: the sparse engine (K7);
   ``scan_cuda.scan_device`` at the kernel boundary with its default
   tables (K6 where the pair table fits) and with K2 forced, each held to
   the host scan's ``(positions, states)``; dense segment seams; streamed
   Teddy seams with matches planted across them; K4 at every piece count
   on the corpus's real fire positions; the batch tiers (K5 and the Teddy
   batch) on documents cut from each corpus; the sharded scan (K8) in
   this process (a world of one rank) and over two gloo ranks that share
   the device, in child processes;
C. a random sweep (:func:`gen_case`) at shapes the fixed inputs miss:
   pattern lengths 1-70, 1-2,000 patterns, alphabets of 2-256 symbols,
   states of over 48 edges, haystacks of 0 bytes to 4 MiB with matches
   planted at lane, sub-lane and segment boundaries.  Every case runs
   every engine x semantics x device tier, and holds each device scan's
   compacted ``(positions, states)`` to the host scan's.  Every 8th case
   reuses the previous case's matchers on a haystack with many more
   matches (compaction overflow, retry and the sticky capacity), every
   16th also its batch matcher; every 64th (from case 5) is a 5-16 MiB
   match-dense haystack that must take the ``MatchDenseError`` bailout.
   The oracle is brute force where ``n * patterns`` is small (there the
   ``numpy`` tier is also held to it), else the ``numpy`` tier.

Run from the repository root:

    python -m ahocorasick_rs_tpu_torch.tools.gpu_conformance [--device cpu] [--cases N | --seconds S] [--seed 0] [--out PATH]

It runs on the card unless ``--device cpu`` is given (then over the
kernels' plain versions, with the Teddy gate forced where a row asks for
Teddy), and raises without a card otherwise.  ``--cases N`` runs the first
``N`` cases of the seed's sweep, so every such run checks the same inputs;
``--seconds S`` runs cases until ``S`` seconds have passed since the start.
It prints progress lines and one JSON summary line, and writes the record
to ``--out`` (on a card ``H100_CONFORMANCE.json`` at the repository root
by default; on the CPU only where ``--out`` is given): the device
and its power limit, the versions, every row of parts A and B with the
tier that served it, part C's counts, the kernels' launch counts and the
cases each kernel ran in, and every mismatch with the smallest input found
that still shows it.  It exits 1 on any mismatch, and when a kernel of
:data:`KERNELS` (on a card) or a tier of :data:`DEVICE_TIERS` (on the
CPU) served no call.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import _kernels
from ..api import AhoCorasick, BytesAhoCorasick, _resolve_device
from ..models.automaton import build_automaton
from ..models.engine import Implementation, MatchKind
from ..ops import scan_cuda, scan_teddy
from ..ops.resolve import MatchDenseError, expand_occurrences
from ..parallel import sharded
from ..parallel.multihost import RankProcesses, init_distributed
from .probe_transpose_kernel import device_label

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
#: the record's path when a run on a card names none
OUT = os.path.join(ROOT, "H100_CONFORMANCE.json")
#: seed of the TPU tool's corpora
CORPUS_SEED = 77
#: the four public semantics: (match kind name, overlapping)
SEMANTICS = (
    ("Standard", False),
    ("Standard", True),
    ("LeftmostFirst", False),
    ("LeftmostLongest", False),
)
#: part A's device configurations, the TPU tool's: (Teddy forced, engine)
CONFIGS = (
    (False, Implementation.DFA),
    (True, Implementation.DFA),
    (False, Implementation.ContiguousNFA),
)
#: every engine and its ``DeviceTables`` name
ENGINES = {
    Implementation.DFA: "dfa",
    Implementation.ContiguousNFA: "classed",
    Implementation.NoncontiguousNFA: "sparse",
}
#: segment lengths of the dense and streamed Teddy seam checks
SEAMS = (4096, 65_543, 1 << 20)
#: document lengths of part B's batches besides the random ones
BATCH_EDGE_LENS = (0, 1, 15, 16, 17, 127)
#: random-length (600-4,096 byte) documents of part B's batches
BATCH_RANDOM_DOCS = 64
#: the launch counters that must be nonzero after a run on a card
KERNELS = (
    "fire", "fire_groups", "verify", "lane_scan", "lane_scan_head",
    "compact", "batch_scan", "stride2_scan", "sparse_scan", "shard_body",
)
#: the tiers that must each serve a call of a run on the CPU
DEVICE_TIERS = (
    "device", "teddy", "device_batch", "teddy_batch", "sharded",
    "teddy_sharded", "sharded_batch", "teddy_sharded_batch",
)
#: ranks of part B's multi-process sharded check (they share the device)
SHARD_RANKS = 2
#: seconds the ranks may take before the check fails
SHARD_TIMEOUT_S = 600
#: ``n * patterns`` at or below which part C's oracle is brute force
BRUTE_MAX = 1 << 20
#: most re-runs of a failing check while shrinking its input, and the
#: mismatches of a run that are shrunk (a broken kernel fails every check)
SHRINK_RUNS, SHRINK_MISMATCHES = 32, 8
#: part C's cases that reuse the previous case's matchers: every 8th, and
#: its batch matcher every 16th
OVERFLOW_EVERY, BATCH_OVERFLOW_EVERY = 8, 16
#: part C's match-dense bailout cases: every 64th, from case 5
BAILOUT_EVERY, BAILOUT_AT = 64, 5
#: cases when neither ``--cases`` nor ``--seconds`` is given
DEFAULT_CASES = 100
#: tiers a call takes when it leaves the device
HOST_TIERS = frozenset(
    ("python", "numpy", "native", "native_batch", "native_resolve")
)


# -- inputs -------------------------------------------------------------


def corpora() -> list[tuple[str, list[bytes], bytes]]:
    """The TPU tool's ``(name, patterns, haystack)`` cases
    (``tools/tpu_conformance.py`` ``corpora``), from the same seed, byte
    for byte."""
    rng = np.random.default_rng(CORPUS_SEED)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    out = []

    # LONG-recipe-like: 500 name patterns over 4MB lowercase text
    names = sorted(
        {
            bytes(letters[rng.integers(0, 26, int(rng.integers(5, 12)))])
            for _ in range(500)
        }
    )
    hay = bytearray(bytes(letters[rng.integers(0, 26, 4 << 20)]))
    for i in range(200):
        p = names[int(rng.integers(0, len(names)))]
        off = int(rng.integers(0, len(hay) - 16))
        hay[off : off + len(p)] = p
    out.append(("long_names_4mb", names, bytes(hay)))

    # overlapping-heavy: nested patterns, repetitive haystack
    pats = [b"a", b"aa", b"aaa", b"ab", b"aab", b"ba"]
    hay2 = (b"a" * 37 + b"b" + b"a" * 11 + b"ba") * 60_000
    out.append(("nested_repeats", pats, hay2))

    # binary byte patterns incl. NUL and 0xFF
    bpats = [bytes([0, 1, 2]), b"\xff\xfe", b"\x00\x00a", b"zz\x00"]
    hb = bytearray(rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes())
    for i in range(100):
        p = bpats[int(rng.integers(0, len(bpats)))]
        off = int(rng.integers(0, len(hb) - 8))
        hb[off : off + len(p)] = p
    out.append(("binary_3mb", bpats, bytes(hb)))
    return out


def unicode_case() -> tuple[list[str], str]:
    """The TPU tool's ``str`` case: three patterns with multi-byte code
    points over a 4.6 M-character text."""
    upats = ["wörld", "día", "ação"]
    body = "texto día con wörld e ação misturados " * 120_000
    return upats, body


def batch_docs(hay: bytes, index: int,
               max_bytes: Optional[int] = None) -> list[bytes]:
    """Part B's documents cut from a corpus: one of each length of
    :data:`BATCH_EDGE_LENS`, then :data:`BATCH_RANDOM_DOCS` of 600-4,096
    bytes, at seeded offsets (all shorter where the corpus is); with
    ``max_bytes``, the first of them up to that many bytes in all."""
    rng = np.random.default_rng([CORPUS_SEED, index])
    lens = list(BATCH_EDGE_LENS) + [
        int(x) for x in rng.integers(600, 4097, BATCH_RANDOM_DOCS)
    ]
    docs = []
    total = 0
    for ln in lens:
        ln = min(ln, len(hay))
        off = int(rng.integers(0, len(hay) - ln + 1))
        total += ln
        if max_bytes is not None and total > max_bytes:
            break
        docs.append(hay[off : off + ln])
    return docs


def oracle_occurrences(
    pats: Sequence[bytes], hay: bytes
) -> list[tuple[int, int, int]]:
    """Every ``(pattern, start, end)`` occurrence, by ``bytes.find``
    (``tools/fuzz_differential.py``'s brute force)."""
    occ = []
    for pid, p in enumerate(pats):
        start = 0
        while True:
            i = hay.find(p, start)
            if i < 0:
                break
            occ.append((pid, i, i + len(p)))
            start = i + 1
    return occ


def oracle(
    pats: Sequence[bytes], hay: bytes, kind: MatchKind, overlapping: bool
) -> list[tuple[int, int, int]]:
    """The brute-force answer of one semantics
    (``tools/fuzz_differential.py`` ``oracle``)."""
    occ = oracle_occurrences(pats, hay)
    if overlapping:
        occ.sort(key=lambda t: (t[2], t[1] - t[2], t[0]))
        return occ
    if kind is MatchKind.Standard:
        occ.sort(key=lambda t: (t[2], t[1]))
    elif kind is MatchKind.LeftmostFirst:
        occ.sort(key=lambda t: (t[1], t[0]))
    else:
        occ.sort(key=lambda t: (t[1], t[1] - t[2], t[0]))
    out = []
    cur = 0
    for t in occ:
        if t[1] >= cur:
            out.append(t)
            cur = t[2]
    return out


#: block lengths matches are planted across: sub-lane pieces, COARSE
#: groups, sub-lanes, lanes, segments and K3's chunk
PLANT_BLOCKS = (16, 32, 64, 128, 512, 4096, 16384, 65536)


def gen_case(
    seed: int, index: int, max_bytes: Optional[int] = None
) -> tuple[list[bytes], bytes, list[int], dict]:
    """Part C's case ``index`` of ``seed``: ``(patterns, haystack, cuts,
    meta)``, where ``cuts`` splits the haystack into the case's batch of
    1-64 documents.

    ``tools/fuzz_differential.py`` ``gen_case`` widened: 1-2,000 distinct
    patterns of 1-70 bytes over an alphabet of 2, 4, 26 or 256 symbols
    (bytes ``0..alpha-1``), in some cases a shared prefix fanning out to
    49-256 distinct next bytes; ``n`` of 0, 1, odd below 128, 16 Ki +- 1,
    or up to 64 KiB, 1 MiB or 4 MiB (cut to ``max_bytes``); its three
    haystack styles (random, patterns with noise, periodic), then up to 32
    patterns planted across the boundaries of :data:`PLANT_BLOCKS`, and in
    half the cases one ending at the haystack's last byte."""
    rng = np.random.default_rng([seed, index])
    alpha = int(rng.choice([2, 4, 26, 256]))
    r = rng.random()
    if r < 0.6:
        npat = int(rng.integers(1, 40))
    elif r < 0.9:
        npat = int(rng.integers(40, 400))
    else:
        npat = int(rng.integers(400, 2001))
    kmax = int(rng.choice([4, 12, 40, 71]))
    pats: list[bytes] = []
    seen: set[bytes] = set()

    def add(p: bytes) -> None:
        if p not in seen:
            seen.add(p)
            pats.append(p)

    for _ in range(npat):
        add(bytes(rng.integers(0, alpha, int(rng.integers(1, kmax)),
                               dtype=np.uint8)))
    wide = bool(rng.random() < 0.15)
    if wide:
        prefix = bytes(rng.integers(0, alpha, int(rng.integers(1, 9)),
                                    dtype=np.uint8))
        for b in rng.permutation(256)[: int(rng.integers(49, 257))]:
            tail = bytes(rng.integers(0, alpha, int(rng.integers(0, 4)),
                                      dtype=np.uint8))
            add(prefix + bytes([int(b)]) + tail)
    r = rng.random()
    if r < 0.05:
        n = 0
    elif r < 0.10:
        n = 1
    elif r < 0.35:
        n = 2 * int(rng.integers(0, 64)) + 1
    elif r < 0.50:
        n = (1 << 14) + int(rng.integers(-1, 2))
    elif r < 0.80:
        n = int(rng.integers(128, 1 << 16))
    elif r < 0.93:
        n = int(rng.integers(1 << 16, 1 << 20))
    else:
        n = int(rng.integers(1 << 20, (4 << 20) + 1))
    if max_bytes is not None:
        n = min(n, max_bytes)
    style = int(rng.integers(0, 3))
    if style == 0:
        hay = rng.integers(0, alpha, n, dtype=np.uint8).tobytes()
    elif style == 1:
        # concatenated patterns with noise: maximal overlap pressure
        parts: list[bytes] = []
        total = 0
        while total < n:
            k = max(16, (n - total) // 4)
            pick = rng.integers(0, len(pats), k)
            is_pat = rng.random(k) < 0.7
            noise = rng.integers(0, alpha, (k, 3), dtype=np.uint8)
            for j in range(k):
                part = pats[pick[j]] if is_pat[j] else noise[j].tobytes()
                parts.append(part)
                total += len(part)
                if total >= n:
                    break
        hay = b"".join(parts)[:n]
    else:
        period = bytes(rng.integers(0, alpha, max(1, alpha // 2),
                                    dtype=np.uint8))
        hay = (period * (n // len(period) + 1))[:n]
    buf = bytearray(hay)
    for _ in range(int(rng.integers(0, 33))):
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) > n:
            continue
        block = int(rng.choice(PLANT_BLOCKS))
        if n // block:
            seam = block * int(rng.integers(1, n // block + 1))
            at = seam - int(rng.integers(0, len(p) + 1))
        else:
            at = n - len(p)
        at = min(max(at, 0), n - len(p))
        buf[at : at + len(p)] = p
    if n and rng.random() < 0.5:
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= n:
            buf[n - len(p) :] = p
    ndocs = int(rng.integers(1, 65))
    cuts = sorted(int(c) for c in rng.integers(0, n + 1, ndocs - 1))
    meta = {"seed": seed, "index": index, "alphabet": alpha,
            "patterns": len(pats), "max_len": max(map(len, pats)),
            "wide": wide, "style": style, "n": n, "documents": ndocs}
    return pats, bytes(buf), cuts, meta


def split_docs(hay: bytes, cuts: Sequence[int]) -> list[bytes]:
    bounds = [0, *cuts, len(hay)]
    return [hay[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def bailout_case(
    seed: int, index: int
) -> tuple[list[bytes], bytes, dict]:
    """A 5-16 MiB match-dense case: the 64 nested patterns ``a``,
    ``aa``, ..., over runs of ``a`` broken by 16 ``!``.  Nearly every
    position matches, past ``max(DENSE_BAILOUT_MIN, n // 8)``."""
    rng = np.random.default_rng([seed, index])
    n = int(rng.integers(5 << 20, (16 << 20) + 1))
    buf = bytearray(b"a" * n)
    for at in rng.integers(0, n, 16):
        buf[int(at)] = ord("!")
    pats = [b"a" * k for k in range(1, 65)]
    return pats, bytes(buf), {"seed": seed, "index": index, "n": n,
                              "bailout": True, "patterns": len(pats)}


# -- the sweep ------------------------------------------------------------


def _flat(per_doc: list) -> list:
    return [(i, *t) for i, doc in enumerate(per_doc) for t in doc]


def digest(matches: list) -> str:
    """sha256 of a tuple list's integers in order, and its length."""
    flat = np.fromiter(itertools.chain.from_iterable(matches), np.int64)
    return f"{hashlib.sha256(flat.tobytes()).hexdigest()}:{len(matches)}"


def _arrays(outs) -> Optional[tuple]:
    """A device or host output as a tuple of host integer arrays (None
    stays None): arrays compare without building millions of tuples."""
    if outs is None:
        return None
    return tuple(np.asarray(o.cpu() if torch.is_tensor(o) else o)
                 for o in outs)


def _same(got, want) -> bool:
    if isinstance(got, tuple) and isinstance(want, tuple):
        return len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))
    return got == want


def _jsonable(x):
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bytes, bytearray)):
        return x.hex()
    if isinstance(x, (np.integer,)):
        return int(x)
    return x


class Sweep:
    """One conformance run: its device, rows, counts and mismatches."""

    def __init__(self, dev: torch.device, verbose: bool) -> None:
        self.dev = dev
        self.verbose = verbose
        self.rows: dict[str, list] = {"A": [], "B": []}
        self.mismatches: list[dict] = []
        self.checks = 0
        #: kernel -> part -> cases (rows, or part C cases) it launched in
        self.cases_by_kernel = {
            k: {"A": 0, "B": 0, "C": 0} for k in _kernels.LAUNCHES
        }
        #: served tier -> calls
        self.tiers: dict[str, int] = {}
        #: part C: "engine/semantics/tier" -> calls, and oracle kinds
        self.c_counts: dict[str, int] = {}
        self.c_oracle = {"brute": 0, "numpy": 0}
        self.c_special = {"overflow": 0, "batch_overflow": 0,
                          "bailout": 0}
        #: digests of the ``numpy`` tier's Standard tuples the ranks are
        #: held to, by corpus (and ``<corpus>/batch``)
        self.single: dict[str, str] = {}
        self._tier: Optional[str] = None
        #: the scan kernel of the latest ``scan_device`` check
        self.kernel: Optional[str] = None
        #: [patterns, their automaton, their prefilter configuration]
        self._built: Optional[list] = None
        #: label -> (patterns, haystack, answer) of :meth:`once`
        self._memo: dict[str, tuple] = {}

    def log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def once(self, label: str, pats, hay, compute: Callable):
        """``compute()``, or its answer for ``label`` while ``pats`` and
        ``hay`` are the very objects it was computed for: a row asks for
        the same host answer (or Teddy scan) in several checks, while a
        shrunk input is a new object and is computed anew."""
        m = self._memo.get(label)
        if m is not None and m[0] is pats and m[1] is hay:
            return m[2]
        value = compute()
        self._memo[label] = (pats, hay, value)
        return value

    # -- matchers --------------------------------------------------------
    def matcher(
        self, pats: Sequence[bytes], kind: str = "Standard",
        impl: Implementation = Implementation.DFA, backend: str = "device",
        teddy: Optional[str] = "off",
    ) -> BytesAhoCorasick:
        """A matcher on this run's device; ``teddy`` sets the Teddy gate
        (``"off"``, ``"force"``, or None for the matcher's own).

        It is made as ``load_matcher`` makes one: over the pattern set's
        automaton, compiled once for the set's matchers, and with the
        prefilter configuration the set's first Teddy scanner chose, which
        its tables rebuild from exactly."""
        key = tuple(pats)
        if self._built is None or self._built[0] != key:
            self._built = [key, build_automaton(list(pats)), None]
        ac = BytesAhoCorasick.__new__(BytesAhoCorasick)
        ac._build(list(pats), MatchKind[kind], impl, backend, self.dev, None,
                  automaton=self._built[1])
        ac._pf_config = self._built[2]
        if teddy is not None:
            ac._teddy_state = teddy
        return ac

    def served(self, ac) -> None:
        """Note the tier that served ``ac``'s latest call (if it made one),
        and the prefilter configuration of its Teddy scanner."""
        tier = ac.stats()["last_backend"]
        if tier is not None:
            self._tier = tier
            self.tiers[tier] = self.tiers.get(tier, 0) + 1
        sc = ac._teddy
        if sc is not None and self._built is not None and \
                self._built[1] is ac._automaton and self._built[2] is None:
            self._built[2] = {"m": sc.m, "words": sc.words,
                              "passes": sc.passes}

    def numpy_oracle(self, kind: str, ov: bool):
        def fn(pats, hay):
            return self.matcher(pats, kind, backend="numpy", teddy=None
                                ).find_matches_as_indexes(hay, overlapping=ov)
        return fn

    def find(self, kind: str, ov: bool, impl: Implementation,
             backend: str = "device", teddy: Optional[str] = "off"):
        def fn(pats, hay):
            ac = self.matcher(pats, kind, impl, backend, teddy)
            got = ac.find_matches_as_indexes(hay, overlapping=ov)
            self.served(ac)
            return got
        return fn

    def find_batch(self, kind: str, ov: bool, impl: Implementation,
                   backend: str = "device", teddy: Optional[str] = "off"):
        def fn(pats, docs):
            ac = self.matcher(pats, kind, impl, backend, teddy)
            got = ac.find_matches_as_indexes_batch(docs, overlapping=ov)
            self.served(ac)
            return _flat(got)
        return fn

    def per_doc(self, one: Callable):
        """A batch oracle from a one-document oracle."""
        return lambda pats, docs: _flat([one(pats, d) for d in docs])

    # -- checks ------------------------------------------------------------
    def _run(self, fn: Callable, pats, hay):
        try:
            return fn(pats, hay)
        except Exception as e:  # recorded as the check's answer
            return f"raised {type(e).__name__}: {e}"

    def check(
        self, part: str, label: str, meta: dict, fn: Callable,
        oracle_fn: Callable, pats: list, hay, want=None,
        shrink: bool = True,
    ) -> bool:
        """Run ``fn(pats, hay)`` against ``oracle_fn(pats, hay)`` (or the
        ``want`` already computed for these inputs); record a mismatch with
        the smallest input found that still shows it."""
        self.checks += 1
        self._tier = None
        got = self._run(fn, pats, hay)
        tier = self._tier
        if want is None:
            want = self._run(oracle_fn, pats, hay)
        if _same(got, want):
            return True
        entry = {"part": part, "check": label, **meta, "tier": tier,
                 "n": len(hay), "patterns_total": len(pats)}
        lo, hi, spats, runs = 0, len(hay), list(pats), 0
        if shrink and len(self.mismatches) < SHRINK_MISMATCHES:
            lo, hi, spats, runs, got, want = self._shrink(
                fn, oracle_fn, spats, hay, got, want
            )
        entry.update(self._diff(got, want))
        small = hay[lo:hi]
        entry["smallest"] = {
            "window": [lo, hi], "runs": runs,
            "patterns": _jsonable(spats[:64]),
            "pattern_count": len(spats),
            "haystack": (_jsonable(small) if isinstance(small, (bytes, str))
                         and len(small) <= 1024 else None),
            "document_lengths": ([len(d) for d in small[:64]]
                                 if isinstance(small, list) else None),
        }
        self.mismatches.append(entry)
        self.log(f"MISMATCH {part} {label} {meta}: {entry['first_difference']}")
        return False

    def _shrink(self, fn, oracle_fn, pats, hay, got, want):
        """Halve the haystack (or document list) and the pattern list while
        the check still fails, at most :data:`SHRINK_RUNS` re-runs."""
        lo, hi, runs = 0, len(hay), 0
        changed = True
        while changed and runs < SHRINK_RUNS:
            changed = False
            n = hi - lo
            cands = []
            if n >= 2:
                cands += [(lo, lo + n // 2, pats), (lo + n // 2, hi, pats),
                          (lo + n // 4, hi - n // 4, pats)]
            if len(pats) >= 2:
                h = len(pats) // 2
                cands += [(lo, hi, pats[:h]), (lo, hi, pats[h:])]
            for a, b, p in cands:
                if runs >= SHRINK_RUNS:
                    break
                runs += 1
                g = self._run(fn, p, hay[a:b])
                w = self._run(oracle_fn, p, hay[a:b])
                if not _same(g, w):
                    lo, hi, pats, got, want = a, b, p, g, w
                    changed = True
                    break
        return lo, hi, pats, runs, got, want

    @staticmethod
    def _diff(got, want) -> dict:
        if isinstance(got, tuple) and isinstance(want, tuple):
            # arrays: the first array and position that differ
            for k, (a, b) in enumerate(zip(got, want)):
                if not np.array_equal(a, b):
                    i = 0
                    m = min(len(a), len(b))
                    if m:
                        ne = np.flatnonzero(a[:m] != b[:m])
                        i = int(ne[0]) if len(ne) else m
                    return {"array": k, "first_difference": i,
                            "got_len": len(a), "want_len": len(b),
                            "got": a[i : i + 5].tolist(),
                            "want": b[i : i + 5].tolist()}
        if not isinstance(got, list) or not isinstance(want, list):
            return {"first_difference": 0, "got": _jsonable(got)[:5]
                    if isinstance(got, list) else _jsonable(got),
                    "want": _jsonable(want)[:5] if isinstance(want, list)
                    else _jsonable(want)}
        i = 0
        while i < min(len(got), len(want)) and got[i] == want[i]:
            i += 1
        return {"first_difference": i, "got_len": len(got),
                "want_len": len(want), "got": _jsonable(got[i : i + 5]),
                "want": _jsonable(want[i : i + 5])}

    def case(self, part: str, fn: Callable) -> dict:
        """Run ``fn()`` as one case of ``part``: count the kernels it
        launched, and return their launches."""
        before = dict(_kernels.LAUNCHES)
        fn()
        launched = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
                    if v > before[k]}
        for k in launched:
            self.cases_by_kernel[k][part] += 1
        return launched

    def row(self, part: str, meta: dict, fn: Callable) -> None:
        """One row of part A or B: ``fn()`` makes its checks and returns
        what the row records besides them."""
        bad = len(self.mismatches)
        extra: dict = {}
        t0 = time.perf_counter()
        launched = self.case(part, lambda: extra.update(fn() or {}))
        row = {**meta, **extra, "exact": len(self.mismatches) == bad,
               "launches": launched, "seconds": time.perf_counter() - t0}
        self.rows[part].append(row)
        self.log(f"{part} {meta}: {'OK' if row['exact'] else 'MISMATCH'} "
                 f"{extra}")


# -- part A ---------------------------------------------------------------


def part_a(sw: Sweep, cps: list, wants: dict,
           max_bytes: Optional[int]) -> None:
    """The TPU tool's 36 device rows and its unicode row (its text cut to
    ``max_bytes`` characters); ``wants`` collects the numpy tier's answers
    by (corpus, semantics)."""
    for name, pats, hay in cps:
        for kind, ov in SEMANTICS:
            want = wants[(name, kind, ov)] = sw.numpy_oracle(kind, ov)(
                pats, hay)
            if kind == "Standard" and not ov:
                sw.single[name] = digest(want)
            for teddy, impl in CONFIGS:
                meta = {"corpus": name, "matchkind": kind, "overlapping": ov,
                        "teddy": teddy, "implementation": impl.name}

                def run(teddy=teddy, impl=impl, meta=meta):
                    sw.check("A", "public tuples", meta,
                             sw.find(kind, ov, impl,
                                     teddy="force" if teddy else "off"),
                             sw.numpy_oracle(kind, ov), pats, hay, want)
                    return {"matches": len(want), "tier": sw._tier}

                sw.row("A", meta, run)
    upats, body = unicode_case()
    body = body[:max_bytes]

    def uni():
        def fn(p, h):
            ac = AhoCorasick(p, backend="device", device=sw.dev)
            got = ac.find_matches_as_indexes(h)
            sw.served(ac)
            return got

        def ref(p, h):
            return AhoCorasick(p, backend="numpy", device=sw.dev
                               ).find_matches_as_indexes(h)
        want = ref(upats, body)
        sw.check("A", "public tuples", {"corpus": "unicode_str_device"}, fn,
                 ref, upats, body, want, shrink=False)
        return {"matches": len(want), "tier": sw._tier}

    sw.row("A", {"corpus": "unicode_str_device", "matchkind": "Standard"},
           uni)


# -- part B ---------------------------------------------------------------


def _host_pairs(sw: Sweep, impl: Implementation):
    """The host scan's ``(position, state)`` pairs (``numpy`` tier)."""
    def fn(pats, hay):
        ac = sw.matcher(pats, impl=impl, backend="numpy", teddy=None)
        return sw.once(f"host pairs {impl.name}", pats, hay, lambda: _arrays(
            ac._host_scan(np.frombuffer(hay, np.uint8), "numpy")))
    return fn


def _device_pairs(sw: Sweep, impl: Implementation, k2: bool = False,
                  segment_bytes: Optional[int] = None):
    """``scan_cuda.scan_device``'s pairs: default tables, or with the pair
    table disabled (K2) for a dense engine.  Notes the scan kernel the
    tables take (K7, K6 or K2) in ``sw.kernel``."""
    def fn(pats, hay):
        ac = sw.matcher(pats, impl=impl, backend="numpy", teddy=None)
        am = ac._automaton
        tables = scan_cuda.DeviceTables(
            am, ENGINES[impl], sw.dev,
            **({"packed2_max_bytes": 0} if k2 else {}),
        )
        sw.kernel = (
            "K7" if impl is Implementation.NoncontiguousNFA
            else "K6" if tables.ensure_packed2() else "K2"
        )
        kw = {} if segment_bytes is None else {"segment_bytes": segment_bytes}
        return _arrays(scan_cuda.scan_device(
            am, np.frombuffer(hay, np.uint8), tables, **kw))
    return fn


def plant_seams(pats: Sequence[bytes], hay: bytes, seg: int) -> bytes:
    """``hay`` with a pattern of two bytes or more planted across every
    multiple of ``seg`` (patterns in turn, each split near its middle)."""
    longs = [p for p in pats if len(p) >= 2]
    if not longs:
        return hay
    buf = bytearray(hay)
    for i, seam in enumerate(range(seg, len(hay), seg)):
        p = longs[i % len(longs)]
        at = min(max(seam - len(p) // 2, 0), len(hay) - len(p))
        buf[at : at + len(p)] = p
    return bytes(buf)


def _teddy_scanner(sw: Sweep, pats):
    ac = sw.matcher(pats, teddy="force")
    sc = ac._get_teddy()
    sw.served(ac)
    return sc


def _teddy_occurrences(sw: Sweep, seg: Optional[int]):
    """The Teddy scanner's occurrences, whole (``seg`` None) or streamed
    in ``seg``-byte segments; None where the scanner abandons the
    prefilter (the fire rate says the dense tiers win)."""
    def scan(pats, hay):
        sc = _teddy_scanner(sw, pats)
        h = np.frombuffer(hay, np.uint8)
        if seg is None:
            return _arrays(sc.occurrences(h))
        return _arrays(sc.occurrences_streamed(h, seg_bytes=seg))
    return lambda pats, hay: sw.once(f"teddy {seg}", pats, hay,
                                     lambda: scan(pats, hay))


def _occurrence_set(sw: Sweep):
    """The whole-buffer Teddy occurrences, or where the whole buffer
    abandons the prefilter, the ``numpy`` tier's complete occurrence set
    (its scan expanded, in the same canonical order)."""
    whole = _teddy_occurrences(sw, None)

    def host(pats, hay):
        ac = sw.matcher(pats, backend="numpy", teddy=None)
        pos, st = ac._host_scan(np.frombuffer(hay, np.uint8), "numpy")
        pids, starts, ends = expand_occurrences(ac._automaton, pos, st)
        order = np.lexsort((pids, starts, ends))
        return pids[order], starts[order], ends[order]

    def fn(pats, hay):
        got = whole(pats, hay)
        if got is not None:
            return got
        return sw.once("host occurrences", pats, hay,
                       lambda: host(pats, hay))
    return fn


def _streamed(sw: Sweep, seg: int):
    """The streamed occurrences; where the streamed scan abandons the
    prefilter, :func:`_occurrence_set` (whether it may abandon is a check
    of its own)."""
    streamed = _teddy_occurrences(sw, seg)
    full = _occurrence_set(sw)

    def fn(pats, hay):
        got = streamed(pats, hay)
        return full(pats, hay) if got is None else got
    return fn


def _sharded_pairs(sw: Sweep):
    """``sharded.scan_sharded``'s pairs over a world of one rank."""
    def fn(pats, hay):
        ac = sw.matcher(pats)
        return _arrays(sharded.scan_sharded(
            ac._automaton, np.frombuffer(hay, np.uint8),
            ac._get_device_tables()))
    return fn


def _sharded_teddy(sw: Sweep):
    """``sharded.scan_sharded_teddy``'s occurrences over a world of one
    rank; where it abandons the prefilter, :func:`_occurrence_set`."""
    full = _occurrence_set(sw)

    def fn(pats, hay):
        ac = sw.matcher(pats, teddy="force")
        occ = sharded.scan_sharded_teddy(
            ac._automaton, ac._get_teddy(), np.frombuffer(hay, np.uint8))
        return full(pats, hay) if occ is None else _arrays(occ)
    return fn


def _verify_inputs(sw: Sweep, pats, hay: bytes):
    """K4's inputs at a corpus's real fire positions, as ``_fire_verify``
    makes them: ``(scanner, (vtable, classes, hay, fire_pos, n, W))``."""
    sc = _teddy_scanner(sw, pats)
    h = np.frombuffer(hay, np.uint8)
    hay2d = sc.stage(h)
    n = len(h)
    mask = scan_teddy.fire_mask(sc.tables, hay2d, sc.m, sc.words, sc.passes,
                                packed=sc.packed).reshape(-1)
    fired = scan_teddy.fire_groups(mask, n)
    count = int(fired.sum())
    fire_grp, _ = scan_cuda.compact_sparse(fired, max(count, 1))
    fire_pos = torch.where(fire_grp >= 0, fire_grp * scan_teddy.COARSE, -1)
    W = sc.am.max_len + scan_teddy.COARSE - 1
    return sc, (sc.vtable, sc.classes, hay2d.reshape(-1), fire_pos, n, W)


def _k4(sw: Sweep, pieces: Optional[int]):
    """K4 at ``pieces`` (None: the plain ``_verify_body`` on CPU copies),
    at a ``cap2`` above the total."""
    def fn(pats, hay):
        sc, args = _verify_inputs(sw, pats, hay)
        cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
        total = int(scan_teddy._verify_body(*cpu, 1, sc.use_classes)[3])
        cap2 = scan_cuda._bucket(max(total, 1), lo=1024)
        if pieces is None:
            return _arrays(
                scan_teddy._verify_body(*cpu, cap2, sc.use_classes))
        W = args[5]
        return _arrays(_kernels.verify_body(
            *args, cap2, sc.use_classes, halo=W - scan_teddy.COARSE,
            pieces=pieces))
    return fn


def part_b(sw: Sweep, cps: list, wants: dict, max_bytes: Optional[int]
           ) -> None:
    """Part B's rows on each corpus, then the ranks' check; ``wants`` are
    part A's answers.  The ranks start first and run beside the rows."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    def argv(rank: int, init: str, out: str) -> list[str]:
        cmd = [sys.executable, "-m",
               "ahocorasick_rs_tpu_torch.tools.gpu_conformance",
               "--shard-child", "--rank", str(rank), "--world",
               str(SHARD_RANKS), "--init", init, "--out", out, "--device",
               str(sw.dev)]
        return cmd + ([] if max_bytes is None
                      else ["--max-bytes", str(max_bytes)])

    tmp = tempfile.mkdtemp(prefix="gpu_conformance_")
    try:
        with RankProcesses(argv, SHARD_RANKS, tmp, cwd=ROOT,
                           env=env) as ranks:
            batch_wants: dict = {}
            for ci, (name, pats, hay) in enumerate(cps):
                corpus_rows(sw, ci, name, pats, hay, wants, batch_wants,
                            max_bytes)
                sw._memo.clear()
            sw.row("B", {"check": f"sharded, {SHARD_RANKS} gloo ranks"},
                   lambda: check_ranks(sw, ranks))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def corpus_rows(sw: Sweep, ci: int, name: str, pats: list, hay: bytes,
                wants: dict, batch_wants: dict,
                max_bytes: Optional[int]) -> None:
    """Part B's rows on one corpus (its batch cut to ``max_bytes``);
    ``batch_wants`` collects the batch oracles' answers."""
    on_card = sw.dev.type == "cuda"
    # K7 through the public API
    for kind, ov in SEMANTICS:
        meta = {"corpus": name, "check": "sparse engine (K7)",
                "matchkind": kind, "overlapping": ov}

        def sparse(kind=kind, ov=ov, meta=meta):
            sw.check("B", "public tuples", meta,
                     sw.find(kind, ov, Implementation.NoncontiguousNFA),
                     sw.numpy_oracle(kind, ov), pats, hay,
                     wants[(name, kind, ov)])
            return {"tier": sw._tier}

        sw.row("B", meta, sparse)
    # the kernel boundary: scan_device against the host scan
    for impl in ENGINES:
        for k2 in ((False, True) if impl is not
                   Implementation.NoncontiguousNFA else (False,)):
            meta = {"corpus": name, "check": "scan_device pairs",
                    "implementation": impl.name, "k2_forced": k2}

            def boundary(impl=impl, k2=k2, meta=meta):
                host = _host_pairs(sw, impl)
                want = host(pats, hay)
                sw.check("B", "scan_device pairs", meta,
                         _device_pairs(sw, impl, k2), host, pats, hay,
                         want)
                return {"pairs": len(want[0]), "kernel": sw.kernel}

            sw.row("B", meta, boundary)
    # dense segment seams
    meta = {"corpus": name, "check": "dense seams",
            "segments": list(SEAMS)}

    def seams(meta=meta):
        whole = _device_pairs(sw, Implementation.DFA)
        want = whole(pats, hay)
        for s in SEAMS:
            sw.check("B", f"dense seams {s}", meta,
                     _device_pairs(sw, Implementation.DFA,
                                   segment_bytes=s), whole, pats, hay,
                     want)
        return {"pairs": len(want[0])}

    sw.row("B", meta, seams)
    # streamed Teddy seams, with matches planted across every seam
    for s in SEAMS:
        meta = {"corpus": name, "check": "streamed Teddy seams",
                "seg_bytes": s}

        def streamed(s=s, meta=meta):
            planted = plant_seams(pats, hay, s)
            full = _occurrence_set(sw)
            want = full(pats, planted)
            sw.check("B", "streamed Teddy", meta, _streamed(sw, s), full,
                     pats, planted, want)
            abandons = [_teddy_occurrences(sw, g)(pats, planted) is None
                        for g in (s, None)]
            sw.check("B", "streamed Teddy abandons only where the whole "
                     "buffer does", meta,
                     lambda p, h: abandons[0] <= abandons[1],
                     lambda p, h: True, pats, planted, True,
                     shrink=False)
            return {"occurrences": len(want[0]),
                    "abandoned": dict(zip(("streamed", "whole"),
                                          abandons))}

        sw.row("B", meta, streamed)
    # K4 at every piece count (a kernel parameter: card only)
    if on_card:
        plain = _k4(sw, None)
        want = plain(pats, hay)
        for k in range(1, _kernels.VERIFY_MAX_PIECES + 1):
            meta = {"corpus": name, "check": "K4 pieces", "pieces": k}

            def pieces(k=k, meta=meta, plain=plain, want=want):
                sw.check("B", "K4 pieces", meta, _k4(sw, k), plain, pats,
                         hay, want)
                return {"matched_steps": int(want[3][0])}

            sw.row("B", meta, pieces)
    # the batch tiers (K5, Teddy batch) and the sharded ones in process
    docs = batch_docs(hay, ci, max_bytes)
    for kind, ov in SEMANTICS:
        one = sw.numpy_oracle(kind, ov)
        want = batch_wants[(name, kind, ov)] = sw.per_doc(one)(pats, docs)
        if kind == "Standard" and not ov:
            sw.single[f"{name}/batch"] = digest(want)
        for teddy in ("off", "force"):
            meta = {"corpus": name, "check": "batch", "matchkind": kind,
                    "overlapping": ov, "teddy": teddy,
                    "documents": len(docs)}

            def batch(kind=kind, ov=ov, teddy=teddy, meta=meta, want=want,
                      one=one):
                sw.check("B", "batch tuples", meta,
                         sw.find_batch(kind, ov, Implementation.DFA,
                                       teddy=teddy),
                         sw.per_doc(one), pats, docs, want)
                return {"tier": sw._tier}

            sw.row("B", meta, batch)
    # K8 in this process (a world of one rank): its scan against the
    # host scan (dense pairs, Teddy occurrences), and public tuples
    for teddy, fn, full in (
        ("off", _sharded_pairs(sw), _host_pairs(sw, Implementation.DFA)),
        ("force", _sharded_teddy(sw), _occurrence_set(sw)),
    ):
        meta = {"corpus": name, "check": "sharded, one rank",
                "teddy": teddy}

        def shard1(teddy=teddy, fn=fn, full=full, meta=meta):
            want = full(pats, hay)
            sw.check("B", "sharded scan", meta, fn, full, pats, hay,
                     want)
            sw.check("B", "sharded tuples", meta,
                     sw.find("Standard", False, Implementation.DFA,
                             backend="sharded", teddy=teddy),
                     sw.numpy_oracle("Standard", False), pats, hay,
                     wants[(name, "Standard", False)])
            return {"found": len(want[0]), "tier": sw._tier}

        sw.row("B", meta, shard1)
    for teddy in ("off", "force"):
        meta = {"corpus": name, "check": "sharded batch, one rank",
                "matchkind": "Standard", "teddy": teddy}

        def shard1_batch(teddy=teddy, meta=meta):
            sw.check("B", "sharded batch tuples", meta,
                     sw.find_batch("Standard", False, Implementation.DFA,
                                   backend="sharded", teddy=teddy),
                     sw.per_doc(sw.numpy_oracle("Standard", False)),
                     pats, docs, batch_wants[(name, "Standard", False)])
            return {"tier": sw._tier}

        sw.row("B", meta, shard1_batch)


# -- K8 over ranks in child processes ------------------------------------


def shard_child(argv: list[str]) -> int:
    """One rank of part B's multi-process check (``--shard-child``): join a
    gloo group on ``--device``, make the sharded Standard calls of every
    corpus and Teddy state, one document and a batch, and write each
    call's digest, tier and the rank's launches to ``--out``.  The ranks'
    bodies and exchanges do not depend on the semantics, which resolve on
    the host after the gather: part B's one-rank rows hold every
    semantics."""
    import torch.distributed as dist

    p = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        p.add_argument(name, type=int, required=True)
    for name in ("--init", "--out", "--device"):
        p.add_argument(name, required=True)
    p.add_argument("--max-bytes", type=int, default=None)
    a = p.parse_args(argv)
    dev = _resolve_device(a.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_distributed(a.init, a.world, a.rank, "gloo")
    try:
        group = dist.group.WORLD
        calls: dict = {}
        _kernels.reset_launches()
        for ci, (name, pats, hay) in enumerate(cut(corpora(), a.max_bytes)):
            docs = batch_docs(hay, ci, a.max_bytes)
            for teddy in ("off", "force"):
                ac = BytesAhoCorasick(pats, implementation=Implementation.DFA,
                                      backend="sharded", mesh=group,
                                      device=dev)
                ac._teddy_state = teddy
                got = ac.find_matches_as_indexes(hay)
                calls[f"{name}/{teddy}"] = {
                    "want": name, "digest": digest(got),
                    "tier": ac.stats()["last_backend"]}
                got = _flat(ac.find_matches_as_indexes_batch(docs))
                calls[f"{name}/batch/{teddy}"] = {
                    "want": f"{name}/batch", "digest": digest(got),
                    "tier": ac.stats()["last_backend"]}
        with open(a.out, "w") as f:
            json.dump({"rank": dist.get_rank(), "calls": calls,
                       "launches": dict(_kernels.LAUNCHES)}, f)
    finally:
        dist.destroy_process_group()
    return 0


def check_ranks(sw: Sweep, ranks: RankProcesses) -> dict:
    """Wait for the ranks (at most :data:`SHARD_TIMEOUT_S`) and hold every
    rank's digests to the ``numpy`` tier's."""
    try:
        records = ranks.records(SHARD_TIMEOUT_S)
    except RuntimeError as e:
        sw.mismatches.append({"part": "B", "check": "sharded ranks",
                              "error": str(e)})
        return {"ranks": SHARD_RANKS, "failed": True}
    tiers: dict[str, int] = {}
    launches = {k: sum(rec["launches"].get(k, 0) for rec in records)
                for k in _kernels.LAUNCHES}
    for rec in records:
        for key, call in rec["calls"].items():
            sw.checks += 1
            tiers[call["tier"]] = tiers.get(call["tier"], 0) + 1
            want = sw.single.get(call["want"])
            if call["digest"] != want:
                sw.mismatches.append({
                    "part": "B", "check": "sharded ranks", "rank":
                    rec["rank"], "call": key, "tier": call["tier"],
                    "got_digest": call["digest"], "want_digest": want})
    for k, v in launches.items():
        if v:
            sw.cases_by_kernel[k]["B"] += 1
    return {"ranks": SHARD_RANKS, "calls": len(records[0]["calls"]),
            "tiers": tiers, "rank_launches": launches}


# -- part C ---------------------------------------------------------------


def run_case(sw: Sweep, seed: int, index: int, max_bytes: Optional[int],
             prev: dict) -> None:
    """Part C's case ``index``: every engine x semantics x device tier, the
    kernel boundary, and on schedule the reuse and bailout cases.
    ``prev`` carries the previous case's matchers and answers."""
    if max_bytes is None and index % BAILOUT_EVERY == BAILOUT_AT:
        bailout(sw, seed, index)
        return
    pats, hay, cuts, meta = gen_case(seed, index, max_bytes)
    docs = split_docs(hay, cuts)
    brute = len(hay) * len(pats) <= BRUTE_MAX
    sw.c_oracle["brute" if brute else "numpy"] += 1
    wants, batch_wants, oracles = {}, {}, {}
    for kind, ov in SEMANTICS:
        num = sw.numpy_oracle(kind, ov)
        if brute:
            mk = MatchKind[kind]
            one = oracles[(kind, ov)] = (
                lambda p, h, mk=mk, ov=ov: oracle(p, h, mk, ov))
            wants[(kind, ov)] = one(pats, hay)
            sw.check("C", "numpy tier vs brute force",
                     {**meta, "matchkind": kind, "overlapping": ov}, num,
                     one, pats, hay, wants[(kind, ov)])
        else:
            one = oracles[(kind, ov)] = num
            wants[(kind, ov)] = one(pats, hay)
        batch_wants[(kind, ov)] = sw.per_doc(one)(pats, docs)
    batch_teddy = "force" if index % 2 else "off"
    cur: dict = {"pats": pats, "hay": hay, "docs": docs,
                 "want": wants[("Standard", False)], "matchers": {}}
    for impl, engine in ENGINES.items():
        sparse = impl is Implementation.NoncontiguousNFA
        host = _host_pairs(sw, impl)
        want_pairs = host(pats, hay)
        for k2 in (False,) if sparse else (False, True):
            sw.check("C", "scan_device pairs",
                     {**meta, "implementation": impl.name, "k2_forced": k2},
                     _device_pairs(sw, impl, k2), host, pats, hay,
                     want_pairs)
            if sw.kernel != "K6":
                break  # the default tables already take K2
        for kind, ov in SEMANTICS:
            cm = {**meta, "implementation": impl.name, "matchkind": kind,
                  "overlapping": ov}
            runs = [("off", sw.find(kind, ov, impl))]
            if not sparse:
                runs.append(("force", sw.find(kind, ov, impl,
                                              teddy="force")))
            for teddy, fn in runs:
                sw.check("C", "public tuples", {**cm, "teddy": teddy}, fn,
                         oracles[(kind, ov)], pats, hay, wants[(kind, ov)])
                key = f"{engine}/{kind}/{ov}/{sw._tier}"
                sw.c_counts[key] = sw.c_counts.get(key, 0) + 1
            if not sparse:
                sw.check("C", "batch tuples", {**cm, "teddy": batch_teddy},
                         sw.find_batch(kind, ov, impl, teddy=batch_teddy),
                         sw.per_doc(oracles[(kind, ov)]), pats, docs,
                         batch_wants[(kind, ov)])
                key = f"{engine}/{kind}/{ov}/{sw._tier}"
                sw.c_counts[key] = sw.c_counts.get(key, 0) + 1
        if (index + 1) % OVERFLOW_EVERY == OVERFLOW_EVERY - 1:
            # the matchers the next case takes over, with their own call
            ac = sw.matcher(pats, impl=impl)
            ac.find_matches_as_indexes(hay)
            cur["matchers"][impl] = ac
            if impl is Implementation.DFA:
                bac = sw.matcher(pats, impl=impl)
                bac.find_matches_as_indexes_batch(docs)
                cur["batch"] = bac
    if prev and index % OVERFLOW_EVERY == OVERFLOW_EVERY - 1:
        overflow(sw, prev, index, max_bytes,
                 index % BATCH_OVERFLOW_EVERY == BATCH_OVERFLOW_EVERY - 1)
    prev.clear()
    prev.update(cur)


def dense_haystack(pats: Sequence[bytes], n: int) -> bytes:
    """``n`` bytes of the patterns back to back: a match at nearly every
    pattern's end."""
    unit = b"".join(pats) or b"\0"
    return (unit * (n // len(unit) + 1))[:n]


def overflow(sw: Sweep, prev: dict, index: int, max_bytes: Optional[int],
             batch: bool) -> None:
    """The previous case's matchers (and their sticky capacities) on a
    haystack with many more matches, then on their own haystack again."""
    pats = prev["pats"]
    n = min(1 << 20, max_bytes or 1 << 20)
    dense = dense_haystack(pats, n)
    meta = {"index": index, "reuse_of": index - 1, "n_dense": n}
    std = sw.numpy_oracle("Standard", False)
    sw.c_special["overflow"] += 1
    for impl, ac in prev["matchers"].items():
        m = {**meta, "implementation": impl.name}
        host = _host_pairs(sw, impl)

        def pairs(p, h, ac=ac):
            tables = ac._get_device_tables()
            return _arrays(scan_cuda.scan_device(
                ac._automaton, np.frombuffer(h, np.uint8), tables))

        def reused(p, h, ac=ac):
            got = ac.find_matches_as_indexes(h)
            sw.served(ac)
            return got

        cap0 = ac._get_device_tables().last_cap
        sw.check("C", "reused matcher, dense", m, reused, std, pats, dense,
                 shrink=False)
        sw.check("C", "reused tables, dense pairs", m, pairs, host, pats,
                 dense, shrink=False)
        sw.check("C", "reused matcher, its own haystack again",
                 {**m, "cap_before": cap0,
                  "cap_after": ac._get_device_tables().last_cap},
                 reused, std, pats, prev["hay"], prev["want"], shrink=False)
    if batch and "batch" in prev:
        sw.c_special["batch_overflow"] += 1
        bac = prev["batch"]
        docs = split_docs(dense, [len(dense) * i // 64 for i in range(1, 64)])

        def reused_batch(p, d):
            got = _flat(bac.find_matches_as_indexes_batch(d))
            sw.served(bac)
            return got

        sw.check("C", "reused batch matcher, dense documents", meta,
                 reused_batch, sw.per_doc(std), pats, docs, shrink=False)


def bailout(sw: Sweep, seed: int, index: int) -> None:
    """A match-dense 5-16 MiB case: ``scan_device`` must raise
    :class:`MatchDenseError`, and the public call (LeftmostLongest) must
    leave the device and still give the ``numpy`` tier's tuples."""
    pats, hay, meta = bailout_case(seed, index)
    sw.c_special["bailout"] += 1
    want = sw.numpy_oracle("LeftmostLongest", False)(pats, hay)
    for impl in (Implementation.DFA, Implementation.ContiguousNFA):
        m = {**meta, "implementation": impl.name}

        def raises(p, h, impl=impl):
            try:
                _device_pairs(sw, impl)(p, h)
            except MatchDenseError:
                return "MatchDenseError"
            return "no MatchDenseError"

        sw.check("C", "scan_device bails out", m, raises,
                 lambda p, h: "MatchDenseError", pats, hay, shrink=False)
        fn = sw.find("LeftmostLongest", False, impl)
        sw.check("C", "public tuples after the bailout", m, fn,
                 sw.numpy_oracle("LeftmostLongest", False), pats, hay, want,
                 shrink=False)
        tier = sw._tier
        sw.check("C", "the bailout leaves the device", {**m, "tier": tier},
                 lambda p, h: tier in HOST_TIERS, lambda p, h: True,
                 pats, hay, True, shrink=False)


def part_c(sw: Sweep, seed: int, cases: Optional[int],
           seconds: Optional[float], max_bytes: Optional[int],
           t_start: float) -> int:
    """Run the sweep's first ``cases`` cases, or cases until ``seconds``
    have passed since ``t_start``; return the count run."""
    prev: dict = {}
    i = 0
    while (i < cases) if cases is not None else (
            time.perf_counter() - t_start < seconds):
        sw.case("C", lambda: run_case(sw, seed, i, max_bytes, prev))
        i += 1
        if i % 25 == 0:
            sw.log(f"C: {i} cases, {sw.checks} checks, "
                   f"{len(sw.mismatches)} mismatches, "
                   f"{time.perf_counter() - t_start:.0f} s")
    return i


# -- the run ----------------------------------------------------------------


def cut(cps: list, max_bytes: Optional[int]) -> list:
    """The corpora cut to their first ``max_bytes`` bytes."""
    if max_bytes is None:
        return cps
    return [(name, pats, hay[:max_bytes]) for name, pats, hay in cps]


def _commit() -> Optional[str]:
    """HEAD of the git checkout whose root is :data:`ROOT`; None in a copy
    that is no checkout (git would name an enclosing repository's)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--show-toplevel", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout.split()
    except (OSError, subprocess.CalledProcessError):
        return None
    if len(out) != 2 or os.path.realpath(out[0]) != os.path.realpath(ROOT):
        return None
    return out[1]


def source_hash() -> str:
    """Hash of every ``.py`` and ``csrc`` file of the package: names the
    code a record was made with where there is no git checkout."""
    h = hashlib.sha256()
    for base, dirs, files in sorted(os.walk(_PKG)):
        dirs[:] = sorted(d for d in dirs if d not in ("_build", "__pycache__"))
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    h.update(os.path.relpath(path, _PKG).encode() + b"\0"
                             + f.read())
    return h.hexdigest()[:16]


def run(
    device: Union[str, torch.device, None] = None,
    cases: Optional[int] = None,
    seconds: Optional[float] = None,
    seed: int = 0,
    out: Optional[str] = None,
    max_bytes: Optional[int] = None,
    commit: Optional[str] = None,
    verbose: bool = True,
) -> dict:
    """Parts A, B and C on ``device`` (the card unless ``"cpu"`` is
    asked); ``max_bytes`` cuts every corpus and case (a rehearsal on the
    CPU).  Writes the record to ``out`` (unless None) and returns it;
    ``record["ok"]`` is False on any mismatch, and on a kernel (card) or
    tier (CPU) that served no call."""
    if cases is None and seconds is None:
        cases = DEFAULT_CASES
    dev = _resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    _kernels.reset_launches()
    sw = Sweep(dev, verbose)
    cps = cut(corpora(), max_bytes)
    wants: dict = {}
    seconds_by_part = {}
    t = time.perf_counter()
    part_a(sw, cps, wants, max_bytes)
    seconds_by_part["A"] = time.perf_counter() - t
    t = time.perf_counter()
    part_b(sw, cps, wants, max_bytes)
    seconds_by_part["B"] = time.perf_counter() - t
    t = time.perf_counter()
    n_cases = part_c(sw, seed, cases, seconds, max_bytes, t_start)
    seconds_by_part["C"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        uncovered = [k for k in KERNELS if not _kernels.LAUNCHES[k]]
    else:
        uncovered = [t for t in DEVICE_TIERS if not sw.tiers.get(t)]
    record = {
        "tool": "python -m ahocorasick_rs_tpu_torch.tools.gpu_conformance",
        "gpu": device_label(dev),
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "commit": commit or _commit(),
        "source_hash": source_hash(),
        "seed": seed,
        "max_bytes": max_bytes,
        "cases": n_cases,
        "seconds": time.perf_counter() - t_start,
        "seconds_by_part": seconds_by_part,
        "checks": sw.checks,
        "part_a": sw.rows["A"],
        "part_b": sw.rows["B"],
        "part_c": {"cases": n_cases, "oracle": sw.c_oracle,
                   "special": sw.c_special,
                   "by_engine_semantics_tier": dict(sorted(
                       sw.c_counts.items()))},
        "tiers": dict(sorted(sw.tiers.items())),
        "launches": dict(_kernels.LAUNCHES),
        "fire_configs": {",".join(map(str, k)): v
                         for k, v in sorted(_kernels.FIRE_CONFIGS.items())},
        "cases_by_kernel": sw.cases_by_kernel,
        "uncovered": uncovered,
        "mismatches": sw.mismatches,
        "ok": not sw.mismatches and not uncovered,
    }
    if out is not None:
        with open(out, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def summary(record: dict) -> dict:
    """The record's one-line summary."""
    return {k: record[k] for k in (
        "ok", "gpu", "cases", "checks", "seconds", "uncovered")} | {
        "mismatches": len(record["mismatches"]),
        "part_a_rows": len(record["part_a"]),
        "part_b_rows": len(record["part_b"]),
        "launches": record["launches"]}


def _cli(argv: Optional[list[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--shard-child"]:
        return shard_child(argv[1:])
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    length = p.add_mutually_exclusive_group()
    length.add_argument("--cases", type=int, default=None,
                        help=f"part C's first N cases (default "
                             f"{DEFAULT_CASES})")
    length.add_argument("--seconds", type=float, default=None,
                        help="run part C until S seconds have passed")
    p.add_argument("--seed", type=int, default=0, help="part C's seed")
    p.add_argument("--out", default=None,
                   help=f"the record's path (default on a card: {OUT}; on "
                        "the CPU none is written unless this is given)")
    p.add_argument("--max-bytes", type=int, default=None,
                   help="cut every corpus and case to this many bytes")
    p.add_argument("--commit", default=None,
                   help="the commit to record where the tree is no git "
                        "checkout")
    a = p.parse_args(argv)
    dev = _resolve_device(a.device)
    out = a.out if a.out is not None or dev.type != "cuda" else OUT
    record = run(dev, a.cases, a.seconds, a.seed, out, a.max_bytes,
                 a.commit)
    print(json.dumps(summary(record)), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_cli())
