"""Benchmark of the port: haystack GB/s of the device scan paths on the
card, and the upstream scenarios end to end.

The counterpart of root ``bench.py`` for ``ahocorasick_rs_tpu_torch``:
the same sections, keys, seeds and sizes, with ``gpu_`` keys where
``bench.py`` has ``tpu_`` ones.  Its sections, in the order they run:

* ``north_star``: 1,000 names (seed 1234) and a 64 MiB corpus after the
  upstream LONG recipe.  The serial native DFA scan (``cpu_native``, the
  baseline) and the native interleaved lanes (``cpu_lanes``), then, on
  data already on the device, the plain lane scan (K2 + K3,
  ``gpu_plain``), the stride-2 scan (K6 + K3, ``gpu_stride2``) and the
  Teddy pipeline (K1 + K3 + K4, ``gpu_teddy``), Teddy also with its
  staging (``gpu_teddy_end_to_end``) and streamed over four copies of the
  corpus.  Every path's count is held to the native scan's.  ``value`` is
  the best GPU path's GB/s and ``vs_baseline`` its ratio to
  ``cpu_native``;
* ``scenarios``: the upstream benchmark's five scenarios over its SHORT
  and LONG batches (seed 7) through the public ``AhoCorasick``, each a
  full pass from host strings to host tuples, per document and batched;
* ``match_dense``, ``large_set``, ``million_set``,
  ``bytes_overlapping_1gb`` and ``sparse_device_forced`` (seeds 99, 1001,
  31 and 55): through the public ``BytesAhoCorasick``, the auto router
  picking the tier (``scan_backend``) except where ``bench.py`` forces
  one.

Run from the repository root:

    python -m ahocorasick_rs_tpu_torch.tools.bench [--device cpu] [--scale K] [--sections a,b,...]

It runs on the card and stops without one unless ``--device cpu`` is
given; on the CPU every kernel is its plain PyTorch version and no number
is the card's.  ``--scale K`` (a power of two up to 1024) divides every
byte, pattern and document count by K and keeps every length: line and
pattern lengths, and the nested patterns up to ``a*64``.  ``--sections``
runs the named sections only.

The kernels are built before any timing (``build_seconds``).  Every timed
call ends in a host fetch or in ``torch.cuda.synchronize()``.  Where a
warm-up call comes first, its time is ``first_seconds`` beside the best
of the repetitions; the ``cpu_*`` paths warm up on a 1 MiB slice, which is
not timed.  ``launches`` holds the kernel launches of a measurement's
calls (the change of ``_kernels.LAUNCHES``, nonzero entries only).
``detail["device"]`` names the card and its power limit.

It prints exactly one JSON line.  A section that raises ends the run with
its traceback and no line, and the command exits non-zero; so does a
north-star path that cannot run (``bench.py`` writes "skipped" or
"fallback" there instead).
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import _kernels
from ..api import (
    AhoCorasick,
    BytesAhoCorasick,
    Implementation,
    MatchKind,
    _resolve_device,
)
from ..models import native
from ..models.automaton import build_automaton
from ..models.prefilter import build_prefilter
from ..ops import scan_cuda
from ..ops.scan_teddy import TeddyScanner
from ._synth import make_datasets, synth_corpus, synth_names
from .probe_transpose_kernel import device_label

HAYSTACK_MB = 64
PATTERNS = 1000
REPS = 3
#: the north star's GPU paths that ``value`` is the best of
HEADLINE_PATHS = ("gpu_plain_scan_gbps", "gpu_stride2_scan_gbps",
                  "gpu_teddy_gbps")
#: the match-dense section's nested patterns (their depth stays at any
#: scale)
NESTED = tuple(b"a" * k for k in range(1, 65))
#: the largest ``--scale``; every size stays a whole number of bytes
MAX_SCALE = 1024


def cut(count: int, scale: int) -> int:
    """A pattern or document count cut to ``scale`` (at least one)."""
    return max(1, count // scale)


class Run:
    """The device and scale of one run, and its timers."""

    def __init__(self, dev: torch.device, scale: int) -> None:
        self.dev = dev
        self.scale = scale

    def seconds(self, fn: Callable[[], object]) -> tuple[float, object]:
        """Wall seconds of one call of ``fn`` (ending in a synchronize on
        the card), and its result."""
        t0 = time.perf_counter()
        out = fn()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter() - t0, out

    def best(self, fn: Callable[[], object], reps: int = REPS
             ) -> tuple[float, object]:
        """The best of ``reps`` calls' seconds, and the last result."""
        best, out = float("inf"), None
        for _ in range(reps):
            out = None  # let the previous result go before the next call
            s, out = self.seconds(fn)
            best = min(best, s)
        return best, out


def launches_since(mark: dict[str, int]) -> dict[str, int]:
    """Kernel launches since ``mark`` (a copy of ``_kernels.LAUNCHES``)."""
    return {k: v - mark[k] for k, v in _kernels.LAUNCHES.items()
            if v != mark[k]}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def north_star_inputs(scale: int) -> tuple[list[bytes], np.ndarray]:
    """The north star's names and corpus (seed 1234) at ``scale``."""
    rng = np.random.default_rng(1234)
    names = synth_names(cut(PATTERNS, scale), rng)
    return names, synth_corpus((HAYSTACK_MB << 20) // scale, names, rng)


def bench_north_star(run: Run, detail: dict) -> None:
    """The streaming north star: the host baselines and the GPU scan
    paths over one corpus, each path's count held to the native scan's."""
    names, hay = north_star_inputs(run.scale)
    n = len(hay)
    am = build_automaton(names)
    detail.update(haystack_mb=n / (1 << 20), patterns=len(names),
                  states=am.num_states, paths_run=[])
    paths = detail["paths_run"]
    first: dict[str, float] = {}
    launches: dict[str, dict] = {}
    detail["first_seconds"] = first
    detail["launches"] = launches

    # --- host-native baseline (the upstream hot loop's counterpart) ---
    check(native.available(), "the native host library did not build, so "
                              "the cpu_native baseline cannot run")
    native.scan_dense_native(am.delta, am.match_count, hay[: 1 << 20])
    t, (pos, st) = run.best(
        lambda: native.scan_dense_native(am.delta, am.match_count, hay),
        reps=2,
    )
    baseline = n / t / 1e9
    detail["cpu_native_gbps"] = baseline
    paths.append("cpu_native")
    host_matches = len(pos)
    host_occurrences = int(am.match_count[st].sum())
    # the host tier's own scan: interleaved halo'd lanes on worker threads
    sc = native.DenseScanner(am.delta, am.match_count, halo=am.max_len - 1)
    sc.scan(hay[: 1 << 20])
    t, _ = run.best(lambda: sc.scan(hay), reps=2)
    detail["cpu_lanes_gbps"] = n / t / 1e9
    paths.append("cpu_lanes")

    # --- the GPU scans over a buffer staged once, as scan_device stages ---
    tables = scan_cuda.DeviceTables(am, "dfa", run.dev)
    halo = am.max_len - 1
    halo += halo & 1  # stride-2 needs an even halo; harmless for stride-1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = hay
    hay_dev = scan_cuda.to_device(buf, run.dev)
    cap = 1 << 16
    flagged = tables.lane_table()

    def plain_once() -> int:
        _, _, total = scan_cuda._scan_compact(
            tables.table, tables.classes, hay_dev, tables.match_count, n, L,
            T, halo, cap, tables.use_classes, flagged=flagged,
        )
        return int(total)  # host fetch = real completion

    mark = dict(_kernels.LAUNCHES)
    first["gpu_plain"], matches = run.seconds(plain_once)
    t, _ = run.best(plain_once)
    launches["gpu_plain"] = launches_since(mark)
    check(matches == host_matches, f"the plain scan found {matches} matched "
                                   f"positions, the native scan "
                                   f"{host_matches}")
    detail["gpu_plain_scan_gbps"] = n / t / 1e9
    detail["matches"] = matches
    paths.append("gpu_plain")

    check(tables.ensure_packed2(), "the names' pair table is over budget")

    def stride2_once() -> int:
        _, _, total = scan_cuda._scan_compact2(
            tables.packed2, tables.table_classed, tables.classes2, hay_dev,
            n, L, T, halo, cap,
        )
        return int(total)

    mark = dict(_kernels.LAUNCHES)
    first["gpu_stride2"], m2 = run.seconds(stride2_once)
    t, _ = run.best(stride2_once)
    launches["gpu_stride2"] = launches_since(mark)
    check(m2 == matches, f"the stride-2 scan found {m2} matched positions, "
                         f"the plain scan {matches}")
    detail["gpu_stride2_scan_gbps"] = n / t / 1e9
    paths.append("gpu_stride2")

    pf = build_prefilter(names)
    check(pf is not None, "no prefilter for the names")
    detail["prefilter"] = {
        "m": pf.m, "words": pf.words, "est_fire_rate": pf.est_fire_rate,
    }
    scanner = TeddyScanner(am, pf, tables)
    hay2d = scanner.stage(hay)
    mark = dict(_kernels.LAUNCHES)
    first["gpu_teddy"], occ = run.seconds(
        lambda: scanner.occurrences(hay, hay2d=hay2d))
    check(occ is not None, "Teddy declined the names corpus (fire rate)")
    check(len(occ[0]) == host_occurrences,
          f"Teddy found {len(occ[0])} occurrences, the native scan "
          f"{host_occurrences}")
    t, _ = run.best(lambda: scanner.occurrences(hay, hay2d=hay2d))
    launches["gpu_teddy"] = launches_since(mark)
    detail["gpu_teddy_gbps"] = n / t / 1e9
    paths.append("gpu_teddy")

    mark = dict(_kernels.LAUNCHES)
    t, _ = run.best(
        lambda: scanner.occurrences(hay, hay2d=scanner.stage(hay)), reps=2)
    launches["gpu_teddy_end_to_end"] = launches_since(mark)
    detail["gpu_teddy_end_to_end_gbps"] = n / t / 1e9
    # double-buffered streamed staging over four segments (the
    # large-corpus path: segment k+1's copy runs beside k's kernels)
    big = np.concatenate([hay] * 4)
    mark = dict(_kernels.LAUNCHES)
    tb, occ_b = run.seconds(lambda: scanner.occurrences_streamed(
        big, seg_bytes=TeddyScanner.SEG_BYTES // run.scale))
    launches["gpu_teddy_e2e_256mb_streamed"] = launches_since(mark)
    check(occ_b is not None, "streamed Teddy declined the corpus")
    detail["gpu_teddy_e2e_256mb_streamed_gbps"] = len(big) / tb / 1e9


def bench_scenarios(run: Run, detail: dict) -> None:
    """The upstream scenarios over SHORT and LONG, end to end (host
    strings in, host tuples out, every transfer included)."""
    rng = np.random.default_rng(7)
    out: dict = {}
    for ds_name, (patterns, haystacks) in make_datasets(
            rng, run.scale).items():
        total_mb = sum(len(h) for h in haystacks) / 1e6
        mark_ds = dict(_kernels.LAUNCHES)
        ac = AhoCorasick(patterns, device=run.dev)
        ll = AhoCorasick(patterns, matchkind=MatchKind.LeftmostLongest,
                         device=run.dev)
        first_s, got = run.seconds(
            lambda: ac.find_matches_as_indexes_batch(haystacks))
        scen: dict = {
            "haystacks": len(haystacks),
            "total_mb": total_mb,
            "matches": sum(len(m) for m in got),
            "first_seconds": first_s,
        }
        del got

        def put(key: str, fn: Callable[[], object], warm: bool = False
                ) -> None:
            mark = dict(_kernels.LAUNCHES)
            entry: dict = {}
            if warm:  # bench.py's warm/compile call
                entry["first_seconds"] = run.seconds(fn)[0]
            seconds = run.best(fn, reps=2)[0]
            entry.update(seconds=seconds, mb_per_s=total_mb / seconds,
                         launches=launches_since(mark))
            scen[key] = entry

        put("standard_strings_loop",
            lambda: [ac.find_matches_as_strings(h) for h in haystacks])
        put("standard_indexes_loop",
            lambda: [ac.find_matches_as_indexes(h) for h in haystacks])
        put("standard_strings_batch",
            lambda: ac.find_matches_as_strings_batch(haystacks), warm=True)
        put("standard_indexes_batch",
            lambda: ac.find_matches_as_indexes_batch(haystacks))
        put("overlapping_strings_batch",
            lambda: ac.find_matches_as_strings_batch(
                haystacks, overlapping=True))
        put("leftmost_longest_strings_batch",
            lambda: ll.find_matches_as_strings_batch(haystacks), warm=True)

        def control() -> None:
            for h in haystacks:
                _ = h

        put("python_loop_control", control)
        scen["batch_backend"] = ac.stats()["last_backend"]
        scen["launches"] = launches_since(mark_ds)
        out[ds_name] = scen
    detail["scenarios"] = out


def _rss_gb() -> float:
    """The process's peak resident set so far (``ru_maxrss``), in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def bench_match_dense(run: Run, detail: dict) -> None:
    """Nested patterns ``a, aa, ..., a*64`` over 128 MiB of ``a``: an
    occurrence set 64 times the haystack, which the density guards must
    land on the fused host resolver (after the device scan bails out).
    ``leftmost_longest`` is the headline; ``standard_16mb`` is O(n) tuples
    by the API's contract, so it runs at 16 MiB."""
    rss0 = _rss_gb()
    n = (128 << 20) // run.scale
    hay = b"a" * n
    ac = BytesAhoCorasick(NESTED, matchkind=MatchKind.LeftmostLongest,
                          device=run.dev)
    # the cold call explores the device tier, hits the bailout and
    # records the floor that every later call sees
    mark = dict(_kernels.LAUNCHES)
    cold_s, _ = run.seconds(lambda: ac.find_matches_as_indexes(hay))
    seconds, got = run.seconds(lambda: ac.find_matches_as_indexes(hay))
    launches = launches_since(mark)
    check(len(got) == n // 64, f"{len(got)} leftmost-longest matches, not "
                               f"{n // 64}")
    entry = {
        "patterns": "a*1..a*64 (nested)",
        "haystack_mb": n / (1 << 20),
        "occurrence_set_size": n * 64 - 64 * 63 // 2,
        "leftmost_longest": {
            "matches": len(got),
            "scan_backend": ac.stats()["last_backend"],
            "mb_per_s": n / seconds / 1e6,
            "cold_first_scan_seconds": cold_s,
            "peak_rss_delta_gb": max(0.0, _rss_gb() - rss0),
            "launches": launches,
        },
    }
    del got
    n2 = (16 << 20) // run.scale
    hay2 = hay[:n2]
    ac2 = BytesAhoCorasick(NESTED, device=run.dev)
    mark = dict(_kernels.LAUNCHES)
    first_s, _ = run.seconds(lambda: ac2.find_matches_as_indexes(hay2))
    seconds, got2 = run.seconds(lambda: ac2.find_matches_as_indexes(hay2))
    check(len(got2) == n2, f"{len(got2)} standard matches, not {n2}")
    entry["standard_16mb"] = {
        "haystack_mb": n2 / (1 << 20),
        "matches": len(got2),
        "scan_backend": ac2.stats()["last_backend"],
        "mb_per_s": n2 / seconds / 1e6,
        "first_seconds": first_s,
        "launches": launches_since(mark),
        "note": "output is O(n) tuples by API contract on this corpus",
    }
    detail["match_dense"] = entry


def _auto_routed_scan(run: Run, ac: BytesAhoCorasick, data: bytes,
                      build_s: float) -> dict:
    """A warm-up call and the best of two auto-routed calls of ``ac`` over
    ``data``: the large sets' common record."""
    mark = dict(_kernels.LAUNCHES)
    first_s, _ = run.seconds(lambda: ac.find_matches_as_indexes(data))
    t, got = run.best(lambda: ac.find_matches_as_indexes(data), reps=2)
    s = ac.stats()
    return {
        "states": s["num_states"],
        "implementation": s["implementation"],
        "build_seconds": build_s,
        "scan_backend": s["last_backend"],
        "scan_mb_per_s": len(data) / t / 1e6,
        "first_seconds": first_s,
        "matches": len(got),
        "launches": launches_since(mark),
    }


def bench_large_set(run: Run, detail: dict) -> None:
    """100,000 names (seed 99) end to end: construction seconds and the
    auto-routed scan of a 16 MiB haystack."""
    rng = np.random.default_rng(99)
    pats = synth_names(cut(100_000, run.scale), rng)
    t0 = time.perf_counter()
    ac = BytesAhoCorasick(pats, device=run.dev)
    build_s = time.perf_counter() - t0
    hay = synth_corpus((16 << 20) // run.scale, pats[: cut(1000, run.scale)], rng)
    detail["large_set"] = {"patterns": len(pats)} | _auto_routed_scan(
        run, ac, hay.tobytes(), build_s)


def bench_million_set(run: Run, detail: dict) -> None:
    """10^6 names (seed 1001): construction seconds, the peak resident
    set (a process high-water mark, so the reading before the build is
    recorded too) and the auto-routed scan of a 16 MiB haystack."""
    rng = np.random.default_rng(1001)
    pats = synth_names(cut(1_000_000, run.scale), rng)
    rss_before = _rss_gb()
    t0 = time.perf_counter()
    ac = BytesAhoCorasick(pats, device=run.dev)
    build_s = time.perf_counter() - t0
    rss_after = _rss_gb()
    hay = synth_corpus((16 << 20) // run.scale, pats[: cut(1000, run.scale)], rng)
    rec = _auto_routed_scan(run, ac, hay.tobytes(), build_s)
    detail["million_set"] = {
        "patterns": len(pats), "peak_rss_gb": rss_after,
        "pre_build_rss_gb": rss_before,
    } | rec


def bench_bytes_overlapping_1gb(run: Run, detail: dict) -> None:
    """50,000 random byte patterns (seed 31), overlapping Standard
    matches over a 1 GiB random haystack with 64 planted occurrences,
    auto-routed."""
    rng = np.random.default_rng(31)
    pats: list[bytes] = []
    seen: set[bytes] = set()
    while len(pats) < cut(50_000, run.scale):
        k = int(rng.integers(5, 12))
        p = bytes(rng.integers(0, 256, k, dtype=np.uint8))
        if p not in seen:
            seen.add(p)
            pats.append(p)
    t0 = time.perf_counter()
    ac = BytesAhoCorasick(pats, device=run.dev)
    build_s = time.perf_counter() - t0
    n = (1 << 30) // run.scale
    hay = rng.integers(0, 256, n, dtype=np.uint8)
    for _ in range(64):  # so that the match pipeline has work
        off = int(rng.integers(0, n - 16))
        p = pats[int(rng.integers(0, len(pats)))]
        hay[off : off + len(p)] = np.frombuffer(p, dtype=np.uint8)
    data = hay.tobytes()
    del hay
    mark = dict(_kernels.LAUNCHES)
    first_s, got = run.seconds(
        lambda: ac.find_matches_as_indexes(data, overlapping=True))
    n_matches = len(got)
    seconds, got = run.seconds(
        lambda: ac.find_matches_as_indexes(data, overlapping=True))
    check(len(got) == n_matches, f"{len(got)} matches, the first call "
                                 f"{n_matches}")
    s = ac.stats()
    detail["bytes_overlapping_1gb"] = {
        "patterns": len(pats),
        "states": s["num_states"],
        "implementation": s["implementation"],
        "build_seconds": build_s,
        "haystack_gb": n / (1 << 30),
        "matches": n_matches,
        "scan_backend": s["last_backend"],
        "scan_mb_per_s": n / seconds / 1e6,
        "first_seconds": first_s,
        "launches": launches_since(mark),
    }


def sparse_inputs(scale: int) -> tuple[list[bytes], bytes]:
    """The forced sparse section's names and haystack (seed 55) at
    ``scale``."""
    rng = np.random.default_rng(55)
    pats = synth_names(cut(PATTERNS, scale), rng)
    return pats, synth_corpus((16 << 20) // scale, pats, rng).tobytes()


def bench_sparse_device(run: Run, detail: dict) -> None:
    """The sparse engine forced onto the device (K7): NoncontiguousNFA
    with ``backend="device"``, which auto routing never picks, over the
    names recipe at 16 MiB (seed 55)."""
    pats, data = sparse_inputs(run.scale)
    n = len(data)
    ac = BytesAhoCorasick(pats, implementation=Implementation.NoncontiguousNFA,
                          backend="device", device=run.dev)
    mark = dict(_kernels.LAUNCHES)
    first_s, _ = run.seconds(lambda: ac.find_matches_as_indexes(data))
    t, got = run.best(lambda: ac.find_matches_as_indexes(data), reps=2)
    detail["sparse_device_forced"] = {
        "patterns": len(pats),
        "haystack_mb": n / (1 << 20),
        "scan_backend": ac.stats()["last_backend"],
        "scan_mb_per_s": n / t / 1e6,
        "first_seconds": first_s,
        "matches": len(got),
        "launches": launches_since(mark),
    }


#: bench.py's sections by name, in the order they run
SECTIONS: dict[str, Callable[[Run, dict], None]] = {
    "north_star": bench_north_star,
    "scenarios": bench_scenarios,
    "match_dense": bench_match_dense,
    "large_set": bench_large_set,
    "million_set": bench_million_set,
    "bytes_overlapping_1gb": bench_bytes_overlapping_1gb,
    "sparse_device_forced": bench_sparse_device,
}


def device_info(dev: torch.device) -> dict:
    """The card (``nvidia-smi``'s name and power limit, torch's name), or
    the CPU, and the torch and CUDA versions."""
    return {
        "nvidia_smi": device_label(dev),
        "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def _scale(text: str) -> int:
    k = int(text)
    if k < 1 or k > MAX_SCALE or k & (k - 1):
        raise argparse.ArgumentTypeError(
            f"--scale must be a power of two from 1 to {MAX_SCALE}")
    return k


def _sections(text: str) -> list[str]:
    names = [s for s in text.split(",") if s]
    if not names or set(names) - set(SECTIONS):
        raise argparse.ArgumentTypeError(
            f"--sections takes names from {list(SECTIONS)}, not {text!r}")
    return [s for s in SECTIONS if s in names]


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--scale", type=_scale, default=1,
                   help="divide every size by this power of two")
    p.add_argument("--sections", type=_sections, default=list(SECTIONS),
                   help="comma-separated sections to run (default: all)")
    a = p.parse_args(argv)
    try:
        dev = _resolve_device(a.device)
    except RuntimeError as e:
        raise SystemExit(f"bench: {e}; on the command line: --device cpu")
    run = Run(dev, a.scale)
    detail: dict = {"device": device_info(dev), "scale": a.scale,
                    "sections": a.sections, "build_seconds": None}
    if dev.type == "cuda":
        _kernels.build()
        detail["build_seconds"] = _kernels.BUILD_SECONDS
    else:
        detail["note"] = ("--device cpu: every kernel ran as its plain "
                          "PyTorch version on the host; no number is the "
                          "card's")
    detail["seconds_by_section"] = {}
    detail["peak_rss_gb_after"] = {}
    for name in a.sections:
        t0 = time.perf_counter()
        SECTIONS[name](run, detail)
        secs = time.perf_counter() - t0
        detail["seconds_by_section"][name] = secs
        detail["peak_rss_gb_after"][name] = _rss_gb()
        print(f"bench: {name} {secs:.1f} s", file=sys.stderr, flush=True)
    # the best GPU path, as bench.py takes it; none without the north star
    value = max((detail[k] for k in HEADLINE_PATHS if k in detail),
                default=None)
    baseline = detail.get("cpu_native_gbps")
    print(json.dumps({
        "metric": "dfa_scan_haystack_throughput_per_chip",
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / baseline if value and baseline else None,
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
