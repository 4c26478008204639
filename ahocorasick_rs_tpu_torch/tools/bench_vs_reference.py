"""Competitor benchmark: the port against the upstream binaries, after the
upstream comparison benchmark's recipe.

The counterpart of the JAX package's ``tools/bench_vs_reference.py``.  The
upstream benchmark compares ``ahocorasick_rs`` with ``pyahocorasick``
(upstream benchmarks/test_comparison.py:72-166).  This tool runs the same
datasets and scenarios over

* ``pyahocorasick`` (``automaton.iter`` / ``iter_long``),
* ``reference``: ``ahocorasick_rs``, the upstream Rust binding,
* ``ours``: the port, one call a document as the upstream calls it,
* ``ours_batch``: the port's ``*_batch`` calls over the same documents,

and writes one markdown table and one JSON artifact, with each scenario's
best-of-3 seconds and the speedup of the faster of ours against each
competitor.  Before timing, ours and ours_batch are held to the reference
on the first 100 documents of each dataset.

Datasets (the shapes of upstream benchmarks/test_comparison.py):

* SHORT: the upstream's 10 patterns over 10,000 haystacks of about 70
  characters, each with a running counter (``_synth.short_case``);
* LONG: 4,200 lowercase names of 5-11 characters (seed 42,
  ``_synth.synth_names``) over
  ``--long-haystacks`` haystacks of about 600 characters, one in 90
  carrying a name.

Ours runs on the card unless ``--device cpu`` is given (the tool exits
non-zero without one); the artifact names the card and its power limit.
A competitor that cannot be imported is listed under ``missing`` and not
timed.  Without ``--self-test`` the reference must be importable
(``ahocorasick_rs``), else the tool exits 3 and names it; ``--self-test``
puts the port's ``python`` host tier on the CPU in the reference's place,
through ``conformance_vs_reference.port_module``.

Run from the repository root::

    python -m ahocorasick_rs_tpu_torch.tools.bench_vs_reference [--self-test] \
        [--device cpu] [--long-haystacks 100000] [--out PATH] [--json-out PATH]

The defaults of ``--out`` and ``--json-out`` are ``H100_VS_REFERENCE.md``
and ``.json`` at the repository root on a card; on the CPU the artifact is
written only where they are given.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..api import _resolve_device
from ._synth import SHORT_DOCS, short_case, synth_names
from .conformance_vs_reference import port_module
from .gpu_conformance import ROOT
from .probe_transpose_kernel import device_label

OUT_MD = os.path.join(ROOT, "H100_VS_REFERENCE.md")
OUT_JSON = os.path.join(ROOT, "H100_VS_REFERENCE.json")
#: documents of each dataset held to the reference before timing
CROSS_CHECK_DOCS = 100
#: LONG's names (the upstream recipe's; the bench tool's LONG has fewer)
LONG_NAMES = 4200


def make_haystacks_long(patterns: list[str], count: int) -> list[str]:
    """LONG's haystacks with the upstream recipe's own line of about 600
    characters (not ``_synth.LONG_FILLER``): one in 90 carries a name, the
    others "notaperson"."""
    line = (
        "no one who had ever seen {} in her infancy would have supposed "
        "her born to be an heroine. her situation in life, the character "
        "of her father and mother, her own person and disposition, were "
        "all equally against her. her father was a clergyman, without "
        "being neglected, or poor, and a very respectable man, though "
        "his name was whatevs - and he had never been handsome. he had a "
        "considerable independence besides two good livings - and he was "
        "not in the least addicted to locking up his daughters. her "
        "mother was a woman of useful plain sense, with a good temper, "
        "and, what is more remarkable, with a good constitution {}."
    )
    out = []
    for i in range(count):
        name = patterns[i % len(patterns)] if i % 90 == 0 else "notaperson"
        out.append(line.format(name, i))
    return out


def datasets(long_haystacks: int) -> dict:
    """SHORT at its recipe's 10,000 haystacks and LONG at
    ``long_haystacks``; LONG's 4,200 names (seed 42) are both the patterns
    and the names planted in its haystacks."""
    rng = np.random.default_rng(42)
    patterns_long = [n.decode() for n in synth_names(LONG_NAMES, rng)]
    return {
        "short": short_case(SHORT_DOCS),
        "long": (patterns_long,
                 make_haystacks_long(patterns_long, long_haystacks)),
    }


def best_of(fn: Callable[[], Any], reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def scenarios(
    mod_kind: str, mod: Any, patterns: list[str], haystacks: list[str]
) -> dict:
    """Seconds of each scenario (best of 3) for one library; ``mod_kind``
    is ``pyahocorasick``, ``reference``, ``ours`` or ``ours_batch``
    (upstream benchmarks/test_comparison.py:100-166)."""
    out: dict = {}
    if mod_kind == "pyahocorasick":
        automaton = mod.Automaton()
        for key in patterns:
            automaton.add_word(key, key)
        automaton.make_automaton()

        def overlapping() -> None:
            for h in haystacks:
                list(automaton.iter(h))

        def longest() -> None:
            for h in haystacks:
                list(automaton.iter_long(h))

        out["overlapping_strings"] = best_of(overlapping)
        out["leftmost_longest_strings"] = best_of(longest)
        return out

    ac = mod.AhoCorasick(patterns)
    ac_l = mod.AhoCorasick(patterns, matchkind=mod.MatchKind.LeftmostLongest)
    if mod_kind in ("reference", "ours"):
        def std_strings() -> None:
            for h in haystacks:
                ac.find_matches_as_strings(h)

        def std_indexes() -> None:
            for h in haystacks:
                ac.find_matches_as_indexes(h)

        def overlapping() -> None:
            for h in haystacks:
                ac.find_matches_as_strings(h, overlapping=True)

        def longest() -> None:
            for h in haystacks:
                ac_l.find_matches_as_strings(h)

        out["standard_strings"] = best_of(std_strings)
        out["standard_indexes"] = best_of(std_indexes)
        out["overlapping_strings"] = best_of(overlapping)
        out["leftmost_longest_strings"] = best_of(longest)
        return out

    # ours_batch: the port's batch calls over the same documents
    out["standard_strings"] = best_of(
        lambda: ac.find_matches_as_strings_batch(haystacks))
    out["standard_indexes"] = best_of(
        lambda: ac.find_matches_as_indexes_batch(haystacks))
    out["overlapping_strings"] = best_of(
        lambda: ac.find_matches_as_strings_batch(haystacks, overlapping=True))
    out["leftmost_longest_strings"] = best_of(
        lambda: ac_l.find_matches_as_strings_batch(haystacks))
    out["batch_backend"] = ac.stats()["last_backend"]
    return out


def cross_check(ref: Any, ours: Any, data: dict) -> None:
    """Ours, per document and batched, equals the reference on the first
    :data:`CROSS_CHECK_DOCS` documents of each dataset, in the Standard,
    overlapping and LeftmostLongest scenarios; raises on a difference."""
    for ds_name, (patterns, haystacks) in data.items():
        docs = haystacks[:CROSS_CHECK_DOCS]
        for kind, ov in (("Standard", False), ("Standard", True),
                         ("LeftmostLongest", False)):
            r = ref.AhoCorasick(patterns,
                                matchkind=getattr(ref.MatchKind, kind))
            o = ours.AhoCorasick(patterns,
                                 matchkind=getattr(ours.MatchKind, kind))
            want = [r.find_matches_as_indexes(h, overlapping=ov)
                    for h in docs]
            got = [o.find_matches_as_indexes(h, overlapping=ov)
                   for h in docs]
            if got != want:
                raise AssertionError(f"ours differs from the reference on "
                                     f"{ds_name} ({kind}, overlapping={ov})")
            if o.find_matches_as_indexes_batch(docs, overlapping=ov) != want:
                raise AssertionError(
                    f"ours_batch differs from the reference on {ds_name} "
                    f"({kind}, overlapping={ov})")


def competitors(self_test: bool) -> tuple[dict, list[str]]:
    """The competitors that import, and the names of those that do not.
    Exits 3, naming it, when ``ahocorasick_rs`` is missing outside
    ``self_test``."""
    libs: dict = {}
    missing = []
    try:
        import ahocorasick  # pyahocorasick

        libs["pyahocorasick"] = ahocorasick
    except ImportError:
        missing.append("pyahocorasick")
    if self_test:
        print("SELF-TEST MODE: reference := the port's python tier on cpu")
        libs["reference"] = port_module("cpu", "python")
        return libs, missing
    try:
        import ahocorasick_rs
    except ImportError as e:
        print(f"bench_vs_reference: the reference module ahocorasick_rs is "
              f"not installed ({e}); --self-test puts the port's python "
              "tier in its place", file=sys.stderr)
        raise SystemExit(3)
    libs["reference"] = ahocorasick_rs
    return libs, missing


def render(results: dict, device: dict, self_test: bool) -> tuple[str, dict]:
    """The markdown table and the speedups of the faster of ours."""
    lines = [
        "# Competitor benchmark (upstream recipe)",
        "",
        "Methodology: the upstream benchmark's datasets and scenarios "
        "(upstream benchmarks/test_comparison.py), best-of-3 wall time per "
        "scenario, one process.  `ours` calls the per-document API as the "
        "upstream does; `ours_batch` is the port's batch API over the same "
        f"documents.  Ours on {device['ours']}; card: {device['gpu']}; host "
        f"CPU: {device['host']}."
        + (" Self-test: `reference` is the port's python tier on the CPU, "
           "not the upstream binary." if self_test else ""),
        "",
    ]
    summary: dict = {}
    for ds_name, per_lib in results.items():
        lines += [f"## {ds_name}", ""]
        scens = sorted({s for t in per_lib.values() for s in t
                        if s != "batch_backend"})
        lines.append("| scenario | " + " | ".join(per_lib) + " | speedups |")
        lines.append("|" + "---|" * (len(per_lib) + 2))
        for s in scens:
            row = [s]
            for lib_name in per_lib:
                v = per_lib[lib_name].get(s)
                row.append("-" if v is None else f"{v:.3f}s")
            best_ours = min((x for x in (per_lib.get("ours", {}).get(s),
                                         per_lib.get("ours_batch", {}).get(s))
                             if x is not None), default=None)
            sp = []
            for other in ("pyahocorasick", "reference"):
                o = per_lib.get(other, {}).get(s)
                if o is not None and best_ours:
                    sp.append(f"{o / best_ours:.2f}x vs {other}")
                    summary.setdefault(ds_name, {})[f"{s}_vs_{other}"] = (
                        o / best_ours)
            row.append("; ".join(sp) or "-")
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
    return "\n".join(lines), summary


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help=f"the markdown (default on a card: {OUT_MD})")
    ap.add_argument("--json-out", default=None,
                    help=f"the JSON artifact (default on a card: {OUT_JSON})")
    ap.add_argument("--long-haystacks", type=int, default=100_000)
    ap.add_argument("--device", default=None,
                    help="ours's device (default: the card)")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    try:
        dev = _resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench_vs_reference: {e}; on the command line: "
                         "--device cpu")
    libs, missing = competitors(args.self_test)
    ours = port_module(str(dev))
    libs["ours"] = libs["ours_batch"] = ours
    device = {"ours": str(dev), "gpu": device_label(dev),
              "host": platform.processor() or platform.machine(),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    data = datasets(args.long_haystacks)
    cross_check(libs["reference"], ours, data)
    results: dict = {}
    for ds_name, (patterns, haystacks) in data.items():
        results[ds_name] = {}
        for lib_name, mod in libs.items():
            t = scenarios(lib_name, mod, patterns, haystacks)
            results[ds_name][lib_name] = t
            print(f"{ds_name}/{lib_name}: {t}", flush=True)

    md, summary = render(results, device, args.self_test)
    md_out = args.out if args.out or dev.type != "cuda" else OUT_MD
    json_out = (args.json_out if args.json_out or dev.type != "cuda"
                else OUT_JSON)
    if md_out:
        with open(md_out, "w") as f:
            f.write(md + "\n")
    if json_out:
        with open(json_out, "w") as f:
            json.dump({"device": device, "self_test": args.self_test,
                       "missing": missing,
                       "long_haystacks": args.long_haystacks,
                       "short_haystacks": len(data["short"][1]),
                       "results": results, "speedups": summary}, f,
                      indent=1)
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
