"""Differential conformance of the port against the upstream
``ahocorasick_rs`` binary, tuple for tuple.

The counterpart of the JAX package's ``tools/conformance_vs_reference.py``.
It compares the port's output with the real extension module (the Rust
binding over the ``aho-corasick`` crate) in four sections, in this order:

* an error-text section: the exception type and message of every error
  path the reference maps explicitly (upstream src/lib.rs:36-39, 149,
  205-212, 288-298, 387-389) and of the PyO3 haystack extraction, held
  verbatim (:data:`ERROR_CASES`);
* the golden cases of the reference's own tests (upstream
  tests/test_ac.py:196-292, README.md:29-54);
* a match-dense section: nested pattern sets over repetitive haystacks of
  128-512 KiB, with the port's streaming thresholds lowered on its
  classes so that the streamed and fused native resolvers run;
* a random sweep: pattern sets x alphabets x haystack styles (random,
  concatenated patterns, periodic, code points above U+2600 on the ``str``
  side, NUL and 0xFF on the ``bytes`` side), every match kind x
  ``overlapping`` x ``implementation``, on both classes, until both
  ``--min-tuple-checks`` and ``--min-list-checks`` are reached or
  ``--max-seconds`` pass.

"Ours" is the port on its default device, the card unless ``--device
cpu`` is given (the tool exits non-zero without one), with ``--backend``
(``auto`` by default, the reference tool's routing; ``device`` sends every
call of ours to the device tier).  Without ``--self-test`` the reference
is ``import ahocorasick_rs``, and without that module the tool exits 3
and names it.  ``--self-test`` puts the port's ``python`` host tier on the
CPU in the reference's place, through an adapter with the reference's
constructor signature (:func:`port_module`), so that the harness runs
where the wheel is not installed and compares two tiers of the port.

Run from the repository root::

    python -m ahocorasick_rs_tpu_torch.tools.conformance_vs_reference \
        [--self-test] [--device cpu] [--backend auto] \
        [--min-tuple-checks 1000000] [--min-list-checks 150000] \
        [--max-seconds 2400] [--dense-cases 12] [--seed N]

Exit 0 when every comparison matched and both minimums were reached, 1 on
a divergence, 2 when too few comparisons were made in ``--max-seconds``.
"""

from __future__ import annotations

import argparse
import sys
import time
import types
from typing import Any, Callable, Optional

import numpy as np

from .. import api as _api
from ..api import _resolve_device
from ..models.engine import Implementation, MatchKind

KIND_NAMES = ["Standard", "LeftmostFirst", "LeftmostLongest"]
IMPL_NAMES = [None, "NoncontiguousNFA", "ContiguousNFA", "DFA"]

#: golden inputs from the reference's own tests (upstream
#: tests/test_ac.py:196-292, README.md:29-54)
WINTER_PATTERNS = ["content", "disco", "disc", "discontent", "winter"]
WINTER_HAYSTACK = "This is the winter of my discontent"
QUICKSTART_PATTERNS = ["hello", "world", "fish"]
QUICKSTART_HAYSTACK = "this is my first hello world. hello!"
UNICODE_PATTERNS = ["d ☃f", "há", "l🤦l"]
UNICODE_HAYSTACK = "hello, world ☃fishá l🤦l"
#: the port's streaming thresholds the match-dense section lowers on ours
DENSE_STREAM = {"_STREAM_MIN": 1 << 16, "_STREAM_SEG": 1 << 15,
                "_STREAM_OCC": 1 << 13}


def port_module(device: str, backend: str = "auto") -> types.SimpleNamespace:
    """The port with the reference module's surface: ``AhoCorasick`` and
    ``BytesAhoCorasick`` with the reference's constructor signatures,
    whose matchers run ``backend`` on ``device``, and the enums."""

    class AhoCorasick(_api.AhoCorasick):
        def __init__(self, patterns: Any,
                     matchkind: MatchKind = MatchKind.Standard,
                     store_patterns: Optional[bool] = None,
                     implementation: Optional[Implementation] = None
                     ) -> None:
            super().__init__(patterns, matchkind, store_patterns,
                             implementation, backend=backend, device=device)

    class BytesAhoCorasick(_api.BytesAhoCorasick):
        def __init__(self, patterns: Any,
                     matchkind: MatchKind = MatchKind.Standard,
                     implementation: Optional[Implementation] = None
                     ) -> None:
            super().__init__(patterns, matchkind, implementation,
                             backend=backend, device=device)

    return types.SimpleNamespace(
        __name__=f"ahocorasick_rs_tpu_torch[{backend} on {device}]",
        AhoCorasick=AhoCorasick, BytesAhoCorasick=BytesAhoCorasick,
        MatchKind=MatchKind, Implementation=Implementation)


class TooManyFailures(Exception):
    """More than 20 divergences: the run stops."""


class Stats:
    def __init__(self) -> None:
        self.cases = 0
        self.list_checks = 0
        self.tuple_checks = 0
        self.failures: list[str] = []

    def note(self, got: list, want: list) -> None:
        self.list_checks += 1
        self.tuple_checks += max(len(got), len(want), 1)


def build_matcher(
    mod: Any,
    pats: list,
    kind_name: Optional[str],
    impl_name: Optional[str],
    is_bytes: bool,
) -> Any:
    cls = mod.BytesAhoCorasick if is_bytes else mod.AhoCorasick
    kwargs: dict = {}
    if kind_name is not None:
        kwargs["matchkind"] = getattr(mod.MatchKind, kind_name)
    if impl_name is not None:
        kwargs["implementation"] = getattr(mod.Implementation, impl_name)
    return cls(pats, **kwargs)


def render_failures(stats: Stats) -> str:
    return (
        f"{len(stats.failures)} DIVERGENCES after {stats.cases} cases / "
        f"{stats.tuple_checks} tuple comparisons:\n\n"
        + "\n\n".join(stats.failures[:20])
    )


def compare_case(
    ref_mod: Any,
    ours: Any,
    pats: list,
    hays: list,
    is_bytes: bool,
    stats: Stats,
    rng: np.random.Generator,
) -> None:
    """Compare every (kind, impl, overlapping) combination on this case."""
    stats.cases += 1
    for kind_name in KIND_NAMES:
        for impl_name in IMPL_NAMES:
            # each side is built on its own, so that a refusal by one side
            # only is reported
            ref_exc = ours_exc = None
            ref = mine = None
            try:
                ref = build_matcher(ref_mod, pats, kind_name, impl_name,
                                    is_bytes)
            except ValueError as e:
                ref_exc = e
            try:
                mine = build_matcher(ours, pats, kind_name, impl_name,
                                     is_bytes)
            except ValueError as e:
                ours_exc = e
            if (ref_exc is None) != (ours_exc is None):
                stats.failures.append(
                    "build refused by only one side\n"
                    f"  reference: {ref_exc!r}\n  ours: {ours_exc!r}\n"
                    f"  pats={pats!r} kind={kind_name} impl={impl_name}"
                )
                continue
            if ref_exc is not None:
                continue  # both refused
            overlaps = [False, True] if kind_name == "Standard" else [False]
            for hay in hays:
                for ov in overlaps:
                    want = ref.find_matches_as_indexes(hay, overlapping=ov)
                    got = mine.find_matches_as_indexes(hay, overlapping=ov)
                    stats.note(got, want)
                    if got != want:
                        stats.failures.append(
                            "MATCH MISMATCH\n"
                            f"  pats={pats!r}\n  hay={hay!r}\n"
                            f"  kind={kind_name} impl={impl_name} "
                            f"overlapping={ov} bytes={is_bytes}\n"
                            f"  reference={want!r}\n  ours={got!r}"
                        )
                        if len(stats.failures) > 20:
                            raise TooManyFailures
                if not is_bytes and rng.random() < 0.25:
                    wants = ref.find_matches_as_strings(hay)
                    gots = mine.find_matches_as_strings(hay)
                    stats.note(gots, wants)
                    if gots != wants:
                        stats.failures.append(
                            "STRINGS MISMATCH\n"
                            f"  pats={pats!r}\n  hay={hay!r}\n"
                            f"  kind={kind_name} impl={impl_name}\n"
                            f"  reference={wants!r}\n  ours={gots!r}"
                        )


def _text(raw: np.ndarray, is_bytes: bool) -> Any:
    if is_bytes:
        return bytes((raw % 256).astype(np.uint8))
    # code points above U+2600 exercise the UTF-8 index mapping
    return "".join(chr(97 + int(c)) if c < 26 else chr(0x2600 + int(c))
                   for c in raw)


def gen_case(rng: np.random.Generator) -> tuple[list, list, bool]:
    """One random ``(patterns, haystacks, is_bytes)`` case (the reference
    tool's recipe, after the axes of upstream tests/test_ac.py:86-193)."""
    is_bytes = bool(rng.random() < 0.5)
    alpha = int(rng.choice([2, 3, 26, 256 if is_bytes else 60]))
    npat = int(rng.integers(1, 24))
    pats: list = []
    seen = set()
    for _ in range(npat):
        k = int(rng.integers(1, 10))
        p = _text(rng.integers(0, alpha, k, dtype=np.int64), is_bytes)
        if p and p not in seen:
            seen.add(p)
            pats.append(p)
    if not pats:
        pats = [b"a" if is_bytes else "a"]
    hays = []
    for _ in range(3):
        n = int(rng.integers(0, 600))
        style = int(rng.integers(0, 3))
        if style == 0:
            hay = _text(rng.integers(0, alpha, n, dtype=np.int64), is_bytes)
        elif style == 1:
            # concatenated patterns: overlap pressure
            parts: list = []
            total = 0
            while total < n and pats:
                p = pats[int(rng.integers(0, len(pats)))]
                parts.append(p)
                total += len(p)
            hay = (b"" if is_bytes else "").join(parts)
        else:
            p0 = pats[int(rng.integers(0, len(pats)))]
            hay = p0 * max(1, n // max(len(p0), 1))
        hays.append(hay)
    return pats, hays, is_bytes


def golden_cases(ref_mod: Any, ours: Any, stats: Stats,
                 rng: np.random.Generator) -> None:
    for pats, hay in ((WINTER_PATTERNS, WINTER_HAYSTACK),
                      (QUICKSTART_PATTERNS, QUICKSTART_HAYSTACK),
                      (UNICODE_PATTERNS, UNICODE_HAYSTACK)):
        compare_case(ref_mod, ours, pats, [hay], False, stats, rng)
    compare_case(ref_mod, ours, [p.encode() for p in WINTER_PATTERNS],
                 [WINTER_HAYSTACK.encode()], True, stats, rng)


_NP_2D = np.zeros((2, 2), dtype=np.uint8)
_NP_STRIDED = np.zeros(16, dtype=np.uint8)[::2]

#: every pinned error path: (name, trigger on a module)
ERROR_CASES: list[tuple[str, Callable[[Any], Any]]] = [
    ("nonstr-pattern", lambda m: m.AhoCorasick(["x", 12])),
    ("empty-str-pattern", lambda m: m.AhoCorasick(["x", ""])),
    ("empty-bytes-pattern", lambda m: m.BytesAhoCorasick([b"x", b""])),
    ("overlapping-leftmost-first", lambda m: m.AhoCorasick(
        ["ab"], matchkind=m.MatchKind.LeftmostFirst
    ).find_matches_as_indexes("abab", overlapping=True)),
    ("overlapping-leftmost-longest", lambda m: m.AhoCorasick(
        ["ab"], matchkind=m.MatchKind.LeftmostLongest
    ).find_matches_as_indexes("abab", overlapping=True)),
    ("bytes-overlapping-leftmost", lambda m: m.BytesAhoCorasick(
        [b"ab"], matchkind=m.MatchKind.LeftmostFirst
    ).find_matches_as_indexes(b"abab", overlapping=True)),
    ("str-haystack-int",
     lambda m: m.AhoCorasick(["x"]).find_matches_as_indexes(12)),
    ("bytes-haystack-str",
     lambda m: m.BytesAhoCorasick([b"x"]).find_matches_as_indexes("xx")),
    ("bytes-haystack-2d",
     lambda m: m.BytesAhoCorasick([b"x"]).find_matches_as_indexes(_NP_2D)),
    ("bytes-haystack-noncontiguous", lambda m: m.BytesAhoCorasick(
        [b"x"]).find_matches_as_indexes(_NP_STRIDED)),
]


def capture(fn: Callable[[], Any]) -> tuple[Optional[str], Optional[str]]:
    """``(type name, message)`` of what ``fn`` raises, or ``(None, None)``."""
    try:
        fn()
        return None, None
    except Exception as e:  # noqa: BLE001 - differential capture
        return type(e).__name__, str(e)


def error_text_section(ref_mod: Any, ours: Any, stats: Stats) -> None:
    """Exception type and message parity on :data:`ERROR_CASES`; a
    mismatch prints the reference's verbatim text."""
    for name, trigger in ERROR_CASES:
        ref_type, ref_text = capture(lambda: trigger(ref_mod))
        our_type, our_text = capture(lambda: trigger(ours))
        stats.list_checks += 1
        stats.tuple_checks += 1
        if (ref_type, ref_text) != (our_type, our_text):
            stats.failures.append(
                f"ERROR-TEXT MISMATCH [{name}]\n"
                f"  reference: {ref_type}: {ref_text!r}\n"
                f"  ours:      {our_type}: {our_text!r}"
            )
        else:
            print(f"  error-text OK [{name}]: {ref_type}: {ref_text!r}")


def dense_adversarial_section(
    ref_mod: Any, ours: Any, stats: Stats, rng: np.random.Generator,
    cases: int = 12,
) -> None:
    """Match-dense haystacks through the port's streamed and fused
    resolvers, held to the reference.

    Nested pattern sets over repetitive haystacks, with :data:`DENSE_STREAM`
    set on ours's classes (not on the port's, so a ``--self-test``
    reference keeps its plain walk) for the section's length.
    """
    classes = (ours.AhoCorasick, ours.BytesAhoCorasick)
    for cls in classes:
        for name, value in DENSE_STREAM.items():
            setattr(cls, name, value)
    try:
        for _ in range(cases):
            base = int(rng.integers(97, 123))
            depth = int(rng.integers(2, 17))
            pats = [bytes([base]) * k for k in range(1, depth + 1)]
            for _ in range(int(rng.integers(0, 3))):
                extra = bytes(rng.integers(
                    97, 123, int(rng.integers(1, 5)), dtype=np.uint8))
                if extra not in pats:
                    pats.append(extra)
            n = int(rng.integers(1 << 17, 1 << 19))
            if rng.random() < 0.5:
                hay = bytes([base]) * n
            else:
                period = bytes([base]) * int(rng.integers(1, 9)) + b"!"
                hay = (period * (n // len(period) + 1))[:n]
            for kind_name in KIND_NAMES:
                ref = build_matcher(ref_mod, pats, kind_name, None, True)
                mine = build_matcher(ours, pats, kind_name, None, True)
                want = ref.find_matches_as_indexes(hay)
                got = mine.find_matches_as_indexes(hay)
                stats.note(got, want)
                if got != want:
                    diff_at = next(
                        (i for i, (a, b) in enumerate(zip(got, want))
                         if a != b),
                        min(len(got), len(want)),
                    )
                    stats.failures.append(
                        "DENSE MISMATCH\n"
                        f"  pats={pats!r} n={n} kind={kind_name}\n"
                        f"  got {len(got)} vs want {len(want)}; "
                        f"first diff near {diff_at}"
                    )
                    return
        print(f"  dense-adversarial OK ({stats.tuple_checks} cumulative "
              "tuple comparisons)")
    finally:
        for cls in classes:
            for name in DENSE_STREAM:
                delattr(cls, name)


def reference_module(self_test: bool) -> Any:
    """The upstream binary, or (``self_test``) the port's ``python`` tier
    on the CPU.  Exits 3, naming the module, when the binary is not
    installed."""
    if self_test:
        print("SELF-TEST MODE: reference := the port's python tier on cpu")
        return port_module("cpu", "python")
    try:
        import ahocorasick_rs  # the upstream binary
    except ImportError as e:
        print(f"conformance_vs_reference: the reference module "
              f"ahocorasick_rs is not installed ({e}); --self-test holds "
              "two tiers of the port against each other instead",
              file=sys.stderr)
        raise SystemExit(3)
    print("reference binary:", getattr(ahocorasick_rs, "__file__", "?"))
    return ahocorasick_rs


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-tuple-checks", type=int, default=1_000_000)
    ap.add_argument(
        "--min-list-checks", type=int, default=150_000,
        help="minimum list comparisons, the random sweep's included (the "
             "match-dense section alone can reach the tuple minimum)")
    ap.add_argument("--max-seconds", type=float, default=2400.0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--dense-cases", type=int, default=12,
                    help="haystacks of the match-dense section")
    ap.add_argument("--device", default=None,
                    help="ours's device (default: the card)")
    ap.add_argument("--backend", default="auto",
                    help="ours's backend= (default: auto)")
    ap.add_argument("--self-test", action="store_true",
                    help="the port's python tier on the CPU in the "
                         "reference's place (where the wheel is missing)")
    args = ap.parse_args(argv)
    try:
        dev = str(_resolve_device(args.device))
    except RuntimeError as e:
        raise SystemExit(f"conformance_vs_reference: {e}; on the command "
                         "line: --device cpu")
    ref_mod = reference_module(args.self_test)
    ours = port_module(dev, args.backend)
    print(f"ours: {ours.__name__}")

    seed = args.seed if args.seed is not None else int(time.time())
    rng = np.random.default_rng(seed)
    print(f"seed={seed}")
    stats = Stats()

    t0 = time.time()
    try:
        print("== error-text section ==")
        error_text_section(ref_mod, ours, stats)
        print("== golden cases ==")
        golden_cases(ref_mod, ours, stats, rng)
        print("== dense-adversarial section ==")
        dense_adversarial_section(ref_mod, ours, stats, rng, args.dense_cases)
        print("== randomized differential sweep ==")
        t0 = last_report = time.time()
        while (
            (stats.tuple_checks < args.min_tuple_checks
             or stats.list_checks < args.min_list_checks)
            and time.time() - t0 < args.max_seconds
            and not stats.failures
        ):
            pats, hays, is_bytes = gen_case(rng)
            compare_case(ref_mod, ours, pats, hays, is_bytes, stats, rng)
            if time.time() - last_report > 20:
                last_report = time.time()
                print(f"  {stats.cases} cases, {stats.list_checks} list "
                      f"checks, {stats.tuple_checks} tuple comparisons, "
                      f"{time.time() - t0:.0f}s", flush=True)
    except TooManyFailures:
        pass

    summary = {
        "cases": stats.cases,
        "list_checks": stats.list_checks,
        "tuple_checks": stats.tuple_checks,
        "seconds": round(time.time() - t0, 1),
        "seed": seed,
        "self_test": args.self_test,
        "ours": ours.__name__,
        "failures": len(stats.failures),
    }
    print("SUMMARY:", summary)
    if stats.failures:
        print(render_failures(stats))
        return 1
    if (stats.tuple_checks < args.min_tuple_checks
            or stats.list_checks < args.min_list_checks):
        print(f"FAIL: {stats.tuple_checks} tuple / {stats.list_checks} "
              f"list comparisons (< {args.min_tuple_checks} / "
              f"{args.min_list_checks}) within {args.max_seconds}s")
        return 2
    print("PASS: zero divergences vs reference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
