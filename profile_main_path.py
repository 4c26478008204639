#!/usr/bin/env python3
"""Where the time of one main-path call goes, on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 profile_main_path.py

It makes the same seeded workloads as ``chip_smoke.py`` (1,000 name
patterns, a 64 MiB corpus; the LONG and SHORT document batches), warms up
the matchers of the PyTorch port (the Teddy path: LeftmostLongest with the
DFA engine; the dense path: ContiguousNFA, Standard, overlapping, Teddy
off, which runs the stride-2 scan; the sparse engine, Standard,
overlapping, with ``backend="device"``; the LONG batch through the Teddy
pipeline and through the batch kernel; the SHORT batch; and the same Teddy,
dense and LONG batch calls with ``backend="sharded"`` in a world of one
rank, with no process group; and the Teddy scanner's streamed pipeline,
16 MiB segments staged on its side copy stream, beside one whole-buffer
pass), times three calls of each on the host clock, then traces one call
of each with ``torch.profiler``.  For each path it prints one JSON line:
the wall time of the calls, the host time of each ``ahocorasick:*`` span,
the device time of each kernel and copy and of each kernel family (the
port's kernels K1-K9, copies, PyTorch's own kernels), the union of device
activity,
the device's idle share of the traced call, and the host-to-device copy
time with the part of it that ran while a kernel ran.  The Chrome traces go to
``chiprun_out/``.  Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port's CUDA kernels by a part of their names (``csrc/*.cu``); any
#: other kernel is PyTorch's own (``at::`` in its name: reductions such
#: as ``amax``, elementwise ops, concatenations) and counts as "torch"
KERNEL_FAMILIES = {
    "fire_kernel": "K1 fire",
    "lane_scan_kernel": "K2 lane_scan",
    "compact_kernel": "K3 compact",
    "verify_kernel": "K4 verify",
    "batch_scan_kernel": "K5 batch_scan",
    "stride2_scan_kernel": "K6 stride2_scan",
    "sparse_scan_kernel": "K7 sparse_scan",
    "groups_kernel": "K9 fire_groups",
}


def kernel_family(name: str) -> str:
    """The family of a device event's name: a port kernel's, "copies"
    (memcpy, memset) or "torch"."""
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if "at::" not in name:
        for part, family in KERNEL_FAMILIES.items():
            if part in name:
                return family
    return "torch"


def device_busy_us(events) -> tuple[float, dict]:
    """Union of the device intervals of kernels and copies, and device
    time by name (us).  The ``ahocorasick:*`` spans' device-side copies
    (from their first to their last kernel) are left out."""
    spans = []
    by_name: dict = {}
    for e in events:
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if not on_device or e.name.startswith("ahocorasick:"):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, by_name


def copy_beside_kernels_us(events) -> tuple[float, float]:
    """Device time of the host-to-device copies, and the part of it during
    which a kernel ran (us)."""
    copies, kernels = [], []
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("ahocorasick:")):
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    merged: list = []
    for a, b in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    beside = sum(max(0.0, min(b, kb) - max(a, ka))
                 for a, b in copies for ka, kb in merged)
    return sum(b - a for a, b in copies), beside


def profile_path(label: str, call) -> dict:
    """Three timed calls, then one traced call of ``call``."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(HERE, "chiprun_out", f"trace_{label}.json")
    )
    events = prof.events()
    spans: dict = {}
    for e in events:
        if e.name.startswith("ahocorasick:"):
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
    busy_us, by_name = device_busy_us(events)
    by_family: dict = {}
    for name, us in by_name.items():
        family = kernel_family(name)
        by_family[family] = by_family.get(family, 0.0) + us / 1e3
    copy_us, beside_us = copy_beside_kernels_us(events)
    if not by_name:
        raise SystemExit(f"{label}: the profiler saw no device activity")
    outside = traced_ms - sum(
        spans.get(k, 0.0)
        for k in ("ahocorasick:scan", "ahocorasick:scan_batch",
                  "ahocorasick:resolve")
    )
    return {
        "path": label,
        "wall_ms": walls,
        "traced_wall_ms": traced_ms,
        "span_ms": spans,
        # the API layer around _find / _find_batch: str -> UTF-8 encode,
        # index mapping
        "outside_spans_ms": outside,
        "device_ms_by_name": {k: v / 1e3 for k, v in by_name.items()},
        "device_ms_by_family": by_family,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "htod_copy_ms": copy_us / 1e3,
        "htod_copy_beside_kernels_ms": beside_us / 1e3,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ahocorasick_rs_tpu_torch as port
    from ahocorasick_rs_tpu_torch.tools._synth import (
        long_docs,
        short_case,
        synth_corpus,
        synth_names,
    )
    from chip_smoke import CORPUS_MIB, PATTERNS, SEED

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(SEED)
    names = synth_names(PATTERNS, rng)
    corpus = synth_corpus(CORPUS_MIB << 20, names, rng)
    text = corpus.tobytes().decode()
    names_s = [x.decode() for x in names]

    teddy = port.AhoCorasick(
        names_s, matchkind=port.MatchKind.LeftmostLongest,
        implementation=port.Implementation.DFA, backend="device",
    )
    dense = port.AhoCorasick(
        names_s, implementation=port.Implementation.ContiguousNFA,
        backend="device",
    )
    dense._teddy_state = "off"
    sparse = port.AhoCorasick(
        names_s, implementation=port.Implementation.NoncontiguousNFA,
        backend="device",
    )
    for ac, kw in ((teddy, {}), (dense, {"overlapping": True}),
                   (sparse, {"overlapping": True})):
        ac.find_matches_as_indexes(text, **kw)  # tables, build, caps
    long_batch = long_docs(names)
    short_patterns, short_batch = short_case()
    batches = {
        "batch_long_teddy": (port.AhoCorasick(names_s, backend="device"),
                             long_batch, "teddy_batch"),
        "batch_long_dense": (port.AhoCorasick(names_s, backend="device"),
                             long_batch, "device_batch"),
        "batch_short": (port.AhoCorasick(short_patterns, backend="device"),
                        short_batch, "device_batch"),
    }
    batches["batch_long_dense"][0]._teddy_state = "off"
    for ac, docs, _ in batches.values():
        ac.find_matches_as_indexes_batch(docs)  # tables, build, caps
    # the sharded calls in a world of one rank: K8's bodies and exchange
    # layer with no collective
    sharded = {
        "teddy_sharded": port.AhoCorasick(
            names_s, matchkind=port.MatchKind.LeftmostLongest,
            implementation=port.Implementation.DFA, backend="sharded",
        ),
        "sharded": port.AhoCorasick(
            names_s, implementation=port.Implementation.ContiguousNFA,
            backend="sharded",
        ),
        "teddy_sharded_batch": port.AhoCorasick(names_s, backend="sharded"),
        "sharded_batch": port.AhoCorasick(names_s, backend="sharded"),
    }
    sharded["sharded"]._teddy_state = "off"
    sharded["sharded_batch"]._teddy_state = "off"
    ts, sd = sharded["teddy_sharded"], sharded["sharded"]
    tb, sb = sharded["teddy_sharded_batch"], sharded["sharded_batch"]
    sharded_calls = {
        "teddy_sharded": lambda: ts.find_matches_as_indexes(text),
        "sharded": lambda: sd.find_matches_as_indexes(text, overlapping=True),
        "teddy_sharded_batch": lambda: tb.find_matches_as_indexes_batch(
            long_batch),
        "sharded_batch": lambda: sb.find_matches_as_indexes_batch(long_batch),
    }
    for call in sharded_calls.values():
        call()  # tables, build, caps
    torch.cuda.synchronize()
    encode_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        text.encode("utf-8")
        encode_ms.append((time.perf_counter() - t0) * 1e3)
    rows = [
        profile_path("teddy", lambda: teddy.find_matches_as_indexes(text)),
        profile_path(
            "dense",
            lambda: dense.find_matches_as_indexes(text, overlapping=True),
        ),
        profile_path(
            "sparse",
            lambda: sparse.find_matches_as_indexes(text, overlapping=True),
        ),
    ]
    for label, (ac, docs, tier) in batches.items():
        rows.append(profile_path(
            label, lambda ac=ac, docs=docs: ac.find_matches_as_indexes_batch(
                docs
            ),
        ))
        if ac.stats()["last_backend"] != tier:
            raise SystemExit(f"{label} did not run {tier}")
    # the streamed Teddy pipeline (four 16 MiB segments, each copied on
    # the scanner's side stream) beside one whole-buffer pass
    scanner = teddy._teddy
    rows.append(profile_path(
        "teddy_whole_buffer", lambda: scanner.occurrences(corpus)))
    rows.append(profile_path(
        "teddy_streamed",
        lambda: scanner.occurrences_streamed(corpus, seg_bytes=16 << 20)))
    for tier, call in sharded_calls.items():
        rows.append(profile_path(tier, call))
        if sharded[tier].stats()["last_backend"] != tier:
            raise SystemExit(f"the {tier} matcher did not run {tier}")
    if teddy.stats()["last_backend"] != "teddy":
        raise SystemExit("the Teddy matcher did not run the Teddy path")
    for ac in (dense, sparse):
        if ac.stats()["last_backend"] != "device":
            raise SystemExit("a dense matcher did not run the device tier")
    for row in rows:
        row["gpu"] = smi
        row["encode_ms"] = encode_ms
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
