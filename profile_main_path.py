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
dense and LONG batch calls with ``backend="sharded"`` and no mesh (every
local card, one thread rank each), then on local meshes of 2 and 4 thread
ranks sharing ``cuda:0`` (``make_mesh(devices=["cuda:0"] * k)``, rows
``<tier>_local<k>``); and the Teddy scanner's streamed pipeline,
16 MiB segments staged on its side copy stream, beside one whole-buffer
pass), times three calls of each on the host clock, then traces one call
of each with ``torch.profiler``.  For each path it prints one JSON line:
the wall time of the calls, the host time of each ``ahocorasick:*`` span,
the device time of each kernel and copy and of each kernel family (the
port's kernels K1-K9, copies, PyTorch's own kernels), the union of device
activity,
the device's idle share of the traced call, and the host-to-device copy
time with the part of it that ran while a kernel ran.  The span recorder,
the kernel families and the interval arithmetic are the benchmark's
(``portbench/trace.py``).  The Chrome traces go to ``chiprun_out/``.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.trace import SpanRecorder, kernel_family, length, union

HERE = os.path.dirname(os.path.abspath(__file__))


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
    return length(union(spans)), by_name


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
    beside = sum(max(0.0, min(b, kb) - max(a, ka))
                 for a, b in copies for ka, kb in union(kernels))
    return sum(b - a for a, b in copies), beside


def host_span_summary(recorder: SpanRecorder) -> dict:
    """Per span, from every thread: ms summed over its ranges, and ms of
    host wall time they cover (below the sum where rank threads ran it at
    once)."""
    by_name: dict = {}
    for name, _tid, a, b in recorder.ranges:
        by_name.setdefault(name, []).append((a, b))
    return {
        k: {"sum_ms": sum(b - a for a, b in v) * 1e3,
            "wall_ms": length(union(v)) * 1e3}
        for k, v in by_name.items()
    }


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
    # torch.profiler records the calling thread's ranges only; the
    # recorder times every thread's, the ranks of a local mesh included
    with torch.profiler.profile(activities=activities) as prof, (
        SpanRecorder()
    ) as host_spans:
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
        # every thread's spans on the host clock (span_ms has the calling
        # thread's only)
        "host_spans": host_span_summary(host_spans),
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
    from ahocorasick_rs_tpu_torch.parallel.sharded import make_mesh

    def sharded_calls(k: int | None) -> dict:
        """The four sharded calls with no mesh (every local card), or on
        a local mesh of k thread ranks sharing cuda:0, each warmed up:
        label -> (tier, matcher, call)."""
        mesh = None if k is None else make_mesh(devices=["cuda:0"] * k)
        suffix = "" if k is None else f"_local{k}"
        ts, sd, tb, sb = (
            port.AhoCorasick(
                names_s, matchkind=port.MatchKind.LeftmostLongest,
                implementation=port.Implementation.DFA, backend="sharded",
                mesh=mesh,
            ),
            port.AhoCorasick(
                names_s, implementation=port.Implementation.ContiguousNFA,
                backend="sharded", mesh=mesh,
            ),
            port.AhoCorasick(names_s, backend="sharded", mesh=mesh),
            port.AhoCorasick(names_s, backend="sharded", mesh=mesh),
        )
        sd._teddy_state = sb._teddy_state = "off"
        out = {}
        for tier, ac, call in (
            ("teddy_sharded", ts,
             lambda ac=ts: ac.find_matches_as_indexes(text)),
            ("sharded", sd, lambda ac=sd: ac.find_matches_as_indexes(
                text, overlapping=True)),
            ("teddy_sharded_batch", tb,
             lambda ac=tb: ac.find_matches_as_indexes_batch(long_batch)),
            ("sharded_batch", sb,
             lambda ac=sb: ac.find_matches_as_indexes_batch(long_batch)),
        ):
            call()  # tables, build, caps
            out[tier + suffix] = (tier, ac, call)
        torch.cuda.synchronize()
        return out

    # the local meshes' matchers are made after the other rows, so that
    # those rows run in the process state of the parent's
    sharded = sharded_calls(None)
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
    for k in (None, 2, 4):
        for label, (tier, ac, call) in (
            sharded if k is None else sharded_calls(k)
        ).items():
            rows.append(profile_path(label, call))
            if ac.stats()["last_backend"] != tier:
                raise SystemExit(f"the {label} matcher did not run {tier}")
            rows[-1]["ranks"] = ac._shard_group().size
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
