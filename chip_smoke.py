#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ahocorasick_rs_tpu_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version at the main
path's shapes (exact equality; all values are integers; K2's, K5's, K6's
and K7's states only where their masks are 1, K2 also at the sharded
ranks' layouts against its own single-device output, K5 at the LONG and
SHORT batches and a rank's row block, K6 also against K2 at its layout and
on the bailout's match-dense input, K7 also against K2 at its layout for
the names and for 100,000 names over 16 MiB; K3 at three caps and as one
kernel a call; K4, the whole Teddy verify body in one launch, against the
plain ``_verify_body`` in all four outputs at cap2 above and below the
total, at every piece count, on a sharded rank's padded buffer, and its
walk alone against the plain walk) and times both.
Then it drives every device path through the public API and checks every
answer against the port's own host tier: ``find_matches_as_indexes`` on a
64 MiB corpus with 1,000 name patterns (the upstream benchmark's LONG
recipe, made from a seed) through the Teddy pipeline, the stride-2 dense
scan, the one-byte dense scan (10,000 names, whose pair table is over
budget), the sparse engine and the match-dense bailout;
``find_matches_as_indexes_batch`` on the LONG batch (20,000 documents of
624-633 bytes) through the Teddy pipeline and the batch kernel, and on the
SHORT batch (10,000 documents of 72-75 bytes).  It also checks and times
the streamed Teddy pipeline (16 MiB segments staged on a side copy stream)
against one whole-buffer pass; runs the layout probe tool
(``ahocorasick_rs_tpu_torch.tools.probe_transpose_kernel``: P1 and P2 at
4 and 64 MiB, the 64 MiB transpose, K1 at every tile of its sweep);
``tune()`` on a 16 MiB slice, whose tuned matcher must agree with the host
tier; and ``save_matcher``/``load_matcher`` of the tuned matcher, whose
64 MiB call must equal the Teddy path's.  The sharded scan (K8) runs last: its per-rank
bodies are held against the same bodies on the CPU, then two gloo ranks
sharing the card and one NCCL rank (child processes of this script) make
the sharded Teddy, dense and batch calls through the public API with
``mesh=``, and every rank's tuples must equal the single-device port's.
Then the bench phase runs the benchmark tool
(``ahocorasick_rs_tpu_torch.tools.bench``) in this process at
``--scale`` :data:`BENCH_SCALE` over :data:`BENCH_SECTIONS`: its one JSON
line must parse, name the five north-star paths, show each GPU
measurement's kernels launched, and count what the host tier counts on
the same inputs.
Then the conformance phase runs the conformance tool
(``ahocorasick_rs_tpu_torch.tools.gpu_conformance``): its parts A and B
and the first :data:`CONFORMANCE_CASES` cases of its seeded sweep (seed
0), a fixed list, every device answer held to the host tier; a mismatch,
or a kernel the run never launched, fails it.
Last, the tools phase runs the JAX package's other tools as the port has
them, each through its entry function: ``multihost_run`` with two gloo
ranks sharing the card, then one NCCL rank, at :data:`TOOLS_MIB` MiB (every
rank's digests equal to the host tier's, and every rank launched the
kernels of the sharded tiers it ran); ``scaling_bench`` at one and
two ranks (pairs equal to the host tier's, the sharded kernels launched
in every rank); both harnesses against the upstream binaries in
``--self-test`` (the conformance harness with ours on the device tier);
and ``fuzz_differential`` for :data:`FUZZ_SECONDS` s from a fixed seed.
The three runs that start ranks overlap the other three tools.

Output: progress lines, the card's name and power limit as ``nvidia-smi``
reports them, one ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero.  Without
a CUDA card, or without the package beside it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
CORPUS_MIB = 64
PATTERNS = 1000
#: name count of the one-byte dense path: its pair table exceeds the
#: classed engine's 64 MiB stride-2 budget
PATTERNS_K2 = 10_000
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: ranks of the sharded phase's gloo run (they share the one card)
SHARD_RANKS = 2
#: seconds a spawned sharded run may take before it fails
SHARD_TIMEOUT_S = 400
#: haystack bytes of the tune() phase (a slice of the names corpus)
TUNE_MIB = 16
#: segment bytes of the streamed Teddy phase (four segments of 64 MiB)
STREAM_SEG_MIB = 16
#: rows of the layout probes' 4 MiB arrays (the reference's 32 blocks)
PROBE_SMALL_ROWS = 32 * 1024
#: shared-memory carveouts the lane scans (K2, K5, K6) are also timed at:
#: percents of an SM's 228 KB of shared memory at its supported splits
#: with L1 (64, 100, 132, 164, 196 and 228 KB of shared memory)
CARVEOUTS = (28, 43, 57, 71, 85, 100)
#: bytes of 'a' the match-dense bailout scans (and K6 is checked on)
BAILOUT_MIB = 16
#: K1 prefilter shapes (m, words, passes) checked besides the names' own
K1_CONFIGS = ((8, 8, 2), (3, 1, 1))
#: K7's large-set case: names (seed 1) and corpus MiB, whose sparse
#: tables outgrow the L1 (the engine exists for sets larger still)
K7_BIG_PATTERNS = 100_000
K7_BIG_MIB = 16
#: part C cases of the conformance phase: the first of seed 0, a fixed
#: list (parts A and B, whose nested-pattern corpus resolves millions of
#: occurrences on the host, take most of the phase)
CONFORMANCE_CASES = 25
#: traces :func:`profiled` takes again after one with no kernel event at
#: all (``torch.profiler`` returned such a trace once in two full runs of
#: the ``gpu`` tests on an H100)
TRACE_RETRIES = 3
#: the bench phase: the bench tool's ``--scale`` and ``--sections``
BENCH_SCALE = 16
BENCH_SECTIONS = ("north_star", "scenarios", "match_dense",
                  "sparse_device_forced")
#: the tools phase: multihost_run's haystack MiB, the fuzzer's seconds
#: and seed, the competitor bench's LONG haystacks, and the conformance
#: harness's minimums
TOOLS_MIB = 16
FUZZ_SECONDS = 10
FUZZ_SEED = 0
TOOLS_LONG_HAYSTACKS = 2000
TOOLS_MIN_CHECKS = ("--min-tuple-checks", "2000", "--min-list-checks",
                    "1000", "--dense-cases", "2")
#: the kernels every scaling_bench rank must launch on the card
SCALING_KERNELS = ("lane_scan", "lane_scan_head", "compact", "shard_body")
#: the kernels each GPU measurement of the bench's north star must launch
BENCH_KERNELS = {
    "gpu_plain": ("lane_scan", "compact"),
    "gpu_stride2": ("stride2_scan", "compact"),
    "gpu_teddy": ("fire", "compact", "verify"),
}


def batch_layout(docs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """The padded ``[Bb, T]`` buffer and lens that scan_device_batch
    stages for ``docs`` (powers of two, at least 8 rows and 16 columns)."""
    T = 1 << (max(max(len(d) for d in docs), 16) - 1).bit_length()
    Bb = 1 << (max(len(docs), 8) - 1).bit_length()
    buf = np.zeros((Bb, T), dtype=np.uint8)
    lens = np.zeros(Bb, dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lens[i] = len(d)
    return buf, lens


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    require(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def lane_scan_err(got, want) -> int:
    """K2's contract: max |difference| of the masks, and of the states
    where the wanted mask is 1 (the kernel writes states nowhere else)."""
    (st, mask), (st_p, mask_p) = got, want
    hit = mask_p.bool()
    return max(max_abs_err(mask, mask_p), max_abs_err(st[hit], st_p[hit]))


def by_carveout(kernel, S: int, args: tuple) -> dict:
    """A lane scan's time (``_kernels._*_at`` with sub-lanes of ``S``
    bytes) at each of :data:`CARVEOUTS`; the kernel's own is its ``ms``."""
    return {c: cuda_ms(lambda: kernel(S, *args, carveout=c), 5)
            for c in CARVEOUTS}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def profiled(fn, reps: int = 20, only: str | None = None
             ) -> tuple[float, float]:
    """CUDA kernels a call of ``fn`` runs (copies and fills left out) and
    their device time a call (ms), from ``torch.profiler`` over ``reps``
    calls after a warm-up call: the kernel's own time, which ``cuda_ms``
    cannot give where the host takes longer to launch it than the card to
    run it.  With ``only``, a call must run that one kernel: every kernel
    seen is it, and it is seen at most ``reps`` times.  The profiler can
    lose the record of a kernel of a few microseconds (one of twenty in a
    run on an H100), so fewer than one a call is a lost record, not a
    missing launch; the launch counters check the launches.  It has also
    returned a trace with no kernel event at all: such a trace is taken
    again, at most :data:`TRACE_RETRIES` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(1 + TRACE_RETRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if found:
            break
    require(found, f"the profiler saw no kernel in {1 + TRACE_RETRIES} "
                   "traces")
    if only is not None:
        names = sorted({e.name for e in found})
        require(all(only in name for name in names) and len(found) <= reps,
                f"{len(found)} kernels in {reps} calls, not one {only} a "
                f"call: {names}")
    us = sum(e.time_range.end - e.time_range.start for e in found)
    return len(found) / reps, us / reps / 1e3


def tables_bytes(t) -> int:
    """Bytes of a ``DeviceTables``' transition table, byte classes and
    match counts."""
    return sum(x.numel() * x.element_size()
               for x in (t.table, t.classes, t.match_count))


def unfused_body(scan_teddy, walk, compact, v_args, cap2, use_classes):
    """The verify body composed of separate launches, as ``_verify_body``
    composes it on the CPU: ``walk`` (the packed walk [M, W]), the
    matched-step compare, ``compact`` (K3 or its plain version) and the
    gathers."""
    W = v_args[5]
    packed = walk(*v_args, use_classes)
    matched = packed.reshape(-1) >= (1 << scan_teddy.FLAG_SHIFT)
    sel, total = compact(matched.view(torch.uint8), cap2)
    win = torch.where(sel >= 0, sel // W, -1)
    step = torch.where(sel >= 0, sel % W, 0)
    st = packed.reshape(-1)[sel.clamp(min=0).long()] & (
        (1 << scan_teddy.FLAG_SHIFT) - 1)
    return win, step, st, total


def plain_body_check(scan_teddy, v_args, cap2, use_classes) -> dict:
    """K4 (``_verify_body`` on the card, one launch) against the plain
    ``_verify_body`` on CPU copies of the same inputs, all four outputs
    bit-equal: at ``cap2`` grown as ``TeddyScanner.occurrences`` grows it
    (above the total) and at half the total (below it)."""
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in v_args)

    def err_at(c: int):
        got = scan_teddy._verify_body(*v_args, c, use_classes)
        want = scan_teddy._verify_body(*cpu, c, use_classes)
        return got, int(want[3]), max(max_abs_err(a.cpu(), b)
                                      for a, b in zip(got, want))

    got, total, err = err_at(cap2)
    while total > cap2:
        cap2 = scan_teddy._bucket(total)
        got, total, err = err_at(cap2)
    below = max(total // 2, 1)
    err_below = err_at(below)[2] if total > 1 else 0
    require(err == 0 and err_below == 0,
            f"K4 differs from the plain _verify_body ({err} at cap2 {cap2}, "
            f"{err_below} at {below})")
    return {"got": got, "cap2": cap2, "total": total, "below": below,
            "max_abs_err": max(err, err_below)}


def phase_kernels(dev, names, corpus, long_batch) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
    from ahocorasick_rs_tpu_torch.models.prefilter import (
        build_prefilter,
        build_prefilter_config,
    )
    from ahocorasick_rs_tpu_torch.ops import probe, scan_cuda, scan_teddy
    from ahocorasick_rs_tpu_torch.parallel import sharded
    from ahocorasick_rs_tpu_torch.tools._synth import (
        short_case,
        synth_corpus,
        synth_names,
    )
    from ahocorasick_rs_tpu_torch.tools.probe_transpose_kernel import (
        SWEEP_TILES,
    )

    am = build_automaton(names)
    pf = build_prefilter(names)
    require(pf is not None, "no prefilter for the name set")
    n = len(corpus)
    out = {}

    # K1: fire mask over the staged corpus, DFA tables (the Teddy path),
    # through the scanner's packed tables
    dfa = scan_cuda.DeviceTables(am, "dfa", dev)
    sc = scan_teddy.TeddyScanner(am, pf, dfa)
    hay2d = sc.stage(corpus)
    fire_args = (sc.tables, hay2d, sc.m, sc.words, sc.passes)
    kfire_args = (sc.packed, *fire_args[1:])
    got = _kernels.fire(*kfire_args)
    want = scan_teddy._fire_mask_plain(*fire_args)
    err = max_abs_err(got, want)
    require(err == 0, f"K1 fire differs from its plain version ({err})")
    # the mask does not depend on the tile a block stages
    for tile in SWEEP_TILES:
        tile_err = max_abs_err(
            _kernels.fire(*kfire_args, tile=tile), want
        )
        require(tile_err == 0, f"K1 at tile {tile} differs from its plain "
                               f"version ({tile_err})")
    N = hay2d.numel()

    def fire_bound(s) -> float:
        # haystack read, mask written, packed tables read
        return bound_ms(2 * N + 4 * s.packed.numel())

    # the other prefilter shapes (8 planes; one plane, one pass) on the
    # same staged corpus
    configs = {}
    for shape in K1_CONFIGS:
        sc_k = scan_teddy.TeddyScanner(
            am, build_prefilter_config(names, *shape), dfa
        )
        args_k = (sc_k.tables, hay2d, *shape)
        got_k = _kernels.fire(sc_k.packed, *args_k[1:])
        err_k = max_abs_err(got_k, scan_teddy._fire_mask_plain(*args_k))
        require(err_k == 0, f"K1 at {shape} differs from its plain version "
                            f"({err_k})")
        configs[",".join(map(str, shape))] = {
            "max_abs_err": err_k,
            "ms": cuda_ms(
                lambda: _kernels.fire(sc_k.packed, *args_k[1:]), 10
            ),
            "bound_ms": fire_bound(sc_k),
            "fire_rate": float(got_k.float().mean()),
        }
        err = max(err, err_k)
    out["fire"] = {
        "shape": f"hay uint8 {list(hay2d.shape)}, tables int32 "
                 f"{list(sc.tables.shape)}, packed int32 "
                 f"{list(sc.packed.shape)}, m={sc.m} words={sc.words} "
                 f"passes={sc.passes}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.fire(*kfire_args), 10),
        "plain_ms": cuda_ms(
            lambda: scan_teddy._fire_mask_plain(*fire_args), 2
        ),
        "bound_ms": fire_bound(sc),
        "bound_by": "bytes",
        "library_ms": None,
        "fire_rate": float(got.float().mean()),
        "tiles_equal": list(SWEEP_TILES),
        "configs": configs,
    }

    # K3 on the Teddy path's shape: the COARSE group mask
    mask = got.reshape(-1)
    G = N // scan_teddy.COARSE
    fired = (mask.view(G, scan_teddy.COARSE).amax(dim=1) != 0) & (
        torch.arange(G, device=dev) * scan_teddy.COARSE < n
    )
    fired_u8 = fired.view(torch.uint8)
    cap = sc.fire_cap
    fg, ftotal = _kernels.compact(fired_u8, cap)
    fg_p, ftotal_p = scan_cuda._compact_plain(fired_u8, cap)
    require(int(ftotal) == int(ftotal_p), "K3 total differs (groups)")
    require(torch.equal(fg, fg_p), "K3 indexes differ (groups)")
    ftotal = int(ftotal)
    while ftotal > cap:  # as TeddyScanner.occurrences grows its cap
        cap = scan_teddy._bucket(ftotal)
        fg, _ = _kernels.compact(fired_u8, cap)
    groups_ms = cuda_ms(lambda: _kernels.compact(fired_u8, cap), 20)
    groups_shape = f"mask uint8 [{G}] ({ftotal} true), cap={cap}"
    cap_g = cap
    groups_per_call, groups_dev_ms = profiled(
        lambda: _kernels.compact(fired_u8, cap_g), only="compact_kernel")

    # K4: the whole verify body in one launch over the fired windows, W =
    # max_len + COARSE - 1, each window cut into the planned pieces; held
    # bit-equal (all four outputs, padding too) to the plain _verify_body
    # on CPU copies of the same inputs, at cap2 above and below the total
    W = am.max_len + scan_teddy.COARSE - 1
    halo = am.max_len - 1
    fire_pos = torch.where(fg >= 0, fg * scan_teddy.COARSE, -1)
    flat = hay2d.reshape(-1)
    v_args = (sc.vtable, sc.classes, flat, fire_pos, n, W)
    k4 = plain_body_check(scan_teddy, v_args, sc.match_cap, sc.use_classes)
    cap2 = k4["cap2"]
    body_args = (*v_args, cap2, sc.use_classes)
    pieces = _kernels.plan_pieces(cap, W, halo, _kernels.sm_count(dev))
    before = dict(_kernels.LAUNCHES)
    scan_teddy._verify_body(*body_args)
    require(_kernels.LAUNCHES["verify"] == before["verify"] + 1
            and _kernels.LAUNCHES["compact"] == before["compact"],
            "a _verify_body call is not one verify launch and no compact")
    # the walk-only instantiation, at the main path's pieces and at one
    want_walk = scan_teddy._verify_walk_plain(*v_args, sc.use_classes)
    walk_err = max(
        max_abs_err(_kernels.verify(*v_args, sc.use_classes, halo=halo,
                                    pieces=k), want_walk)
        for k in (1, pieces)
    )
    require(walk_err == 0, f"K4's walk differs from the plain walk "
                           f"({walk_err})")
    # a sharded rank's hay_pad (shard, the right neighbour's head, VCHUNK
    # zeros), with a window ending at its last byte
    rows, Hr = sharded.teddy_layout(n, SHARD_RANKS, W)
    LT = rows * 128
    hay_pad = torch.cat([flat[:LT], flat[LT : LT + Hr],
                         flat.new_zeros(scan_teddy.VCHUNK)])
    fp_pad = torch.where((fire_pos >= 0) & (fire_pos < LT), fire_pos, -1)
    fp_pad[-1] = hay_pad.numel() - W
    pad_err = plain_body_check(
        scan_teddy, (sc.vtable, sc.classes, hay_pad, fp_pad,
                     hay_pad.numel(), W), sc.match_cap, sc.use_classes,
    )["max_abs_err"]
    require(pad_err == 0, f"K4 on a sharded hay_pad differs ({pad_err})")
    # one window (the first fired one) cut into the planned pieces, and
    # walked whole: a piece's chain of L steps and the window's of W, the
    # floors of this design and of one thread a window (device time)
    one = (sc.vtable, sc.classes, flat, fire_pos[:1].contiguous(), n, W,
           cap2, sc.use_classes)
    by_pieces, dev_by_pieces = {}, {}
    for k in range(1, 9):
        got_k = _kernels.verify_body(*body_args, halo=halo, pieces=k)
        require(max(max_abs_err(a, b) for a, b in zip(got_k, k4["got"]))
                == 0, f"K4 at {k} pieces differs")
        by_pieces[k] = cuda_ms(
            lambda: _kernels.verify_body(*body_args, halo=halo, pieces=k),
            20)
        dev_by_pieces[k] = profiled(
            lambda: _kernels.verify_body(*body_args, halo=halo, pieces=k))[1]
    walk_k1 = (*v_args, sc.use_classes)
    per_call, body_dev_ms = profiled(
        lambda: scan_teddy._verify_body(*body_args), only="verify_kernel")
    unfused = (scan_teddy, _kernels.verify, _kernels.compact, v_args, cap2,
               sc.use_classes)
    unfused_per_call, unfused_dev_ms = profiled(
        lambda: unfused_body(*unfused))
    out["verify"] = {
        "shape": f"fire_pos int32 [{cap}] ({ftotal} windows), W={W}, "
                 f"halo={halo}, {pieces} pieces of "
                 f"{_kernels.verify_split(W, halo, pieces)[0]} steps, cap2="
                 f"{cap2} ({k4['total']} matched steps), vtable int32 "
                 f"{list(sc.vtable.shape)}",
        "max_abs_err": max(k4["max_abs_err"], walk_err, pad_err),
        "cap2_below_total": k4["below"],
        "pieces": pieces,
        # back-to-back calls (CUDA events), which the host's launch rate
        # bounds, then the kernels' own time (torch.profiler)
        "ms": cuda_ms(lambda: scan_teddy._verify_body(*body_args), 20),
        "device_ms": body_dev_ms,
        "kernels_per_call": per_call,
        # the parent's composition on the card: the walk kernel writing
        # [cap, W], the compare, K3, the gathers
        "unfused_ms": cuda_ms(lambda: unfused_body(*unfused), 20),
        "unfused_device_ms": unfused_dev_ms,
        "unfused_kernels_per_call": unfused_per_call,
        "walk_ms": cuda_ms(lambda: _kernels.verify(*walk_k1), 20),
        "walk_device_ms": profiled(lambda: _kernels.verify(*walk_k1))[1],
        "ms_by_pieces": by_pieces,
        "device_ms_by_pieces": dev_by_pieces,
        "piece_chain_ms": profiled(
            lambda: _kernels.verify_body(*one, halo=halo, pieces=pieces))[1],
        "window_chain_ms": profiled(
            lambda: _kernels.verify_body(*one, halo=halo, pieces=1))[1],
        # the plain composition on the card: the plain walk and plain K3
        "plain_ms": cuda_ms(lambda: unfused_body(
            scan_teddy, scan_teddy._verify_walk_plain,
            scan_cuda._compact_plain, v_args, cap2, sc.use_classes), 2),
        # the 16-byte pieces of each real window and the fire positions
        # read, three int32 a cap2 entry and the total written; tables
        # left out (which rows a walk touches depends on the data, and
        # they stay in L2)
        "bound_ms": bound_ms(ftotal * 16 * -(-W // 16) + 4 * cap
                             + 12 * cap2 + 4),
        "bound_by": "bytes",
        "library_ms": None,
    }

    # K2: lane scan at the dense path's layout, classed tables (the dense
    # phase runs ContiguousNFA); the contract is the mask bit-equal and
    # the states equal where it is 1
    cls = scan_cuda.DeviceTables(am, "classed", dev)
    flagged = cls.lane_table()
    halo = am.max_len - 1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = corpus
    hay = torch.from_numpy(buf).to(dev)
    k2_args = (cls.table, cls.classes, hay, cls.match_count, n, L, T, halo,
               cls.use_classes)
    kk2_args = (flagged, cls.classes, hay, n, L, T, halo, cls.use_classes)
    st, lm = _kernels.lane_scan(*kk2_args)
    want = scan_cuda._lane_scan_plain(*k2_args)
    err = lane_scan_err((st, lm), want)
    require(err == 0, f"K2 lane scan differs from its plain version ({err})")
    # K2 with a neighbour's head (the sharded scan): an all-PAD head
    # equals none, and the corpus's last bytes as a head equal the plain
    # version
    pad = torch.full((halo,), 256, dtype=torch.int32, device=dev)
    require(lane_scan_err(
        _kernels.lane_scan(*kk2_args, head=pad), (st, lm)
    ) == 0, "K2 with a PAD head differs from K2")
    head = torch.from_numpy(corpus[-halo:].astype(np.int32)).to(dev)
    got = _kernels.lane_scan(*kk2_args, head=head)
    want = scan_cuda._lane_scan_plain(*k2_args, head=head)
    head_err = lane_scan_err(got, want)
    require(head_err == 0, f"K2 with a head differs from its plain version "
                           f"({head_err})")
    err = max(err, head_err)
    matches = int(lm.sum(dtype=torch.int64))

    def k2_bound(nbytes: int, hits: int) -> float:
        # haystack read, mask written, a state at each match, the flagged
        # table and the classes read
        return bound_ms(2 * nbytes + 4 * hits + 4 * (flagged.numel() + 257))

    # the sharded rank layouts over the same corpus, held against the
    # kernel's own single-device output: two ranks of 512 lanes (the
    # second half with the first half's tail as its head), one of 512
    idx1, tot1 = _kernels.compact(lm, 1 << 16)
    require(int(tot1) == matches, "K3 total differs from the mask's count")
    layouts = {"single": {
        "L": L, "T": T, "S": _kernels.plan_sublanes(
            L, T, halo, _kernels.sm_count(dev)),
        "ms": cuda_ms(lambda: _kernels.lane_scan(*kk2_args), 5),
        "bound_ms": k2_bound(L * T, matches),
    }}
    require(L * T == n, "the corpus does not fill the single-device layout")
    for ranks in (2, 1):
        Ls, Ts = sharded.dense_layout(n, ranks, halo)
        LT = Ls * Ts
        parts, masks, idxs = [], [], []
        for d in range(ranks):
            shard = hay[d * LT : (d + 1) * LT]
            n_d = min(max(n - d * LT, 0), LT)
            h = (sharded.shard_tail(hay[(d - 1) * LT : d * LT], n - (d - 1)
                                    * LT, halo) if d else pad)
            a = (flagged, cls.classes, shard, n_d, Ls, Ts, halo,
                 cls.use_classes)
            st_d, m_d = _kernels.lane_scan(*a, head=h)
            masks.append(m_d)
            i_d, _ = _kernels.compact(m_d, 1 << 16)
            idxs.append(torch.where(i_d >= 0, i_d + d * LT, -1))
            parts.append((a, h, st_d, m_d))
        m_all = torch.cat(masks)
        require(torch.equal(m_all, lm), f"K2 mask at {ranks} rank(s) of "
                                        f"{Ls} lanes differs")
        hit = lm.bool()
        st_all = torch.cat([p[2] for p in parts])
        require(torch.equal(st_all[hit], st[hit]),
                f"K2 states at {ranks} rank(s) differ at the mask")
        got_idx = torch.cat(idxs)
        got_idx = got_idx[got_idx >= 0]
        require(torch.equal(got_idx, idx1[: matches]),
                f"K3 lists at {ranks} rank(s) differ")
        a, h = parts[-1][0], parts[-1][1]
        layouts[f"ranks{ranks}"] = {
            "L": Ls, "T": Ts, "S": _kernels.plan_sublanes(
                Ls, Ts, halo, _kernels.sm_count(dev)),
            "ms": cuda_ms(
                lambda: _kernels.lane_scan(*a, head=h), 5
            ),
            "bound_ms": k2_bound(LT, int(parts[-1][3].sum(dtype=torch.int64))),
        }
    S = layouts["single"]["S"]
    one_lane = (flagged, cls.classes, hay[:T].contiguous(), T, 1, T, halo,
                cls.use_classes)
    one_sub = (flagged, cls.classes, hay[:S].contiguous(), S, 1, S, halo,
               cls.use_classes)
    out["lane_scan"] = {
        "shape": f"L={L} T={T} halo={halo} S={S}, table int32 "
                 f"{list(cls.table.shape)} (flagged)",
        "max_abs_err": err,
        "ms": layouts["single"]["ms"],
        "plain_ms": cuda_ms(lambda: scan_cuda._lane_scan_plain(*k2_args), 1),
        "bound_ms": layouts["single"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "matches": matches,
        "layouts": layouts,
        # one lane walked by one thread: T + halo dependent table loads in
        # a row, the floor of a walk per caller lane
        "dep_chain_ms": cuda_ms(
            lambda: _kernels._lane_scan_at(T, *one_lane), 20),
        # one sub-lane: S + halo dependent loads, this design's floor
        "sub_chain_ms": cuda_ms(
            lambda: _kernels._lane_scan_at(S, *one_sub), 20),
        "ms_by_carveout": by_carveout(_kernels._lane_scan_at, S, kk2_args),
    }

    # K3 on the dense path's shape: the lane scan's match mask, at the
    # sticky starting cap and at caps the retry path grows to (the padding
    # blocks write -1 past the total)
    cap = cls.last_cap
    idx, total = _kernels.compact(lm, cap)
    idx_p, total_p = scan_cuda._compact_plain(lm, cap)
    require(int(total) == int(total_p), "K3 total differs (lanes)")
    err = max_abs_err(idx, idx_p)
    require(err == 0, f"K3 compact differs from its plain version ({err})")
    per_call, dev_ms = profiled(lambda: _kernels.compact(lm, cap),
                                only="compact_kernel")
    ms_by_cap = {}
    for big in (1 << 17, 1 << 23):
        idx_b, total_b = _kernels.compact(lm, big)
        want_b = scan_cuda._compact_plain(lm, big)
        require(int(total_b) == int(want_b[1]) and torch.equal(idx_b,
                                                               want_b[0]),
                f"K3 at cap {big} differs from its plain version")
        ms_by_cap[big] = {
            "ms": cuda_ms(lambda: _kernels.compact(lm, big), 20),
            "device_ms": profiled(lambda: _kernels.compact(lm, big))[1],
            "bound_ms": bound_ms(lm.numel() + 4 * big + 4),
        }
    out["compact"] = {
        "shape": f"mask uint8 [{lm.numel()}] ({int(total)} true), cap={cap}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.compact(lm, cap), 20),
        "plain_ms": cuda_ms(lambda: scan_cuda._compact_plain(lm, cap), 2),
        "bound_ms": bound_ms(lm.numel() + 4 * cap + 4),
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.nonzero(lm), 20),
        "groups_shape": groups_shape,
        "groups_ms": groups_ms,
        "groups_device_ms": groups_dev_ms,
        "groups_kernels_per_call": groups_per_call,
        "groups_bound_ms": bound_ms(G + 4 * cap_g + 4),
        "ms_by_cap": ms_by_cap,
        "kernels_per_call": per_call,
        "device_ms": dev_ms,
    }

    # K6: stride-2 scan at the dense path's layout, classed tables (the
    # dense phase runs ContiguousNFA; its 19.6 MiB pair table fits the
    # 64 MiB budget), halo rounded up to even.  K2's contract: the mask
    # bit-equal and the states equal where it is 1, against the plain
    # version and against K2 at the same layout and halo
    require(cls.ensure_packed2(), "the pair table of the names does not fit")
    halo2 = halo + (halo & 1)
    L2, T2 = scan_cuda.choose_layout(n, halo2)
    buf2 = np.zeros(L2 * T2, dtype=np.uint8)
    buf2[:n] = corpus
    hay2 = torch.from_numpy(buf2).to(dev)
    k6_args = (cls.packed2, cls.table_classed, cls.classes2, hay2, n, L2, T2,
               halo2)
    got6 = _kernels.stride2_scan(*k6_args)
    err = lane_scan_err(got6, scan_cuda._stride2_scan_plain(*k6_args))
    require(err == 0, f"K6 stride-2 scan differs from its plain version "
                      f"({err})")
    k2_same = _kernels.lane_scan(flagged, cls.classes, hay2, n, L2, T2, halo2,
                                 cls.use_classes)
    require(lane_scan_err(got6, k2_same) == 0,
            "K6 differs from K2 at the same layout and halo")
    hits6 = int(got6[1].sum(dtype=torch.int64))
    # the bailout input: 64 nested patterns over 16 MiB of 'a' (DFA, the
    # bailout phase's engine), a match at almost every position
    dense_am = build_automaton([b"a" * k for k in range(1, 65)])
    bail = scan_cuda.DeviceTables(dense_am, "dfa", dev)
    require(bail.ensure_packed2(), "the bailout's pair table does not fit")
    nb = BAILOUT_MIB << 20
    halo_b = dense_am.max_len - 1
    halo_b += halo_b & 1
    Lb, Tb = scan_cuda.choose_layout(nb, halo_b)
    hay_b = torch.full((Lb * Tb,), ord("a"), dtype=torch.uint8, device=dev)
    b6_args = (bail.packed2, bail.table_classed, bail.classes2, hay_b, nb, Lb,
               Tb, halo_b)
    got_b = _kernels.stride2_scan(*b6_args)
    bail_err = lane_scan_err(got_b, scan_cuda._stride2_scan_plain(*b6_args))
    require(bail_err == 0, f"K6 on the bailout input differs from its plain "
                           f"version ({bail_err})")
    bail_hits = int(got_b[1].sum(dtype=torch.int64))
    require(bail_hits > nb * 9 // 10,
            f"the bailout input matched at only {bail_hits} positions")
    err = max(err, bail_err)
    S2 = _kernels.plan_sublanes(L2, T2, halo2, _kernels.sm_count(dev))
    one_lane2 = (cls.packed2, cls.table_classed, cls.classes2,
                 hay2[:T2].contiguous(), T2, 1, T2, halo2)
    # two sub-lanes of one lane: the second walks its halo and its S bytes
    two_sub2 = (cls.packed2, cls.table_classed, cls.classes2,
                hay2[: 2 * S2].contiguous(), 2 * S2, 1, 2 * S2, halo2)

    def k6_bound(nbytes: int, hits: int, t) -> float:
        # haystack read, mask written, a state at each match, the pair
        # table, the classed table and the classes read
        return bound_ms(2 * nbytes + 4 * hits + 4 * (
            t.packed2.numel() + t.table_classed.numel() + 257))

    out["stride2_scan"] = {
        "shape": f"L={L2} T={T2} halo={halo2} S={S2}, packed2 int32 "
                 f"{list(cls.packed2.shape)}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.stride2_scan(*k6_args), 5),
        "plain_ms": cuda_ms(
            lambda: scan_cuda._stride2_scan_plain(*k6_args), 1
        ),
        "bound_ms": k6_bound(L2 * T2, hits6, cls),
        "bound_by": "bytes",
        "library_ms": None,
        "matches": hits6,
        "k2_same_layout_ms": cuda_ms(
            lambda: _kernels.lane_scan(flagged, cls.classes, hay2, n, L2, T2,
                                       halo2, cls.use_classes), 5),
        "bailout": {
            "shape": f"L={Lb} T={Tb} halo={halo_b}, packed2 int32 "
                     f"{list(bail.packed2.shape)}",
            "matches": bail_hits,
            "ms": cuda_ms(lambda: _kernels.stride2_scan(*b6_args), 5),
            "bound_ms": k6_bound(Lb * Tb, bail_hits, bail),
        },
        # one lane walked by one thread: (T + halo) / 2 dependent pair
        # loads, the floor of a walk per caller lane
        "dep_chain_ms": cuda_ms(
            lambda: _kernels._stride2_scan_at(T2, *one_lane2), 20
        ),
        # one sub-lane: (S + halo) / 2 dependent pair loads
        "sub_chain_ms": cuda_ms(
            lambda: _kernels._stride2_scan_at(S2, *two_sub2), 20
        ),
        "ms_by_carveout": by_carveout(_kernels._stride2_scan_at, S2,
                                      k6_args),
    }

    # K5: the batch kernel at the LONG batch's layout, DFA tables (the
    # batch phases run the default DFA engine), then at the SHORT batch's
    # and at one sharded rank's row block (a view into the LONG buffer);
    # K2's contract at each
    def k5_case(t, docs: list[bytes], rows=None) -> dict:
        buf, lens = batch_layout(docs)
        hay_d = torch.from_numpy(buf).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        if rows is not None:
            hay_d, lens_d = hay_d[:rows], lens_d[:rows]
        plain = (t.table, t.classes, hay_d, lens_d, t.match_count,
                 t.use_classes)
        kern = (t.lane_table(), t.classes, hay_d, lens_d, t.halo,
                t.use_classes)
        got = _kernels.batch_scan(*kern)
        case_err = lane_scan_err(got, scan_cuda._batch_scan_plain(*plain))
        B, T = hay_d.shape
        hits = int(got[1].sum(dtype=torch.int64))
        return {
            "B": B, "T": T, "halo": t.halo, "S": _kernels.batch_sublanes(
                B, T, t.halo, _kernels.sm_count(dev)),
            "max_abs_err": case_err, "matches": hits,
            "real_bytes": int(lens_d.sum(dtype=torch.int64)),
            "plain": plain, "kern": kern, "got": got,
        }

    def k5_bound(c: dict, t) -> float:
        # the real bytes read, the mask written, a state at each match,
        # lens, the flagged table and the classes read
        return bound_ms(c["real_bytes"] + c["B"] * c["T"] + 4 * c["matches"]
                        + 4 * c["B"] + 4 * (t.lane_table().numel() + 257))

    long_b = [d.encode() for d in long_batch]
    short_patterns, short_batch = short_case()
    short_am = build_automaton([p.encode() for p in short_patterns])
    short_t = scan_cuda.DeviceTables(short_am, "dfa", dev)
    cases = {
        "long": (dfa, k5_case(dfa, long_b)),
        "short": (short_t, k5_case(short_t, [d.encode() for d in short_batch])),
    }
    Bb_r, T_r = sharded.batch_layout([len(d) for d in long_b], SHARD_RANKS)
    cases["rank"] = (dfa, k5_case(dfa, long_b, rows=Bb_r // SHARD_RANKS))
    long_c = cases["long"][1]
    rank_c = cases["rank"][1]
    # the rank's rows equal the same rows of the whole-buffer launch
    rows_n = rank_c["B"] * rank_c["T"]
    hit = long_c["got"][1][:rows_n].bool()
    require(torch.equal(rank_c["got"][1], long_c["got"][1][:rows_n]) and
            torch.equal(rank_c["got"][0][hit], long_c["got"][0][:rows_n][hit]),
            "K5 on a rank's row block differs from the whole batch")
    layouts5 = {}
    for key, (t, c) in cases.items():
        require(c["max_abs_err"] == 0, f"K5 batch scan ({key}) differs from "
                                       f"its plain version "
                                       f"({c['max_abs_err']})")
        kern = c["kern"]
        layouts5[key] = {
            "B": c["B"], "T": c["T"], "halo": c["halo"], "S": c["S"],
            "matches": c["matches"], "real_bytes": c["real_bytes"],
            "ms": cuda_ms(lambda: _kernels.batch_scan(*kern), 5),
            "bound_ms": k5_bound(c, t),
        }
    B5, T5, S5 = long_c["B"], long_c["T"], long_c["S"]
    hay5, lens5_d = long_c["kern"][2], long_c["kern"][3]
    one_row = (dfa.lane_table(), dfa.classes, hay5[:1].contiguous(),
               lens5_d[:1].contiguous(), dfa.halo, dfa.use_classes)
    # two sub-lanes of one full row: the second walks its halo and S bytes
    two_sub5 = (dfa.lane_table(), dfa.classes, hay5[:1, : 2 * S5].contiguous(),
                torch.full((1,), 2 * S5, dtype=torch.int32, device=dev),
                dfa.halo, dfa.use_classes)
    out["batch_scan"] = {
        "shape": f"hay2d uint8 [{B5}, {T5}] ({len(long_batch)} real rows), "
                 f"halo={dfa.halo} S={S5}, table int32 "
                 f"{list(dfa.table.shape)} (flagged)",
        "max_abs_err": max(c["max_abs_err"] for _, c in cases.values()),
        "ms": layouts5["long"]["ms"],
        "plain_ms": cuda_ms(
            lambda: scan_cuda._batch_scan_plain(*long_c["plain"]), 1),
        "bound_ms": layouts5["long"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "matches": long_c["matches"],
        "layouts": layouts5,
        # one row alone, walked by one thread: its lens[0] dependent loads
        "dep_chain_ms": cuda_ms(
            lambda: _kernels._batch_scan_at(T5, *one_row), 20),
        # one sub-lane: halo + S dependent loads
        "sub_chain_ms": cuda_ms(
            lambda: _kernels._batch_scan_at(S5, *two_sub5), 20),
        "ms_by_carveout": by_carveout(_kernels._batch_scan_at, S5,
                                      long_c["kern"]),
    }

    # K7: the sparse scan at the sparse path's layout (K2's: the same
    # halo), over its derived tables; K2's contract against its plain
    # version (which walks every failure link of every lane in a
    # vectorised loop) and against K2 over the classed table of the same
    # automaton at the same layout; then the same against K2 for 100,000
    # names over 16 MiB, whose tables no longer fit in L1
    sp = scan_cuda.DeviceTables(am, "sparse", dev)
    k7_args = (sp.sparse, hay, n, L, T, halo)
    got7 = _kernels.sparse_scan(*k7_args)
    err = lane_scan_err(got7, scan_cuda._sparse_scan_plain(*k7_args))
    require(err == 0, f"K7 sparse scan differs from its plain version "
                      f"({err})")
    require(lane_scan_err(got7, (st, lm)) == 0,
            "K7 differs from K2 at the same layout and halo (names)")
    plain7_ms = cuda_ms(
        lambda: scan_cuda._sparse_scan_plain(*k7_args), 1, warmup=0
    )
    big_names = synth_names(K7_BIG_PATTERNS, np.random.default_rng(SEED + 1))
    big_n = K7_BIG_MIB << 20
    big_corpus = synth_corpus(big_n, big_names,
                              np.random.default_rng(SEED + 1))
    big_am = build_automaton(big_names)
    big_sp = scan_cuda.DeviceTables(big_am, "sparse", dev)
    big_cls = scan_cuda.DeviceTables(big_am, "classed", dev)
    big_halo = big_am.max_len - 1
    Lb7, Tb7 = scan_cuda.choose_layout(big_n, big_halo)
    buf7 = np.zeros(Lb7 * Tb7, dtype=np.uint8)
    buf7[:big_n] = big_corpus
    big_hay = torch.from_numpy(buf7).to(dev)
    big_args = (big_sp.sparse, big_hay, big_n, Lb7, Tb7, big_halo)
    got_big = _kernels.sparse_scan(*big_args)
    big_k2 = (big_cls.lane_table(), big_cls.classes, big_hay, big_n, Lb7,
              Tb7, big_halo, big_cls.use_classes)
    require(lane_scan_err(got_big, _kernels.lane_scan(*big_k2)) == 0,
            "K7 differs from K2 at the same layout and halo (100,000 names)")

    def k7_case(t, tc, args, am_, k2) -> dict:
        tabs, hay_, n_, L_, T_, halo_ = args
        S_ = _kernels.plan_sublanes(L_, T_, halo_, _kernels.sm_count(dev))
        hits = int(_kernels.sparse_scan(*args)[1].sum(dtype=torch.int64))
        return {
            "L": L_, "T": T_, "halo": halo_, "S": S_, "matches": hits,
            "states": am_.num_states, "edges": tabs.targets.numel(),
            "ms": cuda_ms(lambda: _kernels.sparse_scan(*args), 5),
            # haystack read, mask written, a state at each match, the
            # derived tables read
            "bound_ms": bound_ms(2 * L_ * T_ + 4 * hits + tabs.nbytes()),
            "tables_bytes": tabs.nbytes(),
            "classed_table_bytes": tables_bytes(tc),
            "k2_ms": cuda_ms(lambda: _kernels.lane_scan(*k2), 5),
            # one sub-lane: S + halo dependent steps, this design's floor
            "sub_chain_ms": cuda_ms(lambda: _kernels._sparse_scan_at(
                S_, tabs, hay_[:S_].contiguous(), S_, 1, S_, halo_), 20),
            "ms_by_carveout": by_carveout(_kernels._sparse_scan_at, S_,
                                          args),
        }

    sizes7 = {
        "names": k7_case(sp, cls, k7_args, am, kk2_args),
        "names100k": k7_case(big_sp, big_cls, big_args, big_am, big_k2),
    }
    main7 = sizes7["names"]
    out["sparse_scan"] = {
        "shape": f"L={L} T={T} halo={halo} S={main7['S']}, records int32 "
                 f"[{am.num_states}, 4], {main7['edges']} edges",
        "max_abs_err": err,
        "ms": main7["ms"],
        "plain_ms": plain7_ms,
        "bound_ms": main7["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "matches": main7["matches"],
        "sub_chain_ms": main7["sub_chain_ms"],
        "ms_by_carveout": main7["ms_by_carveout"],
        "layouts": sizes7,
    }

    # P1 and P2: the layout probes, on random bytes at the reference's 32
    # blocks (4 MiB) and at K1's main-path layout (64 MiB)
    rng = np.random.default_rng(SEED + 2)
    for key, kernel, plain, library, out_div in (
        ("probe_reduce", _kernels.probe_reduce, probe._reduce16_plain,
         lambda x: torch.amax(x.view(-1, 16, 128), 1), 16),
        ("probe_rollrows", _kernels.probe_rollrows, probe._rollrows_plain,
         None, 1),
    ):
        by_size = {}
        for rows in (PROBE_SMALL_ROWS, hay2d.shape[0]):
            x = torch.from_numpy(
                rng.integers(0, 256, (rows, 128), dtype=np.uint8)
            ).to(dev)
            err = max_abs_err(kernel(x), plain(x))
            require(err == 0, f"{key} differs from its plain version at "
                              f"{rows} rows ({err})")
            by_size[rows] = {
                "shape": f"x uint8 [{rows}, 128]",
                "max_abs_err": err,
                "ms": cuda_ms(lambda: kernel(x), 20),
                "plain_ms": cuda_ms(lambda: plain(x), 5),
                # each input byte read once, each output byte written once
                "bound_ms": bound_ms(rows * 128 + rows * 128 // out_div),
                "bound_by": "bytes",
                "library_ms": (cuda_ms(lambda: library(x), 20)
                               if library else None),
            }
        main_row = dict(by_size[hay2d.shape[0]])
        main_row["max_abs_err"] = max(r["max_abs_err"]
                                      for r in by_size.values())
        main_row["small"] = by_size[PROBE_SMALL_ROWS]
        out[key] = main_row
    return out


def phase_shard_kernels(dev, names, corpus, long_batch) -> dict:
    """K8: the sharded scan's per-rank bodies at the sharded phase's
    shapes (two ranks over the 64 MiB corpus and the LONG batch), each on
    the card against the same body on CPU copies of its inputs, which is
    its plain version (every wrapper takes its plain version for CPU
    tensors).  The plain time is a host-clock time on the CPU."""
    from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
    from ahocorasick_rs_tpu_torch.models.prefilter import build_prefilter
    from ahocorasick_rs_tpu_torch.ops import scan_cuda, scan_teddy
    from ahocorasick_rs_tpu_torch.parallel import sharded

    am = build_automaton(names)
    pf = build_prefilter(names)
    n, n_dev, halo = len(corpus), SHARD_RANKS, am.max_len - 1
    cpu = torch.device("cpu")
    devs = (dev, cpu)

    def run_both(body, args) -> tuple[int, float, float]:
        """max |card - cpu| of ``body`` over its outputs, the card's ms
        and the CPU's ms; ``args`` maps a device to the arguments."""
        on_card, on_cpu = args(dev), args(cpu)
        got = body(*on_card)
        t0 = time.perf_counter()
        want = body(*on_cpu)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(a.cpu(), b) for a, b in zip(got, want))
        return err, cuda_ms(lambda: body(*on_card), 5), plain_ms

    out: dict = {}
    # dense (the sharded ContiguousNFA path): rank 1, whose head is rank
    # 0's tail
    cls = {d: scan_cuda.DeviceTables(am, "classed", d) for d in devs}
    L, T = sharded.dense_layout(n, n_dev, halo)
    LT = L * T
    shards = [torch.from_numpy(sharded._shard_of(corpus, d, LT))
              for d in range(n_dev)]
    tail = sharded.shard_tail(shards[0], n, halo)
    cap = 4096
    err, ms, plain_ms = run_both(
        sharded.shard_scan_body, lambda d: (
            cls[d], shards[1].to(d), tail.to(d), n - LT, LT, L, T, halo, cap,
        ),
    )
    out["dense"] = {
        "shape": f"rank 1 of {n_dev}: L={L} T={T} halo={halo}, table int32 "
                 f"{list(cls[dev].table.shape)}, cap={cap}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        # the body's own inputs and outputs only (K2's state stream and
        # mask are intermediates): shard, head, tables read; the compacted
        # positions, states and total written; the tails and the outputs
        # the two collectives gather
        "bound_ms": bound_ms(LT + 4 * halo + tables_bytes(cls[dev])
                             + 12 * cap + 4
                             + n_dev * (4 * halo + 8 * (2 * cap + 1))),
    }
    # Teddy (the sharded DFA LeftmostLongest path): rank 0, whose right
    # neighbour's head is rank 1's first Hr bytes
    dfa = {d: scan_cuda.DeviceTables(am, "dfa", d) for d in devs}
    sc = {
        d: scan_teddy.TeddyScanner(am, pf, t) for d, t in dfa.items()
    }
    W = am.max_len + scan_teddy.COARSE - 1
    rows, Hr = sharded.teddy_layout(n, n_dev, W)
    LT = rows * 128
    shards = [torch.from_numpy(sharded._shard_of(corpus, d, LT))
              for d in range(n_dev)]
    right = shards[1][:Hr].clone()
    fcap, mcap = 1 << 14, 1 << 12
    while True:  # scan_sharded_teddy's cap growth, on the card
        o = sharded.shard_teddy_body(
            sc[dev], shards[0].to(dev), right.to(dev), n, 0, W, fcap, mcap
        )
        ftotal, mtotal = int(o[1]), int(o[5])
        if ftotal > fcap:
            fcap = scan_teddy._bucket(ftotal)
        elif mtotal > mcap:
            mcap = scan_teddy._bucket(mtotal)
        else:
            break
    err, ms, plain_ms = run_both(
        sharded.shard_teddy_body, lambda d: (
            sc[d], shards[0].to(d), right.to(d), n, 0, W, fcap, mcap,
        ),
    )
    out["teddy"] = {
        "shape": f"rank 0 of {n_dev}: hay uint8 [{rows}, 128], Hr={Hr}, "
                 f"W={W}, {ftotal} windows (cap {fcap}), {mtotal} matched "
                 f"steps (cap {mcap})",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        # the body's own inputs and outputs only (the fire mask is an
        # intermediate, the windows read the shard): shard, right head,
        # fire and verify tables read; window starts, ftotal, the matched
        # steps and mtotal written; the heads and the outputs gathered
        "bound_ms": bound_ms(LT + Hr + 4 * (sc[dev].tables.numel()
                                            + sc[dev].vtable.numel()
                                            + sc[dev].classes.numel())
                             + 8 * fcap + 12 * mcap + 8
                             + n_dev * (Hr + 8 * (fcap + 3 * mcap + 2))),
    }
    # batch (the sharded LONG batch): rank 0's row block
    Bb, T = sharded.batch_layout([len(d) for d in long_batch], n_dev)
    Bl = Bb // n_dev
    buf = np.zeros((Bl, T), dtype=np.uint8)
    lens = np.zeros(Bl, dtype=np.int32)
    for r, d in enumerate(long_batch[:Bl]):
        b = d.encode()
        buf[r, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[r] = len(b)
    hay2d, lens_t = torch.from_numpy(buf), torch.from_numpy(lens)
    err, ms, plain_ms = run_both(
        sharded.shard_batch_body, lambda d: (
            dfa[d], hay2d.to(d), lens_t.to(d), 0, cap,
        ),
    )
    out["batch"] = {
        "shape": f"rank 0 of {n_dev}: hay2d uint8 [{Bl}, {T}], DFA table "
                 f"int32 {list(dfa[dev].table.shape)}, cap={cap}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        # rows, lens and tables read; the compacted outputs written and
        # gathered (K5's states and mask are intermediates)
        "bound_ms": bound_ms(Bl * T + 4 * Bl + tables_bytes(dfa[dev])
                             + 12 * cap + 4 + n_dev * 8 * (2 * cap + 1)),
    }
    for key, row in out.items():
        require(row["max_abs_err"] == 0,
                f"K8 {key} body on the card differs from the CPU "
                f"({row['max_abs_err']})")
    dense = out["dense"]
    return {
        "shape": dense["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in out.values()),
        "ms": dense["ms"], "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "by_body": out,
    }


def host_backend() -> str:
    from ahocorasick_rs_tpu_torch.models import native

    return "native" if native.available() else "numpy"


def phase_teddy(port, names_s, text) -> dict:
    """The main path: auto routing, then the forced device tier, all
    through the Teddy pipeline; answers checked against the host tier."""
    from ahocorasick_rs_tpu_torch import _kernels

    kind = port.MatchKind.LeftmostLongest
    impl = port.Implementation.DFA
    _kernels.reset_launches()
    t0 = time.perf_counter()
    auto = port.AhoCorasick(names_s, matchkind=kind, implementation=impl)
    got = auto.find_matches_as_indexes(text)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    require(
        auto.stats()["last_backend"] == "teddy",
        f"auto call ran {auto.stats()['last_backend']!r}, not teddy",
    )
    ac = port.AhoCorasick(
        names_s, matchkind=kind, implementation=impl, backend="device"
    )
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = ac.find_matches_as_indexes(text)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(again == got, "device call differs from the auto call")
        require(ac.stats()["last_backend"] == "teddy", "device call not teddy")
    launches = dict(_kernels.LAUNCHES)
    for k in ("fire", "compact", "verify"):
        require(launches[k] > 0, f"Teddy path launched no {k} kernel")
    host = host_backend()
    want = port.AhoCorasick(
        names_s, matchkind=kind, implementation=impl, backend=host
    ).find_matches_as_indexes(text)
    require(got == want, f"Teddy tuples differ from the {host} tier")
    require(len(got) > 100, f"only {len(got)} matches")
    return {
        "launches": launches, "matches": len(got), "host_tier": host,
        "auto_call_s": auto_s, "device_call_s": times, "scanner": ac._teddy,
        "digest": digest(want),
    }


def phase_streamed(scanner, corpus) -> dict:
    """The streamed Teddy pipeline (16 MiB segments, each staged on the
    scanner's side copy stream) against one whole-buffer pass, three of
    each in turns, every result held equal; host-clock times of calls that
    end in their results' fetch."""
    from ahocorasick_rs_tpu_torch import _kernels

    _kernels.reset_launches()
    times: dict = {"whole_s": [], "streamed_s": []}
    first = None
    for _ in range(3):
        for key, run in (
            ("whole_s", lambda: scanner.occurrences(corpus)),
            ("streamed_s", lambda: scanner.occurrences_streamed(
                corpus, seg_bytes=STREAM_SEG_MIB << 20)),
        ):
            t0 = time.perf_counter()
            occ = run()
            times[key].append(time.perf_counter() - t0)
            require(occ is not None, "Teddy declined")
            if first is None:
                first = occ
            for a, b in zip(first, occ):
                require(np.array_equal(a, b),
                        "streamed Teddy differs from one pass")
    launches = dict(_kernels.LAUNCHES)
    for k in ("fire", "compact", "verify"):
        require(launches[k] > 0, f"streamed Teddy launched no {k} kernel")
    require(scanner._copy_stream is not None, "no side copy stream was made")
    return {"matches": len(first[0]), "launches": launches,
            "segments": -(-len(corpus) // (STREAM_SEG_MIB << 20)),
            "device_call_s": times["streamed_s"], **times}


def phase_probe(dev) -> dict:
    """The layout probe tool through its entry points: P1 and P2 at 4 and
    64 MiB with the transpose (``main``), then K1 at every tile of its
    sweep (``fire_tile_sweep``); both hold every result against its plain
    version or the default tile and raise on a difference."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.tools import probe_transpose_kernel as tool

    _kernels.reset_launches()
    probes = tool.main(dev)
    sweep = tool.fire_tile_sweep(dev)
    launches = dict(_kernels.LAUNCHES)
    for k in ("probe_reduce", "probe_rollrows", "fire"):
        require(launches[k] > 0, f"the probe tool launched no {k} kernel")
    require(sorted(sweep["tiles"]) == sorted(tool.SWEEP_TILES),
            "the sweep left out a tile")
    return {"launches": launches, "probes": probes, "sweep": sweep}


def phase_tune(port, names_s, text, want_digest) -> dict:
    """``tune()`` on a 16 MiB slice of the names corpus (LeftmostLongest,
    DFA, ``backend="device"``, Teddy state left at auto): every candidate's
    prefilter shape launches K1, and the tuned matcher's tuples equal the
    host tier's.  Then the tuned matcher is saved, loaded on the default
    device, and its 64 MiB call must equal the Teddy path's
    (``want_digest``) through the tuned prefilter."""
    from ahocorasick_rs_tpu_torch import _kernels

    kind = port.MatchKind.LeftmostLongest
    impl = port.Implementation.DFA
    sample = text[: TUNE_MIB << 20]
    ac = port.AhoCorasick(
        names_s, matchkind=kind, implementation=impl, backend="device"
    )
    _kernels.reset_launches()
    t0 = time.perf_counter()
    report = ac.tune(sample)
    tune_s = time.perf_counter() - t0
    require(isinstance(report["chosen"], dict),
            f"tune() chose {report['chosen']!r}")
    by_shape = dict(_kernels.FIRE_CONFIGS)
    shapes = [(c["m"], c["words"], c["passes"]) for c in report["candidates"]]
    require(len(shapes) >= 2, f"tune() measured {len(shapes)} candidates")
    for shape in shapes:
        require(by_shape.get(shape, 0) > 0, f"tune() never launched K1 at "
                                            f"m, words, passes = {shape}")
    got = ac.find_matches_as_indexes(sample)
    require(ac.stats()["last_backend"] == "teddy", "tuned call not teddy")
    launches = dict(_kernels.LAUNCHES)
    for k in ("fire", "compact", "verify"):
        require(launches[k] > 0, f"tune() launched no {k} kernel")
    host = host_backend()
    want = port.AhoCorasick(
        names_s, matchkind=kind, implementation=impl, backend=host
    ).find_matches_as_indexes(sample)
    require(got == want, f"tuned tuples differ from the {host} tier")
    chosen = report["chosen"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuned.npz")
        port.save_matcher(path, ac)
        loaded = port.load_matcher(path)
    require(loaded._device.type == "cuda", f"loaded on {loaded._device}")
    require(loaded._pf_config == chosen, "the tuned config did not persist")
    t0 = time.perf_counter()
    again = loaded.find_matches_as_indexes(text)
    torch.cuda.synchronize()
    load_call_s = time.perf_counter() - t0
    require(loaded.stats()["last_backend"] == "teddy", "loaded call not teddy")
    t = loaded._teddy
    require((t.m, t.words, t.passes) == tuple(chosen.values()),
            "the loaded matcher did not rebuild the tuned prefilter")
    require(digest(again) == want_digest,
            "the loaded matcher's 64 MiB tuples differ from the Teddy path's")
    return {
        "launches": dict(_kernels.LAUNCHES), "matches": len(got),
        "report": report, "fire_by_shape": {
            ",".join(map(str, k)): v for k, v in by_shape.items()},
        "tune_s": tune_s, "loaded_call_s": load_call_s,
        "loaded_matches": len(again), "host_tier": host,
    }


def phase_dense(port, names_s, text) -> dict:
    """The dense path: ContiguousNFA, Standard, overlapping, Teddy off.
    The names' pair table fits the 64 MiB budget, so it runs K6."""
    from ahocorasick_rs_tpu_torch import _kernels

    impl = port.Implementation.ContiguousNFA
    _kernels.reset_launches()
    ac = port.AhoCorasick(names_s, implementation=impl, backend="device")
    ac._teddy_state = "off"
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = ac.find_matches_as_indexes(text, overlapping=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(ac.stats()["last_backend"] == "device", "dense call not device")
    launches = dict(_kernels.LAUNCHES)
    for k in ("stride2_scan", "compact"):
        require(launches[k] > 0, f"dense path launched no {k} kernel")
    require(launches["lane_scan"] == 0, "dense path ran K2, not K6")
    host = host_backend()
    want = port.AhoCorasick(
        names_s, implementation=impl, backend=host
    ).find_matches_as_indexes(text, overlapping=True)
    require(got == want, f"dense tuples differ from the {host} tier")
    return {"launches": launches, "matches": len(got), "device_call_s": times,
            "want": want, "digest": digest(want)}


def phase_dense_k2(port, text) -> dict:
    """The one-byte dense scan (K2) on a real path: ContiguousNFA over
    10,000 names, whose pair table is over the 64 MiB classed budget."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.tools._synth import synth_names

    names_s = [
        x.decode()
        for x in synth_names(PATTERNS_K2, np.random.default_rng(SEED + 1))
    ]
    impl = port.Implementation.ContiguousNFA
    ac = port.AhoCorasick(names_s, implementation=impl, backend="device")
    ac._teddy_state = "off"
    am = ac._automaton
    require(am.packed2_bytes > 64 << 20,
            f"pair table of {am.packed2_bytes} bytes fits the budget")
    _kernels.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = ac.find_matches_as_indexes(text, overlapping=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(ac.stats()["last_backend"] == "device", "K2 call not device")
    launches = dict(_kernels.LAUNCHES)
    require(launches["lane_scan"] > 0, "the K2 path launched no lane_scan")
    require(launches["stride2_scan"] == 0, "the K2 path ran K6")
    host = host_backend()
    want = port.AhoCorasick(
        names_s, implementation=impl, backend=host
    ).find_matches_as_indexes(text, overlapping=True)
    require(got == want, f"K2 path tuples differ from the {host} tier")
    return {
        "launches": launches, "matches": len(got), "device_call_s": times,
        "states": am.num_states, "classes": am.num_classes,
        "packed2_bytes": am.packed2_bytes, "digest": digest(want),
    }


def phase_sparse(port, names_s, text, want) -> dict:
    """The sparse engine on the device (K7): NoncontiguousNFA, Standard,
    overlapping, over the 64 MiB corpus."""
    from ahocorasick_rs_tpu_torch import _kernels

    impl = port.Implementation.NoncontiguousNFA
    ac = port.AhoCorasick(names_s, implementation=impl, backend="device")
    _kernels.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = ac.find_matches_as_indexes(text, overlapping=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(ac.stats()["last_backend"] == "device", "sparse not device")
    launches = dict(_kernels.LAUNCHES)
    for k in ("sparse_scan", "compact"):
        require(launches[k] > 0, f"sparse path launched no {k} kernel")
    # ``want`` is the host tier's answer for the same names and text
    require(got == want, "sparse tuples differ from the host tier")
    return {"launches": launches, "matches": len(got), "device_call_s": times,
            "digest": digest(got)}


def phase_batch(port, patterns, docs, teddy_state, tier, kernel) -> dict:
    """``find_matches_as_indexes_batch`` with ``backend="device"``, for
    Standard and LeftmostLongest, three timed calls each; every answer
    held against the per-document loop on the host tier."""
    from ahocorasick_rs_tpu_torch import _kernels

    host = host_backend()
    out: dict = {"launches": None, "tier": tier, "host_tier": host,
                 "documents": len(docs),
                 "bytes": sum(len(d.encode()) for d in docs)}
    _kernels.reset_launches()
    for kind_name in ("Standard", "LeftmostLongest"):
        kind = port.MatchKind[kind_name]
        ac = port.AhoCorasick(patterns, matchkind=kind, backend="device")
        if teddy_state is not None:
            ac._teddy_state = teddy_state
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = ac.find_matches_as_indexes_batch(docs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            require(ac.stats()["last_backend"] == tier,
                    f"batch call ran {ac.stats()['last_backend']!r}, "
                    f"not {tier}")
        ref = port.AhoCorasick(patterns, matchkind=kind, backend=host)
        want = [ref.find_matches_as_indexes(d) for d in docs]
        require(got == want, f"{tier} {kind_name} differs from the "
                             f"{host} per-document loop")
        out[kind_name] = {"matches": sum(map(len, got)),
                          "device_call_s": times,
                          "digest": digest(flat_batch(want))}
    out["matches"] = out["Standard"]["matches"]
    out["device_call_s"] = (
        out["Standard"]["device_call_s"]
        + out["LeftmostLongest"]["device_call_s"]
    )
    out["launches"] = dict(_kernels.LAUNCHES)
    require(out["launches"][kernel] > 0, f"{tier} launched no {kernel}")
    require(out["launches"]["compact"] > 0, f"{tier} launched no compact")
    return out


def phase_bailout(port) -> dict:
    """Nested patterns over 16 MiB of 'a': the device scan bails out with
    MatchDenseError and the call re-routes to the host resolvers."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.ops import scan_cuda
    from ahocorasick_rs_tpu_torch.ops.resolve import MatchDenseError

    pats = ["a" * k for k in range(1, 65)]
    text = "a" * (BAILOUT_MIB << 20)
    kind = port.MatchKind.LeftmostLongest
    ac = port.AhoCorasick(pats, matchkind=kind, backend="device")
    _kernels.reset_launches()
    got = ac.find_matches_as_indexes(text)
    tier = ac.stats()["last_backend"]
    require(tier in ("native_resolve", "numpy"), f"bailout ran {tier!r}")
    launches = dict(_kernels.LAUNCHES)
    require(launches["lane_scan"] + launches["stride2_scan"] > 0,
            "bailout never ran a dense scan kernel")
    try:
        scan_cuda.scan_device(
            ac._automaton, np.frombuffer(text.encode(), np.uint8),
            ac._get_device_tables(),
        )
        raise SmokeFailure("scan_device did not raise MatchDenseError")
    except MatchDenseError:
        pass
    want = port.AhoCorasick(
        pats, matchkind=kind, backend=host_backend()
    ).find_matches_as_indexes(text)
    require(got == want, "bailout tuples differ from the host tier")
    return {"rerouted_to": tier, "matches": len(got), "launches": launches,
            "digest": digest(got)}


def digest(matches: list) -> str:
    """The sharded runner's digest of a tuple list, so that the ranks'
    records and the single-device answers compare as one format."""
    from ahocorasick_rs_tpu_torch.parallel.multihost import _match_digest

    return _match_digest(matches)


def flat_batch(per_doc: list) -> list:
    return [(i, *t) for i, doc in enumerate(per_doc) for t in doc]


#: the sharded calls each rank makes: result tier, matcher keywords, Teddy
#: state, and the call (single document or the LONG batch)
SHARD_CALLS = (
    ("teddy_sharded", {"matchkind": "LeftmostLongest",
                       "implementation": "DFA"}, None, "text"),
    ("sharded", {"implementation": "ContiguousNFA"}, "off", "text_overlap"),
    ("teddy_sharded_batch", {}, None, "batch"),
    ("sharded_batch", {}, "off", "batch"),
)
#: the kernels each sharded call must launch (besides the K8 bodies)
SHARD_KERNELS = {
    "teddy_sharded": ("fire", "compact", "verify"),
    "sharded": ("lane_scan", "lane_scan_head", "compact"),
    "teddy_sharded_batch": ("fire", "compact", "verify"),
    "sharded_batch": ("batch_scan", "compact"),
}


def shard_child(argv: list[str]) -> int:
    """One rank of the sharded phase (started by :func:`phase_sharded`):
    join the group on ``cuda:0`` and make each of :data:`SHARD_CALLS`
    three times through the public API with ``mesh=`` (the first builds
    the tables); write digests, tiers, launches and times to ``--out``."""
    import argparse

    import torch.distributed as dist

    p = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        p.add_argument(name, type=int, required=True)
    for name in ("--backend", "--init", "--out"):
        p.add_argument(name, required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ahocorasick_rs_tpu_torch as port
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.parallel.multihost import (
        global_mesh,
        init_distributed,
    )
    from ahocorasick_rs_tpu_torch.tools._synth import (
        long_docs,
        synth_corpus,
        synth_names,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_distributed(a.init, a.world, a.rank, a.backend)
    try:
        # NCCL: a 1-D DeviceMesh; gloo: the process group itself
        mesh = global_mesh("cuda" if a.backend == "nccl" else None)
        rng = np.random.default_rng(SEED)
        names = synth_names(PATTERNS, rng)
        text = synth_corpus(CORPUS_MIB << 20, names, rng).tobytes().decode()
        names_s = [x.decode() for x in names]
        long_batch = long_docs(names)
        runs = {
            "text": lambda ac: ac.find_matches_as_indexes(text),
            "text_overlap": lambda ac: ac.find_matches_as_indexes(
                text, overlapping=True),
            "batch": lambda ac: flat_batch(
                ac.find_matches_as_indexes_batch(long_batch)),
        }
        record: dict = {"rank": dist.get_rank(), "world": a.world,
                        "backend": dist.get_backend(), "mesh":
                        type(mesh).__name__, "calls": {}}
        for tier, kw, teddy_state, run in SHARD_CALLS:
            kw = dict(kw)
            if "matchkind" in kw:
                kw["matchkind"] = port.MatchKind[kw["matchkind"]]
            if "implementation" in kw:
                kw["implementation"] = port.Implementation[
                    kw["implementation"]]
            _kernels.reset_launches()
            ac = port.AhoCorasick(
                names_s, backend="sharded", mesh=mesh, device=dev, **kw
            )
            if teddy_state is not None:
                ac._teddy_state = teddy_state
            times = []
            for _ in range(3):
                dist.barrier()
                t0 = time.perf_counter()
                got = runs[run](ac)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            record["calls"][tier] = {
                "tier": ac.stats()["last_backend"], "matches": len(got),
                "digest": digest(got), "launches": dict(_kernels.LAUNCHES),
                "call_s": times,
            }
        with open(a.out, "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(world: int, backend: str) -> list[dict]:
    """Run ``world`` ranks of :func:`shard_child` on ``cuda:0`` over
    ``backend`` and return their records; any failure fails the phase,
    and every child is stopped before this returns."""
    from ahocorasick_rs_tpu_torch.parallel.multihost import RankProcesses

    def argv(r: int, init: str, out: str) -> list[str]:
        return [sys.executable, os.path.abspath(__file__), "--shard-child",
                "--rank", str(r), "--world", str(world), "--backend",
                backend, "--init", init, "--out", out]

    with RankProcesses(argv, world, os.path.join(HERE, "chiprun_out",
                                                 "shard"),
                       tag=f"{backend}{world}", cwd=HERE) as ranks:
        try:
            return ranks.records(SHARD_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from None


def phase_sharded(want: dict[str, str]) -> dict:
    """The sharded paths (K8): two gloo ranks sharing the card, then one
    NCCL rank, each making :data:`SHARD_CALLS` through the public API with
    ``mesh=``; every rank's tuples must equal the single-device port's
    (``want``: digests of tuples already held against the host tier)."""
    paths = {}
    for world, backend in ((SHARD_RANKS, "gloo"), (1, "nccl")):
        records = spawn_ranks(world, backend)
        for tier, _, _, _ in SHARD_CALLS:
            calls = [r["calls"][tier] for r in records]
            for r, c in zip(records, calls):
                require(c["tier"] == tier,
                        f"{backend} rank {r['rank']} ran {c['tier']!r}, not "
                        f"{tier}")
                require(c["digest"] == want[tier],
                        f"{backend} rank {r['rank']} {tier} differs from the "
                        "single-device port and the host tier")
            launches = {k: sum(c["launches"][k] for c in calls)
                        for k in calls[0]["launches"]}
            for k in ("shard_body",) + SHARD_KERNELS[tier]:
                require(launches[k] > 0, f"{backend} {tier} launched no {k}")
            if tier == "sharded":
                require(launches["stride2_scan"] == 0, "sharded ran K6")
            paths[f"{tier}_{backend}{world}"] = {
                "launches": launches, "matches": calls[0]["matches"],
                "device_call_s": [t for c in calls for t in c["call_s"]],
                "ranks": world, "backend": records[0]["backend"],
                "mesh": records[0]["mesh"],
            }
    return paths


def phase_bench(port) -> dict:
    """The bench tool (``python -m ahocorasick_rs_tpu_torch.tools.bench``)
    in this process at :data:`BENCH_SCALE` over :data:`BENCH_SECTIONS`:
    its one JSON line parses, the five north-star paths ran, each GPU
    measurement launched the kernels of :data:`BENCH_KERNELS` and the
    forced sparse section K7, and its match counts equal the host tier's
    on the same inputs."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.tools import bench
    from ahocorasick_rs_tpu_torch.tools._synth import make_datasets

    out = io.StringIO()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--scale", str(BENCH_SCALE),
                         "--sections", ",".join(BENCH_SECTIONS)])
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    lines = out.getvalue().splitlines()
    require(rc == 0 and len(lines) == 1,
            f"the bench exited {rc} and printed {len(lines)} lines")
    line = json.loads(lines[0])
    d = line["detail"]
    require(line["metric"] == "dfa_scan_haystack_throughput_per_chip"
            and line["value"] > 0 and line["vs_baseline"] > 0,
            f"the bench's headline is {line['metric']} = {line['value']}")
    require(d["paths_run"] == ["cpu_native", "cpu_lanes", "gpu_plain",
                               "gpu_stride2", "gpu_teddy"],
            f"the bench ran the paths {d['paths_run']}")
    require("_error" not in lines[0], "the bench wrote an error key")
    require(d["device"]["name"] == torch.cuda.get_device_name(0),
            f"the bench ran on {d['device']['name']}")
    for p, kernels in BENCH_KERNELS.items():
        for k in kernels:
            require(d["launches"][p].get(k, 0) > 0,
                    f"the bench's {p} launched no {k}")
    sparse = d["sparse_device_forced"]
    require(sparse["scan_backend"] == "device"
            and sparse["launches"].get("sparse_scan", 0) > 0,
            f"the forced sparse section ran {sparse['scan_backend']} with "
            f"launches {sparse['launches']}")
    # the counts against the host tier's public calls on the same inputs
    host = host_backend()
    names, hay = bench.north_star_inputs(BENCH_SCALE)
    ends = {e for _, _, e in port.BytesAhoCorasick(
        names, backend=host).find_matches_as_indexes(
        hay.tobytes(), overlapping=True)}
    require(d["matches"] == len(ends), f"the north star's {d['matches']} "
            f"matched positions differ from the {host} tier's {len(ends)}")
    for key, (patterns, docs) in make_datasets(
            np.random.default_rng(7), BENCH_SCALE).items():
        ac = port.AhoCorasick(patterns, backend=host)
        want = sum(len(ac.find_matches_as_indexes(doc)) for doc in docs)
        got = d["scenarios"][key]["matches"]
        require(got == want, f"the bench's {key} scenario counts {got} "
                             f"matches, the {host} loop {want}")
    pats, data = bench.sparse_inputs(BENCH_SCALE)
    want = len(port.BytesAhoCorasick(pats, backend=host)
               .find_matches_as_indexes(data))
    require(sparse["matches"] == want, f"the forced sparse section counts "
            f"{sparse['matches']} matches, the {host} tier {want}")
    md = d["match_dense"]
    n = (128 << 20) // BENCH_SCALE
    require(md["leftmost_longest"]["matches"] == n // 64
            and md["standard_16mb"]["matches"] == (16 << 20) // BENCH_SCALE,
            "the match-dense counts are wrong")
    return {"launches": launches, "matches": d["matches"], "host_tier": host,
            "seconds": seconds, "line": line}


def phase_conformance(dev) -> dict:
    """The conformance tool on the card: parts A and B and the first
    :data:`CONFORMANCE_CASES` cases of part C from seed 0.  Any mismatch
    or uncovered kernel fails the phase; the tool's record goes to
    ``chiprun_out/conformance.json``.  Notes whether the committed record
    ``H100_CONFORMANCE.json`` was made with the package's present sources
    (its ``source_hash``)."""
    from ahocorasick_rs_tpu_torch.tools import gpu_conformance

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    rec = gpu_conformance.run(
        dev, cases=CONFORMANCE_CASES, seed=0, verbose=False,
        out=os.path.join(out_dir, "conformance.json"),
    )
    if rec["mismatches"]:
        raise SmokeFailure(
            f"conformance: {len(rec['mismatches'])} mismatches, the first "
            f"{json.dumps(rec['mismatches'][0], default=str)[:3000]}")
    require(not rec["uncovered"],
            f"conformance: no launch of {rec['uncovered']}")
    try:
        with open(os.path.join(HERE, "H100_CONFORMANCE.json")) as f:
            record_hash = json.load(f).get("source_hash")
    except FileNotFoundError:
        record_hash = None
    return {k: rec[k] for k in (
        "cases", "checks", "seconds", "seconds_by_part", "launches",
        "cases_by_kernel", "tiers", "part_c", "source_hash")} | {
        "part_a_rows": len(rec["part_a"]),
        "part_b_rows": len(rec["part_b"]), "mismatches": 0,
        "record_source_hash": record_hash}


def quiet(fn, *args) -> tuple[int, str]:
    """``fn(args)``'s return code and standard output (a tool's CLI);
    ``SystemExit`` counts as its code."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = fn(*args)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def timed(fn, *args, **kwargs) -> tuple[object, float]:
    """``fn``'s result and its seconds."""
    t = time.perf_counter()
    return fn(*args, **kwargs), time.perf_counter() - t


def phase_tools() -> dict:
    """The port's counterparts of the JAX package's last tools, on the
    card: ``multihost_run`` (two gloo ranks sharing the card, and one NCCL
    rank), ``scaling_bench`` (one and two ranks), both harnesses against
    the upstream binaries in ``--self-test``, and the fuzzer.  The three
    runs that start ranks wait on them in threads while the other tools
    run in this process, so the seconds of each overlap.  Any failure
    fails the phase.  ``launches`` adds this process's launches and those
    of every rank the tools started."""
    from concurrent.futures import ThreadPoolExecutor

    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.tools import (
        bench_vs_reference,
        conformance_vs_reference,
        fuzz_differential,
        multihost_run,
        scaling_bench,
    )

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    res: dict = {"seconds": {}}
    _kernels.reset_launches()
    with ThreadPoolExecutor(3) as pool:
        ranked = {
            f"multihost_{backend}{world}": pool.submit(
                timed, multihost_run.run, world, TOOLS_MIB << 20,
                backend=backend, weak=False, timeout=SHARD_TIMEOUT_S)
            for world, backend in ((SHARD_RANKS, "gloo"), (1, "nccl"))
        }
        ranked["scaling_bench"] = pool.submit(
            timed, scaling_bench.run, ranks=SHARD_RANKS,
            timeout=SHARD_TIMEOUT_S)
        for name, fn, argv, word in (
            ("conformance_vs_reference", conformance_vs_reference.main,
             ["--self-test", "--backend", "device", "--seed", "0",
              "--max-seconds", "120", *TOOLS_MIN_CHECKS], "PASS: zero"),
            ("bench_vs_reference", bench_vs_reference.main,
             ["--self-test", "--long-haystacks", str(TOOLS_LONG_HAYSTACKS),
              "--out", os.path.join(out_dir, "vs_reference.md"),
              "--json-out", os.path.join(out_dir, "vs_reference.json")],
             "# Competitor benchmark"),
            ("fuzz_differential", fuzz_differential.main,
             [str(FUZZ_SECONDS), "--seed", str(FUZZ_SEED)], "PASS:"),
        ):
            (rc, text), res["seconds"][name] = timed(quiet, fn, argv)
            with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
                f.write(text)
            require(rc == 0 and word in text,
                    f"{name} exited {rc}: {text[-2000:]}")
            res[name] = text.strip().splitlines()[-1][:300]
        for key, future in ranked.items():
            rec, res["seconds"][key] = future.result()
            res[key] = rec
    for world, backend in ((SHARD_RANKS, "gloo"), (1, "nccl")):
        rec = res[f"multihost_{backend}{world}"]
        require(rec["bit_exact_vs_single_process"],
                f"multihost_run {backend}{world}: {rec['mismatches'][:3]}")
        require(rec["backend"] == backend
                and rec["devices_by_rank"] == ["cuda:0"] * world,
                f"multihost_run {backend}{world} ran {rec['backend']} on "
                f"{rec['devices_by_rank']}")
        tiers = set(rec["tier_by_semantics"].values())
        require(tiers <= set(SHARD_KERNELS),
                f"multihost_run ran the tiers {rec['tier_by_semantics']}")
        for r, counts in enumerate(rec["launches_by_rank"]):
            for k in {"shard_body"}.union(*(SHARD_KERNELS[t] for t in tiers)):
                require(counts.get(k, 0) > 0, f"multihost_run {backend}"
                        f"{world} rank {r} launched no {k}")
    sc = res["scaling_bench"]
    require(sc["exact_vs_host_tier"], f"scaling_bench: {sc['mismatches']}")
    launches = dict(_kernels.LAUNCHES)
    require(launches["compact"] > 0, "the conformance harness's device tier "
            "launched no compact")
    for world, backend in ((SHARD_RANKS, "gloo"), (1, "nccl")):
        for counts in res[f"multihost_{backend}{world}"]["launches_by_rank"]:
            for k, v in counts.items():
                launches[k] += v
    for world, run in sc["by_world"].items():
        for r, counts in enumerate(run["launches_by_rank"]):
            for k in SCALING_KERNELS:
                require(counts.get(k, 0) > 0,
                        f"scaling_bench rank {r} of {world} launched no {k}")
            for k, v in counts.items():
                launches[k] += v
    res["launches"] = launches
    return res


KERNELS = {
    "fire": ("K1 fire", "ahocorasick_rs_tpu_torch/csrc/teddy.cu",
             "ahocorasick_rs_tpu/ops/scan_teddy.py:187"),
    "lane_scan": ("K2 lane_scan", "ahocorasick_rs_tpu_torch/csrc/scan.cu",
                  "ahocorasick_rs_tpu/ops/scan_jax.py:72"),
    "compact": ("K3 compact", "ahocorasick_rs_tpu_torch/csrc/scan.cu",
                "ahocorasick_rs_tpu/ops/scan_jax.py:94"),
    "verify": ("K4 verify", "ahocorasick_rs_tpu_torch/csrc/verify.cu",
               "ahocorasick_rs_tpu/ops/scan_teddy.py:245"),
    "batch_scan": ("K5 batch_scan", "ahocorasick_rs_tpu_torch/csrc/batch.cu",
                   "ahocorasick_rs_tpu/ops/scan_jax.py:180"),
    "stride2_scan": ("K6 stride2_scan",
                     "ahocorasick_rs_tpu_torch/csrc/stride2.cu",
                     "ahocorasick_rs_tpu/ops/scan_jax.py:277"),
    "sparse_scan": ("K7 sparse_scan",
                    "ahocorasick_rs_tpu_torch/csrc/sparse.cu",
                    "ahocorasick_rs_tpu/ops/scan_jax.py:339"),
    "shard_body": ("K8 shard bodies (composite)",
                   "ahocorasick_rs_tpu_torch/parallel/sharded.py",
                   "ahocorasick_rs_tpu/parallel/sharded.py:95"),
    "probe_reduce": ("P1 probe_reduce",
                     "ahocorasick_rs_tpu_torch/csrc/probe.cu",
                     "tools/probe_transpose_kernel.py:45"),
    "probe_rollrows": ("P2 probe_rollrows",
                       "ahocorasick_rs_tpu_torch/csrc/probe.cu",
                       "tools/probe_transpose_kernel.py:51"),
}


def main() -> int:
    if sys.argv[1:2] == ["--shard-child"]:
        return shard_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import ahocorasick_rs_tpu_torch as port
        from ahocorasick_rs_tpu_torch import _kernels
        from ahocorasick_rs_tpu_torch.tools._synth import (
            long_docs,
            short_case,
            synth_corpus,
            synth_names,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    _kernels.build()
    log(f"build: {_kernels.BUILD_SECONDS:.2f} s")
    # ptxas -v: each kernel's name, then its spills, registers and shared
    # memory
    for src, text in _kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "spill", "Used",
                                       "error")):
                log(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    names = synth_names(PATTERNS, rng)
    corpus = synth_corpus(CORPUS_MIB << 20, names, rng)
    text = corpus.tobytes().decode()
    names_s = [x.decode() for x in names]
    long_batch = long_docs(names)
    short_patterns, short_batch = short_case()

    report: dict = {"gpu": smi, "device_name": name}
    t = time.perf_counter()
    report["kernels"] = phase_kernels(dev, names, corpus, long_batch)
    log(f"kernels: equal to their plain versions "
        f"({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    k8 = report["kernels"]["shard_body"] = phase_shard_kernels(
        dev, names, corpus, long_batch
    )
    log("K8 bodies: equal to the CPU; card ms " + ", ".join(
        f"{k} {r['ms']:.4f}" for k, r in k8["by_body"].items()
    ) + f" ({time.perf_counter() - t:.1f} s)")

    def path(label: str, fn, *args) -> dict:
        t = time.perf_counter()
        res = fn(*args)
        calls = res.get("device_call_s")
        shown = (f", device calls {[round(x * 1e3, 1) for x in calls]} ms"
                 if calls else "")
        log(f"{label}: {res.get('matches', '')} matches{shown}, launches "
            f"{res.get('launches')} ({time.perf_counter() - t:.1f} s)")
        return res

    teddy = path("teddy path", phase_teddy, port, names_s, text)
    scanner = teddy.pop("scanner")
    streamed = path("streamed teddy", phase_streamed, scanner, corpus)
    log(f"  whole-buffer calls {[round(x * 1e3, 1) for x in streamed['whole_s']]}"
        f" ms, {streamed['segments']} segments streamed")
    probe = path("layout probes and K1 tile sweep", phase_probe, dev)
    for size, r in probe["probes"]["probes"].items():
        log(f"  {size}: P1 {r['reduce']['ms']:.4f} ms, P2 "
            f"{r['rollrows']['ms']:.4f} ms")
    log(f"  transpose {probe['probes']['transpose']['ms']:.4f} ms; K1 by "
        "tile: " + ", ".join(
            f"{k} {v['ms']:.4f} ms ({v['fires']} fires)"
            for k, v in probe["sweep"]["tiles"].items()))
    tune = path("tune() and save/load", phase_tune, port, names_s, text,
                teddy["digest"])
    log(f"  chosen {tune['report']['chosen']}; candidates " + ", ".join(
        f"({c['m']},{c['words']},{c['passes']}) {c['seconds'] * 1e3:.2f} ms"
        for c in tune["report"]["candidates"]))
    dense = path("dense path (K6)", phase_dense, port, names_s, text)
    dense_want = dense.pop("want")
    paths = {
        "teddy": teddy,
        "streamed": streamed,
        "probe": probe,
        "tune": tune,
        "dense": dense,
        "dense_k2": path("dense path (K2)", phase_dense_k2, port, text),
        "sparse": path("sparse path (K7)", phase_sparse, port, names_s, text,
                       dense_want),
        "bailout": path("bailout", phase_bailout, port),
        "batch_long_teddy": path(
            "LONG batch, teddy_batch", phase_batch, port, names_s,
            long_batch, None, "teddy_batch", "fire"),
        "batch_long_dense": path(
            "LONG batch, device_batch", phase_batch, port, names_s,
            long_batch, "off", "device_batch", "batch_scan"),
        "batch_short": path(
            "SHORT batch, device_batch", phase_batch, port, short_patterns,
            short_batch, None, "device_batch", "batch_scan"),
    }
    t = time.perf_counter()
    sharded = phase_sharded({
        "teddy_sharded": teddy["digest"],
        "sharded": digest(dense_want),
        "teddy_sharded_batch": paths["batch_long_dense"]["Standard"]["digest"],
        "sharded_batch": paths["batch_long_dense"]["Standard"]["digest"],
    })
    for key, res in sharded.items():
        log(f"{key}: {res['ranks']} {res['backend']} rank(s) on cuda:0 "
            f"({res['mesh']}), {res['matches']} matches, calls "
            f"{[round(x * 1e3, 1) for x in res['device_call_s']]} ms, "
            f"launches {res['launches']}")
    log(f"sharded phase: every rank equal to the single-device port "
        f"({time.perf_counter() - t:.1f} s)")
    paths.update(sharded)
    bench = paths["bench"] = path("bench tool", phase_bench, port)
    d = bench["line"]["detail"]
    log("  bench GB/s: " + ", ".join(
        f"{k[:-5]} {d[k]:.4f}" for k in d
        if k.endswith("_gbps") and isinstance(d[k], float)))
    log(f"bench phase: {bench['seconds']:.1f} s")
    report["paths"] = paths
    conf = report["conformance"] = phase_conformance(dev)
    log(f"conformance: {conf['part_a_rows']} part A and "
        f"{conf['part_b_rows']} part B rows, {conf['cases']} sweep cases, "
        f"{conf['checks']} checks, no mismatch, every kernel launched "
        f"({conf['seconds']:.1f} s)")
    log("  H100_CONFORMANCE.json " + (
        "was made with these sources"
        if conf["record_source_hash"] == conf["source_hash"] else
        f"is stale: made with sources {conf['record_source_hash']}, these "
        f"are {conf['source_hash']}"))
    t = time.perf_counter()
    tools = paths["tools"] = phase_tools()
    for key, secs in tools["seconds"].items():
        log(f"  {key}: {secs:.1f} s")
    log(f"tools phase: {time.perf_counter() - t:.1f} s")

    rows = []
    for key, (kname, source, replaces) in KERNELS.items():
        k = report["kernels"][key]
        by_path = {p: r["launches"][key] for p, r in paths.items()}
        require(sum(by_path.values()) > 0, f"{kname} never ran on a path")
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "equal": k["max_abs_err"] == 0,
            "shape": k["shape"],
        })
        for extra in ("dep_chain_ms", "sub_chain_ms", "layouts", "configs",
                      "bailout", "k2_same_layout_ms", "ms_by_carveout",
                      "groups_ms", "groups_device_ms", "groups_bound_ms",
                      "ms_by_cap", "kernels_per_call", "device_ms",
                      "unfused_ms", "unfused_device_ms",
                      "unfused_kernels_per_call", "walk_ms",
                      "walk_device_ms", "ms_by_pieces",
                      "device_ms_by_pieces", "pieces", "piece_chain_ms",
                      "window_chain_ms"):
            if extra in k:
                rows[-1][extra] = k[extra]
        if key == "fire":
            rows[-1]["ms_by_tile"] = {
                t: v["ms"] for t, v in probe["sweep"]["tiles"].items()}
        if key in ("probe_reduce", "probe_rollrows"):
            rows[-1]["small"] = k["small"]
        if key == "lane_scan":
            rows[-1]["launches_with_head"] = sum(
                r["launches"]["lane_scan_head"] for r in paths.values())
        if key == "shard_body":
            rows[-1]["composite"] = (
                "per-rank body dispatches, not one kernel: ms is one dense "
                "body's card time (K2 with head + K3; by_body also has the "
                "Teddy body, K1 + K3 + K4, and the batch body, K5 + K3); "
                "launches count bodies run on a card; bound_ms counts the "
                "body's inputs, its compacted outputs and its collectives"
            )
            rows[-1]["by_body"] = k["by_body"]
            rows[-1]["replaces_bodies"] = [
                "ahocorasick_rs_tpu/parallel/sharded.py:95",
                "ahocorasick_rs_tpu/parallel/sharded.py:203",
                "ahocorasick_rs_tpu/parallel/sharded.py:437",
            ]
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
