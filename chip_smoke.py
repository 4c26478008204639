#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ahocorasick_rs_tpu_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version at the main
path's shapes (exact equality; all values are integers) and times both.
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

Output: progress lines, the card's name and power limit as ``nvidia-smi``
reports them, one ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero.  Without
a CUDA card, or without the package beside it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

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


def long_docs(names: list[bytes]) -> list[str]:
    """The LONG batch: 20,000 lines of 624-633 characters, one in 90
    carrying a name (the upstream benchmark's LONG recipe)."""
    filler = (
        "no one who had ever seen {} in her infancy would have supposed "
        "her born to be an heroine; her situation in life, the character "
        "of her father and mother, her own person and disposition were "
        "all equally against her, and the rest of this line is ordinary "
        "prose of roughly six hundred characters so the haystack length "
        "matches the reference recipe with room to spare for the counter "
        "value {} at the end, padded with plain words that never match "
        "any generated name pattern because they are common english and "
        "the names are uniform random lowercase strings of length five "
        "to eleven which almost surely do not occur in this text"
    )
    out = []
    for i in range(20_000):
        name = names[i % len(names)].decode() if i % 90 == 0 else "nobody"
        out.append(filler.format(name, i))
    return out


def short_case() -> tuple[list[str], list[str]]:
    """The SHORT batch: 10 patterns, 10,000 documents of 72-75 bytes (the
    upstream benchmark's SHORT recipe)."""
    patterns = [
        "abc", "hello", "world", "aardvark", "fish",
        "what", "arbitrarymonkey", "birds", "host7", "host76",
    ]
    docs = [
        f"arbitrarymonkey says hello to fish host76, 0.123 my friend, "
        f"but why??? {i}"
        for i in range(10_000)
    ]
    return patterns, docs


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


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def tables_bytes(t) -> int:
    """Bytes of a ``DeviceTables``' transition table, byte classes and
    match counts."""
    return sum(x.numel() * x.element_size()
               for x in (t.table, t.classes, t.match_count))


def phase_kernels(dev, names, corpus, long_batch) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from ahocorasick_rs_tpu_torch import _kernels
    from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
    from ahocorasick_rs_tpu_torch.models.prefilter import build_prefilter
    from ahocorasick_rs_tpu_torch.ops import probe, scan_cuda, scan_teddy
    from ahocorasick_rs_tpu_torch.tools.probe_transpose_kernel import (
        SWEEP_TILES,
    )

    am = build_automaton(names)
    pf = build_prefilter(names)
    require(pf is not None, "no prefilter for the name set")
    n = len(corpus)
    out = {}

    # K1: fire mask over the staged corpus, DFA tables (the Teddy path)
    dfa = scan_cuda.DeviceTables(am, "dfa", dev)
    sc = scan_teddy.TeddyScanner(
        am, pf, dfa.table, dfa.classes, dfa.match_count, dfa.use_classes
    )
    hay2d = sc.stage(corpus)
    fire_args = (sc.tables, hay2d, sc.m, sc.words, sc.passes)
    got = _kernels.fire(*fire_args)
    want = scan_teddy._fire_mask_plain(*fire_args)
    err = max_abs_err(got, want)
    require(err == 0, f"K1 fire differs from its plain version ({err})")
    # the mask does not depend on the tile a block stages
    for tile in SWEEP_TILES:
        tile_err = max_abs_err(_kernels.fire(*fire_args, tile=tile), want)
        require(tile_err == 0, f"K1 at tile {tile} differs from its plain "
                               f"version ({tile_err})")
    N = hay2d.numel()
    out["fire"] = {
        "shape": f"hay uint8 {list(hay2d.shape)}, tables int32 "
                 f"{list(sc.tables.shape)}, m={sc.m} words={sc.words} "
                 f"passes={sc.passes}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.fire(*fire_args), 10),
        "plain_ms": cuda_ms(
            lambda: scan_teddy._fire_mask_plain(*fire_args), 2
        ),
        "bound_ms": bound_ms(2 * N + sc.tables.numel() * 4),
        "bound_by": "bytes",
        "library_ms": None,
        "fire_rate": float(got.float().mean()),
        "tiles_equal": list(SWEEP_TILES),
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

    # K4: verify walk over the fired windows, W = max_len + COARSE - 1
    W = am.max_len + scan_teddy.COARSE - 1
    fire_pos = torch.where(fg >= 0, fg * scan_teddy.COARSE, -1)
    flat = hay2d.reshape(-1)
    v_args = (sc.vtable, sc.classes, flat, fire_pos, n, W, sc.use_classes)
    got = _kernels.verify(*v_args)
    want = scan_teddy._verify_walk_plain(*v_args)
    err = max_abs_err(got, want)
    require(err == 0, f"K4 verify differs from its plain version ({err})")
    out["verify"] = {
        "shape": f"fire_pos int32 [{cap}] ({ftotal} windows), W={W}, "
                 f"vtable int32 {list(sc.vtable.shape)}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.verify(*v_args), 20),
        "plain_ms": cuda_ms(
            lambda: scan_teddy._verify_walk_plain(*v_args), 2
        ),
        # window bytes + fire positions read, the walk of the real
        # windows written; tables left out (which rows a walk touches
        # depends on the data, and they stay in L2)
        "bound_ms": bound_ms(ftotal * W + 4 * ftotal + 4 * ftotal * W),
        "bound_by": "bytes",
        "library_ms": None,
    }

    # K2: lane scan at the dense path's layout, classed tables (the dense
    # phase runs ContiguousNFA)
    cls = scan_cuda.DeviceTables(am, "classed", dev)
    halo = am.max_len - 1
    L, T = scan_cuda.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = corpus
    hay = torch.from_numpy(buf).to(dev)
    k2_args = (cls.table, cls.classes, hay, cls.match_count, n, L, T, halo,
               cls.use_classes)
    st, lm = _kernels.lane_scan(*k2_args)
    st_p, lm_p = scan_cuda._lane_scan_plain(*k2_args)
    err = max(max_abs_err(st, st_p), max_abs_err(lm, lm_p))
    require(err == 0, f"K2 lane scan differs from its plain version ({err})")
    # K2 with a neighbour's head (the sharded scan): an all-PAD head is
    # bit-equal to none, and the corpus's last bytes as a head equal the
    # plain version
    pad = torch.full((halo,), 256, dtype=torch.int32, device=dev)
    for a, b in zip(_kernels.lane_scan(*k2_args, head=pad), (st, lm)):
        require(torch.equal(a, b), "K2 with a PAD head differs from K2")
    head = torch.from_numpy(corpus[-halo:].astype(np.int32)).to(dev)
    got = _kernels.lane_scan(*k2_args, head=head)
    want = scan_cuda._lane_scan_plain(*k2_args, head=head)
    head_err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(head_err == 0, f"K2 with a head differs from its plain version "
                           f"({head_err})")
    err = max(err, head_err)
    one_lane = (cls.table, cls.classes, hay[:T].contiguous(),
                cls.match_count, T, 1, T, halo, cls.use_classes)
    out["lane_scan"] = {
        "shape": f"L={L} T={T} halo={halo}, table int32 "
                 f"{list(cls.table.shape)}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.lane_scan(*k2_args), 5),
        "plain_ms": cuda_ms(lambda: scan_cuda._lane_scan_plain(*k2_args), 1),
        # haystack, table and match counts read, int32 states and uint8
        # mask written
        "bound_ms": bound_ms(
            L * T * (1 + 4 + 1) + 4 * (cls.table.numel() + am.num_states)
        ),
        "bound_by": "bytes",
        "library_ms": None,
        # one lane alone: T + halo dependent table loads in a row, the
        # latency floor no lane layout can beat
        "dep_chain_ms": cuda_ms(lambda: _kernels.lane_scan(*one_lane), 20),
    }

    # K3 on the dense path's shape: the lane scan's match mask
    cap = cls.last_cap
    idx, total = _kernels.compact(lm, cap)
    idx_p, total_p = scan_cuda._compact_plain(lm, cap)
    require(int(total) == int(total_p), "K3 total differs (lanes)")
    err = max_abs_err(idx, idx_p)
    require(err == 0, f"K3 compact differs from its plain version ({err})")
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
    }

    # K6: stride-2 scan at the dense path's layout, classed tables (the
    # dense phase runs ContiguousNFA; its 19.6 MiB pair table fits the
    # 64 MiB budget), halo rounded up to even
    require(cls.ensure_packed2(), "the pair table of the names does not fit")
    halo2 = halo + (halo & 1)
    L2, T2 = scan_cuda.choose_layout(n, halo2)
    buf2 = np.zeros(L2 * T2, dtype=np.uint8)
    buf2[:n] = corpus
    hay2 = torch.from_numpy(buf2).to(dev)
    C = cls.table_classed.shape[1]
    k6_args = (cls.packed2, C, cls.classes2, hay2, n, L2, T2, halo2)
    got = _kernels.stride2_scan(*k6_args)
    want = scan_cuda._stride2_scan_plain(*k6_args)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(err == 0, f"K6 stride-2 scan differs from its plain version "
                      f"({err})")
    one_lane2 = (cls.packed2, C, cls.classes2, hay2[:T2].contiguous(), T2,
                 1, T2, halo2)
    out["stride2_scan"] = {
        "shape": f"L={L2} T={T2} halo={halo2}, packed2 int32 "
                 f"{list(cls.packed2.shape)}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.stride2_scan(*k6_args), 5),
        "plain_ms": cuda_ms(
            lambda: scan_cuda._stride2_scan_plain(*k6_args), 1
        ),
        # haystack, pair table and classes read; int32 pair end states,
        # the lanes' after-halo states and the uint8 mask written
        "bound_ms": bound_ms(
            L2 * T2 * (1 + 2 + 1) + 4 * (cls.packed2.numel() + 257 + L2)
        ),
        "bound_by": "bytes",
        "library_ms": None,
        # one lane alone: (T + halo) / 2 dependent pair-table loads
        "dep_chain_ms": cuda_ms(
            lambda: _kernels.stride2_scan(*one_lane2), 20
        ),
    }

    # K5: the batch kernel at the LONG batch's layout, DFA tables (the
    # batch phases run the default DFA engine)
    buf5, lens5 = batch_layout([d.encode() for d in long_batch])
    hay5 = torch.from_numpy(buf5).to(dev)
    lens5_d = torch.from_numpy(lens5).to(dev)
    k5_args = (dfa.table, dfa.classes, hay5, lens5_d, dfa.match_count,
               dfa.use_classes)
    got = _kernels.batch_scan(*k5_args)
    want = scan_cuda._batch_scan_plain(*k5_args)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(err == 0, f"K5 batch scan differs from its plain version ({err})")
    one_row = (dfa.table, dfa.classes, hay5[:1].contiguous(),
               lens5_d[:1].contiguous(), dfa.match_count, dfa.use_classes)
    B5, T5 = buf5.shape
    out["batch_scan"] = {
        "shape": f"hay2d uint8 [{B5}, {T5}] ({len(long_batch)} real rows), "
                 f"table int32 {list(dfa.table.shape)}",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.batch_scan(*k5_args), 5),
        "plain_ms": cuda_ms(lambda: scan_cuda._batch_scan_plain(*k5_args), 1),
        # buffer, lens, table and match counts read; int32 states and the
        # uint8 mask written
        "bound_ms": bound_ms(
            B5 * T5 * (1 + 4 + 1) + 4 * B5
            + 4 * (dfa.table.numel() + am.num_states)
        ),
        "bound_by": "bytes",
        "library_ms": None,
        # one row alone: T dependent table loads
        "dep_chain_ms": cuda_ms(lambda: _kernels.batch_scan(*one_row), 20),
    }

    # K7: the sparse CSR scan at the sparse path's layout (K2's: the same
    # halo); its plain version walks every failure link of every lane in
    # a vectorised loop and takes seconds here
    sp = scan_cuda.DeviceTables(am, "sparse", dev)
    k7_args = (sp.keys, sp.targets, sp.fail, sp.match_count, hay, n, L, T,
               halo)
    got = _kernels.sparse_scan(*k7_args)
    want = scan_cuda._sparse_scan_plain(*k7_args)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(err == 0, f"K7 sparse scan differs from its plain version "
                      f"({err})")
    one_lane7 = (sp.keys, sp.targets, sp.fail, sp.match_count,
                 hay[:T].contiguous(), T, 1, T, halo)
    E = sp.keys.numel()
    out["sparse_scan"] = {
        "shape": f"L={L} T={T} halo={halo}, keys int64 [{E}], fail int32 "
                 f"[{sp.fail.numel()}]",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.sparse_scan(*k7_args), 5),
        "plain_ms": cuda_ms(
            lambda: scan_cuda._sparse_scan_plain(*k7_args), 1, warmup=0
        ),
        # haystack, keys, targets, fail links and match counts read; int32
        # states and the uint8 mask written
        "bound_ms": bound_ms(
            L * T * (1 + 4 + 1) + 12 * E + 8 * am.num_states
        ),
        "bound_by": "bytes",
        "library_ms": None,
        # one lane alone: T + halo steps of binary searches and fail walks
        "dep_chain_ms": cuda_ms(lambda: _kernels.sparse_scan(*one_lane7), 5),
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
        d: scan_teddy.TeddyScanner(
            am, pf, t.table, t.classes, t.match_count, t.use_classes
        )
        for d, t in dfa.items()
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
            "want": want}


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
        "packed2_bytes": am.packed2_bytes,
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
    return {"launches": launches, "matches": len(got), "device_call_s": times}


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
    text = "a" * (16 << 20)
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
    return {"rerouted_to": tier, "matches": len(got), "launches": launches}


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
    out_dir = os.path.join(HERE, "chiprun_out", "shard")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{backend}{world}"
    rdv = os.path.join(out_dir, f"rendezvous_{tag}")
    if os.path.exists(rdv):
        os.remove(rdv)
    procs = []
    try:
        for r in range(world):
            out = os.path.join(out_dir, f"{tag}_rank{r}.json")
            log_path = os.path.join(out_dir, f"{tag}_rank{r}.log")
            with open(log_path, "w") as log_f:
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--shard-child", "--rank", str(r), "--world",
                     str(world), "--backend", backend, "--init",
                     f"file://{rdv}", "--out", out],
                    cwd=HERE, stdout=log_f, stderr=subprocess.STDOUT,
                ), out, log_path))
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        # a rank that fails leaves its peers waiting in a collective: stop
        # waiting at the first failure
        while any(p.poll() is None for p, _, _ in procs):
            if any(p.returncode not in (None, 0) for p, _, _ in procs):
                break
            if time.monotonic() > deadline:
                raise SmokeFailure(f"{tag} ranks still running at the "
                                   "deadline")
            time.sleep(0.2)
        bad = [(r, p.returncode, lp) for r, (p, _, lp) in enumerate(procs)
               if p.returncode not in (None, 0)]
        if bad:
            with open(bad[0][2]) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(
                f"{tag} ranks {[(r, rc) for r, rc, _ in bad]} failed; "
                f"rank {bad[0][0]}:\n{tail}"
            )
        records = []
        for _, out, _ in procs:
            with open(out) as f:
                records.append(json.load(f))
        return records
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


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


KERNELS = {
    "fire": ("K1 fire", "ahocorasick_rs_tpu_torch/csrc/teddy.cu",
             "ahocorasick_rs_tpu/ops/scan_teddy.py:187"),
    "lane_scan": ("K2 lane_scan", "ahocorasick_rs_tpu_torch/csrc/scan.cu",
                  "ahocorasick_rs_tpu/ops/scan_jax.py:72"),
    "compact": ("K3 compact", "ahocorasick_rs_tpu_torch/csrc/scan.cu",
                "ahocorasick_rs_tpu/ops/scan_jax.py:94"),
    "verify": ("K4 verify", "ahocorasick_rs_tpu_torch/csrc/teddy.cu",
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
    for src, text in _kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or "error" in line:
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
    report["paths"] = paths

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
        if "dep_chain_ms" in k:
            rows[-1]["dep_chain_ms"] = k["dep_chain_ms"]
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
