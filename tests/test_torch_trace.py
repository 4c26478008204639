"""The port's tracing (``ahocorasick_rs_tpu_torch/utils/trace.py``): spans
that open only while a ``torch.profiler`` session runs, the garbage
collector's ranges, the process-wide byte counters held to the staged
shapes, and the benchmark's readers of both.  CPU, small sizes."""

from __future__ import annotations

import gc
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import ahocorasick_rs_tpu_torch.api as api  # noqa: E402
from ahocorasick_rs_tpu_torch import (  # noqa: E402
    AhoCorasick,
    BytesAhoCorasick,
    Implementation,
    MatchKind,
)
from ahocorasick_rs_tpu_torch.ops import scan_cuda, scan_teddy  # noqa: E402
from ahocorasick_rs_tpu_torch.parallel import sharded  # noqa: E402
from ahocorasick_rs_tpu_torch.utils import trace  # noqa: E402
from portbench import config, run, traffic  # noqa: E402
from portbench.cell import load_reader, run_cell  # noqa: E402
from portbench.trace import SpanRecorder  # noqa: E402

SEED = 3
NAMES = config.patterns({"patterns": {"recipe": "names", "count": 200}}, SEED)
#: one document of the LONG text, and a batch of its lines
DOC = traffic.inputs(NAMES, dict(traffic.load("doc64m"), doc_chars=150_000,
                                 distinct=1), SEED)[0]
LINES = traffic.inputs(NAMES, dict(traffic.load("lines20k"), corpus_lines=300,
                                   lines_per_call=300), SEED)[0]
NEW_METRICS = {
    "names1k-doc64m": ["encode_ms.doc", "pad_ms.doc", "pin_ms.doc",
                       "host_bytes_per_byte.doc"],
    "names4k-lines20k": ["encode_ms.batch", "pad_ms.batch", "pin_ms.batch",
                         "gc_full_ms.batch", "host_bytes_per_byte.batch",
                         "h2d_bytes_per_byte.batch"],
}


def _teddy() -> AhoCorasick:
    ac = AhoCorasick(NAMES, matchkind=MatchKind.LeftmostLongest,
                     implementation=Implementation.DFA, backend="device",
                     device="cpu")
    ac._teddy_state = "force"
    return ac


def _dense() -> AhoCorasick:
    ac = AhoCorasick(NAMES, implementation=Implementation.DFA,
                     backend="device", device="cpu")
    ac._teddy_state = "off"
    return ac


#: each path: a matcher, its call, and the backend it must take
PATHS = {
    "teddy": (_teddy, lambda ac: ac.find_matches_as_indexes(DOC), "teddy"),
    "dense": (_dense, lambda ac: ac.find_matches_as_indexes(DOC), "device"),
    "batch": (_dense, lambda ac: ac.find_matches_as_indexes_batch(LINES),
              "device_batch"),
}


def _warm(path: str):
    make, call, backend = PATHS[path]
    ac = make()
    assert call(ac)
    assert ac.stats()["last_backend"] == backend
    return ac, lambda: call(ac)


def _traced(fn) -> SpanRecorder:
    """``fn()`` under a CPU profiler session, its ranges read through the
    benchmark's recorder."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts), SpanRecorder() as rec:
        fn()
    return rec


def test_span_without_a_session_is_one_shared_noop():
    assert not trace._session_on()
    assert trace.span("stage") is trace.span("pad")
    with trace.span("stage") as got:
        assert got is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_session_opens_no_range_and_no_gc_hook(path, monkeypatch):
    _ac, call = _warm(path)
    before = list(gc.callbacks)

    def refuse(*a, **k):
        raise AssertionError("a range was opened with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert call()
    gc.collect()
    assert gc.callbacks == before


def test_bytes_matcher_without_a_session_opens_no_range(monkeypatch):
    ac = BytesAhoCorasick([n.encode() for n in NAMES], backend="device",
                          device="cpu")
    ac._teddy_state = "off"

    def refuse(*a, **k):
        raise AssertionError("a range was opened with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert ac.find_matches_as_indexes(DOC.encode())
    assert ac.find_matches_as_indexes_batch([x.encode() for x in LINES])


def _inside(inner, outers) -> bool:
    _n, tid, a, b = inner
    return any(t == tid and c <= a and b <= d for _m, t, c, d in outers)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_session_records_encode_stage_pad_and_pin(path):
    _ac, call = _warm(path)
    rec = _traced(call)
    names = {r[0] for r in rec.ranges}
    want = {"encode", "stage", "pad", "pin"}
    if path == "batch":
        want |= {"expand", "scan_batch", "resolve"}
    assert want <= names, names
    stages = [r for r in rec.ranges if r[0] == "stage"]
    for r in rec.ranges:
        if r[0] in ("pad", "pin"):
            assert _inside(r, stages), r
    # one encode a call, never one a line
    assert sum(r[0] == "encode" for r in rec.ranges) == 1


def test_batch_expand_is_inside_scan_batch_and_read_by_resolve_ms():
    _ac, call = _warm("batch")
    rec = _traced(call)
    expands = [r for r in rec.ranges if r[0] == "expand"]
    assert len(expands) == 1
    assert _inside(expands[0], [r for r in rec.ranges if r[0] == "scan_batch"])


@pytest.mark.parametrize("generation,label", [
    (0, "gc_young"), (1, "gc_young"), (2, "gc_full")])
def test_a_collection_in_a_session_is_a_range(generation, label):
    _ac, call = _warm("dense")

    def fn():
        call()  # the first span puts the hook in
        assert trace._on_gc in gc.callbacks
        gc.collect(generation)

    rec = _traced(fn)
    got = [r for r in rec.ranges if r[0] == label]
    assert got, {r[0] for r in rec.ranges}
    # the session is over: the next call takes the hook out
    call()
    assert trace._on_gc not in gc.callbacks


def test_the_hook_leaves_the_other_callbacks_whole():
    """With the session over, a collection that finds the hook last takes
    it out at once; the callback before it still sees both phases.  Where
    another callback follows it, it stays for the next span to take out."""
    seen: list[str] = []

    def other(phase, info):
        seen.append(phase)

    gc.callbacks.append(other)
    try:
        trace._hook()
        gc.collect()
        assert seen == ["start", "stop"]
        assert trace._on_gc not in gc.callbacks and not trace._gc_hooked

        trace._hook()
        gc.callbacks.append(other)
        seen.clear()
        gc.collect()
        assert seen == ["start", "start", "stop", "stop"]
        assert trace._on_gc in gc.callbacks
        trace.span("stage")
        assert trace._on_gc not in gc.callbacks
    finally:
        while other in gc.callbacks:
            gc.callbacks.remove(other)
        trace._unhook()


def _spy(monkeypatch, module, name) -> list:
    """Every value ``module.name`` returns, kept in a list."""
    got: list = []
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        got.append(out)
        return out

    monkeypatch.setattr(module, name, spy)
    return got


def test_counters_of_the_teddy_document_path():
    _ac, call = _warm("teddy")
    n = len(DOC.encode())
    rows = -(-n // 128)
    rows_p = max(min(scan_teddy.BLOCK_ROWS, scan_teddy._bucket(rows, lo=8)),
                 scan_teddy._bucket(rows, lo=8))
    trace.reset_counters()
    call()
    assert trace.counters() == {
        "scanned_bytes": n, "encode_bytes": n, "pad_bytes": rows_p * 128,
        "pin_bytes": rows_p * 128, "h2d_bytes": rows_p * 128,
    }


def test_counters_of_the_dense_document_path(monkeypatch):
    _ac, call = _warm("dense")
    layouts = _spy(monkeypatch, scan_cuda, "choose_layout")
    n = len(DOC.encode())
    trace.reset_counters()
    call()
    [(L, T)] = layouts
    assert L * T >= n
    assert trace.counters() == {
        "scanned_bytes": n, "encode_bytes": n, "pad_bytes": L * T,
        "pin_bytes": L * T, "h2d_bytes": L * T,
    }


def test_counters_of_the_batch_path():
    _ac, call = _warm("batch")
    S = sum(len(x.encode()) for x in LINES)
    T = scan_cuda._bucket(max(max(len(x) for x in LINES), 16), lo=16)
    Bb = scan_cuda._bucket(max(len(LINES), scan_cuda.MIN_LANES),
                           lo=scan_cuda.MIN_LANES)
    trace.reset_counters()
    call()
    assert trace.counters() == {
        "scanned_bytes": S, "encode_bytes": S, "pad_bytes": Bb * T + 4 * Bb,
        "pin_bytes": Bb * T, "h2d_bytes": Bb * T + 4 * Bb,
    }


def test_counters_of_a_bytes_matcher_have_no_encode():
    ac = BytesAhoCorasick([n.encode() for n in NAMES], backend="device",
                          device="cpu")
    ac._teddy_state = "off"
    docs = [x.encode() for x in LINES]
    trace.reset_counters()
    ac.find_matches_as_indexes_batch(docs)
    ac.find_matches_as_indexes(DOC.encode())
    c = trace.counters()
    assert c["scanned_bytes"] == sum(map(len, docs)) + len(DOC.encode())
    assert "encode_bytes" not in c and c["pad_bytes"] > c["scanned_bytes"]


def test_counters_of_a_local_mesh_count_every_rank(monkeypatch):
    mesh = sharded.make_mesh(devices=["cpu"] * 2)
    ac = AhoCorasick(NAMES, implementation=Implementation.DFA,
                     backend="sharded", mesh=mesh, device="cpu")
    ac._teddy_state = "off"
    ac.find_matches_as_indexes(DOC)
    layouts = _spy(monkeypatch, sharded, "dense_layout")
    trace.reset_counters()
    ac.find_matches_as_indexes(DOC)
    L, T = layouts[0]
    assert len({tuple(x) for x in layouts}) == 1
    c = trace.counters()
    assert c["pad_bytes"] == c["pin_bytes"] == c["h2d_bytes"] == 2 * L * T


def test_counters_add_under_concurrent_threads():
    import threading

    trace.reset_counters()
    threads = [threading.Thread(target=lambda: [
        trace.count("scanned_bytes", 3) for _ in range(2000)])
        for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.counters() == {"scanned_bytes": 16 * 2000 * 3}


def _tiny_spec(cell: str) -> dict:
    spec = run.cell_spec(run.load_bench(), cell)
    if spec["traffic"]["call"] == "doc":
        spec["traffic"].update(doc_chars=120_000)
    else:
        spec["traffic"].update(corpus_lines=600, lines_per_call=300)
    return spec


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_a_traced_cell_reports_every_new_metric(cell, monkeypatch):
    spec = _tiny_spec(cell)
    layouts = _spy(monkeypatch, scan_cuda, "choose_layout")
    if spec["traffic"]["call"] == "batch":
        # a full collection inside every batch call, so the tiny window
        # has some to read
        orig = api._MatcherBase._find_batch

        def collecting(self, docs, overlapping):
            gc.collect()
            return orig(self, docs, overlapping)

        monkeypatch.setattr(api._MatcherBase, "_find_batch", collecting)
    trace.reset_counters()
    out = run_cell(spec, SEED, 0.3, True, t_start=time.time(),
                   devices=["cpu"], log=lambda s: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW_METRICS[cell]:
        assert got[name]["value"] > 0, name
    c = trace.counters()
    if cell == "names1k-doc64m":
        # every document is 120,000 bytes and stages one L x T layout
        (L, T), = set(layouts)
        assert got["host_bytes_per_byte.doc"]["value"] == pytest.approx(
            (120_000 + 2 * L * T) / 120_000)
    else:
        S = c["scanned_bytes"]
        assert got["host_bytes_per_byte.batch"]["value"] == pytest.approx(
            (c["encode_bytes"] + c["pad_bytes"] + c["pin_bytes"]) / S)
        assert got["h2d_bytes_per_byte.batch"]["value"] == pytest.approx(
            c["h2d_bytes"] / S)
        # the lens: 4 bytes a row, staged and copied beside the rows
        assert c["pad_bytes"] - c["pin_bytes"] == \
            c["h2d_bytes"] - c["pin_bytes"] > 0
    gaps = {k for k, _ in out["breakdown"]["idle_gaps"]}
    assert gaps  # the CPU device has no busy time: every gap is idle


@pytest.mark.parametrize("name", [
    "host_bytes_per_byte.doc", "host_bytes_per_byte.batch",
    "h2d_bytes_per_byte.batch"])
def test_counter_readers_read_nothing_without_the_counters(name, monkeypatch):
    class W:
        call = name.rsplit(".", 1)[1]
        trace = None

    read = load_reader(name)
    trace.reset_counters()
    assert read(W()) is None  # nothing scanned
    trace.count("scanned_bytes", 10)
    trace.count("h2d_bytes", 20)
    assert read(W()) is not None
    W.call = "batch" if W.call == "doc" else "doc"
    assert read(W()) is None  # the other call kind
    W.call = name.rsplit(".", 1)[1]
    # a port without the counters (the parent of this module)
    import ahocorasick_rs_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "ahocorasick_rs_tpu_torch.utils.trace",
                        None)
    assert read(W()) is None
