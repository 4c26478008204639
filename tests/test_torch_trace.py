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
#: DOC with a non-ASCII character on each of its lines: it is encoded
DOC_UTF8 = DOC.replace("\n", " \u00e9\n")
LINES = traffic.inputs(NAMES, dict(traffic.load("lines20k"), corpus_lines=300,
                                   lines_per_call=300), SEED)[0]
NEW_METRICS = {
    "names1k-doc64m": ["encode_ms.doc", "pad_ms.doc", "pin_ms.doc",
                       "host_bytes_per_byte.doc"],
    "names4k-lines20k": ["encode_ms.batch", "pad_ms.batch", "pin_ms.batch",
                         "gc_full_ms.batch", "host_bytes_per_byte.batch",
                         "h2d_bytes_per_byte.batch"],
    # the doc metrics read in the binary cell too; scan_roofline.doc reads
    # kernel time, which a CPU trace lacks
    "bytes50k-bin1g": ["stage_ms.doc", "pad_ms.doc", "pin_ms.doc",
                       "resolve_ms.doc", "api_self_ms.doc", "doc_call_p95_ms",
                       "device_idle_pct.doc", "host_bytes_per_byte.doc"],
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


def test_a_document_with_no_tail_opens_one_pad_span_a_call():
    """1,024 rows of 128 bytes fill the Teddy layout: nothing is padded,
    and the call still opens one (empty) ``pad`` span, so ``pad_ms.doc``
    reads a time and not nothing."""
    doc = DOC.encode()[: 1024 * 128].decode()
    assert len(doc.encode()) == 1024 * 128
    ac = _teddy()
    assert ac.find_matches_as_indexes(doc)
    trace.reset_counters()
    rec = _traced(lambda: [ac.find_matches_as_indexes(doc) for _ in range(2)])
    assert ac.stats()["last_backend"] == "teddy"
    assert sum(r[0] == "pad" for r in rec.ranges) == 2
    assert sum(r[0] == "pin" for r in rec.ranges) == 2
    c = trace.counters()
    assert (c["pad_bytes"], c["pin_bytes"]) == (0, 2 * 1024 * 128)


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
    rows_p = max(min(scan_teddy.BLOCK_ROWS, scan_cuda._bucket(rows, lo=8)),
                 scan_cuda._bucket(rows, lo=8))
    trace.reset_counters()
    call()
    # an ASCII document is staged from the string's own storage
    assert trace.counters() == {
        "scanned_bytes": n, "str_view_bytes": n,
        "pad_bytes": rows_p * 128 - n, "pin_bytes": n,
        "h2d_bytes": rows_p * 128,
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
        "scanned_bytes": n, "str_view_bytes": n, "pad_bytes": L * T - n,
        "pin_bytes": n, "h2d_bytes": L * T,
    }


@pytest.mark.parametrize("path", ["teddy", "dense"])
def test_counters_of_a_non_ascii_document_path(path, monkeypatch):
    ac, _call = _warm(path)
    layouts = _spy(monkeypatch, scan_cuda, "choose_layout")
    n = len(DOC_UTF8.encode())
    trace.reset_counters()
    assert ac.find_matches_as_indexes(DOC_UTF8)
    assert ac.stats()["last_backend"] == PATHS[path][2]
    c = trace.counters()
    if path == "dense":
        [(L, T)] = layouts
        assert (c["pad_bytes"], c["h2d_bytes"]) == (L * T - n, L * T)
    assert c["scanned_bytes"] == c["encode_bytes"] == c["pin_bytes"] == n
    assert "str_view_bytes" not in c


def test_counters_of_the_batch_path():
    _ac, call = _warm("batch")
    S = sum(len(x.encode()) for x in LINES)
    T = scan_cuda._bucket(max(max(len(x) for x in LINES), 16), lo=16)
    Bb = scan_cuda._bucket(max(len(LINES), scan_cuda.MIN_LANES),
                           lo=scan_cuda.MIN_LANES)
    trace.reset_counters()
    call()
    # the rows zeroed once, the lines and their int32 lengths written
    # into them, and both copied to the device
    assert trace.counters() == {
        "scanned_bytes": S, "encode_bytes": S, "pad_bytes": Bb * T,
        "pin_bytes": S + 4 * Bb, "h2d_bytes": Bb * T + 4 * Bb,
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
    n = len(DOC.encode())
    c = trace.counters()
    assert (c["pin_bytes"], c["pad_bytes"], c["h2d_bytes"]) == (
        n, 2 * L * T - n, 2 * L * T)
    assert c["scanned_bytes"] == c["str_view_bytes"] == n
    assert "encode_bytes" not in c


def _mesh_dense(ranks: int) -> AhoCorasick:
    ac = AhoCorasick(NAMES, implementation=Implementation.DFA,
                     backend="sharded", device="cpu",
                     mesh=sharded.make_mesh(devices=["cpu"] * ranks))
    ac._teddy_state = "off"
    assert ac.find_matches_as_indexes(DOC)
    assert ac.stats()["last_backend"] == "sharded"
    return ac


def test_gather_bytes_of_a_four_rank_call_equal_the_shapes():
    """Each of four ranks receives the other three ranks' tails (``halo``
    int32 bytes) and their outputs (positions, states and the total,
    int64, at the capacity the call ran at)."""
    ac = _mesh_dense(4)
    halo = ac._automaton.max_len - 1
    cap = ac._get_device_tables().last_cap
    trace.reset_counters()
    ac.find_matches_as_indexes(DOC)
    assert ac._get_device_tables().last_cap == cap  # one run, no retry
    assert trace.counters()["gather_bytes"] == 4 * 3 * (
        4 * halo + 8 * (2 * cap + 1))


def test_a_process_group_counts_the_other_ranks_parts(monkeypatch):
    """A ``ShardGroup`` of four process ranks receives three parts of the
    tensor it sends; a world of one rank receives none."""
    g = sharded.ShardGroup(None)
    trace.reset_counters()
    g.all_gather(torch.zeros(5, dtype=torch.int64))
    assert trace.counters().get("gather_bytes", 0) == 0
    g.group, g.rank, g.size = object(), 1, 4

    def all_gather(parts, t, group=None):
        for p in parts:
            p.copy_(t)

    monkeypatch.setattr(sharded.dist, "all_gather", all_gather)
    got = g.all_gather(torch.arange(6, dtype=torch.int32))
    assert got.shape == (4, 6)
    assert trace.counters()["gather_bytes"] == 3 * 6 * 4


def test_the_ranks_span_is_the_calling_threads():
    """Under a session the calling thread of a four-rank call holds
    ``ranks``; every rank's ``stage``, ``exchange`` and ``gather`` lie
    inside it in time, on threads of their own."""
    import threading

    ac = _mesh_dense(4)
    rec = _traced(lambda: ac.find_matches_as_indexes(DOC))
    me = threading.get_ident()
    ranks = [r for r in rec.ranges if r[0] == "ranks"]
    assert len(ranks) == 1 and ranks[0][1] == me
    _n, _t, a, b = ranks[0]
    inner = [r for r in rec.ranges if r[0] in ("stage", "exchange", "gather")]
    assert {r[0] for r in inner} == {"stage", "exchange", "gather"}
    assert len({r[1] for r in inner}) == 4 and me not in {r[1] for r in inner}
    assert all(a <= c and d <= b for _m, _u, c, d in inner)


def test_api_self_time_leaves_the_ranks_out():
    """A call that is only a local mesh's run is almost all ``ranks``: its
    API self time is the rest, and without the span it would be the
    whole call."""
    import threading

    from portbench.trace import CALL_SPAN, summarize

    mesh = sharded.make_mesh(devices=["cpu"] * 4)
    me = threading.get_ident()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ), SpanRecorder() as rec:
        a = time.perf_counter()
        mesh.run(lambda g: time.sleep(0.2))
        b = time.perf_counter()
    events = [(CALL_SPAN, False, -1, a * 1e6, b * 1e6)]
    got = summarize(events, rec, [(me, a, b)], 1)
    assert b - a >= 0.2
    assert got.api_self_s < 0.05
    assert got.span_s["ranks"] >= 0.2
    rec.ranges = [r for r in rec.ranges if r[0] != "ranks"]
    assert summarize(events, rec, [(me, a, b)], 1).api_self_s >= 0.2


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
        # every document is 120,000 ASCII bytes and stages one L x T
        # layout: pinned once from the string's own storage, never
        # encoded, and only the layout's tail padded
        (L, T), = set(layouts)
        assert "encode_bytes" not in c
        assert c["str_view_bytes"] == c["scanned_bytes"]
        assert got["host_bytes_per_byte.doc"]["value"] == pytest.approx(
            L * T / 120_000)
    elif cell == "bytes50k-bin1g":
        # one segment a document, not encoded: pinned once and its
        # layout's tail padded, the whole layout copied to the device
        (L, T), = set(layouts)
        assert "encode_bytes" not in c
        assert got["host_bytes_per_byte.doc"]["value"] == pytest.approx(
            L * T / 120_000)
        assert c["h2d_bytes"] / c["scanned_bytes"] == pytest.approx(
            L * T / 120_000)
    else:
        S = c["scanned_bytes"]
        assert got["host_bytes_per_byte.batch"]["value"] == pytest.approx(
            (c["encode_bytes"] + c["pad_bytes"] + c["pin_bytes"]) / S)
        assert got["h2d_bytes_per_byte.batch"]["value"] == pytest.approx(
            c["h2d_bytes"] / S)
        # the lens: 4 bytes a row, written and copied beside the rows
        assert c["pin_bytes"] - S == c["h2d_bytes"] - c["pad_bytes"] > 0
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


def test_the_mesh_cell_reports_its_exchange_metrics():
    """The four-card cell, cut to a 1 MiB document on four CPU ranks with
    its seams where they cut it: the exchange's span and counter metrics
    read, the calling thread's wait is labelled ``ranks``, and the API's
    own time is a small part of a call."""
    spec = run.cell_spec(run.load_bench(), "pii100k-doc1g-mesh4")
    spec["traffic"].update(doc_chars=1 << 20, seam_bytes=1 << 18)
    trace.reset_counters()
    out = run_cell(spec, SEED, 0.5, True, t_start=time.time(),
                   devices=["cpu"] * 4, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["host"]["last_backend"] == "sharded"
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["exchange_ms.doc"] > 0
    c = trace.counters()
    assert got["gather_bytes_per_byte.doc"] == pytest.approx(
        c["gather_bytes"] / c["scanned_bytes"])
    assert got["api_self_ms.doc"] < got["doc_call_p95_ms"] / 10
    assert "ranks" in {k for k, _ in out["breakdown"]["idle_gaps"]}


def test_the_gather_reader_reads_nothing_without_the_counter(monkeypatch):
    class W:
        call = "doc"
        trace = None

    read = load_reader("gather_bytes_per_byte.doc")
    trace.reset_counters()
    trace.count("scanned_bytes", 100)
    assert read(W()) is None  # no sharded call, or a port that counts none
    trace.count("gather_bytes", 30)
    assert read(W()) == pytest.approx(0.3)
    W.call = "batch"
    assert read(W()) is None
    W.call = "doc"
    import ahocorasick_rs_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "ahocorasick_rs_tpu_torch.utils.trace",
                        None)
    assert read(W()) is None
