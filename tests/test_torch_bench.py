"""PyTorch port, the benchmark tool
(``python -m ahocorasick_rs_tpu_torch.tools.bench``) on the CPU.

Its recipes equal root ``bench.py``'s (loaded from its file) list for list
and byte for byte; a ``--device cpu --scale 16`` run of every section
prints one JSON line with ``bench.py``'s keys (``gpu_`` for ``tpu_``) and
no ``*_error`` key, and its match counts equal what the JAX package's
public API counts on the same inputs; ``--scale`` cuts counts and keeps
lengths; without a card, or when a section raises, the command exits
non-zero and prints no line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
from ahocorasick_rs_tpu_torch.tools import _synth, bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_BENCH = os.path.join(ROOT, "bench.py")
#: the scale of the CPU run: 4 MiB north star, 625 SHORT and 1,250 LONG
#: documents, 8 MiB of match-dense input (about 20 s alone)
SCALE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, which share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root_bench():
    """Root ``bench.py``, loaded from its file (it imports JAX only inside
    its sections, none of which runs here)."""
    spec = importlib.util.spec_from_file_location("_root_bench", ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(argv: list[str]) -> list[str]:
    """``bench.main(argv)`` in this process; its standard output's lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(argv) == 0
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def cpu_line() -> dict:
    lines = _run(["--device", "cpu", "--scale", str(SCALE)])
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("seed", [7, 1234, 55])
def test_recipes_equal_root_bench(root_bench, seed: int) -> None:
    """``make_datasets``, ``synth_names`` and ``synth_corpus`` make
    ``bench.py``'s lists and bytes from the same generator state, and leave
    the generator where ``bench.py``'s do."""
    got_rng, want_rng = (np.random.default_rng(seed) for _ in range(2))
    assert _synth.make_datasets(got_rng) == root_bench.make_datasets(want_rng)
    names = _synth.synth_names(300, got_rng)
    assert names == root_bench.synth_names(300, want_rng)
    got = _synth.synth_corpus(1 << 20, names, got_rng)
    want = root_bench.synth_corpus(1 << 20, names, want_rng)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got_rng.integers(0, 1 << 62) == want_rng.integers(0, 1 << 62)


def _bench_detail_keys() -> set[str]:
    """The keys ``bench.py`` writes into ``detail``, ``tpu_`` read as
    ``gpu_``, its ``*_error`` and no-device ``note`` left out."""
    with open(ROOT_BENCH) as f:
        src = f.read()
    keys = set(re.findall(r'detail\[\s*"([a-z0-9_]+)"\s*\]', src))
    keys |= {"haystack_mb", "patterns", "states", "paths_run"}
    return {k.replace("tpu_", "gpu_", 1) for k in keys
            if not k.endswith("_error") and k != "note"}


def _keys(obj) -> set[str]:
    if isinstance(obj, dict):
        return set(obj) | {k for v in obj.values() for k in _keys(v)}
    if isinstance(obj, list):
        return {k for v in obj for k in _keys(v)}
    return set()


def test_cpu_run_has_bench_keys(cpu_line) -> None:
    """One line with ``bench.py``'s top-level keys; ``detail`` holds every
    key ``bench.py`` writes there with ``gpu_`` for ``tpu_``; no
    ``*_error`` key anywhere; the five north-star paths ran, and every
    section records its tier, launches and first call."""
    assert set(cpu_line) == {"metric", "value", "unit", "vs_baseline",
                             "detail"}
    assert cpu_line["metric"] == "dfa_scan_haystack_throughput_per_chip"
    assert cpu_line["unit"] == "GB/s"
    d = cpu_line["detail"]
    assert _bench_detail_keys() <= set(d), _bench_detail_keys() - set(d)
    assert not [k for k in _keys(cpu_line) if k.endswith("_error")]
    assert d["paths_run"] == ["cpu_native", "cpu_lanes", "gpu_plain",
                              "gpu_stride2", "gpu_teddy"]
    assert cpu_line["value"] == max(d[k] for k in bench.HEADLINE_PATHS)
    assert cpu_line["vs_baseline"] == pytest.approx(
        cpu_line["value"] / d["cpu_native_gbps"])
    assert d["device"]["name"] == "cpu" and d["build_seconds"] is None
    assert set(d["first_seconds"]) == {"gpu_plain", "gpu_stride2",
                                       "gpu_teddy"}
    # the counters count launches on a card only
    assert set(d["launches"]) >= {"gpu_plain", "gpu_stride2", "gpu_teddy"}
    assert not any(d["launches"].values())
    for ds in d["scenarios"].values():
        assert ds["batch_backend"] and "first_seconds" in ds
        assert "launches" in ds
    md = d["match_dense"]
    for entry in (md["leftmost_longest"], md["standard_16mb"]):
        assert entry["scan_backend"] and "launches" in entry
    assert "first_seconds" in md["standard_16mb"]
    for key in ("large_set", "million_set", "bytes_overlapping_1gb",
                "sparse_device_forced"):
        assert {"scan_backend", "launches", "first_seconds"} <= set(d[key])
    assert d["sparse_device_forced"]["scan_backend"] == "device"
    assert list(d["seconds_by_section"]) == list(bench.SECTIONS)


def _ref_count(section: str) -> int:
    """What the JAX package's public API counts on the CPU run's inputs,
    in the bench's own terms."""
    if section == "north_star":  # matched positions of the plain scan
        names, hay = bench.north_star_inputs(SCALE)
        got = ref.BytesAhoCorasick(names).find_matches_as_indexes(
            hay.tobytes(), overlapping=True)
        return len({end for _, _, end in got})
    if section == "sparse_device_forced":
        pats, data = bench.sparse_inputs(SCALE)
        return len(ref.BytesAhoCorasick(
            pats, implementation=ref.Implementation.NoncontiguousNFA,
        ).find_matches_as_indexes(data))
    patterns, docs = _synth.make_datasets(
        np.random.default_rng(7), SCALE)[section]
    return sum(map(len, ref.AhoCorasick(patterns)
                   .find_matches_as_indexes_batch(docs)))


@pytest.mark.parametrize(
    "section", ["north_star", "short", "long", "sparse_device_forced"])
def test_cpu_run_matches_equal_reference(cpu_line, section: str) -> None:
    d = cpu_line["detail"]
    got = {"north_star": d["matches"],
           "short": d["scenarios"]["short"]["matches"],
           "long": d["scenarios"]["long"]["matches"],
           "sparse_device_forced": d["sparse_device_forced"]["matches"],
           }[section]
    want = _ref_count(section)
    assert want > 0
    assert got == want


def test_cpu_run_match_dense_counts(cpu_line) -> None:
    """The nested patterns reach ``a*64`` at any scale: leftmost-longest
    takes one match per 64 bytes, standard one per byte."""
    md = cpu_line["detail"]["match_dense"]
    n = (128 << 20) // SCALE
    assert md["leftmost_longest"]["matches"] == n // 64
    assert md["standard_16mb"]["matches"] == (16 << 20) // SCALE
    assert md["occurrence_set_size"] == sum(n - k + 1 for k in range(1, 65))


@pytest.mark.parametrize("scale", [1, 16, 1024])
def test_scale_keeps_lengths(scale: int) -> None:
    """``--scale`` divides counts and sizes; LONG lines stay 624-633
    characters, SHORT documents 72-75, names 5-11 bytes, and the nested
    patterns reach ``a*64``."""
    data = _synth.make_datasets(np.random.default_rng(7), scale)
    names, long_docs = data["long"]
    short_patterns, short_docs = data["short"]
    assert len(names) == max(1, 1000 // scale)
    assert len(long_docs) == max(1, 20_000 // scale)
    assert len(short_docs) == max(1, 10_000 // scale)
    assert short_patterns == list(_synth.SHORT_PATTERNS)
    assert {5 <= len(x) <= 11 for x in names} == {True}
    lens = {len(x) for x in long_docs}
    assert min(lens) >= 624 and max(lens) <= 633
    assert {72 <= len(x) <= 75 for x in short_docs} == {True}
    assert [len(p) for p in bench.NESTED] == list(range(1, 65))
    if scale > 1:  # the 64 MiB corpus is not made here at scale 1
        ns_names, hay = bench.north_star_inputs(scale)
        assert len(hay) == (64 << 20) // scale
        assert len(ns_names) == max(1, 1000 // scale)


def test_sections_subset_in_bench_order() -> None:
    lines = _run(["--device", "cpu", "--scale", "1024", "--sections",
                  "sparse_device_forced,scenarios"])
    d = json.loads(lines[0])["detail"]
    assert list(d["seconds_by_section"]) == ["scenarios",
                                             "sparse_device_forced"]
    assert "match_dense" not in d and "paths_run" not in d


@pytest.mark.parametrize("argv", [
    ["--scale", "3"], ["--scale", "2048"], ["--scale", "0"],
    ["--sections", "north_star,nope"], ["--sections", ","],
])
def test_bad_arguments_exit_nonzero(argv: list[str]) -> None:
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", *argv])
    assert e.value.code != 0


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_card_exits_nonzero(monkeypatch, capsys, device) -> None:
    """Without a card, and without ``--device cpu``, it stops before any
    section with a message that names ``--device cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if device is None else ["--device", device]
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert isinstance(e.value.code, str) and "--device cpu" in e.value.code
    assert capsys.readouterr().out == ""


def test_failing_section_exits_nonzero() -> None:
    """A section that raises ends the command with a non-zero code, its
    traceback, and no line (so no ``*_error`` key either)."""
    code = (
        "import sys\n"
        "from ahocorasick_rs_tpu_torch.tools import bench\n"
        "def boom(run, detail):\n"
        "    raise ValueError('planted failure')\n"
        "bench.SECTIONS['large_set'] = boom\n"
        "sys.exit(bench.main(['--device', 'cpu', '--scale', '1024',\n"
        "                     '--sections', 'scenarios,large_set']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "planted failure" in proc.stderr
    assert "bench: scenarios" in proc.stderr
