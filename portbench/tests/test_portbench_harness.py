"""The harness finds every cell's parts by name, keeps the contract's
shapes, and loads nothing of JAX.  CPU only, tiny sizes."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import config, host, run, traffic
from portbench.cell import load_reader

ROOT = run.ROOT
BENCH = run.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(cell):
    spec = run.cell_spec(BENCH, cell)
    assert spec["config"]["chips"] == spec["chips"]
    assert spec["traffic"]["call"] in ("doc", "batch")
    assert config.plugin("recipes", spec["config"]["patterns"]["recipe"])
    assert config.plugin("texts", spec["traffic"]["text"])
    assert spec["end_to_end"] and spec["per_layer"]
    assert ("setup_s", "s") in spec["end_to_end"]
    for name, _unit in spec["end_to_end"] + spec["per_layer"]:
        assert callable(load_reader(name))


@pytest.mark.parametrize(
    "metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
)
def test_every_metric_has_a_reader_and_a_lawful_name(metric):
    assert NAME.match(metric)
    assert callable(load_reader(metric))


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for key in ("backend", "binding", "guarantees", "assumed"):
            assert conf[key]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        # every cell that reports the layer metric reports what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {
        "ahocorasick_rs_tpu_torch": 1, "ahocorasick_rs_tpu_torch.api": 1,
        "jaxtyping": 1, "flaxen": 1, "portbench": 1,
    }
    assert run.forbidden_modules(mods) == []
    mods.update({"ahocorasick_rs_tpu.api": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax": 1})
    assert run.forbidden_modules(mods) == [
        "ahocorasick_rs_tpu.api", "flax", "jax", "jaxlib.xla"]


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run in a fresh process, then the check."""
    code = (
        "import time, json, sys\n"
        "from portbench import run\n"
        "from portbench.cell import run_cell\n"
        "spec = run.cell_spec(run.load_bench(), 'names1k-doc64m')\n"
        "spec['traffic'].update(doc_chars=200_000)\n"
        "out = run_cell(spec, 3, 0.5, False, t_start=time.time(),\n"
        "               devices=['cpu'])\n"
        "assert out['correct'], out\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


def test_no_card_exits_nonzero_with_no_result():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "names1k-doc64m", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_alone_without_the_port_exits_nonzero(tmp_path):
    """Only BENCHMARK.json and portbench/: the port cannot be imported."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "names1k-doc64m", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_cpulist_and_bus_id():
    assert host.parse_cpulist("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert host._cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"
    assert host.sysfs_bus_id("00000000:1A:00.0") == "0000:1a:00.0"


def test_bind_without_nvidia_smi_leaves_affinity(monkeypatch):
    before = os.sched_getaffinity(0)
    monkeypatch.setattr(host, "_smi", lambda query: [])
    rec = host.bind(1)
    assert rec["bound"] is False and os.sched_getaffinity(0) == before


def test_bind_takes_the_card_cpus_the_host_allows(monkeypatch, tmp_path):
    allowed = sorted(os.sched_getaffinity(0))
    monkeypatch.setattr(host, "_smi", lambda q: [["00000000:18:00.0"]])
    monkeypatch.setattr(host, "card_cpus",
                        lambda cards: ({allowed[0], 100000}, "test"))
    before = os.sched_getaffinity(0)
    try:
        rec = host.bind(1)
        assert rec["bound"] and os.sched_getaffinity(0) == {allowed[0]}
    finally:
        os.sched_setaffinity(0, before)


def test_traffic_files_are_data():
    for w in BENCH["workloads"]:
        params = traffic.load(w["traffic"])
        assert isinstance(params, dict) and params["call"] in ("doc", "batch")


def test_no_bus_id_leaves_the_process_unbound(monkeypatch):
    """A virtual machine's card has no bus id, so no local_cpulist: the
    binding gives up and says why."""
    before = os.sched_getaffinity(0)
    monkeypatch.setattr(host, "_smi", lambda q: [["[N/A]"]])
    assert host.card_cpus(1)[0] is None
    rec = host.bind(1)
    assert rec["bound"] is False and "[N/A]" in rec["why"]
    assert os.sched_getaffinity(0) == before


CONFIGS = sorted(os.listdir(os.path.join(run.HERE, "configs")))


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_file_has_only_known_keys(name):
    cfg = config.load(os.path.join(run.HERE, "configs", name))
    assert "where the host lists none" in cfg["binding"]
    assert config.patterns(cfg, 1)


@pytest.mark.parametrize("key,value,err", [
    ("overlaping", True, "unknown configuration keys"),
    ("mesh", "global", "unknown mesh"),
    ("patterns", {"count": 3}, "no recipe"),
])
def test_a_config_key_the_harness_does_not_read_is_refused(key, value, err):
    cfg = config.load(os.path.join(run.HERE, "configs", CONFIGS[0]))
    cfg[key] = value
    with pytest.raises(ValueError, match=err):
        config.check(cfg)


def test_a_recipe_parameter_it_does_not_take_is_refused():
    with pytest.raises(TypeError):
        config.patterns({"patterns": {"recipe": "names", "count": 5,
                                      "alphabet": "ab"}}, 1)
    with pytest.raises(ValueError):
        config.plugin("recipes", "../names")


def test_memory_and_build_readers():
    mem = host.memory()
    assert set(mem) == {"rss_kb", "hwm_kb", "mem_available_kb",
                        "cached_kb", "maxrss_kb"}
    assert all(isinstance(v, int) for v in mem.values())
    assert host.tree_bytes(os.path.join(run.HERE, "configs")) > 0
    assert host.tree_bytes(os.path.join(run.HERE, "no_such_dir")) == 0
