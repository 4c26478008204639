"""The frozen generators give the port's tools' bytes from the same seed,
every seed gives the same sizes, and every mix, text and recipe is found
by its name.  CPU, tiny sizes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from ahocorasick_rs_tpu_torch.tools import _synth, bench_vs_reference
from portbench import config, traffic
from portbench.recipes import names as names_recipe
from portbench.recipes import short
from portbench.texts import long_lines, short_lines

MIXES = sorted(f[:-5] for f in os.listdir(traffic.HERE) if f.endswith(".json"))


def pattern_names(count: int, seed: int) -> list[str]:
    return names_recipe.make(seed, count)


@pytest.mark.parametrize("seed", [7, 42, 1234, 2**31 + 11])
@pytest.mark.parametrize("count", [1000, 4244])
def test_synth_names_equals_the_tools(seed, count):
    a = names_recipe.synth_names(count, np.random.default_rng(seed))
    b = _synth.synth_names(count, np.random.default_rng(seed))
    assert a == b


@pytest.mark.parametrize("seed", [42, 5])
def test_long_lines_equal_make_haystacks_long(seed):
    names = [n.decode() for n in
             _synth.synth_names(4200, np.random.default_rng(seed))]
    assert long_lines.lines(names, {}, 0, 3000) == (
        bench_vs_reference.make_haystacks_long(names, 3000))


def test_short_recipe_and_lines_equal_the_tools():
    pats, docs = _synth.short_case(500)
    assert short.make(3) == pats
    assert short_lines.lines([], {}, 0, 500) == docs


@pytest.mark.parametrize("seed", [0, 1, 99, 2**31 + 3])
def test_pattern_names_keep_the_recipe_and_skip_the_line(seed):
    names = pattern_names(4244, seed)
    assert len(names) == len(set(names)) == 4244
    line = long_lines.LONG_LINE.format(long_lines.NO_NAME, "")
    assert not any(n in line for n in names)
    assert all(5 <= len(n) <= 11 and n.isalpha() and n.islower()
               for n in names)
    recipe = [n.decode() for n in
              names_recipe.synth_names(4244, np.random.default_rng(seed))]
    # the recipe's draws are kept unless they occur in the line
    assert set(n for n in recipe if n not in line) <= set(names)


def test_a_name_in_the_line_is_drawn_again(monkeypatch):
    real = names_recipe.synth_names

    def with_a_word(count, rng):
        return sorted(real(count - 1, rng) + [b"daughters"])

    monkeypatch.setattr(names_recipe, "synth_names", with_a_word)
    names = pattern_names(50, 3)
    assert "daughters" not in names and len(names) == 50


def test_sizes_do_not_depend_on_the_seed():
    params = dict(traffic.load("doc64m"), doc_chars=100_000)
    docs_a = traffic.inputs(pattern_names(1000, 1), params, 1)
    docs_b = traffic.inputs(pattern_names(1000, 2**31 + 1), params, 2**31 + 1)
    assert [len(d) for d in docs_a] == [len(d) for d in docs_b]
    assert len(docs_a) == params["distinct"] and docs_a[0] != docs_a[1]
    bp = dict(traffic.load("lines20k"), corpus_lines=900, lines_per_call=300)
    a = traffic.inputs(pattern_names(4244, 1), bp, 1)
    b = traffic.inputs(pattern_names(4244, 2), bp, 2)
    assert [len(x) for x in a] == [len(x) for x in b] == [300, 300, 300]


@pytest.mark.parametrize(
    "mix", [m for m in MIXES if traffic.load(m)["call"] == "doc"])
def test_doc_mixes_cut_documents_to_size(mix):
    names = pattern_names(1000, 4)
    params = dict(traffic.load(mix), doc_chars=70_000, distinct=2)
    docs = traffic.inputs(names, params, 4)
    assert [len(d) for d in docs] == [70_000, 70_000]
    assert traffic.input_bytes(docs[0]) == 70_000


def test_doc_sizes_give_one_document_each():
    params = {"call": "doc", "text": "short_lines",
              "doc_sizes": [1000, 65536, 5]}
    docs = traffic.inputs(short.make(0), params, 9)
    assert [len(d) for d in docs] == [1000, 65536, 5]


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_random_bytes_plant_the_patterns(seed):
    pats = config.patterns(
        {"patterns": {"recipe": "random_bytes", "count": 300,
                      "min_len": 5, "max_len": 11}}, seed)
    assert len(pats) == len(set(pats)) == 300
    assert all(isinstance(p, bytes) and 5 <= len(p) <= 11 for p in pats)
    params = {"call": "doc", "text": "random_bytes", "doc_chars": 50_000,
              "distinct": 2, "planted": 40}
    docs = traffic.inputs(pats, params, seed)
    assert [len(d) for d in docs] == [50_000, 50_000] and docs[0] != docs[1]
    assert sum(d.count(p) for d in docs[:1] for p in pats) >= 30
    assert docs == traffic.inputs(pats, params, seed)


def test_nested_recipe_and_repeat_text():
    pats = config.patterns({"patterns": {"recipe": "nested", "count": 4}}, 0)
    assert pats == ["a", "aa", "aaa", "aaaa"]
    params = {"call": "batch", "text": "repeat", "corpus_lines": 6,
              "lines_per_call": 3, "line_chars": 5}
    assert traffic.inputs(pats, params, 0) == [["aaaaa"] * 3] * 2


@pytest.mark.parametrize("mix", MIXES)
def test_every_mix_file_loads_with_known_keys(mix):
    params = traffic.load(mix)
    assert params["call"] in traffic.CALLS
    assert config.plugin("texts", params["text"])
    assert traffic.callers(params) >= 1


def test_unknown_traffic_key_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(traffic, "HERE", str(tmp_path))
    (tmp_path / "bad.json").write_text(json.dumps(
        {"call": "doc", "text": "long_lines", "doc_chars": 10,
         "distinct": 1, "planted": 3}))
    with pytest.raises(ValueError, match="planted"):
        traffic.load("bad")
    (tmp_path / "bad.json").write_text(json.dumps(
        {"call": "doc", "text": "no_such_text"}))
    with pytest.raises(ModuleNotFoundError):
        traffic.load("bad")
