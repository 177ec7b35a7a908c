"""BENCHMARK.json keeps to the rules of its format, and every cell finds its
files by name."""

import copy
import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|n_embd|n_inner|experts_per_tok)")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])


def test_cells_and_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}
               ) == len(cells)
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()[
    "workloads"]])
def test_every_cell_resolves_by_name(cell, bench):
    spec = harness.resolve(cell, bench)
    cfg = spec["config"]
    fam = harness.family(cfg)
    assert set(fam.leaf_map(cfg))
    assert 2 <= cfg["train"]["check_steps"] <= 3
    assert spec["mix"]["pool_batches"] > cfg["train"]["check_steps"]
    assert set(spec["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    for m in spec["per_layer"]:
        assert callable(harness.layer_metric(m["name"]).read)
    conf = {c["name"]: c for c in bench["configs"]}[spec["cell"]["config"]]
    assert conf["file"].startswith("portbench/")
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])


def test_a_new_cell_needs_only_a_manifest_entry(bench):
    bench = copy.deepcopy(bench)
    bench["workloads"].append({
        "name": "qwen3-0.6b.stream", "config": "qwen3-0.6b",
        "traffic": "stream", "chips": 1, "why": "a cell added by an entry"})
    for m in bench["per_layer"]:
        m["workloads"].append("qwen3-0.6b.stream")
    spec = harness.resolve("qwen3-0.6b.stream", bench)
    assert spec["mix"]["arrange"] == "stream"
    assert spec["limits"] == harness.limits("qwen3-0.6b")
    assert len(spec["per_layer"]) == len(bench["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    root = os.path.dirname(harness.HERE)
    for dirpath, dirnames, files in os.walk(harness.HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
