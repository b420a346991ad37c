"""BENCHMARK.json against the benchmark's contract and against the files
that the harness finds by name."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness.manifest import Tree

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTHS = ("d_model", "d_ff", "head_dim", "num_heads", "num_kv_heads")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_sources():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert len(set(CELLS)) == len(CELLS)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    tree = Tree(REPO)
    for cell in CELLS:
        e2e = {m["name"] for m in tree.metrics_of(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert tree.metrics_of(cell, "per_layer")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_a_layer_metric_moves_what_its_cells_report(m):
    tree = Tree(REPO)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", CELLS):
        e2e = {e["name"] for e in tree.metrics_of(cell, "end_to_end")}
        assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader_that_agrees(m):
    mod = Tree(REPO).module("metrics", m["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"],
                                                 m["source"])
    if "moves" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_and_their_files(w):
    tree = Tree(REPO)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    wl = tree.workload(w["name"])
    assert (wl["name"], wl["config"], wl["traffic"], wl["why"]) == \
        (w["name"], w["config"], w["traffic"], w["why"])
    assert (REPO / "portbench/traffic" / f"{w['traffic']}.py").exists()
    assert wl["correct"]["sample"] >= 8


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_and_their_files(c):
    doc = json.loads((REPO / c["file"]).read_text())
    assert c["file"].startswith("portbench/")
    assert (doc["name"], doc["source"], doc["reduced"]) == \
        (c["name"], c["source"], c["reduced"])
    assert not set(doc["reduced"]) & set(WIDTHS)
    # each departure from the source gives the published value and why
    assert all(k in doc["published"] and k in doc["assumed"]
               for k in doc["reduced"])
    assert (REPO / doc["plan"]).exists()
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    from repro_torch.configs import get_config
    program = get_config(doc["program_config"])
    for k, v in doc["config"].items():
        if k in doc["reduced"]:
            continue
        if isinstance(v, dict):       # a nested group, field by field
            for f, x in v.items():
                if f"{k}.{f}" not in doc["assumed"]:
                    assert getattr(getattr(program, k), f) == x, (k, f)
        else:
            assert getattr(program, k) == v, k


def test_the_frozen_plan_has_its_fingerprint():
    from repro_torch.core.plan import PrecisionPlan
    for c in BENCH["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        plan = PrecisionPlan.load(str(REPO / doc["plan"]))
        assert plan.fingerprint() == doc["plan_fingerprint"]
