"""Every workload of BENCHMARK.json resolves to its files, and the file
keeps the contract's shape."""

import json
import os
import re

import pytest

import standin
from benchmark import cells, reference, scenes

BENCH = cells.load(standin.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(standin.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_keys():
    for group in ("configs", "workloads"):
        for e in BENCH[group]:
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"], e
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_to_its_files(workload):
    cell = cells.resolve(BENCH, workload, standin.ROOT)
    entry = {w["name"]: w for w in BENCH["workloads"]}[workload]
    config = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert cell.chips == entry["chips"] in (1, 4)
    assert cell.config["reduced"] == config["reduced"]
    assert set(cell.limits) >= {"fields_gap", "params_gap", "outputs_gap"}
    reported = {e["name"] for e in cell.end_to_end}
    for m in cell.per_layer:
        mod = cells.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
        # what a per-layer metric moves is reported in each of its cells
        assert m["moves"] in reported, (m["name"], workload)
        assert callable(mod.read) and isinstance(mod.SPANS, dict)
    assert cell.per_layer and len(cell.end_to_end) >= 2
    # the configuration as run: its sizes follow from the grid law
    p = cell.reference_params()
    g = reference.grid(p["world_x"], p["world_y"], p["resolution"])
    assert [g.nx, g.ny] == cell.config["solver_cells"]
    assert g.steps == cell.config["steps"]
    assert scenes.load(cell.config["scene"])["boxes"]


def test_every_config_is_used_and_in_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(standin.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_benchmark_json_is_the_only_cell_list():
    """A metric's cells are its ``workloads`` entry, or every cell: its file
    names none, so a later cell is added without editing it."""
    for m in BENCH["per_layer"]:
        mod = cells.metric_module(m["name"])
        assert not hasattr(mod, "CELLS")
        for w in WORKLOADS:
            cell = cells.resolve(BENCH, w, standin.ROOT)
            wanted = "workloads" not in m or w in m["workloads"]
            assert (m in cell.per_layer) == wanted
