"""The 126 m split screen and whole-grid publish: the Route layer's readers on
a canned ring of step records and a canned trace, and the two cells and the
grids configuration resolved through ``cells.resolve``."""

import json
import os

import pytest

import standin
from benchmark import cells, tracing
from planeverb_tpu_torch.utils import profiling

BENCH = cells.load(standin.ROOT)
INFO = {"cells": 964 * 964, "steps": 2006, "views": 4, "state_bytes": 4}
NEW_CELLS = ("floorplan-126m.split4-cells", "floorplan-126m.walk-grids")
ROUTE = ("route.passes_per_refresh", "route.idle_ms_per_refresh")


def _read(name, trace):
    return cells.metric_module(name).read(trace, INFO)


def _step(i, profiled, counters):
    rec = profiling.StepRecord(i)
    rec.profiled = profiled
    rec.spans.append(("step", None, 0, 1000, 1000))
    rec.counters = dict(counters)
    return rec


def _ring(counters, unprofiled=150):
    """Set-up, the traced window's profiled steps, then its remainder."""
    return ([_step(i, False, counters) for i in range(5)]
            + [_step(5 + i, True, counters) for i in range(200)]
            + [_step(205 + i, False, counters) for i in range(unprofiled)])


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "pvb." + name,
            "ts": ts, "dur": dur}


def _kernel(corr, host, dev, dur):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": host, "dur": 2, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": dev,
             "dur": dur, "args": {"correlation": corr}}]


def _events():
    """Two refreshes of two views on the tiled route: each view's span holds
    a solver span whose kernel runs 180 us; the assembly's kernel 40 us.
    The card idles 240 us a refresh with the host in ``route`` or
    ``view``: 50 us before and after each solver span inside its view,
    20 us before and after the assembly."""
    ev = []
    for r in range(2):
        t = 1000.0 * r
        ev += [_span("refresh", t, 1000), _span("step", t, 900),
               _span("route", t + 100, 700),
               _span("view", t + 100, 300), _span("solver", t + 150, 200),
               _span("view", t + 400, 300), _span("solver", t + 450, 200),
               _span("analysis", t + 720, 60)]
        ev += _kernel(10 * r, t + 155, t + 160, 180)
        ev += _kernel(10 * r + 1, t + 455, t + 460, 180)
        ev += _kernel(10 * r + 2, t + 725, t + 730, 40)
    return ev


def test_passes_read_the_counter_of_the_unprofiled_steps(monkeypatch):
    ring = _ring({"route.passes": 4, "route.views": 4, "fetch.bytes": 8})
    monkeypatch.setattr(profiling, "steps", lambda: list(ring))
    trace = tracing.reduce(_events())
    assert _read("route.passes_per_refresh", trace) == 4.0
    # a step whose route counted one pass (the batched route, one view)
    ring[-1].counters["route.passes"] = 1
    assert _read("route.passes_per_refresh", trace) == pytest.approx(
        (149 * 4 + 1) / 150)


def test_passes_give_nothing_without_the_counter(monkeypatch):
    trace = tracing.reduce(_events())
    # a program whose steps lack the counter (the parent of this reader)
    parent = _ring({"fetch.bytes": 8})
    monkeypatch.setattr(profiling, "steps", lambda: list(parent))
    assert _read("route.passes_per_refresh", trace) is None
    few = _ring({"route.passes": 4}, unprofiled=99)
    monkeypatch.setattr(profiling, "steps", lambda: list(few))
    assert _read("route.passes_per_refresh", trace) is None
    enough = _ring({"route.passes": 4})
    monkeypatch.setattr(profiling, "steps", lambda: list(enough))
    assert _read("route.passes_per_refresh", tracing.reduce([])) is None
    monkeypatch.delattr(profiling, "steps")
    assert _read("route.passes_per_refresh", trace) is None


def test_idle_reads_the_route_and_view_gaps():
    trace = tracing.reduce(_events())
    assert trace.refreshes == 2
    assert _read("route.idle_ms_per_refresh", trace) == pytest.approx(0.24)
    idle = trace.idle_by_span()
    assert idle["view"] == pytest.approx(4 * 100.0)
    assert idle["route"] == pytest.approx(2 * 40.0)
    # a program that opens route but no view: the same time, under route
    no_view = tracing.reduce([e for e in _events()
                              if e["name"] != "pvb.view"])
    assert _read("route.idle_ms_per_refresh", no_view) == pytest.approx(0.24)


def test_idle_gives_nothing_without_the_span_or_a_device():
    no_route = tracing.reduce([e for e in _events()
                               if e["name"] not in ("pvb.route", "pvb.view")])
    assert _read("route.idle_ms_per_refresh", no_route) is None
    host_only = tracing.reduce([e for e in _events()
                                if e["cat"] == "user_annotation"])
    assert _read("route.idle_ms_per_refresh", host_only) is None
    assert _read("route.idle_ms_per_refresh", tracing.reduce([])) is None


@pytest.mark.parametrize("workload,views,publish", [
    ("floorplan-126m.split4-cells", 4, "cells"),
    ("floorplan-126m.walk-grids", 1, "grids")])
def test_new_cells_resolve(workload, views, publish):
    cell = cells.resolve(BENCH, workload, standin.ROOT)
    assert cell.chips == 1
    assert cell.traffic["listeners"] == views
    assert cell.config["publish"] == publish
    assert cell.config["solver_cells"] == [964, 964]
    # the views' recordings are not published: no recording_gap
    assert ("recording_gap" in cell.limits) == (views == 1)
    assert set(ROUTE) <= {m["name"] for m in cell.per_layer}
    assert {"refreshes_per_s", "device_mem_peak_gib", "setup_s"} <= {
        m["name"] for m in cell.end_to_end}


def test_grids_config_is_the_level_on_grids_publish():
    """The grids configuration is the cells one but for its name, its
    publish, the guarantee that says what is published, and a source that
    names the part of the engine that defines it: the results grid."""
    configs = {c["name"]: c for c in BENCH["configs"]}
    files = {}
    for name in ("floorplan-126m-750hz", "floorplan-126m-750hz-grids"):
        with open(os.path.join(standin.ROOT, configs[name]["file"])) as f:
            files[name] = json.load(f)
        assert configs[name]["reduced"] == files[name]["reduced"] == []
    cells_cfg, grids_cfg = files.values()
    differ = {k for k in cells_cfg if cells_cfg[k] != grids_cfg.get(k)}
    assert set(grids_cfg) == set(cells_cfg)
    assert differ == {"name", "publish", "guarantees", "source"}
    assert grids_cfg["publish"] == "grids"
    for cfg in (configs["floorplan-126m-750hz-grids"], grids_cfg):
        assert cfg["source"].startswith(
            "https://github.com/themattrosen/Planeverb/")
        assert "results grid" in cfg["source"]
    others = {c["source"] for c in BENCH["configs"]
              if c["name"] != "floorplan-126m-750hz-grids"}
    assert configs["floorplan-126m-750hz-grids"]["source"] not in others


def test_route_metrics_list_the_new_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ROUTE:
        m = per_layer[name]
        assert m["layer"] == "Route" and m["moves"] == "refreshes_per_s"
        assert tuple(m["workloads"]) == NEW_CELLS
