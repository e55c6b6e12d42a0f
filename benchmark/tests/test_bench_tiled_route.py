"""The Route layer's tiled-pass reader on a canned ring of step records: the
program's ``route.tiled_passes`` counter per refresh, nothing from a program
without it, and the cells it lists."""

import pytest

import standin
from benchmark import cells, tracing
from planeverb_tpu_torch.utils import profiling

BENCH = cells.load(standin.ROOT)
NAME = "route.tiled_passes_per_refresh"
INFO = {"cells": 192 * 192, "steps": 1187, "views": 1, "state_bytes": 4}
# one refresh, so the trace has a traced window
EVENTS = [{"ph": "X", "cat": "user_annotation", "name": "pvb.refresh",
           "ts": 0.0, "dur": 1000.0}]


def _read(trace):
    return cells.metric_module(NAME).read(trace, INFO)


def _ring(counters, unprofiled=150):
    """Set-up, the traced window's profiled steps, then its remainder."""
    ring = []
    for i in range(5 + 200 + unprofiled):
        rec = profiling.StepRecord(i)
        rec.profiled = 5 <= i < 205
        rec.counters = dict(counters)
        ring.append(rec)
    return ring


@pytest.mark.parametrize("counters,want", [
    ({"route.passes": 1, "route.tiled_passes": 1}, 1.0),
    ({"route.passes": 4, "route.tiled_passes": 4}, 4.0),
    ({"route.passes": 1}, None),      # B1 + B2, or a program without it
    ({}, None)])
def test_tiled_passes_read_the_counter(monkeypatch, counters, want):
    monkeypatch.setattr(profiling, "steps", lambda: _ring(counters))
    trace = tracing.reduce(EVENTS)
    assert trace.refreshes == 1
    assert _read(trace) == want
    assert _read(tracing.reduce([])) is None


def test_tiled_passes_need_enough_unprofiled_steps(monkeypatch):
    counters = {"route.passes": 1, "route.tiled_passes": 1}
    monkeypatch.setattr(profiling, "steps",
                        lambda: _ring(counters, unprofiled=99))
    assert _read(tracing.reduce(EVENTS)) is None
    monkeypatch.delattr(profiling, "steps")
    assert _read(tracing.reduce(EVENTS)) is None


def test_tiled_passes_list_every_cell_on_the_tiled_route():
    """Every cell but the 25 m split screen, whose four views share one
    batched B1 pass."""
    m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert m["layer"] == "Route" and m["moves"] == "refreshes_per_s"
    assert m["source"] == "program_counter"
    assert set(m["workloads"]) == {w["name"] for w in BENCH["workloads"]
                                   } - {"hugeroom-25m.split4"}
