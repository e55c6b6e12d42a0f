"""The solver layer's window-rounds reader on a canned ring of step records:
the program's ``solver.window_rounds`` counter per refresh, nothing from a
program without it, and the cells it lists."""

import pytest

import standin
from benchmark import cells, tracing
from planeverb_tpu_torch.utils import profiling

BENCH = cells.load(standin.ROOT)
NAME = "solver.window_rounds_per_refresh"
INFO = {"cells": 964 * 964, "steps": 2006, "views": 1, "state_bytes": 4}
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
        rec.counters = dict(counters(i))
        ring.append(rec)
    return ring


@pytest.mark.parametrize("counters,want", [
    (lambda i: {"route.tiled_passes": 1, "solver.window_rounds": 2412},
     2412.0),
    (lambda i: {"route.tiled_passes": 4, "solver.window_rounds": 4 * 2412},
     9648.0),
    # a step that ran no B3 pass counts none: the mean over every step
    (lambda i: {"solver.window_rounds": 198} if i % 2 else {}, 99.0),
    (lambda i: {"route.passes": 1}, None),   # B1 + B2, or no counter
    (lambda i: {}, None)])
def test_window_rounds_read_the_counter(monkeypatch, counters, want):
    monkeypatch.setattr(profiling, "steps", lambda: _ring(counters))
    trace = tracing.reduce(EVENTS)
    assert trace.refreshes == 1
    assert _read(trace) == want
    assert _read(tracing.reduce([])) is None


def test_window_rounds_need_enough_unprofiled_steps(monkeypatch):
    def counters(i):
        return {"solver.window_rounds": 2412}

    monkeypatch.setattr(profiling, "steps",
                        lambda: _ring(counters, unprofiled=99))
    assert _read(tracing.reduce(EVENTS)) is None
    monkeypatch.delattr(profiling, "steps")
    assert _read(tracing.reduce(EVENTS)) is None


def test_window_rounds_list_every_cell_on_the_tiled_route():
    """Every cell but the 25 m split screen, whose four views share one
    batched B1 pass."""
    m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert m["layer"] == "solver" and m["moves"] == "refreshes_per_s"
    assert m["source"] == "program_counter" and m["better"] == "lower"
    assert m["unit"] == cells.metric_module(NAME).UNIT == "window-rounds"
    assert set(m["workloads"]) == {w["name"] for w in BENCH["workloads"]
                                   } - {"hugeroom-25m.split4"}
