"""The per-layer readers of the program's own spans and counters: a canned
ring of step records (set-up, the profiled steps of a traced window, then
its unprofiled remainder) and a canned trace whose ``pvb.fetch`` span holds
the step's host copy."""

import pytest

from benchmark import cells, tracing
from planeverb_tpu_torch.utils import profiling

RECORDER = ("solver.fold_ms_per_refresh", "solver.folds_per_refresh",
            "analysis.doa_ms_per_refresh", "publish.host_ms_per_refresh",
            "publish.copy_bytes_per_refresh", "step.self_ms_per_refresh")
INFO = {"cells": 192 * 192, "steps": 1187, "views": 1, "state_bytes": 4}
MS = 1_000_000


def _step(i, profiled, fold_ms=0.5, copy=1000):
    """A step record with the spans the readers read: (name, parent, ms,
    self ms). A profiled step's spans take three times as long."""
    k = 3 if profiled else 1
    rec = profiling.StepRecord(i)
    rec.profiled = profiled
    for name, parent, ms, own in (
            ("fold", "solver", fold_ms, fold_ms),
            ("doa", "analysis", 2.0, 2.0),
            ("pack", "simulate+analyze", 0.25, 0.25),
            ("fetch", "simulate+analyze", 0.5, 0.5),
            ("publish", "step", 0.125, 0.125),
            ("step", None, 20.0, 1.0)):
        rec.spans.append((name, parent, 0, int(k * ms * MS),
                          int(k * own * MS)))
    rec.counters = {"fetch.bytes": copy}
    return rec


def _ring(unprofiled=150, fold_ms=0.5):
    return ([_step(i, False) for i in range(5)]
            + [_step(5 + i, True) for i in range(200)]
            + [_step(205 + i, False, fold_ms, 1000 + (i % 2) * 2)
               for i in range(unprofiled)])


def _events():
    """Two traced refreshes, each with a fetch span holding one copy, and
    one copy launched outside it."""
    ev = []
    for r, t0 in enumerate((0.0, 1000.0)):
        ev += [{"ph": "X", "cat": "user_annotation", "name": "pvb.refresh",
                "ts": t0, "dur": 1000},
               {"ph": "X", "cat": "user_annotation", "name": "pvb.step",
                "ts": t0, "dur": 800},
               {"ph": "X", "cat": "user_annotation", "name": "pvb.fetch",
                "ts": t0 + 500, "dur": 200}]
        for k, (host, dev, dur) in enumerate(((t0 + 510, t0 + 520, 30),
                                              (t0 + 100, t0 + 120, 7))):
            corr = 10 * r + k
            ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpy",
                    "ts": host, "dur": 5, "args": {"correlation": corr}},
                   {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
                    "ts": dev, "dur": dur, "args": {"correlation": corr}}]
    return ev


TRACE = tracing.reduce(_events())


def _read(name, trace=TRACE):
    return cells.metric_module(name).read(trace, INFO)


def test_recorder_readers_read_the_unprofiled_remainder(monkeypatch):
    ring = _ring()
    monkeypatch.setattr(profiling, "steps", lambda: list(ring))
    assert _read("solver.fold_ms_per_refresh") == pytest.approx(0.5)
    assert _read("solver.folds_per_refresh") == 1.0
    assert _read("analysis.doa_ms_per_refresh") == pytest.approx(2.0)
    assert _read("publish.host_ms_per_refresh") == pytest.approx(0.375)
    assert _read("publish.copy_bytes_per_refresh") == pytest.approx(1001.0)
    assert _read("step.self_ms_per_refresh") == pytest.approx(1.0)


def test_a_full_ring_without_profiled_steps_is_all_remainder(monkeypatch):
    """The profiled steps left the ring: every step in it came after them."""
    ring = [_step(i, False, fold_ms=0.0) for i in range(profiling.STEPS_KEPT)]
    monkeypatch.setattr(profiling, "steps", lambda: list(ring))
    assert _read("solver.fold_ms_per_refresh") == 0.0
    assert _read("step.self_ms_per_refresh") == pytest.approx(1.0)


@pytest.mark.parametrize("name", RECORDER)
def test_recorder_readers_give_nothing_to_read_nothing(name, monkeypatch):
    few = _ring(unprofiled=99)
    monkeypatch.setattr(profiling, "steps", lambda: list(few))
    assert _read(name) is None                       # under 100 steps
    enough = _ring()
    monkeypatch.setattr(profiling, "steps", lambda: list(enough))
    assert _read(name) is not None
    assert _read(name, tracing.reduce([])) is None   # no traced window
    # a program that keeps no step records (the parent of this reader)
    monkeypatch.delattr(profiling, "steps")
    assert _read(name) is None


def test_copy_ms_reads_the_copies_inside_fetch():
    # 30 us a refresh inside fetch; the 7 us copy outside it is not read
    assert _read("publish.copy_ms_per_refresh") == pytest.approx(0.03)
    no_fetch = tracing.reduce([e for e in _events()
                               if e["name"] != "pvb.fetch"])
    assert _read("publish.copy_ms_per_refresh", no_fetch) is None
    host_only = tracing.reduce([e for e in _events()
                                if e["cat"] == "user_annotation"])
    assert _read("publish.copy_ms_per_refresh", host_only) is None


def test_fetch_splits_the_step_idle_time():
    idle = dict(tracing.breakdown(TRACE)["idle_gaps"])
    assert "host in fetch" in idle and "host in step" in idle
