"""The per-layer metric readers and the breakdown on a canned profiler
trace: two refreshes, each with its spans, launches and device work."""

import pytest

from benchmark import cells, roofline, tracing


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _refresh(t0, c0):
    """A refresh at t0 (us): inputs, step (voxelize, solver, analysis),
    query; two solver kernels, three analysis kernels, one copy."""
    ev = [_x("user_annotation", "pvb.refresh", t0, 1000),
          _x("user_annotation", "pvb.inputs", t0, 20),
          _x("user_annotation", "pvb.step", t0 + 20, 800),
          _x("user_annotation", "pvb.voxelize", t0 + 30, 40),
          _x("user_annotation", "pvb.solver", t0 + 100, 100),
          _x("user_annotation", "pvb.analysis", t0 + 200, 300),
          _x("user_annotation", "pvb.query", t0 + 820, 180)]
    launches = [(t0 + 110, t0 + 150, 400, "sim"),
                (t0 + 190, t0 + 560, 20, "moments"),
                (t0 + 210, t0 + 580, 10, "where"),
                (t0 + 300, t0 + 600, 10, "gather"),
                (t0 + 400, t0 + 610, 10, "stack")]
    for k, (host, dev, dur, name) in enumerate(launches):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", host, 5, c0 + k))
        ev.append(_x("kernel", name, dev, dur, c0 + k))
    ev.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 + 510, 5, c0 + 9))
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", t0 + 700, 100, c0 + 9))
    return ev


TRACE = tracing.reduce(_refresh(0.0, 0) + _refresh(1000.0, 100)
                       + [_x("cpu_op", "aten::add", 5, 1)])
INFO = {"cells": 192 * 192, "steps": 1187, "views": 1, "state_bytes": 4}


def _read(name, trace=TRACE):
    return cells.metric_module(name).read(trace, INFO)


def test_window_and_attribution():
    assert TRACE.refreshes == 2
    assert TRACE.window_us == 2000.0
    assert sorted(d[4] for d in TRACE.kernels()) == \
        ["analysis"] * 6 + ["solver"] * 4
    # busy a refresh: 150-550, 560-590, 600-620 and the copy 700-800
    assert TRACE.busy_us() == pytest.approx(2 * (400 + 50 + 100))


def test_readers():
    # per refresh: solver kernels 400 + 20 us; analysis 300 us of host;
    # three analysis launches; query 180 us; voxelize 40 us
    bound = roofline.solver_bound_s(INFO["cells"], INFO["steps"])
    assert _read("solver.roofline_pct") == pytest.approx(
        100 * bound / 420e-6)
    assert _read("analysis.host_ms_per_refresh") == pytest.approx(0.3)
    assert _read("analysis.launches_per_refresh") == 3
    assert _read("query.host_ms_per_refresh") == pytest.approx(0.18)
    assert _read("voxelize.host_ms_per_refresh") == pytest.approx(0.04)
    assert _read("device.idle_pct") == pytest.approx(100 * (1 - 1100 / 2000))


def test_refresh_tail_reads_the_untraced_refreshes():
    """refresh.ms_p95: the inclusive 95th percentile of the refreshes after
    the traced ones, and nothing where there are none."""
    read = cells.metric_module("refresh.ms_p95").read
    lat = [float(k) for k in range(1, 101)]
    assert read(TRACE, {**INFO, "refresh_ms_untraced": lat}) == \
        pytest.approx(95.05)
    assert read(TRACE, {**INFO, "refresh_ms_untraced": []}) is None
    assert read(TRACE, INFO) is None


def test_breakdown():
    b = tracing.breakdown(TRACE)
    ops = dict(b["device_ops"])
    assert ops["sim"] == pytest.approx(800e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(200e-6)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(900e-6)
    # idle a refresh: 0-150 (inputs, step, voxelize, solver), 550-560,
    # 590-600 and 620-700 (analysis, step), 800-1000 (step, query)
    assert idle["host in query"] == pytest.approx(2 * 180e-6)
    assert idle["host in inputs"] == pytest.approx(2 * 20e-6)
    assert list(b) == ["device_ops", "idle_gaps"]
    assert len(b["device_ops"]) <= tracing.TOP


def test_nothing_to_read_gives_nothing():
    host_only = tracing.reduce([e for e in _refresh(0.0, 0)
                                if e["cat"] == "user_annotation"])
    for name in ("device.idle_pct", "solver.roofline_pct",
                 "analysis.launches_per_refresh"):
        assert _read(name, host_only) is None
    empty = tracing.reduce([])
    for m in cells.load(cells.os.path.dirname(cells.HERE))["per_layer"]:
        assert _read(m["name"], empty) is None
    static = tracing.reduce([e for e in _refresh(0.0, 0)
                             if e["name"] != "pvb.voxelize"])
    assert _read("voxelize.host_ms_per_refresh", static) is None



def test_audio_blocks_of_the_traced_window():
    """audio.host_ms_per_block reads the callback's blocks the harness
    timed inside the traced window; nothing where none were."""
    info = dict(INFO, audio_block_ms=[4.0, 5.0, 6.0])
    read = cells.metric_module("audio.host_ms_per_block").read
    assert read(TRACE, info) == pytest.approx(5.0)
    assert read(TRACE, dict(INFO, audio_block_ms=[])) is None
    assert read(tracing.reduce([]), info) is None
