"""The port's spans and counters (``planeverb_tpu_torch/utils/profiling.py``)
on the CPU at 6 m and 275 Hz: the span tree of one ``Context.step``, its
step records and counters, the forwarding into a ``torch.profiler`` trace
(only while a profiler records, and never of ``fold`` and ``doa``), the
per-thread stack of open spans, and ``profile_summary()`` with the server's
``profile`` op."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity

import planeverb_tpu_torch as pv
from planeverb_tpu_torch.server import EngineServer
from planeverb_tpu_torch.utils import profiling

# span -> its parent in one step on one listener whose geometry changed
TREE = {"step": None, "fields": "step", "voxelize": "fields",
        "simulate+analyze": "step", "route": "simulate+analyze",
        "solver": "route", "fold": "solver", "analysis": "route",
        "doa": "analysis", "pack": "simulate+analyze",
        "fetch": "simulate+analyze", "publish": "step"}
# the spans a profiler's trace holds: fold and doa would take the solver's
# and the analysis's kernels
FORWARDED = set(TREE) - {"fold", "doa"}
EMITTERS = ((4.5, 3.0), (1.5, 2.0))


def _context(publish="grids"):
    ctx = pv.Context(pv.PlaneverbConfig(6.0, 6.0, 275), publish=publish,
                     device="cpu")
    ctx.set_listener_position(3.0, 0.0, 3.0)
    for x, z in EMITTERS:
        ctx.emissions.emit(x, 0.0, z)
    return ctx, ctx.geometry.add(pv.AABB(2.0, 4.0, 1.0, 0.5, 0.9))


def _moved_step(ctx, gid, i):
    """A step after the box moved: the step voxelizes again."""
    ctx.geometry.update(gid, pv.AABB(2.0 + 0.25 * i, 4.0, 1.0, 0.5, 0.9))
    ctx.step()
    return profiling.steps()[-1]


def _children(rec, span):
    """The spans of ``rec`` directly inside ``span``."""
    name, _, start, dur, _ = span
    return [s for s in rec.spans if s[1] == name and start <= s[2]
            and s[2] + s[3] <= start + dur]


@pytest.mark.parametrize("publish", ["grids", "cells"])
def test_two_steps_record_the_span_tree(publish):
    ctx, gid = _context(publish)
    recs = [_moved_step(ctx, gid, i) for i in range(2)]
    assert [r.iteration for r in recs] == [1, 2] and ctx.iteration == 2
    p = ctx.params
    rows = p.grid_x * p.grid_y if publish == "grids" else len(EMITTERS)
    for rec in recs:
        assert not rec.profiled
        assert {(n, parent) for n, parent, *_ in rec.spans} \
            == set(TREE.items())
        assert rec.spans[-1][0] == "step"     # the root ends last
        assert rec.span_count("fold") == rec.span_count("doa") == 1
        # B1, then B2
        assert rec.span_count("solver") == 2
        # one listener: one solver pass for one view
        assert rec.counters == {"fetch.bytes": rows * 9 * 4,
                                "route.passes": 1, "route.views": 1}
        for s in rec.spans:
            assert s[3] >= s[4] >= 0
            assert s[4] + sum(c[3] for c in _children(rec, s)) == s[3]
    published = ctx._published
    fetched = (published["occlusion"].base if publish == "grids"
               else list(published["cells"].values()))
    nbytes = (fetched.nbytes if publish == "grids"
              else sum(row.nbytes for row in fetched))
    assert recs[-1].counters["fetch.bytes"] == nbytes


def test_a_step_on_unchanged_geometry_has_no_fields_span():
    ctx, gid = _context()
    _moved_step(ctx, gid, 0)
    ctx.step()
    rec = profiling.steps()[-1]
    assert {n for n, *_ in rec.spans} == set(TREE) - {"fields", "voxelize"}
    assert rec.iteration == 2


def test_several_views_fold_once_and_assemble_each():
    ctx, gid = _context()
    ctx.set_listener_positions([(3.0, 0.0, 3.0), (2.0, 0.0, 2.0)])
    rec = _moved_step(ctx, gid, 0)
    assert rec.span_count("fold") == 1 and rec.span_count("solver") == 2
    # one assembly call for both views; the plain version's DOA a view
    assert rec.span_count("analysis") == 1 and rec.span_count("doa") == 2
    assert rec.counters["fetch.bytes"] == \
        2 * ctx.params.grid_x * ctx.params.grid_y * 9 * 4


def test_forwarded_spans_reach_the_trace_only_under_a_profiler(
        tmp_path, monkeypatch):
    ctx, gid = _context()
    _moved_step(ctx, gid, 0)
    opened = []
    real = profiling.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    rec = _moved_step(ctx, gid, 1)
    assert opened == [] and not rec.profiled
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = _moved_step(ctx, gid, 2)
    assert rec.profiled
    assert sorted(opened) == sorted("pvb." + n for n, *_ in rec.spans
                                    if n in FORWARDED)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pvb." + n for n in FORWARDED} <= names
    assert not names & {"pvb.fold", "pvb.doa"}
    assert not _moved_step(ctx, gid, 3).profiled


def test_the_background_loop_keeps_its_own_stack():
    """Spans the main thread opens while the loop steps join neither the
    loop's steps nor take their time as children."""
    ctx, _ = _context()
    mine = profiling.Stats()
    ctx.start()
    try:
        while ctx.iteration < 2 and ctx.error is None:
            with profiling.span("elsewhere", mine):
                threading.Event().wait(0.001)
    finally:
        ctx.stop()
    assert ctx.error is None
    recs = profiling.steps()[-ctx.iteration:]
    assert [r.iteration for r in recs] == list(range(1, ctx.iteration + 1))
    for rec in recs:
        assert {(n, p) for n, p, *_ in rec.spans} <= set(TREE.items())
    own = mine.summary()["elsewhere"]
    assert own["count"] >= 1 and own["self_mean_s"] == own["mean_s"]


def test_profile_summary_keeps_its_keys_and_the_server_returns_the_spans():
    srv = EngineServer(port=0, device="cpu")
    srv.start_background()
    try:
        assert srv.dispatch({"cmd": "init", "grid_size_x": 6,
                             "grid_size_y": 6, "grid_resolution": 275,
                             "background": False})["ok"]
        assert srv.dispatch({"cmd": "emit", "x": 4.5, "y": 0.0,
                             "z": 3.0})["ok"]
        for _ in range(2):
            assert srv.dispatch({"cmd": "step"})["ok"]
        stages = srv.dispatch({"cmd": "profile"})["stages"]
    finally:
        srv.shutdown()
    assert {"calibration", "simulate+analyze", "publish",
            "throughput"} <= set(stages)
    # no box: the first step lays the empty fields and voxelizes nothing
    assert set(TREE) - {"voxelize"} <= set(stages)
    # a fold a step, and one more where the calibration was not cached
    assert stages["step"]["count"] == 2 <= stages["fold"]["count"] <= 3
    for name in set(TREE) - {"voxelize"}:
        s = stages[name]
        assert set(s) == {"mean_s", "last_s", "count", "self_mean_s"}
        assert 0 <= s["self_mean_s"] <= s["mean_s"]
    # the server publishes cells: one emitter's row a step
    assert stages["fetch.bytes"] == {"total": 2 * 9 * 4, "last": 9 * 4,
                                     "count": 2}


def test_counters_spanned_and_the_ring():
    stats = profiling.Stats()

    @profiling.spanned("inner", forward=False)
    def inner():
        profiling.count("things", 3)

    profiling.count("nowhere", 1)          # outside every span: dropped
    with profiling.span("step", stats, record=profiling.StepRecord(-7)):
        inner()
        inner()
    rec = profiling.steps()[-1]
    assert rec.iteration == -7 and rec.counters == {"things": 6}
    assert [(n, p) for n, p, *_ in rec.spans] == [("inner", "step")] * 2 \
        + [("step", None)]
    summary = stats.summary()
    assert summary["things"] == {"total": 6, "last": 3, "count": 2}
    assert summary["inner"]["count"] == 2 and "nowhere" not in summary
    # a step that raises is not kept; the ring keeps the newest steps
    with pytest.raises(ValueError):
        with profiling.span("step", record=profiling.StepRecord(-8)):
            raise ValueError("no step")
    assert profiling.steps()[-1].iteration == -7
    assert profiling.STEPS_KEPT >= 4096
    for i in range(profiling.STEPS_KEPT + 3):
        with profiling.span("step", record=profiling.StepRecord(i)):
            pass
    ring = profiling.steps()
    assert len(ring) == profiling.STEPS_KEPT
    assert [r.iteration for r in ring[-2:]] == [profiling.STEPS_KEPT + 1,
                                                profiling.STEPS_KEPT + 2]
    assert ring[0].iteration == 3
