"""Several views on the large-world route on the CPU: with every grid routed
there (``fdtd_fused.TILED_MIN_CELLS`` = 0; 16 x 8 tiles with a 4-cell halo,
so several windows), a Context with four split-screen listeners runs one
B3 + B4 pass a view, then one assembly of every view.

Its published rows or grids and its ``get_output`` values are held to the
benchmark's plain reference (``benchmark/reference.py``) by the benchmark's
own comparison (``benchmark/check.py``) at the benchmark's 10 m, 275 Hz
stand-in, on cells and grids publish; and the route's ``route.passes``,
``route.tiled_passes`` and ``route.views`` counters and ``view`` spans are
read on the tiled route and on the batched one, and with the single-listener
rule applied as on the card."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity

import planeverb_tpu_torch as pv
from benchmark import cells, check, drive, reference, scenes, traffic
from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
STANDIN = os.path.join(BENCH, "tests", "data", "standin-10m-275hz.json")
SEED = 2718281828  # more than 32 signed bits hold
VIEWS = 4


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiled(monkeypatch):
    """Every grid on the tiled route, in several windows."""
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_tiled, "PLAIN_PLAN", (16, 8, 4))


def _split4(publish):
    """The stand-in configuration on ``publish`` and the benchmark's split4
    traffic on it, and the reference's parameters."""
    cfg = _json(STANDIN)
    cfg["publish"] = publish
    mix = _json(os.path.join(BENCH, "traffic", "split4.json"))
    params = cells.Cell("standin.split4", 1, cfg, mix, {}, [],
                        []).reference_params()
    g = reference.grid(params["world_x"], params["world_y"],
                       params["resolution"])
    return cfg, params, traffic.make(g, scenes.load(cfg["scene"]), mix, SEED)


@pytest.mark.parametrize("publish", ["cells", "grids"])
def test_four_tiled_views_equal_the_plain_reference(tiled, publish):
    cfg, params, t = _split4(publish)
    assert len(t.walks) == VIEWS
    prog = drive.Program(cfg, t, "cpu")
    ref = reference.Reference(params, "cpu")
    for i in (0, 7):
        outs = prog.refresh(t.listeners(i), t.door(i))
        assert profiling.steps()[-1].counters["route.passes"] == VIEWS
        sample = prog.sample(i, t.listeners(i), outs)
        want = ref.refresh(sample["boxes"], sample["listeners"], t.emitters)
        assert check.compare(sample, want, VIEWS) == {
            "fields_gap": 0.0, "params_gap": 0.0, "outputs_gap": 0.0}


@pytest.fixture
def card_rule(monkeypatch):
    """The single-listener rule as the card applies it, from 0 cells: every
    float32 pass of one view goes to B3 + B4 (in several windows)."""
    real = fdtd_fused.route_tiled
    monkeypatch.setattr(fdtd_fused, "TILED_SINGLE_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_fused, "route_tiled",
                        lambda cells, listeners, dtype, card:
                        real(cells, listeners, dtype, True))
    monkeypatch.setattr(fdtd_tiled, "PLAIN_PLAN", (16, 8, 4))


def _context(listeners, precision="f32"):
    ctx = pv.Context(pv.PlaneverbConfig(6.0, 6.0, 275), publish="cells",
                     precision=precision, device="cpu")
    ctx.geometry.add(pv.AABB(2.0, 4.0, 1.0, 0.5, 0.9))
    ctx.emissions.emit(4.5, 0.0, 3.0)
    if len(listeners) == 1:
        ctx.set_listener_position(*listeners[0])
    else:
        ctx.set_listener_positions(listeners)
    return ctx


LISTENERS = [(3.0, 0.0, 3.0), (2.0, 0.0, 2.0), (4.5, 0.0, 4.5),
             (1.5, 0.0, 4.0)]


@pytest.mark.parametrize("route,views,passes,spans", [
    ("tiled", 4, 4, 4), ("batched", 4, 1, 0), ("tiled", 1, 1, 0)])
def test_route_counts_its_passes_and_views(request, route, views, passes,
                                           spans):
    """Four views: four passes, each in a ``view`` span holding its B3 and
    B4 calls, on the tiled route; one batched pass and no span on B1. One
    view on the tiled route: one pass and no span."""
    if route == "tiled":
        request.getfixturevalue("tiled")
    ctx = _context(LISTENERS[:views])
    for _ in range(2):
        ctx.step()
        rec = profiling.steps()[-1]
        assert rec.counters["route.passes"] == passes
        assert rec.counters["route.views"] == views
        assert rec.counters.get("route.tiled_passes", 0) == (
            passes if route == "tiled" else 0)
        assert rec.span_count("view") == spans
        assert rec.span_count("solver") == 2 * passes
        views_at = [s for s in rec.spans if s[0] == "view"]
        assert all(s[1] == "route" for s in views_at)
        for _, _, start, dur, own in views_at:
            inside = [s for s in rec.spans if s[1] == "view"
                      and start <= s[2] and s[2] + s[3] <= start + dur]
            assert [s[0] for s in inside] == ["solver", "solver"]
            assert own == dur - sum(s[3] for s in inside)


@pytest.mark.parametrize("rule,views,precision,tiled_passes", [
    (True, 1, "f32", 1), (True, 1, "bf16", 0), (True, 4, "f32", 0),
    (False, 1, "f32", 0)])
def test_single_listener_rule_counts_its_tiled_passes(
        request, rule, views, precision, tiled_passes):
    """With the single-listener rule applied as on the card, one float32
    view counts one B3 + B4 pass a step in ``route.tiled_passes``; a bf16
    view, four views (one batched B1 pass) and the CPU's own rule none."""
    if rule:
        request.getfixturevalue("card_rule")
    ctx = _context(LISTENERS[:views], precision)
    for _ in range(2):
        ctx.step()
        rec = profiling.steps()[-1]
        assert rec.counters["route.passes"] == 1
        assert rec.counters.get("route.tiled_passes", 0) == tiled_passes
        assert rec.span_count("solver") == 2


def test_view_spans_reach_the_trace(tiled, tmp_path):
    ctx = _context(LISTENERS)
    ctx.step()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.step()
    assert profiling.steps()[-1].profiled
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in _json(path)["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("pvb.view") == VIEWS
    assert names.count("pvb.route") == 1
