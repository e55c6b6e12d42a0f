"""The port's engine step against the JAX engine, both on the CPU.

``planeverb_tpu_torch.Context(device="cpu")`` runs the kernels' plain
versions; ``planeverb_tpu.Context`` runs its CPU path (lax.scan solver +
jnp moments). Every cell's published parameters are held to the golden
tolerances of tests/test_golden_scenes.py (delay exact; occlusion and wet
gain rtol 2e-4 atol 1e-5; lowpass rtol 2e-4 atol 1e-2; RT60 on valid cells
rtol 5e-3; source directivity rtol 1e-3 atol 1e-4; direction: no cell off
by more than 1e-4). EFree to rel 1e-5, impulse responses to 1e-6 times the
recording's peak.
"""

import numpy as np
import pytest

import planeverb_tpu as jpv
import planeverb_tpu_torch as tpv
from planeverb_tpu_torch.convert import scene_from_jax

# (scene, grid edge m, resolution Hz, listener (x, z)); DirectionTester's
# grid center lies inside its divider wall, so its listener sits below it
CASES = [("SmallRoom", 10.0, 275, (5.0, 5.0)),
         ("DirectionTester", 10.0, 275, (5.0, 2.5)),
         ("BigRoom", 11.0, 275, (5.5, 5.5)),
         ("SmallRoom", 10.0, 375, (5.0, 5.0))]
# emitter offsets from the listener, all inside each case's room
OFFSETS = [(1.5, 0.0), (-1.0, -1.0), (0.5, 1.2)]


def _fields(ctx, xs, zs):
    outs = [[ctx.result_at(x, z) for z in zs] for x in xs]
    return {
        "occlusion": np.array([[o.occlusion for o in r] for r in outs]),
        "wet_gain": np.array([[o.wet_gain for o in r] for r in outs]),
        "rt60": np.array([[o.rt60 for o in r] for r in outs]),
        "lowpass": np.array([[o.lowpass for o in r] for r in outs]),
        "direction": np.array([[(o.direction.x, o.direction.y) for o in r]
                               for r in outs]),
        "source_directivity": np.array(
            [[(o.source_directivity.x, o.source_directivity.y) for o in r]
             for r in outs]),
    }


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c[0]}@{c[2]}" for c in CASES])
def engines(request):
    name, size, res, (lx, lz) = request.param
    scene = jpv.demo_scene(name)
    ctxs = []
    for make in (lambda cfg: jpv.Context(cfg, scene=scene),
                 lambda cfg: tpv.Context(cfg, scene=scene_from_jax(scene),
                                         device="cpu")):
        cfg_mod = jpv if not ctxs else tpv
        ctx = make(cfg_mod.PlaneverbConfig(size, size, res))
        ctx.set_listener_position(lx, 0.0, lz)
        for dx, dz in OFFSETS:
            ctx.emissions.emit(lx + dx, 0.0, lz + dz)
        ctx.step()
        ctxs.append(ctx)
    return ctxs


def _emitters(ctx):
    return [(x, z) for x, _, z in ctx.emissions.snapshot().values()]


def test_efree(engines):
    j, t = engines
    assert abs(t.efree - j.efree) <= 1e-5 * abs(j.efree)


def test_every_cell_matches(engines):
    j, t = engines
    p = t.params
    np.testing.assert_array_equal(t._published["delay_samples"],
                                  j._published["delay_samples"])
    xs = [(i + 0.5) * p.dx for i in range(p.grid_x)]
    zs = [(k + 0.5) * p.dx for k in range(p.grid_y)]
    a, b = _fields(t, xs, zs), _fields(j, xs, zs)
    np.testing.assert_allclose(a["occlusion"], b["occlusion"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(a["wet_gain"], b["wet_gain"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(a["lowpass"], b["lowpass"], rtol=2e-4,
                               atol=1e-2)
    valid = (b["rt60"] > 0.01) & (b["rt60"] < 100.0)
    assert valid.sum() > 0
    np.testing.assert_allclose(a["rt60"][valid], b["rt60"][valid], rtol=5e-3)
    np.testing.assert_allclose(a["source_directivity"],
                               b["source_directivity"], rtol=1e-3, atol=1e-4)
    diff = np.abs(a["direction"] - b["direction"]).max(axis=-1)
    assert int((diff > 1e-4).sum()) == 0
    for eid, (x, z) in enumerate(_emitters(t)):
        assert t.get_output(eid) == t.result_at(x, z)
        assert t.get_output(eid).valid


def test_impulse_response(engines):
    """IRs within 1e-6 of the recording's peak (the C1 pressure bound;
    the peak is at the listener's injection cell)."""
    j, t = engines
    peak = np.abs(np.asarray(j._published["pressure"])).max()
    for x, z in _emitters(t):
        a = t.get_impulse_response(x, z)
        b = j.get_impulse_response(x, z)
        assert a.shape == b.shape == (t.params.response_length,)
        assert np.abs(a - b).max() <= 1e-6 * peak
        assert np.abs(a).max() > 0


def test_out_of_grid_probe(engines):
    _, t = engines
    assert not t.result_at(500.0, 500.0).valid
    assert not t.result_at(-1.0, 5.0).valid
    assert t.get_impulse_response(500.0, 500.0).shape == (0,)
    assert not t.get_output(99).valid


def test_background_loop():
    ctx = tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275),
                      scene=tpv.demo_scene("SmallRoom"), device="cpu")
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.start()
    try:
        assert ctx.wait_for_iteration(2, timeout=60.0)
        assert ctx.background_running
    finally:
        ctx.stop()
    assert ctx.error is None and not ctx.background_running
    assert ctx.iteration >= 2
    summary = ctx.profile_summary()
    assert summary["simulate+analyze"]["count"] >= 2
    assert summary["throughput"]["cell_updates"] == (
        ctx.params.nx * ctx.params.ny * ctx.params.response_length)


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"halo": 8},
                                    {"precision": "bf16"},
                                    {"publish": "cells"},
                                    {"lazy_directions": True}],
                         ids=["mesh", "halo", "bf16", "cells", "lazy_doa"])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275), device="cpu",
                    **kwargs)


def test_multi_listener_raises():
    ctx = tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        ctx.set_listener_positions([(5, 0, 5), (3, 0, 3)])
    ctx.set_listener_positions([(4.0, 0.0, 6.0)])
    assert ctx.get_listener_position() == (4.0, 0.0, 6.0)


def test_cuda_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275))
