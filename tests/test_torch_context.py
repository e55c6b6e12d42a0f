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
import torch

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


def _assert_golden(t, j):
    """Every cell's published parameters of the port's Context ``t`` held
    to the JAX Context ``j`` at the golden tolerances."""
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


def test_every_cell_matches(engines):
    j, t = engines
    _assert_golden(t, j)
    for eid, (x, z) in enumerate(_emitters(t)):
        assert t.get_output(eid) == t.result_at(x, z)
        assert t.get_output(eid).valid


def test_tiled_route_matches(engines, monkeypatch):
    """With every grid routed to the tiled plain path (B3 + B4, 16 x 8
    tiles with a 4-cell halo, so several windows), the published grids
    equal the untiled Context's bit for bit and hold the JAX Context's
    golden tolerances."""
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled

    j, t = engines
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_tiled, "TILES", ((16, 8),))
    monkeypatch.setattr(fdtd_tiled, "HALO", 4)
    tiled = tpv.Context(t.config,
                        scene=tpv.Scene(boxes=t.geometry.snapshot()[1]),
                        device="cpu")
    lx, _, lz = t.get_listener_position()
    tiled.set_listener_position(lx, 0.0, lz)
    for x, z in _emitters(t):
        tiled.emissions.emit(x, 0.0, z)
    tiled.step()
    assert tiled.efree == t.efree
    for k, v in t._published.items():
        if k == "pressure":
            assert torch.equal(tiled._published[k], v)
        elif k != "listener":
            np.testing.assert_array_equal(tiled._published[k], v, err_msg=k)
    _assert_golden(tiled, j)


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
                                    {"precision": "bf16"}],
                         ids=["mesh", "halo", "bf16"])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275), device="cpu",
                    **kwargs)


CFG10 = (10.0, 10.0, 275)


def _small_ctx(mod, **kwargs):
    """SmallRoom at 275 Hz, listener (5, 5), emitters at (6.5, 5) and
    (4, 5), one step; on the CPU for the port."""
    if mod is tpv:
        kwargs["device"] = "cpu"
    ctx = mod.Context(mod.PlaneverbConfig(*CFG10),
                      scene=mod.demo_scene("SmallRoom"), **kwargs)
    ctx.set_listener_position(5.0, 0.0, 5.0)
    eids = [ctx.emissions.emit(6.5, 0.0, 5.0),
            ctx.emissions.emit(4.0, 0.0, 5.0)]
    ctx.step()
    return ctx, eids


def _same_output(a, b, rel):
    for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=rel), f
    for f in ("direction", "source_directivity"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.x == pytest.approx(v.x, abs=1e-4), f
        assert u.y == pytest.approx(v.y, abs=1e-4), f


def test_cells_publish_mode_matches_grids():
    """publish='cells' (emitter rows copied, grid kept on the device)
    answers emitter queries and any probe exactly as the grids publish
    does, and within the golden tolerances of the JAX engine's cells
    publish."""
    ctx_g, eg = _small_ctx(tpv, lazy_directions=False)
    ctx_c, ec = _small_ctx(tpv, publish="cells")
    jax_c, ej = _small_ctx(jpv, publish="cells")
    assert len(ctx_c._published["cells"]) == 2
    for a_id, b_id, j_id in zip(eg, ec, ej):
        a, b = ctx_g.get_output(a_id), ctx_c.get_output(b_id)
        assert a.valid and b.valid
        assert a == b
        _same_output(b, jax_c.get_output(j_id), 2e-4)
    # a probe outside the emitter set: one row fetched on demand ...
    a, b = ctx_g.result_at(5.5, 6.0), ctx_c.result_at(5.5, 6.0)
    assert b.valid and a == b
    _same_output(b, jax_c.result_at(5.5, 6.0), 2e-4)
    # ... and memoized in the snapshot's cache
    cx, cy = ctx_c.params.world_to_cell(5.5, 6.0)
    assert (cx, cy) in ctx_c._published["cells"]
    assert not ctx_c.result_at(500.0, 500.0).valid
    ir = ctx_c.get_impulse_response(6.5, 5.0)
    assert ir.shape == (ctx_c.params.response_length,)
    np.testing.assert_array_equal(ir, ctx_g.get_impulse_response(6.5, 5.0))
    with pytest.raises(ValueError, match="cells"):
        tpv.Context(tpv.PlaneverbConfig(*CFG10), publish="cells",
                    lazy_directions=True, device="cpu")
    with pytest.raises(ValueError, match="publish"):
        tpv.Context(tpv.PlaneverbConfig(*CFG10), publish="nope",
                    device="cpu")


def test_cells_publish_without_emitters():
    ctx = tpv.Context(tpv.PlaneverbConfig(*CFG10),
                      scene=tpv.demo_scene("SmallRoom"), publish="cells",
                      device="cpu")
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.step()
    assert ctx._published["cells"] == {}
    assert ctx.result_at(6.5, 5.0).valid


def test_lazy_directions_context_matches_default():
    """Lazy directions (host walk per query) give the device DOA pass's
    directions, and the JAX engine's lazy ones, within 1e-4."""
    ctx_a, ea = _small_ctx(tpv)
    ctx_b, eb = _small_ctx(tpv, lazy_directions=True)
    jax_b, ej = _small_ctx(jpv, lazy_directions=True)
    assert not ctx_a._lazy_doa and ctx_b._lazy_doa
    np.testing.assert_array_equal(ctx_b._published["direction"], 0.0)
    for x, z in ((6.5, 5.0), (4.0, 5.0), (5.5, 6.0), (2.0, 8.0)):
        a, b = ctx_a.result_at(x, z), ctx_b.result_at(x, z)
        assert a.occlusion == b.occlusion
        _same_output(a, b, 1e-6)
        _same_output(b, jax_b.result_at(x, z), 2e-4)


def test_lazy_doa_default():
    """Lazy directions are the default on grids publish above
    LAZY_DOA_CELLS analysis cells (the JAX engine's threshold), never on
    cells publish; an explicit request works below it."""
    from planeverb_tpu.core.context import LAZY_DOA_CELLS as JAX_LAZY
    from planeverb_tpu_torch.core.context import LAZY_DOA_CELLS

    assert LAZY_DOA_CELLS == JAX_LAZY == 1 << 20
    small = tpv.PlaneverbConfig(95.0, 95.0, 275)     # ~266^2 cells
    ctx = tpv.Context(small, device="cpu")
    assert not ctx._lazy_doa
    assert ctx.params.grid_x * ctx.params.grid_y > (1 << 16)
    assert tpv.Context(small, lazy_directions=True, device="cpu")._lazy_doa
    big = tpv.PlaneverbConfig(400.0, 400.0, 275)     # > 1024^2 cells
    ctx = tpv.Context(big, device="cpu")
    assert ctx.params.grid_x * ctx.params.grid_y > LAZY_DOA_CELLS
    assert ctx._lazy_doa
    assert not tpv.Context(big, publish="cells", device="cpu")._lazy_doa
    assert jpv.Context(jpv.PlaneverbConfig(400.0, 400.0, 275))._lazy_doa


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
