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


def _fields(ctx, xs, zs, listener=0):
    outs = [[ctx.result_at(x, z, listener=listener) for z in zs] for x in xs]
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


def _assert_golden(t, j, listener=0):
    """Every cell's published parameters of the port's Context ``t`` held
    to the JAX Context ``j`` at the golden tolerances (view ``listener``
    of several)."""
    p = t.params
    if "delay_samples" in t._published:   # grids publish
        view = (listener,) if "listeners" in t._published else ()
        np.testing.assert_array_equal(t._published["delay_samples"][view],
                                      j._published["delay_samples"][view])
    xs = [(i + 0.5) * p.dx for i in range(p.grid_x)]
    zs = [(k + 0.5) * p.dx for k in range(p.grid_y)]
    a, b = _fields(t, xs, zs, listener), _fields(j, xs, zs, listener)
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
    from planeverb_tpu_torch.core import free_grid
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled

    j, t = engines
    monkeypatch.setattr(free_grid, "_CACHE", {})   # calibrate tiled too
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_tiled, "PLAIN_PLAN", (16, 8, 4))
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


def _port_mesh():
    from planeverb_tpu_torch.parallel import grid_mesh

    return grid_mesh(["cpu"] * 4, (2, 2))


@pytest.mark.parametrize("case", ["halo"])
def test_unported_options_raise(case):
    """The overlapped halo exchange of the sharded rounds is ported; what
    the JAX engine refuses for it raises the JAX engine's ValueError: a 2D
    mesh, and on a 1D mesh shards of fewer than 3 * halo rows."""
    import jax

    from planeverb_tpu.parallel import grid_mesh as jax_grid_mesh
    from planeverb_tpu.parallel import simulate_sharded_pallas
    from planeverb_tpu_torch.parallel import grid_mesh, simulate_sharded_fused

    cfg = tpv.PlaneverbConfig(10.0, 10.0, 275)
    p = tpv.compute_grid_params(cfg)
    zeros = torch.zeros((32, 32))
    pulse = torch.zeros(p.response_length)
    for shape, match in (((2, 2), r"1D \('x', N\) mesh"),
                         ((4, 1), r"3\*halo")):
        n = shape[0] * shape[1]
        with pytest.raises(ValueError, match=match) as port:
            simulate_sharded_fused(p, zeros, zeros, pulse, 5, 5,
                                   grid_mesh(["cpu"] * n, shape), 32, 32,
                                   halo=8, overlap=True)
        with pytest.raises(ValueError, match=match) as ref:
            simulate_sharded_pallas(p, zeros.numpy(), zeros.numpy(),
                                    pulse.numpy(), 5, 5,
                                    jax_grid_mesh(jax.devices()[:n], shape),
                                    32, 32, halo=8, interpret=True,
                                    overlap=True)
        assert str(port.value) == str(ref.value)


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


@pytest.mark.parametrize("publish", ["grids", "cells"])
def test_mesh_context_matches(publish):
    """The port's Context on a 2x2 mesh of cpu (the plain B5 rounds, halo
    8 on its 15 x 15 shards) publishes exactly what the single-device
    Context publishes (every grid, or every emitter row and the device
    grid), with equal impulse responses read from the owning shards; and
    the JAX Context on a 2x2 mesh of its CPU devices within the golden
    tolerances."""
    import jax

    from planeverb_tpu.parallel import grid_mesh as jax_grid_mesh

    ctx_m, em = _small_ctx(tpv, mesh=_port_mesh(), publish=publish)
    ctx_1, _ = _small_ctx(tpv, publish=publish)
    jax_m, ej = _small_ctx(jpv, mesh=jax_grid_mesh(jax.devices()[:4],
                                                   (2, 2)),
                           publish=publish)
    assert ctx_m._halo == 8 and ctx_m.mesh.shape == {"x": 2, "y": 2}
    a, b = ctx_m._published, ctx_1._published
    if publish == "grids":
        for k in a.keys() - {"listener", "pressure"}:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        assert a["cells"].keys() == b["cells"].keys() and len(a["cells"])
        for cell, row in a["cells"].items():
            np.testing.assert_array_equal(row, b["cells"][cell])
        assert torch.equal(a["packed_device"], b["packed_device"])
    for x, z in ((6.5, 5.0), (4.0, 5.0), (1.0, 8.5), (9.0, 1.5)):
        ir = ctx_m.get_impulse_response(x, z)
        assert ir.shape == (ctx_m.params.response_length,)
        np.testing.assert_array_equal(ir, ctx_1.get_impulse_response(x, z))
    assert ctx_m.get_impulse_response(500.0, 5.0).shape == (0,)
    for e_m, e_j in zip(em, ej):
        _same_output(ctx_m.get_output(e_m), jax_m.get_output(e_j), 2e-4)
    _assert_golden(ctx_m, jax_m)


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


# two listeners inside SmallRoom's walls: split screen
MULTI = [(5.0, 0.0, 5.0), (4.0, 0.0, 6.0)]
PROBES = ((6.5, 5.0), (4.0, 5.0), (5.5, 6.0), (3.5, 3.5))


def _multi_ctx(mod, positions=MULTI, emit=True, **kwargs):
    """SmallRoom at 275 Hz with several listeners, emitters at (6.5, 5) and
    (4, 5), one step; on the CPU for the port."""
    if mod is tpv:
        kwargs["device"] = "cpu"
    ctx = mod.Context(mod.PlaneverbConfig(*CFG10),
                      scene=mod.demo_scene("SmallRoom"), **kwargs)
    ctx.set_listener_positions(positions)
    eids = ([ctx.emissions.emit(6.5, 0.0, 5.0),
             ctx.emissions.emit(4.0, 0.0, 5.0)] if emit else [])
    ctx.step()
    return ctx, eids


def _solo(pos, **kwargs):
    ctx = tpv.Context(tpv.PlaneverbConfig(*CFG10),
                      scene=tpv.demo_scene("SmallRoom"), device="cpu",
                      **kwargs)
    ctx.set_listener_position(*pos)
    ctx.step()
    return ctx


def test_multi_listener_mode():
    """Split screen: every view's published grids equal a single-listener
    Context's at that position, and hold the JAX multi-listener Context's
    at the golden tolerances; out-of-range views are the sentinel, the
    recordings are not kept, and one listener restores the single path."""
    t, te = _multi_ctx(tpv)
    j, _ = _multi_ctx(jpv)
    assert t.get_listener_positions() == MULTI
    assert t.get_listener_position() == MULTI[0]
    p = t.params
    assert t._published["occlusion"].shape == (2, p.grid_x, p.grid_y)
    assert t._published["listeners"] == [(x, z) for x, _, z in MULTI]
    for i, pos in enumerate(MULTI):
        solo = _solo(pos)
        for k in solo._published.keys() - {"listener", "pressure"}:
            np.testing.assert_array_equal(t._published[k][i],
                                          solo._published[k], err_msg=k)
        for e, (x, z) in zip(te, ((6.5, 5.0), (4.0, 5.0))):
            assert t.get_output(e, listener=i) == solo.result_at(x, z)
            assert t.get_output(e, listener=i).valid
        _assert_golden(t, j, listener=i)
    # the views differ (another listener, another IR)
    v0, v1 = (t.result_at(6.5, 5.0, listener=i) for i in (0, 1))
    assert abs(v0.occlusion - v1.occlusion) > 1e-4
    for bad in (2, -1):
        assert not t.result_at(6.5, 5.0, listener=bad).valid
        assert not t.get_output(te[0], listener=bad).valid
    assert t.get_impulse_response(6.5, 5.0).size == 0
    tput = t.profile_summary()["throughput"]
    assert tput["listeners"] == 2
    assert tput["cell_updates"] == p.nx * p.ny * p.response_length

    t.set_listener_position(5.0, 0.0, 5.0)
    assert t.get_listener_positions() == [(5.0, 0.0, 5.0)]
    t.step()
    assert t.get_impulse_response(6.5, 5.0).shape == (p.response_length,)
    assert t.result_at(6.5, 5.0).valid
    assert not t.result_at(6.5, 5.0, listener=1).valid


def test_multi_listener_validation():
    ctx = tpv.Context(tpv.PlaneverbConfig(*CFG10), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ctx.set_listener_positions([])
    with pytest.raises(ValueError, match="triples"):
        ctx.set_listener_positions([(1.0, 2.0)])
    # a single-element list is just the ordinary listener
    ctx.set_listener_positions([(4.0, 0.0, 4.0)])
    assert ctx.get_listener_position() == (4.0, 0.0, 4.0)
    assert ctx.get_listener_positions() == [(4.0, 0.0, 4.0)]
    # every view is checked for coverage
    with pytest.warns(RuntimeWarning, match="only covers"):
        ctx.set_listener_positions([(5.0, 0.0, 5.0), (-30.0, 0.0, -30.0)])
    assert len(ctx.get_listener_positions()) == 2


def test_multi_listener_cells_publish():
    """Cells publish with several views: each emitter cell's [B, 9] rows
    in one copy, equal to the grids publish and within the golden
    tolerances of the JAX engine's; a probe outside the emitter set
    fetches every view's row on demand and memoizes it."""
    c, ce = _multi_ctx(tpv, publish="cells")
    g, ge = _multi_ctx(tpv, lazy_directions=False)
    j, je = _multi_ctx(jpv, publish="cells")
    cells = c._published["cells"]
    assert len(cells) == 2
    assert all(row.shape == (2, 9) for row in cells.values())
    assert c._published["packed_device"].shape == (2, 28, 28, 9)
    for i in range(2):
        for a_id, b_id, j_id in zip(ce, ge, je):
            a = c.get_output(a_id, listener=i)
            assert a.valid and a == g.get_output(b_id, listener=i)
            _same_output(a, j.get_output(j_id, listener=i), 2e-4)
        probe = c.result_at(5.5, 6.0, listener=i)
        assert probe == g.result_at(5.5, 6.0, listener=i)
        _same_output(probe, j.result_at(5.5, 6.0, listener=i), 2e-4)
    assert c.params.world_to_cell(5.5, 6.0) in cells
    assert not c.result_at(6.5, 5.0, listener=3).valid
    empty, _ = _multi_ctx(tpv, publish="cells", emit=False)
    assert empty._published["cells"] == {}
    assert empty.result_at(6.5, 5.0, listener=1) == g.result_at(
        6.5, 5.0, listener=1)


def test_multi_listener_lazy_directions():
    """Lazy directions walk each view's own grids from its own listener:
    the device DOA pass's directions, and the JAX engine's lazy ones."""
    a, _ = _multi_ctx(tpv, lazy_directions=False)
    b, _ = _multi_ctx(tpv, lazy_directions=True)
    jb, _ = _multi_ctx(jpv, lazy_directions=True)
    assert b._lazy_doa
    np.testing.assert_array_equal(b._published["direction"], 0.0)
    for i in range(2):
        for x, z in PROBES:
            u = b.result_at(x, z, listener=i)
            _same_output(a.result_at(x, z, listener=i), u, 1e-6)
            _same_output(u, jb.result_at(x, z, listener=i), 2e-4)


@pytest.mark.parametrize("publish", ["grids", "cells"])
def test_multi_listener_on_mesh(publish):
    """Several views on a 2x2 mesh of cpu (one sharded pass per view)
    publish exactly what the single-device multi-listener Context
    publishes, and hold the JAX engine's on a 2x2 mesh at the golden
    tolerances."""
    import jax

    from planeverb_tpu.parallel import grid_mesh as jax_grid_mesh

    m, me = _multi_ctx(tpv, mesh=_port_mesh(), publish=publish)
    s, _ = _multi_ctx(tpv, publish=publish)
    jm, je = _multi_ctx(jpv, mesh=jax_grid_mesh(jax.devices()[:4], (2, 2)),
                        publish=publish)
    a, b = m._published, s._published
    if publish == "grids":
        for k in a.keys() - {"listener", "listeners"}:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        assert a["cells"].keys() == b["cells"].keys() and len(a["cells"])
        for cell, row in a["cells"].items():
            np.testing.assert_array_equal(row, b["cells"][cell])
        assert torch.equal(a["packed_device"], b["packed_device"])
    assert m.get_impulse_response(6.5, 5.0).size == 0
    for i in range(2):
        for e_m, e_j in zip(me, je):
            _same_output(m.get_output(e_m, listener=i),
                         jm.get_output(e_j, listener=i), 2e-4)
        _assert_golden(m, jm, listener=i)


def test_multi_listener_tiled_route(monkeypatch):
    """Above TILED_MIN_CELLS (here 0) the views run one tiled pass each;
    the published grids equal the batched route's."""
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled

    batched, _ = _multi_ctx(tpv)
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_tiled, "PLAIN_PLAN", (16, 8, 6))
    tiled, _ = _multi_ctx(tpv)
    for k in batched._published.keys() - {"listener", "listeners"}:
        np.testing.assert_array_equal(tiled._published[k],
                                      batched._published[k], err_msg=k)


def test_cuda_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275))


def test_calibrate_without_card_raises():
    """calibrate_free_field runs on the card unless asked for the CPU."""
    from planeverb_tpu_torch.core.free_grid import calibrate_free_field

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tpv.compute_grid_params(tpv.PlaneverbConfig(*CFG10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_free_field(p)
    assert calibrate_free_field(p, device="cpu") > 0


# --------------------------------------------- the free-field cache (C6)
@pytest.fixture()
def counted_efree(monkeypatch):
    """An empty calibration cache, and the list of (params, device) each
    calibration simulation ran on."""
    from planeverb_tpu_torch.core import free_grid

    runs = []
    sim = free_grid._efree_on

    def counting(params, device):
        runs.append((params, device))
        return sim(params, device)

    monkeypatch.setattr(free_grid, "_CACHE", {})
    monkeypatch.setattr(free_grid, "_efree_on", counting)
    return free_grid, runs


def test_calibration_cached_per_configuration(counted_efree):
    """A second calibration of the same configuration and device runs no
    simulation and returns the same float; another configuration runs one;
    clear_cache() empties the cache."""
    free_grid, runs = counted_efree
    p = tpv.compute_grid_params(tpv.PlaneverbConfig(*CFG10))
    q = tpv.compute_grid_params(tpv.PlaneverbConfig(10.0, 10.0, 375))
    first = free_grid.calibrate_free_field(p, device="cpu")
    assert len(runs) == 1
    assert free_grid.calibrate_free_field(p, device="cpu") == first
    a = tpv.Context(tpv.PlaneverbConfig(*CFG10), device="cpu")
    assert len(runs) == 1 and a.efree == first
    free_grid.calibrate_free_field(q, device="cpu")
    assert len(runs) == 2 and len(free_grid._CACHE) == 2
    free_grid.clear_cache()
    assert free_grid._CACHE == {}
    assert free_grid.calibrate_free_field(p, device="cpu") == first
    assert len(runs) == 3


def test_calibration_cache_keeps_devices_apart(counted_efree):
    """A value cached for one device never answers another: a CUDA entry
    is not returned to the CPU, and a CPU entry does not stop a CUDA
    request from going to the card (which raises here, without one)."""
    free_grid, runs = counted_efree
    p = tpv.compute_grid_params(tpv.PlaneverbConfig(*CFG10))
    cal = free_grid._cal_params(p)
    for dev in ("cuda", "cuda:0", "cuda:1"):
        free_grid._CACHE[free_grid._key(cal, torch.device(dev))] = -1.0
    efree = free_grid.calibrate_free_field(p, device="cpu")
    assert efree > 0 and len(runs) == 1
    assert len({free_grid._key(cal, torch.device(d))
                for d in ("cpu", "cuda", "cuda:0", "cuda:1")}) == 4
    if not torch.cuda.is_available():
        free_grid._CACHE.pop(free_grid._key(cal, torch.device("cuda")))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            free_grid.calibrate_free_field(p)
        assert len(runs) == 1


def test_cached_efree_across_the_clamp_matches_jax(counted_efree):
    """Grids over CAL_SIZE_M calibrate on the clamped 25 m domain: 30 m and
    40 m share one cache entry (one simulation), equal to the JAX
    package's EFree at rel 1e-5 and to the 25 m grid's own."""
    from planeverb_tpu.core import free_grid as jfree_grid

    free_grid, runs = counted_efree
    vals = [free_grid.calibrate_free_field(tpv.compute_grid_params(
        tpv.PlaneverbConfig(size, size, 275)), device="cpu")
        for size in (30.0, 40.0, 25.0)]
    assert len(runs) == 1 and vals[0] == vals[1] == vals[2]
    want = jfree_grid.calibrate_free_field(jpv.compute_grid_params(
        jpv.PlaneverbConfig(30.0, 30.0, 275)))
    assert abs(vals[0] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("publish", ["grids", "cells"])
def test_queries_hold_no_recording(publish, monkeypatch):
    """``result_at`` reads the published snapshot without its recording: a
    reader held up inside it while the next step runs (an audio callback
    beside the refresh loop) keeps the old recording alive no longer than
    the step that replaces it. Its answers are the published ones."""
    import gc
    import sys
    import weakref

    from planeverb_tpu_torch.core import context as tcontext

    ctx = tpv.Context(tpv.PlaneverbConfig(6.0, 6.0, 275), publish=publish,
                      device="cpu")
    ctx.geometry.add(tpv.AABB(2.0, 4.0, 1.0, 0.5, 0.9))
    eid = ctx.emissions.emit(4.5, 0.0, 3.0)
    ctx.set_listener_position(3.0, 0.0, 3.0)
    ctx.step()
    held = []
    real = tcontext._output_from_row if publish == "cells" else tcontext.vec2

    def spy(*args):      # called inside result_at, its snapshot in reach
        held.append(sys._getframe(1).f_locals["results"])
        return real(*args)

    monkeypatch.setattr(tcontext, "_output_from_row" if publish == "cells"
                        else "vec2", spy)
    out = ctx.get_output(eid)
    assert out.valid and held
    snapshot = held[-1]
    assert "pressure" not in snapshot
    assert all(snapshot[k] is v for k, v in ctx._published.items()
               if k != "pressure")
    recording = weakref.ref(ctx._published["pressure"])
    ctx.step()
    gc.collect()
    assert recording() is None    # freed while the old snapshot is held
