"""The bf16 wave-state mode (``state_dtype=torch.bfloat16``,
``Context(precision="bf16")``) against the JAX package on the CPU.

The bf16 CUDA kernels need the card; ``chip_smoke.py`` phase 16 holds them
to these plain versions there. Here, on SmallRoom at 275 Hz with the full
435-step response:

  - the plain bf16 sim + moments against JAX ``simulate_moments_pallas(...,
    interpret=True, state_dtype=jnp.bfloat16)``. Raw fields: measured
    bit-equal on this setting (recording, onset, flux, windowed energies;
    the RT60 moments within 1.1e-7 of their scale); held to the C1 bound
    (1e-6 of the peak; onset exact) and 1e-5 for the moments.
  - the six parameters at the bounds of tests/test_fdtd_pallas.py::
    test_bf16_state_mode_golden_parameters (occlusion and wet gain 2 %,
    RT60 6 %, lowpass 0.5 %, directions within 2 degrees), against JAX's
    bf16 pass and against the port's own float32 pass;
  - the CPU ``Context(precision="bf16")`` against JAX's, whose CPU path
    ignores the precision (so: against float32), at the same bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import planeverb_tpu as jpv
import planeverb_tpu_torch as tpv
from planeverb_tpu.ops import analyzer as jan
from planeverb_tpu.ops import fdtd_pallas
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy, scene_from_jax
from planeverb_tpu_torch.core import free_grid
from planeverb_tpu_torch.ops import fdtd_fused
from planeverb_tpu_torch.ops._common import window_scalars

EFREE = 0.0288
LISTENER = (5.0, 5.0)


def _max_rel(a, b, floor=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    m = np.abs(a) > floor
    return float((np.abs(a - b)[m] / np.abs(a)[m]).max())


def _max_angle(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dot = (a * b).sum(-1)
    nrm = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    ok = nrm > 1e-9
    return float(np.degrees(np.arccos(np.clip(dot[ok] / nrm[ok], -1, 1)))
                 .max()) if ok.any() else 0.0


def _assert_bf16_bounds(ref, got):
    """The bf16 parameter bounds of the JAX package's bf16 test."""
    assert _max_rel(ref["occlusion"], got["occlusion"]) < 0.02
    assert _max_rel(ref["wet_gain"], got["wet_gain"]) < 0.02
    assert _max_rel(ref["rt60"], got["rt60"]) < 0.06
    assert _max_rel(ref["lowpass"], got["lowpass"]) < 0.005
    for name in ("direction", "source_directivity"):
        assert _max_angle(ref[name], got[name]) < 2.0, name


@pytest.fixture(scope="module")
def case():
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(10.0, 10.0, 275))
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(*LISTENER)
    jres, jm = fdtd_pallas.simulate_moments_pallas(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.int32(lix), jnp.int32(liy), interpret=True,
        state_dtype=jnp.bfloat16)
    jout = jan.analyze_moments(p, jm, jres.onset, jres.flux_x, jres.flux_y,
                               np.float32(EFREE), np.float32(LISTENER[0]),
                               np.float32(LISTENER[1]))
    fields = fields_from_numpy(beta, refl, pulse, device="cpu")
    return p, fields, (lix, liy), (jres, jm, jout)


def _crop(p, a):
    return np.asarray(a)[..., :p.nx, :p.ny]


def test_courant_rounded_like_jax():
    """The trap: JAX rounds the weakly typed Python Courant number to bf16
    before it multiplies the bf16 state; the port passes it so rounded."""
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(25.0, 25.0, 750))
    c16 = window_scalars(p, torch.bfloat16)[0]
    assert c16 == float(jnp.asarray(p.courant, jnp.bfloat16))
    assert c16 != window_scalars(p)[0] == float(np.float32(p.courant))
    assert window_scalars(p, torch.bfloat16)[1:] == window_scalars(p)[1:]


def test_bf16_sim_matches_pallas(case):
    p, (b, r, pl), (lix, liy), (jres, jm, _) = case
    res, mom = fdtd_fused.simulate_moments_fused(p, b, r, pl, lix, liy,
                                                 state_dtype=torch.bfloat16)
    # the recording is bf16, every accumulator float32
    assert res.pressure.dtype == torch.bfloat16
    assert res.pressure.shape == (p.response_length, p.nx, p.ny)
    for x in (res.onset, res.flux_x, res.flux_y, *mom):
        assert x.dtype == torch.float32
    rec = _crop(p, jres.pressure.astype(jnp.float32))
    got = res.pressure.float().numpy()
    assert np.abs(got - rec).max() <= 1e-6 * np.abs(rec).max()
    np.testing.assert_array_equal(res.onset.numpy(), _crop(p, jres.onset))
    for name, a, ref in (("flux_x", res.flux_x, jres.flux_x),
                         ("flux_y", res.flux_y, jres.flux_y),
                         *((k, getattr(mom, k), getattr(jm, k))
                           for k in jm._fields)):
        ref = _crop(p, ref)
        rel = 1e-5 if name in ("s0", "s1") else 1e-6
        assert np.abs(a.numpy() - ref).max() <= rel * np.abs(ref).max(), \
            name


def test_bf16_parameters_within_bounds(case):
    """Assembled parameters of the port's bf16 pass against JAX's bf16
    pass and against the port's float32 pass, at the bf16 bounds."""
    p, (b, r, pl), (lix, liy), (_, _, jout) = case

    def params_of(dtype):
        _, out = fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, EFREE,
                                          *LISTENER, state_dtype=dtype)
        return {k: v.numpy() for k, v in out._asdict().items()}

    got16, got32 = params_of(torch.bfloat16), params_of(torch.float32)
    _assert_bf16_bounds({k: np.asarray(v) for k, v in jout._asdict().items()},
                        got16)
    _assert_bf16_bounds(got32, got16)
    # and the bf16 mode does change the result (it is not silently f32)
    assert not np.array_equal(got16["occlusion"], got32["occlusion"])


def _grids(ctx):
    """Every analysis cell's published parameters, through result_at."""
    p = ctx.params
    outs = [[ctx.result_at((i + 0.5) * p.dx, (k + 0.5) * p.dx)
             for k in range(p.grid_y)] for i in range(p.grid_x)]
    g = {f: np.array([[getattr(o, f) for o in row] for row in outs])
         for f in ("occlusion", "wet_gain", "rt60", "lowpass")}
    for f in ("direction", "source_directivity"):
        g[f] = np.array([[(getattr(o, f).x, getattr(o, f).y) for o in row]
                         for row in outs])
    return g


def test_bf16_context_matches_jax():
    """The CPU Context(precision="bf16") runs the bf16 plain version: within
    the bf16 bounds of the JAX Context (whose CPU path ignores precision),
    not equal to the port's float32 Context; its impulse response is
    float32."""
    scene = demo_scene("SmallRoom")
    cfg = (10.0, 10.0, 275)
    j = jpv.Context(jpv.PlaneverbConfig(*cfg), scene=scene, precision="bf16")
    t16 = tpv.Context(tpv.PlaneverbConfig(*cfg), scene=scene_from_jax(scene),
                      precision="bf16", device="cpu")
    free_grid.clear_cache()      # t32 calibrates anew, not from t16's entry
    t32 = tpv.Context(tpv.PlaneverbConfig(*cfg), scene=scene_from_jax(scene),
                      device="cpu")
    for c in (j, t16, t32):
        c.set_listener_position(LISTENER[0], 0.0, LISTENER[1])
        c.step()
    assert t16._published["pressure"].dtype == torch.bfloat16
    assert t16.efree == t32.efree        # calibration runs float32
    g16 = _grids(t16)
    _assert_bf16_bounds(_grids(j), g16)
    assert not np.array_equal(g16["occlusion"], _grids(t32)["occlusion"])
    ir = t16.get_impulse_response(6.5, 5.0)
    assert ir.dtype == np.float32 and ir.shape == (t16.params.response_length,)
    assert np.abs(ir).max() > 0


def test_bf16_context_tiled_route_runs_f32(monkeypatch):
    """Above TILED_MIN_CELLS (here 0) the bf16 Context runs B3 + B4 in
    float32: its grids equal the float32 Context's on the same route."""
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    ctxs = []
    for precision in ("bf16", "f32"):
        c = tpv.Context(tpv.PlaneverbConfig(10.0, 10.0, 275),
                        scene=tpv.demo_scene("SmallRoom"),
                        precision=precision, device="cpu")
        c.set_listener_position(LISTENER[0], 0.0, LISTENER[1])
        c.step()
        ctxs.append(c._published)
    assert ctxs[0]["pressure"].dtype == torch.float32
    for k in ctxs[0].keys() - {"listener", "pressure"}:
        np.testing.assert_array_equal(ctxs[0][k], ctxs[1][k], err_msg=k)
