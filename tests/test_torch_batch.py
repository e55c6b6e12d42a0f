"""Several listeners: the batched B1/B2 plain versions, ``pipeline_auto_batch``
and ``ops/batch.py`` against the JAX package on the CPU.

The batched CUDA kernels need the card; ``chip_smoke.py`` phase 14 holds
them to these plain versions there. Here, at the setting of
tests/test_fdtd_pallas.py::test_batched_kernel_parity (SmallRoom, 29x29
cells, T=70, three listeners):

  - the batched plain versions against JAX ``simulate_pallas_batch`` /
    ``simulate_moments_pallas_batch`` in interpret mode at the C1 bound
    (recording, flux and windowed energies max-abs <= 1e-6 * max|ref|;
    onset exactly equal; RT60 moments scale-relative < 1e-5), and
    ``torch.equal`` to three single-listener plain passes (the property
    the card's batched kernels are held to as well);
  - ``pipeline_auto_batch`` against JAX's at rtol 1e-5, atol 1e-6, the
    bound of tests/test_fdtd_pallas.py::test_pipeline_auto_batch_matches_
    sequential;
  - ``ops/batch.py`` against ``planeverb_tpu/ops/batch.py`` at C1.
"""

import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planeverb_tpu.ops import batch as jbatch
from planeverb_tpu.ops import fdtd_pallas
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import AABB3D as JAABB3D
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import batch as tbatch
from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.scene import AABB3D

T = 70
LISTENERS = [(5.0, 5.0), (3.0, 7.0), (8.0, 2.0)]
EFREE = 0.0288


def _params(T=T):
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(10.0, 10.0, 275))
    return dataclasses.replace(p, response_length=T)


@pytest.fixture(scope="module")
def case():
    """The fields, the listener cells and the JAX batched kernels' outputs
    (interpret mode), cropped to the field."""
    p = _params()
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)
    cells = [p.world_to_cell(*pos) for pos in LISTENERS]
    args = (p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
            jnp.asarray(np.array(cells, np.int32)))
    jres = fdtd_pallas.simulate_pallas_batch(*args, interpret=True)
    (onset, fx, fy), jm = fdtd_pallas.simulate_moments_pallas_batch(
        *args, interpret=True)

    def crop(a):
        return np.asarray(a)[..., :p.nx, :p.ny]

    ref = {"pressure": crop(jres.pressure), "onset": crop(onset),
           "flux_x": crop(fx), "flux_y": crop(fy),
           **{k: crop(getattr(jm, k)) for k in jm._fields}}
    fields = fields_from_numpy(beta, refl, pulse, device="cpu")
    return p, fields, cells, ref, args


def _close(got, ref, rel, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(ref).max() + 1e-30
    assert np.abs(got - ref).max() <= rel * scale, name


def test_fdtd_sim_batch_reference_matches_pallas(case):
    p, (b, r, pl), cells, ref, _ = case
    res, (ed, ew, et) = fdtd_fused.fdtd_sim_batch_reference(p, b, r, pl,
                                                            cells)
    assert res.pressure.shape == (len(cells), T, p.nx, p.ny)
    for key in ("pressure", "flux_x", "flux_y"):
        _close(getattr(res, key), ref[key], 1e-6, key)
    np.testing.assert_array_equal(res.onset.numpy(), ref["onset"])
    for name, got in (("e_dry", ed), ("e_wet", ew), ("e_total", et)):
        _close(got, ref[name], 1e-6, name)


def test_rt60_moments_batch_reference_matches_pallas(case):
    p, (b, r, pl), cells, ref, _ = case
    res, _ = fdtd_fused.fdtd_sim_batch_reference(p, b, r, pl, cells)
    s0, s1 = fdtd_fused.rt60_moments_batch_reference(p, res.pressure,
                                                     res.onset)
    _close(s0, ref["s0"], 1e-5, "s0")
    _close(s1, ref["s1"], 1e-5, "s1")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_batch_equals_single_passes(case, dtype):
    """Each listener of the batched plain versions equals its own
    single-listener plain pass bit for bit, in both state types."""
    p, (b, r, pl), cells, _, _ = case
    res, acc = fdtd_fused.fdtd_sim_batch_reference(p, b, r, pl, cells,
                                                   state_dtype=dtype)
    s0, s1 = fdtd_fused.rt60_moments_batch_reference(p, res.pressure,
                                                     res.onset)
    assert res.pressure.dtype == dtype and res.onset.dtype == torch.float32
    for i, (lix, liy) in enumerate(cells):
        one, one_acc = fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy,
                                                     state_dtype=dtype)
        for a, g in zip((*one, *one_acc), (*res, *acc)):
            assert torch.equal(a, g[i])
        m0, m1 = fdtd_fused.rt60_moments_reference(p, one.pressure,
                                                   one.onset)
        assert torch.equal(m0, s0[i]) and torch.equal(m1, s1[i])


def test_cpu_batch_wrappers_take_plain_path(case):
    p, (b, r, pl), cells, _, _ = case
    fdtd_fused.reset_launch_counts()
    res, mom = fdtd_fused.simulate_moments_fused_batch(
        p, b, r, pl, np.array(cells, np.int32))
    ref, acc = fdtd_fused.fdtd_sim_batch_reference(p, b, r, pl, cells)
    s0, s1 = fdtd_fused.rt60_moments_batch_reference(p, ref.pressure,
                                                     ref.onset)
    assert fdtd_fused.fdtd_sim_batch.launches == 0
    assert fdtd_fused.rt60_moments_batch.launches == 0
    for a, g in zip((*ref, *acc, s0, s1), (*res, *mom[:3], mom.s0, mom.s1)):
        assert torch.equal(a, g)


def test_batch_wrappers_errors(case):
    p, (b, r, pl), cells, _, _ = case
    with pytest.raises(ValueError, match="meta"):
        fdtd_fused.fdtd_sim_batch(p, b.to("meta"), r.to("meta"),
                                  pl.to("meta"), cells)
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        fdtd_fused.fdtd_sim_batch(p, b, r, pl, [])
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        fdtd_fused.fdtd_sim_batch(p, b, r, pl, [(1, 2, 3)])
    with pytest.raises(ValueError, match="state_dtype"):
        fdtd_fused.fdtd_sim_batch(p, b, r, pl, cells,
                                  state_dtype=torch.float16)
    rec = torch.zeros((2, T, p.nx, p.ny))
    onset = torch.zeros((2, p.nx, p.ny))
    with pytest.raises(ValueError, match="3D"):
        fdtd_fused.rt60_moments_batch(p, rec, onset[0])
    with pytest.raises(ValueError, match="bfloat16"):
        fdtd_fused.rt60_moments_batch(p, rec.double(), onset)
    with pytest.raises(ValueError, match="meta"):
        fdtd_fused.rt60_moments_batch(p, rec.to("meta"), onset.to("meta"))
    # B4 (tiled) reads float32 recordings only
    with pytest.raises(ValueError, match="float32"):
        fdtd_tiled.rt60_moments_tiled(p, rec[0].bfloat16(), onset[0])
    assert fdtd_fused.fdtd_sim_batch.launches == 0


def test_pipeline_auto_batch_matches_pallas(case):
    """The batched pass with per-view assembly against JAX's
    ``pipeline_auto_batch`` (batched kernels + vmapped assembly, interpret
    mode) and, exactly, against one ``pipeline_auto`` per listener."""
    p, (b, r, pl), cells, _, args = case
    lpos = np.array(LISTENERS[:2], np.float32)
    jout = fdtd_pallas.pipeline_auto_batch(
        *args[:4], args[4][:2], jnp.float32(EFREE), jnp.asarray(lpos),
        interpret=True)
    out = fdtd_fused.pipeline_auto_batch(p, b, r, pl, cells[:2], EFREE,
                                         lpos)
    for name in out._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for i, ((lix, liy), (lx, lz)) in enumerate(zip(cells, lpos)):
        _, one = fdtd_fused.pipeline_auto(p, b, r, pl, lix, liy, EFREE,
                                          float(lx), float(lz))
        for name in out._fields:
            assert torch.equal(getattr(out, name)[i], getattr(one, name))


def test_pipeline_auto_batch_tiled_route(case, monkeypatch):
    """Above TILED_MIN_CELLS (here 0) the listeners run one B3 + B4 pass
    each, in turn, every recording freed before the next pass starts, and
    the results equal the batched route's."""
    p, (b, r, pl), cells, _, _ = case
    batched = fdtd_fused.pipeline_auto_batch(p, b, r, pl, cells, EFREE,
                                             LISTENERS)
    calls = {"fdtd_sim_tiled": 0, "rt60_moments_tiled": 0}
    live = []
    sim, mom = fdtd_tiled.fdtd_sim_tiled, fdtd_tiled.rt60_moments_tiled

    def sim_spy(*a, **k):
        # the previous listener's recording is gone before this pass
        assert all(ref() is None for ref in live)
        calls["fdtd_sim_tiled"] += 1
        res, acc = sim(*a, **k)
        live.append(weakref.ref(res.pressure))
        return res, acc

    def mom_spy(*a, **k):
        calls["rt60_moments_tiled"] += 1
        return mom(*a, **k)

    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    monkeypatch.setattr(fdtd_tiled, "PLAIN_PLAN", (16, 8, 6))
    monkeypatch.setattr(fdtd_tiled, "fdtd_sim_tiled", sim_spy)
    monkeypatch.setattr(fdtd_tiled, "rt60_moments_tiled", mom_spy)
    fdtd_fused.reset_launch_counts()
    tiled = fdtd_fused.pipeline_auto_batch(p, b, r, pl, cells, EFREE,
                                           LISTENERS,
                                           state_dtype=torch.bfloat16)
    assert calls == {"fdtd_sim_tiled": 3, "rt60_moments_tiled": 3}
    assert fdtd_fused.fdtd_sim_batch.launches == 0   # CPU: plain versions
    # float32 on the tiled route whatever the state type
    for name in batched._fields:
        assert torch.equal(getattr(tiled, name), getattr(batched, name))


def test_simulate_listeners_match_jax(case):
    p, (b, r, pl), cells, _, args = case
    ixs, iys = [c[0] for c in cells], [c[1] for c in cells]
    res = tbatch.simulate_listeners(p, b, r, pl, ixs, iys)
    jres = jbatch.simulate_listeners(p, *args[1:4], jnp.asarray(ixs),
                                     jnp.asarray(iys))
    assert res.pressure.shape == (3, T, p.nx, p.ny)
    for key in ("pressure", "flux_x", "flux_y"):
        _close(getattr(res, key), np.asarray(getattr(jres, key)), 1e-6, key)
    np.testing.assert_array_equal(res.onset.numpy(), np.asarray(jres.onset))

    out = tbatch.analyze_listeners(p, res, EFREE,
                                   [x for x, _ in LISTENERS],
                                   [z for _, z in LISTENERS])
    jout = jbatch.analyze_listeners(
        p, jres, jnp.float32(EFREE),
        jnp.asarray([x for x, _ in LISTENERS], jnp.float32),
        jnp.asarray([z for _, z in LISTENERS], jnp.float32))
    np.testing.assert_allclose(out.occlusion.numpy(),
                               np.asarray(jout.occlusion), rtol=1e-5)
    np.testing.assert_allclose(out.direction.numpy(),
                               np.asarray(jout.direction), atol=1e-5)

    for tiled in (False, True):
        if tiled:   # the per-listener route above TILED_MIN_CELLS
            old = fdtd_fused.TILED_MIN_CELLS
            fdtd_fused.TILED_MIN_CELLS = 0
        try:
            auto = tbatch.simulate_listeners_auto(p, b, r, pl, ixs, iys)
        finally:
            if tiled:
                fdtd_fused.TILED_MIN_CELLS = old
        for a, g in zip(auto, res):
            assert torch.equal(a, g)


def test_simulate_scenes_match_jax():
    p = _params(48)
    beta_a, refl_a = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    beta_b, refl_b = jvox.voxelize_np(p, demo_scene("BigRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(5.0, 5.0)
    betas, refls = np.stack([beta_a, beta_b]), np.stack([refl_a, refl_b])
    res = tbatch.simulate_scenes(p, torch.from_numpy(betas),
                                 torch.from_numpy(refls),
                                 torch.from_numpy(pulse), lix, liy)
    jres = jbatch.simulate_scenes(p, jnp.asarray(betas), jnp.asarray(refls),
                                  jnp.asarray(pulse), lix, liy)
    assert res.pressure.shape == (2, 48, p.nx, p.ny)
    _close(res.pressure, np.asarray(jres.pressure), 1e-6, "pressure")
    np.testing.assert_array_equal(res.onset.numpy(), np.asarray(jres.onset))


def test_simulate_slices_match_jax():
    """Per-height slices see different geometry (a wall only below 2 m):
    the stack equals JAX's at C1, and the high slice beyond the wall is
    louder than the low one."""
    p = _params(60)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(4.0, 5.0)
    wall = (6.0, 1.0, 5.0, 0.5, 2.0, 8.0, 0.97)
    res = tbatch.simulate_slices(p, [AABB3D(*wall)], [1.0, 5.0],
                                 torch.from_numpy(pulse), lix, liy)
    jres = jbatch.simulate_slices(p, [JAABB3D(*wall)], [1.0, 5.0],
                                  jnp.asarray(pulse), lix, liy)
    assert res.pressure.shape == (2, 60, p.nx, p.ny)
    _close(res.pressure, np.asarray(jres.pressure), 1e-6, "pressure")
    px, py = p.world_to_cell(8.0, 5.0)
    e_low, e_high = (float((res.pressure[k, :, px, py] ** 2).sum())
                     for k in (0, 1))
    assert e_high > 2.0 * e_low
