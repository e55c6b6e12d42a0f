"""B1/B2 plain versions against the JAX Pallas kernels (interpret mode).

The CUDA kernels themselves need the card; ``chip_smoke.py`` holds each one
to these plain versions there. Here the plain versions are held to
``planeverb_tpu.ops.fdtd_pallas.simulate_moments_pallas`` run in interpret
mode, at the setting of tests/test_fdtd_pallas.py::test_moments_parity_vs_jnp
(SmallRoom, 29x29 cells, T=70).

Tolerances: recording, flux and windowed energies max-abs <= 1e-6 * max|ref|
(XLA contracts multiply-adds into FMAs, eager PyTorch does not); onset
exactly equal; the RT60 moments s0/s1 scale-relative < 1e-5 (the bound the
JAX package holds its own kernel to; log implementations differ by ulps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planeverb_tpu.ops import fdtd_pallas
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import analyzer as tan
from planeverb_tpu_torch.ops import fdtd_fused

T = 70


@pytest.fixture(scope="module")
def case():
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(10.0, 10.0, 275))
    p = dataclasses.replace(p, response_length=T)
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(5.0, 5.0)
    jres, jm = fdtd_pallas.simulate_moments_pallas(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.int32(lix), jnp.int32(liy), interpret=True)
    nx, ny = p.nx, p.ny

    def crop(a):
        return np.asarray(a)[..., :nx, :ny]

    ref = {"pressure": crop(jres.pressure), "onset": crop(jres.onset),
           "flux_x": crop(jres.flux_x), "flux_y": crop(jres.flux_y),
           **{k: crop(getattr(jm, k)) for k in jm._fields}}
    fields = fields_from_numpy(beta, refl, pulse, device="cpu")
    return p, fields, (lix, liy), ref


def _close(got, ref, rel, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(ref).max() + 1e-30
    assert np.abs(got - ref).max() <= rel * scale, name


def test_fdtd_sim_reference_matches_pallas(case):
    p, (b, r, pl), (lix, liy), ref = case
    res, (ed, ew, et) = fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy)
    assert res.pressure.shape == (T, p.nx, p.ny)
    for key in ("pressure", "flux_x", "flux_y"):
        _close(getattr(res, key), ref[key], 1e-6, key)
    np.testing.assert_array_equal(res.onset.numpy(), ref["onset"])
    for name, got in (("e_dry", ed), ("e_wet", ew), ("e_total", et)):
        _close(got, ref[name], 1e-6, name)


def test_rt60_moments_reference_matches_pallas(case):
    p, (b, r, pl), (lix, liy), ref = case
    res, _ = fdtd_fused.fdtd_sim_reference(p, b, r, pl, lix, liy)
    s0, s1 = fdtd_fused.rt60_moments_reference(p, res.pressure, res.onset)
    _close(s0, ref["s0"], 1e-5, "s0")
    _close(s1, ref["s1"], 1e-5, "s1")
    # and against the plain reduction form over the analysis grid
    m = tan.moments_from_pressure(p, res.pressure, res.onset)
    gx, gy = p.grid_x, p.grid_y
    _close(s0[:gx, :gy], m.s0.numpy(), 1e-5, "s0 vs reduction")
    _close(s1[:gx, :gy], m.s1.numpy(), 1e-5, "s1 vs reduction")


def test_cpu_wrappers_take_plain_path(case):
    p, (b, r, pl), (lix, liy), _ = case
    fdtd_fused.reset_launch_counts()
    res, mom = fdtd_fused.simulate_moments_fused(p, b, r, pl, lix, liy)
    ref, rmom = fdtd_fused.simulate_moments_fused_reference(p, b, r, pl,
                                                            lix, liy)
    assert fdtd_fused.fdtd_sim.launches == 0
    assert fdtd_fused.rt60_moments.launches == 0
    for a, g in zip((*ref, *rmom), (*res, *mom)):
        assert torch.equal(a, g)


def test_other_devices_raise(case):
    p, (b, r, pl), (lix, liy), _ = case
    with pytest.raises(ValueError, match="meta"):
        fdtd_fused.fdtd_sim(p, b.to("meta"), r.to("meta"), pl.to("meta"),
                            lix, liy)
    rec = torch.zeros((T, p.nx, p.ny), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fdtd_fused.rt60_moments(p, rec, b.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        fdtd_fused.fdtd_sim(p, b, r.to("meta"), pl, lix, liy)
    with pytest.raises(ValueError, match="float32"):
        fdtd_fused.fdtd_sim(p, b.double(), r, pl, lix, liy)
    assert fdtd_fused.fdtd_sim.launches == 0


@pytest.mark.parametrize("nx,ny", [(192, 192), (1, 192 * 192),
                                   (192 * 192, 1), (8, 192), (192, 8),
                                   (29, 29), (16, 306), (96, 384)])
@pytest.mark.parametrize("dtype", fdtd_fused.STATE_DTYPES)
@pytest.mark.parametrize("B", [1, 4])
def test_b1_mode_cluster_up_to_tiled_min_cells(nx, ny, dtype, B):
    """B1's one launch a pass holds every grid the engine routes to it:
    every shape of at most TILED_MIN_CELLS cells, thin ones included,
    float32 and bf16, any number of listeners, none of which the route
    sends to the tiled kernels on the CPU."""
    assert nx * ny <= fdtd_fused.TILED_MIN_CELLS <= fdtd_fused.CLUSTER_CELLS
    assert not fdtd_fused.route_tiled(nx * ny, B, dtype, False)
    assert fdtd_fused.b1_fits(nx, ny)


@pytest.mark.parametrize("nx,ny", [(193, 192), (1, 192 * 192 + 1),
                                   (459, 459), (964, 964)])
@pytest.mark.parametrize("B", [1, 4])
def test_b1_mode_per_step_above(case, nx, ny, B):
    """Above the cluster's capacity the card's launcher refuses the pass,
    in float32 and bf16, before it allocates or loads anything, and names
    the tiled kernels; the route sends every such grid there."""
    p, (_, _, pl), _, _ = case
    q = dataclasses.replace(p, grid_x=nx - 1, grid_y=ny - 1)
    field = torch.zeros((nx, ny))
    cells = [(0, 0)] * B
    assert not fdtd_fused.b1_fits(nx, ny)
    for dtype in fdtd_fused.STATE_DTYPES:
        assert fdtd_fused.route_tiled(nx * ny, B, dtype, True)
        with pytest.raises(ValueError, match="fdtd_sim_tiled"):
            fdtd_fused._launch_fdtd_sim("fdtd_sim_batch", q, field, field,
                                        pl, cells, dtype)


@pytest.mark.parametrize("threshold", [0, 96 * 96, 10 ** 9])
def test_b1_mode_ignores_the_route(monkeypatch, threshold):
    """What B1 holds follows the cluster's capacity (CLUSTER_CELLS), not
    the route's TILED_MIN_CELLS: moving the route's threshold moves
    nothing B1 holds."""
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", threshold)
    n = fdtd_fused.CLUSTER_CELLS
    assert fdtd_fused.b1_fits(1, n)
    assert not fdtd_fused.b1_fits(1, n + 1)
    assert fdtd_fused.b1_fits(192, 192)
    assert not fdtd_fused.b1_fits(459, 459)


def test_device_kernels_match_the_library_enum():
    """kernels.DEVICE_KERNELS names the C launchers' launch counters in
    the order of csrc/common.cuh's DeviceKernel enum."""
    import os
    import re

    from planeverb_tpu_torch import kernels

    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "common.cuh")) as f:
        body = re.search(r"enum DeviceKernel : int \{(.*?)\};", f.read(),
                         re.S).group(1)
    names = [n.strip().split("=")[0].strip() for n in body.split(",")]
    names = [n for n in names if n and n != "kDeviceKernels"]

    def camel(name):
        base, _, arg = name.partition("<")
        return "k" + "".join(w.title() for w in base.split("_")) + {
            "false>": "", "true>": ""}.get(arg, "")

    expect = [camel(n) for n in kernels.DEVICE_KERNELS]
    expect[-2:] = ["kShardedRoundKernel", "kBandedRoundKernel"]
    assert names == expect


def test_b1_mode_rejects_what_it_has_no_mode_for(case):
    """B1's wrappers refuse a state type it has no kernel for and a batch
    of no listeners."""
    p, (b, r, pl), (lix, liy), _ = case
    with pytest.raises(ValueError, match="state_dtype"):
        fdtd_fused.fdtd_sim(p, b, r, pl, lix, liy, torch.float16)
    with pytest.raises(ValueError, match="state_dtype"):
        fdtd_fused.fdtd_sim_batch(p, b, r, pl, [(lix, liy)], torch.float16)
    with pytest.raises(ValueError, match="B >= 1"):
        fdtd_fused.fdtd_sim_batch(p, b, r, pl, [])


def test_calibration_grids_take_the_cluster_mode():
    """Every calibration grid (at most CAL_SIZE_M square, up to 750 Hz)
    fits B1's cluster."""
    from planeverb_tpu_torch.core import free_grid

    for res in (275, 500, 750):
        p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(
            free_grid.CAL_SIZE_M, free_grid.CAL_SIZE_M, res))
        assert fdtd_fused.b1_fits(p.nx, p.ny)


