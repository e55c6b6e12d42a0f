"""The port's FDTD time loop and voxelizer against the JAX package.

Tolerance: the JAX solver runs through XLA on the CPU, which contracts the
velocity update's multiply-adds into FMAs; PyTorch's eager ops round every
op once. The two therefore differ in the last ulp from the first few steps
on, and pressure and flux are held to max-abs <= 1e-6 * max|ref|. Onsets are
threshold crossings of integer steps and must be exactly equal.
"""

import numpy as np
import pytest
import torch

from planeverb_tpu.ops import fdtd as jfdtd
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy, scene_from_jax
from planeverb_tpu_torch.ops import fdtd as tfdtd
from planeverb_tpu_torch.ops import voxelize as tvox

REL = 1e-6

SCENE_GRIDS = {
    "SmallRoom": 10.0, "BigRoom": 11.0, "DirectionTester": 10.0,
    "ExampleProject": 10.0, "SmallRoomScene": 13.0,
    "UnityReplicationTest": 20.0, "HugeRoom": 25.0, "Shoebox": 25.0,
    "SingleWall": 25.0, "MiddleWallScene": 25.0, "FloorPlanScene": 25.0,
}


def _setup(name, res):
    size = SCENE_GRIDS[name]
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(size, size, res))
    beta, refl = jvox.voxelize_np(p, demo_scene(name).boxes)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(size / 2, size / 2)
    return p, beta, refl, pulse, lix, liy


def test_coefficients_match_jax():
    p, beta, refl, _, _, _ = _setup("DirectionTester", 275)
    for absorbing in (True, False):
        ref = jfdtd.coefficients_from_fields(
            beta, jfdtd.admittance(refl), p.grid_x, p.grid_y, absorbing)
        b, r, _ = fields_from_numpy(beta, refl, np.zeros(1), device="cpu")
        got = tfdtd.coefficients_from_fields(
            b, tfdtd.admittance(r), p.grid_x, p.grid_y, absorbing)
        for a, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(a))


@pytest.mark.parametrize("name,res", [("SmallRoom", 275), ("HugeRoom", 275),
                                      ("SmallRoom", 750)])
def test_simulate_matches_jax(name, res):
    p, beta, refl, pulse, lix, liy = _setup(name, res)
    ref = jfdtd.simulate(p, beta, refl, pulse, lix, liy)
    b, r, pl = fields_from_numpy(beta, refl, pulse, device="cpu")
    got = tfdtd.simulate(p, b, r, pl, lix, liy)
    assert got.pressure.shape == (p.response_length, p.nx, p.ny)
    for key in ("pressure", "flux_x", "flux_y"):
        a = np.asarray(getattr(ref, key))
        g = getattr(got, key).numpy()
        assert np.abs(g - a).max() <= REL * np.abs(a).max(), key
    np.testing.assert_array_equal(got.onset.numpy(), np.asarray(ref.onset))


@pytest.mark.parametrize("name", sorted(SCENE_GRIDS))
def test_voxelize_matches_jax(name):
    size = SCENE_GRIDS[name]
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(size, size, 275))
    jboxes = demo_scene(name).boxes
    jb, jr = jvox.voxelize(p, jvox.boxes_to_array(jboxes, 32))
    tb, tr = tvox.voxelize(p, torch.from_numpy(
        tvox.boxes_to_array(scene_from_jax(demo_scene(name)).boxes)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    nb, nr = tvox.voxelize_np(p, jboxes)
    np.testing.assert_array_equal(tb.numpy(), nb)
    np.testing.assert_array_equal(tr.numpy(), nr)
