"""Parameter assembly and DOA of the port against the JAX package.

Both sides get the same inputs: moments, onsets and fluxes from the port's
CPU pass, handed over as numpy arrays.

Tolerances: assembled parameters elementwise at rtol 1e-5 (the two
frameworks' pow/sqrt/log and XLA's FMA contraction differ by ulps; atol
1e-6 only for values that cancel to near zero, such as directivity
components). DOA: the pointer-jumping walk must end on the same cell as
the greedy host walk for every cell (labels identical), and its unit
vectors must match the JAX label propagation within 1e-6.
"""

import numpy as np
import pytest

import planeverb_tpu.config as jcfg
from planeverb_tpu.ops import analyzer as jan
from planeverb_tpu.ops import doa as jdoa
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy, scene_from_jax
from planeverb_tpu_torch.ops import analyzer as tan
from planeverb_tpu_torch.ops import doa as tdoa
from planeverb_tpu_torch.ops import fdtd_fused, voxelize

SCENE_GRIDS = {
    "SmallRoom": 10.0, "BigRoom": 11.0, "DirectionTester": 10.0,
    "ExampleProject": 10.0, "SmallRoomScene": 13.0,
    "UnityReplicationTest": 20.0, "HugeRoom": 25.0, "Shoebox": 25.0,
    "SingleWall": 25.0, "MiddleWallScene": 25.0, "FloorPlanScene": 25.0,
}
EFREE = 0.0288


def _port_pass(name, res=275):
    size = SCENE_GRIDS[name]
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(size, size, res))
    jp = jcfg.compute_grid_params(jcfg.PlaneverbConfig(size, size, res))
    beta, refl = voxelize.voxelize_np(p, scene_from_jax(demo_scene(name)))
    b, r, pl = fields_from_numpy(beta, refl, tcfg.gaussian_pulse(p),
                                 device="cpu")
    lix, liy = p.world_to_cell(size / 2, size / 2)
    res_, mom = fdtd_fused.simulate_moments_fused(p, b, r, pl, lix, liy)
    return p, jp, size / 2, res_, mom


@pytest.mark.parametrize("name,res", [("SmallRoom", 275), ("SmallRoom", 375),
                                      ("HugeRoom", 275)])
def test_analyze_moments_matches_jax(name, res):
    p, jp, c, fres, mom = _port_pass(name, res)
    out = tan.analyze_moments(p, mom, fres.onset, fres.flux_x, fres.flux_y,
                              EFREE, c, c)
    jm = jan.Moments(*(np.asarray(m) for m in mom))
    ref = jan.analyze_moments(jp, jm, fres.onset.numpy(),
                              fres.flux_x.numpy(), fres.flux_y.numpy(),
                              np.float32(EFREE), np.float32(c),
                              np.float32(c))
    for key in ("occlusion", "wet_gain", "rt60", "lowpass",
                "source_directivity"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out.delay_samples.numpy(),
                                  np.asarray(ref.delay_samples))
    np.testing.assert_allclose(out.direction.numpy(),
                               np.asarray(ref.direction), atol=1e-6)
    assert (out.rt60 > 0).any() and (out.occlusion > 0).any()


def test_analyze_matches_moments_path():
    """analyze() (plain reductions over the recording) agrees with the
    kernels' moments path."""
    p, _, c, fres, mom = _port_pass("SmallRoom")
    a = tan.analyze(p, fres.pressure, fres.onset, fres.flux_x, fres.flux_y,
                    EFREE, c, c)
    b = tan.analyze_moments(p, mom, fres.onset, fres.flux_x, fres.flux_y,
                            EFREE, c, c)
    for key in ("occlusion", "wet_gain", "lowpass", "rt60"):
        np.testing.assert_allclose(getattr(a, key).numpy(),
                                   getattr(b, key).numpy(), rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(SCENE_GRIDS))
def test_encode_directions_matches_jax(name):
    p, jp, c, fres, mom = _port_pass(name)
    out = tan.analyze_moments(p, mom, fres.onset, fres.flux_x, fres.flux_y,
                              EFREE, c, c, compute_directions=False)
    occ, dly = out.occlusion, out.delay_samples
    lw = float(np.float32(c))
    got = tdoa.encode_directions(p, occ, dly, lw, lw).numpy()
    ref = np.asarray(jdoa.encode_directions(jp, occ.numpy(), dly.numpy(),
                                            np.float32(c), np.float32(c)))
    assert np.abs(got - ref).max() <= 1e-6

    # labels: the pointer-jumping walk ends where the greedy walk ends
    ends = tdoa.walk_ends(p, occ, dly, lw, lw).numpy()
    occ_np, dly_np = occ.numpy(), dly.numpy()
    step = 1 if p.grid_x * p.grid_y < 2000 else 3
    cells = [(i, j) for i in range(p.grid_x) for j in range(p.grid_y)
             if (i * p.grid_y + j) % step == 0]
    for i, j in cells:
        ei, ej = tdoa.walk_end(p, occ_np, dly_np, i, j, np.float32(lw),
                               np.float32(lw))
        assert ends[i * p.grid_y + j] == ei * p.grid_y + ej, (i, j)
