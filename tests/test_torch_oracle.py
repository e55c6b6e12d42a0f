"""The port held to ``tests/oracle.py`` where the JAX tests are held to it.

``oracle.py`` is the NumPy transliteration of the C++ original. The JAX
package's tests compare ``fdtd.simulate`` with ``oracle.generate_response``
(tests/test_fdtd.py), the analyzer with ``oracle.analyze`` and EFree with
``oracle.free_field_energy`` (tests/test_analyzer.py); these are the same
comparisons for the port's CPU path, on the same scenes at 275 Hz.

Bounds (the C1 bounds and their reasons): the raw pressure field within
1e-6 of its peak (the oracle and eager PyTorch round the same f32 ops in
the same order up to multiply-add contraction in numpy's reductions);
onset exactly equal; the in-loop flux against the oracle's masked sums
within 1e-5 of its scale, the JAX test's bound (the oracle sums the masked
products in one reduction, the port step by step); EFree relative 1e-5;
the six parameters at the golden tolerances of tests/test_analyzer.py
(log/pow implementations differ by ulps).
"""

import numpy as np
import pytest
import torch

import oracle
from planeverb_tpu.config import CONSTANTS, PlaneverbConfig
from planeverb_tpu.scene import AABB, Scene, demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy, scene_from_jax
from planeverb_tpu_torch.core.free_grid import calibrate_free_field
from planeverb_tpu_torch.ops import analyzer as tan
from planeverb_tpu_torch.ops import fdtd as tfdtd
from planeverb_tpu_torch.ops import voxelize as tvox

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)
TCFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
LISTENER = (5.0, 5.0)
# the scenes of tests/test_analyzer.py's pair fixture, and a local
# single-wall diffraction scene that fits the 10 m grid, as there
WALL = Scene(boxes=[AABB(6.5, 5.0, 0.75, 6.0, 0.98)],
             name="MiddleWallScene_local")
ANALYZER_SCENES = {"SmallRoom": demo_scene("SmallRoom"),
                   "MiddleWallScene_local": WALL, "empty": None}


def _port_pass(scene, pulse):
    """The port's voxelization and plain simulation pass on the CPU."""
    p = tcfg.compute_grid_params(TCFG)
    beta, refl = tvox.voxelize_np(
        p, scene_from_jax(scene).boxes if scene is not None else [])
    b, r, pl = fields_from_numpy(beta, refl, pulse, device="cpu")
    lx, ly = p.world_to_cell(*LISTENER)
    return p, (beta, refl), tfdtd.simulate(p, b, r, pl, lx, ly)


@pytest.fixture(scope="module", params=[None, "SmallRoom", "ExampleProject"])
def sim_pair(request):
    """(port params, oracle recordings, port FdtdResult) on the scenes of
    tests/test_fdtd.py."""
    scene = demo_scene(request.param) if request.param else None
    og = oracle.build_scene(CFG, scene)
    rec = oracle.generate_response(og, *LISTENER)
    p, (beta, refl), res = _port_pass(scene, og.pulse)
    # the same voxelized fields are a precondition
    np.testing.assert_array_equal(beta.ravel(), og.b.astype(np.float32))
    np.testing.assert_array_equal(refl.ravel(), og.absorption)
    return request.param, p, rec, res


def _oracle_onset(o_pr):
    above = np.abs(o_pr) > np.float32(CONSTANTS.audible_threshold_gain)
    return np.where(above.any(axis=0), np.argmax(above, axis=0), np.inf)


def test_pressure_matches_oracle(sim_pair):
    _, p, (o_pr, _, _), res = sim_pair
    got = res.pressure.numpy().reshape(p.response_length, -1)
    peak = np.abs(o_pr).max()
    assert np.abs(got - o_pr).max() <= 1e-6 * max(peak, 1.0)


def test_onset_matches_oracle(sim_pair):
    _, _, (o_pr, _, _), res = sim_pair
    np.testing.assert_array_equal(res.onset.numpy().ravel(),
                                  _oracle_onset(o_pr).astype(np.float32))


def test_flux_matches_oracle(sim_pair):
    _, p, (o_pr, o_vx, o_vy), res = sim_pair
    onset = _oracle_onset(o_pr)
    t = np.arange(p.response_length)[:, None]
    m = t < onset[None, :] + p.source_dir_samples
    o_fx = np.sum(m * o_pr * o_vx, axis=0, dtype=np.float32)
    o_fy = np.sum(m * o_pr * o_vy, axis=0, dtype=np.float32)
    scale = max(np.abs(o_fx).max(), np.abs(o_fy).max(), 1e-12)
    assert np.abs(res.flux_x.numpy().ravel() - o_fx).max() <= 1e-5 * scale
    assert np.abs(res.flux_y.numpy().ravel() - o_fy).max() <= 1e-5 * scale


def test_efree_matches_oracle():
    p = tcfg.compute_grid_params(TCFG)
    efree = calibrate_free_field(p, device="cpu")
    o_efree = oracle.free_field_energy(CFG)
    assert abs(efree - o_efree) <= 1e-5 * abs(o_efree)


@pytest.fixture(scope="module", params=sorted(ANALYZER_SCENES))
def pair(request):
    """(name, port params, port AnalyzerResults, oracle parameters) on the
    scenes of tests/test_analyzer.py, with the port's EFree on both."""
    scene = ANALYZER_SCENES[request.param]
    p, _, res = _port_pass(scene, tcfg.gaussian_pulse(
        tcfg.compute_grid_params(TCFG)))
    efree = calibrate_free_field(p, device="cpu")
    lw = float(np.float32(LISTENER[0])), float(np.float32(LISTENER[1]))
    out = tan.analyze(p, res.pressure, res.onset, res.flux_x, res.flux_y,
                      efree, *lw)
    grid = oracle.build_scene(CFG, scene)
    ref = oracle.analyze(grid, *oracle.generate_response(grid, *LISTENER),
                         *LISTENER, efree)
    return request.param, p, out, ref


def _grids(p, out, ref, key):
    got = getattr(out, key)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    shape = ((p.grid_x, p.grid_y, 2)
             if key in ("direction", "source_directivity")
             else (p.grid_x, p.grid_y))
    return got, ref[key].reshape(shape)


def test_delay_matches_oracle(pair):
    _, p, out, ref = pair
    np.testing.assert_array_equal(*_grids(p, out, ref, "delay_samples"))


@pytest.mark.parametrize("key,rtol,atol", [
    ("occlusion", 2e-4, 1e-5), ("wet_gain", 2e-4, 1e-5),
    ("lowpass", 2e-4, 1e-2), ("source_directivity", 1e-3, 1e-4)])
def test_parameters_match_oracle(pair, key, rtol, atol):
    _, p, out, ref = pair
    got, o = _grids(p, out, ref, key)
    np.testing.assert_allclose(got, o, rtol=rtol, atol=atol, err_msg=key)


def test_rt60_matches_oracle(pair):
    """RT60 = -60/slope is sensitive where the decay is flat: compared
    where the oracle's value is well defined, as the JAX test does."""
    name, p, out, ref = pair
    got, o = _grids(p, out, ref, "rt60")
    valid = (o > 0.01) & (o < 100.0)
    np.testing.assert_allclose(got[valid], o[valid], rtol=5e-3)
    assert valid.sum() > 0 or name == "empty"


def test_direction_matches_oracle(pair):
    """The walk is discrete: at most 1 % of the cells may settle on a
    different-but-adjacent terminal cell (f32 tie sensitivity), as the JAX
    test allows."""
    _, p, out, ref = pair
    got, o = _grids(p, out, ref, "direction")
    assert float((np.abs(got - o).max(axis=-1) > 1e-4).mean()) <= 0.01
