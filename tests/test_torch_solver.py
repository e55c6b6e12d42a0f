"""The per-step sharded solvers of the port (parallel/solver.py) on the CPU.

``simulate_sharded`` (one-cell halos every step) and
``simulate_sharded_wide`` (k-cell halos every k steps) on meshes of
``"cpu"`` repeated, at the shapes and halos of tests/test_parallel.py
(SmallRoom, 10 m at 275 Hz: 29 x 29 cells, 435 steps):

  - against the JAX package's solvers under ``shard_map`` on the 8-device
    CPU mesh at the C1 bound: recording and flux max-abs <= 1e-6 of the
    recording's peak, onset exactly equal (XLA contracts multiply-adds into
    FMAs, eager PyTorch does not). Largest differences measured over
    these cases: 7.5e-7 of the peak on the recording, 3.1e-7 on the flux;
  - against the port's single-device plain pass (``ops/fdtd.simulate``):
    bit for bit (``torch.equal``), every field;
  - padding stays silent, the end-to-end analysis equals the single-device
    one, and an oversized halo raises JAX's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import oracle
from planeverb_tpu.ops import analyzer as janalyzer
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.parallel import mesh as jmesh
from planeverb_tpu.parallel import solver as jsolver
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.ops import analyzer as tanalyzer
from planeverb_tpu_torch.ops import fdtd as tfdtd
from planeverb_tpu_torch.parallel import (grid_mesh, pad_to_mesh,
                                          simulate_sharded,
                                          simulate_sharded_wide)

CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
LISTENER = (5.0, 5.0)
SIM = ("pressure", "onset", "flux_x", "flux_y")
C1 = 1e-6
EFREE = 0.0288


def _setup(scene):
    p = tcfg.compute_grid_params(CFG)
    beta, refl = jvox.voxelize_np(p, scene.boxes if scene else [])
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(*LISTENER)
    return p, beta, refl, pulse, lix, liy


@pytest.fixture(scope="module")
def room():
    p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
    single = tfdtd.simulate(p, torch.from_numpy(beta), torch.from_numpy(refl),
                            torch.from_numpy(pulse), lix, liy)
    return p, beta, refl, pulse, lix, liy, single


def _padded(p, beta, refl, shape):
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, grid_mesh(
        ["cpu"] * (shape[0] * shape[1]), shape))
    pad = (0, ny_pad - p.ny, 0, nx_pad - p.nx)
    return (F.pad(torch.from_numpy(beta), pad),
            F.pad(torch.from_numpy(refl), pad), nx_pad, ny_pad)


def _jax(fn, p, beta, refl, pulse, lix, liy, shape, nx_pad, ny_pad, **kw):
    n = shape[0] * shape[1]
    mesh = jmesh.grid_mesh(jax.devices()[:n], shape)
    b = np.zeros((nx_pad, ny_pad), np.float32)
    r = np.zeros((nx_pad, ny_pad), np.float32)
    b[:p.nx, :p.ny], r[:p.nx, :p.ny] = beta, refl
    return fn(p, b, r, pulse, jnp.int32(lix), jnp.int32(liy), mesh, nx_pad,
              ny_pad, **kw)


def _check(got, jres, single, p):
    """``got`` (assembled) against JAX's sharded result at C1 and the
    port's single-device pass bit for bit, on [:nx, :ny]."""
    peak = float(single.pressure.abs().max())
    for name in SIM:
        g = getattr(got, name)[..., :p.nx, :p.ny]
        assert torch.equal(g, getattr(single, name)), name
        j = np.asarray(getattr(jres, name))[..., :p.nx, :p.ny]
        if name == "onset":
            np.testing.assert_array_equal(g.numpy(), j)
        else:
            assert np.abs(g.numpy() - j).max() <= C1 * peak, name


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (8, 1)])
def test_sharded_matches_jax_and_single_device(room, shape):
    p, beta, refl, pulse, lix, liy, single = room
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, shape)
    mesh = grid_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    got = simulate_sharded(p, b, r, torch.from_numpy(pulse), lix, liy, mesh,
                           nx_pad, ny_pad).assemble("cpu")
    jres = _jax(jsolver.simulate_sharded, p, beta, refl, pulse, lix, liy,
                shape, nx_pad, ny_pad)
    _check(got, jres, single, p)


def test_padding_stays_silent():
    """Padded cells (beta = 0) never develop pressure."""
    p, beta, refl, pulse, lix, liy = _setup(None)
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, (2, 4))
    assert (nx_pad, ny_pad) != (p.nx, p.ny)   # padding actually exercised
    mesh = grid_mesh(["cpu"] * 8, (2, 4))
    pr = torch.from_numpy(pulse)
    for res in (simulate_sharded(p, b, r, pr, lix, liy, mesh, nx_pad,
                                 ny_pad),
                simulate_sharded_wide(p, b, r, pr, lix, liy, mesh, nx_pad,
                                      ny_pad, halo=3)):
        rec = res.field("pressure", "cpu")
        assert rec[:, p.nx:, :].abs().max() == 0.0
        assert rec[:, :, p.ny:].abs().max() == 0.0


def test_end_to_end_sharded_analysis(room):
    """simulate_sharded -> analyzer.analyze equals the single-device
    analysis bit for bit and the JAX package's sharded analysis at its
    test's tolerances."""
    p, beta, refl, pulse, lix, liy, single = room
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, (2, 4))
    res = simulate_sharded(p, b, r, torch.from_numpy(pulse), lix, liy,
                           grid_mesh(["cpu"] * 8, (2, 4)), nx_pad,
                           ny_pad).assemble("cpu")
    out = tanalyzer.analyze(p, res.pressure[:, :p.nx, :p.ny],
                            res.onset[:p.nx, :p.ny], res.flux_x[:p.nx, :p.ny],
                            res.flux_y[:p.nx, :p.ny], EFREE, *LISTENER)
    want = tanalyzer.analyze(p, *single, EFREE, *LISTENER)
    for name in want._fields:
        assert torch.equal(getattr(out, name), getattr(want, name)), name
    jres = _jax(jsolver.simulate_sharded, p, beta, refl, pulse, lix, liy,
                (2, 4), nx_pad, ny_pad)
    jout = janalyzer.analyze(
        p, jres.pressure[:, :p.nx, :p.ny], jres.onset[:p.nx, :p.ny],
        jres.flux_x[:p.nx, :p.ny], jres.flux_y[:p.nx, :p.ny],
        np.float32(EFREE), np.float32(LISTENER[0]), np.float32(LISTENER[1]))
    np.testing.assert_allclose(out.occlusion.numpy(),
                               np.asarray(jout.occlusion), rtol=1e-4)
    np.testing.assert_allclose(out.rt60.numpy(), np.asarray(jout.rt60),
                               rtol=1e-3)
    np.testing.assert_allclose(out.direction.numpy(),
                               np.asarray(jout.direction), atol=1e-4)


@pytest.mark.parametrize("shape,halo", [((2, 4), 4), ((2, 4), 7),
                                        ((1, 8), 3)])
def test_wide_halo_matches_jax_and_single_device(room, shape, halo):
    """k-wide ghosts exchanged every k steps (T % halo != 0 included: the
    padded tail round)."""
    p, beta, refl, pulse, lix, liy, single = room
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, shape)
    mesh = grid_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    got = simulate_sharded_wide(p, b, r, torch.from_numpy(pulse), lix, liy,
                                mesh, nx_pad, ny_pad,
                                halo=halo).assemble("cpu")
    jres = _jax(jsolver.simulate_sharded_wide, p, beta, refl, pulse, lix,
                liy, shape, nx_pad, ny_pad, halo=halo)
    _check(got, jres, single, p)


def test_wide_halo_rejects_oversized_halo():
    p, beta, refl, pulse, lix, liy = _setup(None)
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, (2, 4))
    with pytest.raises(ValueError, match="halo 50 exceeds shard block"):
        simulate_sharded_wide(p, b, r, torch.from_numpy(pulse), lix, liy,
                              grid_mesh(["cpu"] * 8, (2, 4)), nx_pad, ny_pad,
                              halo=50)


def test_block_grid_inputs_and_errors(room):
    """``shard_fields`` block grids give the same pass as whole tensors;
    a field that does not cover the grid raises."""
    from planeverb_tpu_torch.parallel import shard_fields

    p, beta, refl, pulse, lix, liy, single = room
    b, r, nx_pad, ny_pad = _padded(p, beta, refl, (2, 2))
    mesh = grid_mesh(["cpu"] * 4, (2, 2))
    pr = torch.from_numpy(pulse)
    (bb,), (rb,) = shard_fields(mesh, b), shard_fields(mesh, r)
    got = simulate_sharded_wide(p, bb, rb, pr, lix, liy, mesh, nx_pad, ny_pad,
                                halo=5).assemble("cpu")
    assert torch.equal(got.pressure[:, :p.nx, :p.ny], single.pressure)
    with pytest.raises(ValueError, match="must cover"):
        simulate_sharded(p, b[:28, :28], r[:28, :28], pr, lix, liy, mesh, 28,
                         28)
