"""The sharded engine's plain path (planeverb_tpu_torch.parallel) on the CPU.

A mesh of ``"cpu"`` repeated runs the plain versions of the round kernels
(B5 ``sharded_round_reference``, B6 ``banded_round_reference``) with real
ghosts and a real exchange; ``chip_smoke.py`` holds the CUDA kernels to
these plain versions on the card. Here, on SmallRoom at 275 Hz (29 x 29
cells, 435 steps, as tests/test_parallel.py):

  - the mesh helpers and the ghost exchange equal the JAX package's
    (``_exchange_axes`` under ``shard_map`` on the 8-device CPU mesh,
    exactly);
  - the sharded fields equal the single-device plain versions bit for bit
    (``torch.equal``), moments included, on B5 and on B6;
  - they are held to the JAX sharded Pallas rounds in interpret mode at the
    C1 bound (recording, flux and energies max-abs <= 1e-6 of the peak,
    onset exactly equal; XLA contracts multiply-adds into FMAs, eager
    PyTorch does not) and the RT60 moments at scale-relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import oracle
import planeverb_tpu_torch as tpv
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.parallel import mesh as jmesh
from planeverb_tpu.parallel import solver as jsolver
from planeverb_tpu.parallel import solver_pallas as jsp
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.ops.fdtd import admittance
from planeverb_tpu_torch.parallel import (grid_mesh, mesh_from_count,
                                          pad_to_mesh, shard_fields,
                                          simulate_moments_sharded,
                                          simulate_sharded_fused)
from planeverb_tpu_torch.parallel import mesh as tmesh
from planeverb_tpu_torch.parallel import solver as tsolver
from planeverb_tpu_torch.parallel import solver_fused

CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
SIM = ("pressure", "onset", "flux_x", "flux_y")
MOMENTS = ("e_dry", "e_wet", "e_total", "s0", "s1")


@pytest.fixture(scope="module")
def room():
    """SmallRoom fields (numpy and CPU tensors), the listener cell and the
    single-device plain pass (B1 + B2 plain versions)."""
    p = tcfg.compute_grid_params(CFG)
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(5.0, 5.0)
    fields = fields_from_numpy(beta, refl, pulse, device="cpu")
    res, mom = fdtd_fused.simulate_moments_fused_reference(p, *fields, lix,
                                                           liy)
    ref = {**res._asdict(), **mom._asdict()}
    return p, (beta, refl, pulse), fields, (lix, liy), ref


def _cpu_mesh(shape):
    return grid_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _padded(p, fields, mesh, multiple=1):
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh, multiple)
    pad = (0, ny_pad - p.ny, 0, nx_pad - p.nx)
    beta, refl, pulse = fields
    return F.pad(beta, pad), F.pad(refl, pad), pulse, nx_pad, ny_pad


def _assembled(p, res, mom=None):
    """{name: [..., nx, ny] tensor} of a sharded pass, cropped."""
    out = {k: v[..., :p.nx, :p.ny] for k, v in
           res.assemble("cpu")._asdict().items()}
    if mom is not None:
        out.update({k: v[:p.nx, :p.ny]
                    for k, v in mom.assemble("cpu")._asdict().items()})
    return out


def _equal(got, ref, names):
    for name in names:
        assert torch.equal(got[name], ref[name]), name


def _close(got, ref, rel, name):
    scale = np.abs(ref).max() + 1e-30
    assert np.abs(got.numpy() - ref).max() <= rel * scale, name


def _hold_to_jax(got, jax_fields, p, names):
    for name in names:
        ref = np.asarray(jax_fields[name])[..., :p.nx, :p.ny]
        if name == "onset":
            np.testing.assert_array_equal(got[name].numpy(), ref)
        else:
            _close(got[name], ref, 1e-5 if name in ("s0", "s1") else 1e-6,
                   name)


# ------------------------------------------------------------- mesh helpers
@pytest.mark.parametrize("n", [1, 4, 7, 8, 16])
def test_factor_mesh_matches_jax(n):
    assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n)


@pytest.mark.parametrize("shape,multiple", [((2, 4), 1), ((8, 1), 1),
                                            ((2, 2), 8), ((1, 1), 1)])
def test_pad_to_mesh_matches_jax(shape, multiple):
    n = shape[0] * shape[1]
    jm = jmesh.grid_mesh(jax.devices()[:n], shape)
    tm = _cpu_mesh(shape)
    for nx, ny in ((29, 29), (192, 192), (964, 963)):
        assert (tmesh.pad_to_mesh(nx, ny, tm, multiple)
                == jmesh.pad_to_mesh(nx, ny, jm, multiple))


def test_mesh_construction():
    m = grid_mesh(["cpu"] * 8, (2, 4))
    assert m.shape == {"x": 2, "y": 4} and m.device_type == "cpu"
    assert grid_mesh(["cpu"] * 6).shape == {"x": 2, "y": 3}
    assert grid_mesh(["cuda"] * 4, (2, 2)).first_device == torch.device(
        "cuda", 0)
    with pytest.raises(ValueError, match="mesh shape"):
        grid_mesh(["cpu"] * 4, (3, 2))
    with pytest.raises(ValueError, match="all be cuda or all cpu"):
        grid_mesh(["cpu", "cuda:0"], (1, 2))
    with pytest.raises(ValueError, match="all be cuda or all cpu"):
        grid_mesh(["meta"] * 2, (2, 1))
    with pytest.raises(ValueError, match="available"):
        mesh_from_count(torch.cuda.device_count() + 1)


def test_shard_fields_assemble_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 12, 8)).astype(np.float32))
    m = _cpu_mesh((3, 2))
    (blocks,) = shard_fields(m, x)
    assert [[b.shape for b in row] for row in blocks] == [[(5, 4, 4)] * 2] * 3
    assert torch.equal(tsolver.assemble(blocks, "cpu"), x)
    with pytest.raises(ValueError, match="divisible"):
        shard_fields(_cpu_mesh((5, 1)), x)


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 1)],
                         ids=["2x4", "8x1", "1x1"])
@pytest.mark.parametrize("kx,ky", [(0, 0), (3, 0), (0, 3), (3, 3)],
                         ids=["k00", "k30", "k03", "k33"])
def test_exchange_axes_matches_jax(shape, kx, ky):
    """The ghost exchange on a mesh of repeated cpu equals JAX's
    ``_exchange_axes`` under ``shard_map`` on the 8-device CPU mesh."""
    mx, my = shape
    x = np.random.default_rng(1).standard_normal((24, 16)).astype(np.float32)
    jm = jmesh.grid_mesh(jax.devices()[:mx * my], shape)
    spec = jax.sharding.PartitionSpec("x", "y")
    ext = jax.shard_map(lambda b: jsolver._exchange_axes(b, kx, ky),
                        mesh=jm, in_specs=spec, out_specs=spec,
                        check_vma=False)(jnp.asarray(x))
    (blocks,) = shard_fields(_cpu_mesh(shape), torch.from_numpy(x))
    got = tsolver._exchange_axes(blocks, kx, ky)
    bxe, bye = 24 // mx + 2 * kx, 16 // my + 2 * ky
    ext = np.asarray(ext)
    for i in range(mx):
        for j in range(my):
            np.testing.assert_array_equal(
                got[i][j].numpy(),
                ext[i * bxe:(i + 1) * bxe, j * bye:(j + 1) * bye])
            if kx or ky:   # new tensors: the exchange never aliases a block
                assert got[i][j].data_ptr() != blocks[i][j].data_ptr()
    if kx == ky:   # the symmetric form, _exchange_halo
        halo = tsolver._exchange_halo(blocks, kx)
        assert all(torch.equal(a, b) for ra, rb in zip(halo, got)
                   for a, b in zip(ra, rb))


# ------------------------------------------------------- B5: fused rounds
@pytest.mark.parametrize("shape,halo,chunk", [
    ((2, 4), 8, None),   # 2D mesh
    ((8, 1), 4, 2),      # 1D x-sharding (JAX's recording sub-chunks)
    ((2, 4), 7, 7),      # T % halo != 0: a short last round
])
def test_sharded_fused_matches_jax_and_single_device(room, shape, halo,
                                                     chunk):
    p, (beta, refl, pulse), fields, (lix, liy), ref = room
    n = shape[0] * shape[1]
    jm = jmesh.grid_mesh(jax.devices()[:n], shape)
    nx_pad, ny_pad = jmesh.pad_to_mesh(p.nx, p.ny, jm)
    pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
    jres = jsp.simulate_sharded_pallas(
        p, np.pad(beta, pad), np.pad(refl, pad), pulse, jnp.int32(lix),
        jnp.int32(liy), jm, nx_pad, ny_pad, halo=halo, chunk=chunk,
        interpret=True)
    mesh = _cpu_mesh(shape)
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    assert (nxp, nyp) == (nx_pad, ny_pad)
    fdtd_fused.reset_launch_counts()
    res = simulate_sharded_fused(p, b, r, pl, lix, liy, mesh, nxp, nyp,
                                 halo=halo)
    assert solver_fused.sharded_round.launches == 0   # plain versions
    got = _assembled(p, res)
    _equal(got, ref, SIM)
    _hold_to_jax(got, jres._asdict(), p, SIM)
    assert res.blocks["pressure"][0][0].shape == (
        p.response_length, nxp // shape[0], nyp // shape[1])


# ------------------------------------------------------ B6: banded rounds
@pytest.mark.parametrize("shape,halo,band", [((2, 4), 8, 8), ((8, 1), 4, 8)])
def test_banded_matches_jax_and_fused_rounds(room, shape, halo, band):
    """Forced B6 (in-window fold, 8 x 8 tiles) equals plain B5 bit for bit,
    moments included, and holds the JAX banded rounds' bounds."""
    p, (beta, refl, pulse), fields, (lix, liy), ref = room
    n = shape[0] * shape[1]
    jm = jmesh.grid_mesh(jax.devices()[:n], shape)
    nx_pad, ny_pad = jmesh.pad_to_mesh(p.nx, p.ny, jm, multiple=8)
    pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
    jres, jmom = jsp.simulate_moments_sharded(
        p, np.pad(beta, pad), np.pad(refl, pad), pulse, jnp.int32(lix),
        jnp.int32(liy), jm, nx_pad, ny_pad, halo=halo, band_rows=band,
        interpret=True)
    mesh = _cpu_mesh(shape)
    b, r, pl, nxp, nyp = _padded(p, fields, mesh, multiple=8)
    banded = _assembled(p, *simulate_moments_sharded(
        p, b, r, pl, lix, liy, mesh, nxp, nyp, halo=halo, band_rows=band))
    fused = _assembled(p, *simulate_moments_sharded(
        p, b, r, pl, lix, liy, mesh, nxp, nyp, halo=halo))
    _equal(banded, fused, SIM + MOMENTS)
    _equal(banded, ref, SIM + MOMENTS)
    _hold_to_jax(banded, {**jres._asdict(), **jmom._asdict()}, p,
                 SIM + MOMENTS)


def test_1x1_beyond_b5_delegates_to_tiled(room, monkeypatch):
    """A 1x1 mesh whose shard is above TILED_MIN_CELLS needs no exchange:
    it takes the tiled route (B3 + B4) and never a round kernel; the
    results equal the B5 rounds', and the launch counters stay 0 on the
    CPU."""
    p, _, fields, (lix, liy), ref = room
    mesh = _cpu_mesh((1, 1))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    rounds = _assembled(p, *simulate_moments_sharded(p, b, r, pl, lix, liy,
                                                     mesh, nxp, nyp, halo=8))
    calls = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapped

    for mod, name in ((fdtd_tiled, "simulate_moments_tiled"),
                      (solver_fused, "sharded_round"),
                      (solver_fused, "banded_round")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    monkeypatch.setattr(fdtd_fused, "TILED_MIN_CELLS", 0)
    fdtd_fused.reset_launch_counts()
    res, mom = simulate_moments_sharded(p, b, r, pl, lix, liy, mesh, nxp,
                                        nyp, halo=8)
    assert calls == ["simulate_moments_tiled"]
    assert fdtd_tiled.fdtd_sim_tiled.launches == 0
    assert fdtd_tiled.rt60_moments_tiled.launches == 0
    delegated = _assembled(p, res, mom)
    _equal(delegated, rounds, SIM + MOMENTS)
    _equal(delegated, ref, SIM + MOMENTS)
    # band_rows forces the banded rounds even on 1x1
    calls.clear()
    simulate_sharded_fused(p, b, r, pl, lix, liy, mesh, nxp, nyp, halo=8,
                           band_rows=16)
    assert set(calls) == {"banded_round"}


def test_shards_keep_their_own_rule(room, monkeypatch):
    """The single-listener rule (``fdtd_fused.route_tiled``) does not reach
    a mesh's shards: with it sending every pass to B3 + B4, a 1x1 mesh at
    or under TILED_MIN_CELLS still runs B5 rounds, equal to B1 + B2."""
    p, _, fields, (lix, liy), ref = room
    mesh = _cpu_mesh((1, 1))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    calls = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapped

    for mod, name in ((fdtd_tiled, "simulate_moments_tiled"),
                      (solver_fused, "sharded_round"),
                      (solver_fused, "banded_round")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    monkeypatch.setattr(fdtd_fused, "route_tiled", lambda *a: True)
    monkeypatch.setattr(fdtd_fused, "TILED_SINGLE_MIN_CELLS", 0)
    res, mom = simulate_moments_sharded(p, b, r, pl, lix, liy, mesh, nxp,
                                        nyp, halo=8)
    assert set(calls) == {"sharded_round"}
    _equal(_assembled(p, res, mom), ref, SIM + MOMENTS)


@pytest.mark.parametrize("band", [None, 5], ids=["B5", "B6"])
def test_listener_at_shard_corner(room, band):
    """The listener 2 cells from the corner of four shards: its ghost copies
    in three neighbours are injected, corner ghosts carry the diagonal
    neighbour's cells, and every shard's round reads the previous round's
    outputs of its neighbours. Any of those wrong breaks torch.equal."""
    p, _, fields, _, _ = room
    mesh = _cpu_mesh((2, 2))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    lix, liy = nxp // 2 - 2, nyp // 2 + 1      # shard corner at (15, 15)
    res, mom = fdtd_fused.simulate_moments_fused_reference(p, *fields, lix,
                                                           liy)
    ref = {**res._asdict(), **mom._asdict()}
    got = _assembled(p, *simulate_moments_sharded(
        p, b, r, pl, lix, liy, mesh, nxp, nyp, halo=8, band_rows=band))
    _equal(got, ref, SIM + MOMENTS)


def test_listener_outside_field(room):
    """A listener outside the field injects nothing, not even into the
    zero ghosts beyond the global edge."""
    p, _, fields, _, _ = room
    mesh = _cpu_mesh((2, 2))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    for lix, liy in ((-1, 3), (p.nx, 4)):
        ref, _ = fdtd_fused.fdtd_sim_reference(p, *fields, lix, liy)
        got = _assembled(p, simulate_sharded_fused(
            p, b, r, pl, lix, liy, mesh, nxp, nyp, halo=8))
        _equal(got, ref._asdict(), SIM)


# ------------------------------------------------------ wrappers and errors
def _launch(p, fields, lix, liy, k, banded):
    """One device's round launch over the four shards of a 2x2 cpu mesh,
    on random round-start state, as the plain rounds build it."""
    mesh = _cpu_mesh((2, 2))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    bx, by = nxp // 2, nyp // 2
    (bb,), (yb,) = shard_fields(mesh, b), shard_fields(mesh, admittance(r))
    kx, ky = k, k
    shards = solver_fused._shards(mesh, bb, yb, bx, by, kx, ky,
                                  p.response_length)
    solver_fused._link(shards, kx, ky, False)
    rng = np.random.default_rng(2)
    for row in shards:
        for s in row:
            s.state[0] = torch.from_numpy(
                rng.standard_normal((3, bx, by)).astype(np.float32))
            s.rec.zero_()
    regions = [(s, 0, bx) for row in shards for s in row]
    return shards, solver_fused.RoundLaunch(p, regions, kx, ky, banded, k, pl,
                                            lix, liy, (8, 8))


def test_round_wrappers_take_plain_path_on_cpu(room):
    """On CPU tensors both wrappers run one device's round as its plain
    version (no launch), writing the round's rows of every shard's
    recording and its new state; a launch of the other mode, a bad t0,
    halo or parity, and another device raise."""
    p, _, fields, (lix, liy), _ = room
    k = 4
    fdtd_fused.reset_launch_counts()
    shards, launch = _launch(p, fields, lix, liy, k, banded=False)
    solver_fused.sharded_round(p, 8, k, launch, 0)
    assert solver_fused.sharded_round.launches == 0
    for row in shards:
        for s in row:
            assert s.rec[:8].abs().sum() == 0 and s.rec[8:12].abs().sum() > 0
            assert s.state[1].abs().sum() > 0
    shards, banded = _launch(p, fields, lix, liy, k, banded=True)
    solver_fused.banded_round(p, p.response_length - 3, k, banded, 0)
    assert solver_fused.banded_round.launches == 0
    assert shards[1][1].rec[-3:].abs().sum() > 0
    with pytest.raises(ValueError, match="B6"):
        solver_fused.sharded_round(p, 0, k, banded, 0)
    with pytest.raises(ValueError, match="B5"):
        solver_fused.banded_round(p, 0, k, launch, 0)
    with pytest.raises(ValueError, match="t0"):
        solver_fused.sharded_round(p, p.response_length, k, launch, 0)
    with pytest.raises(ValueError, match="parity"):
        solver_fused.sharded_round(p, 0, k, launch, 2)
    with pytest.raises(ValueError, match="halo"):
        solver_fused.sharded_round(p, 0, k + 1, launch, 0)
    meta = solver_fused.RoundLaunch(p, launch.regions, k, k, False, k,
                                    fields[2].to("meta"), lix, liy, (8, 8))
    with pytest.raises(ValueError, match="meta"):
        solver_fused.sharded_round(p, 0, k, meta, 0)


def test_pick_region_tile():
    """On a 132-SM card a round launch takes a tile of its own (20 x 52 or
    20 x 20 at a 6-cell border, ``solver_fused.pick_region_tile``; B3 plans
    apart) with the fewest waves of windows over all of its regions: 20 x
    52 for the headline's four 128^2 extended blocks (84 tiles; 20 x 20
    would take two waves of 196), the 126 m world's four 514^2 and the
    split's eight 48-row frames of 126 m; 20 x 20 where one wave of either
    suffices (a 224 x 192 block, a 32^2 one). Sub-rounds stay 6 steps."""
    assert solver_fused.SUB_ROUND == 6
    assert solver_fused.REGION_TILES == ((20, 52), (20, 20))

    def pick(blocks):
        return solver_fused.pick_region_tile(blocks, 132)

    assert pick([(128, 128)] * 4) == (20, 52)
    assert pick([(514, 514)] * 4) == (20, 52)
    assert pick([(48, 996)] * 8) == (20, 52)
    assert pick([(224, 192)]) == (20, 20)
    assert pick([(32, 32)]) == (20, 20)


def test_sharded_errors(room):
    p, _, fields, (lix, liy), _ = room
    mesh = _cpu_mesh((2, 2))
    b, r, pl, nxp, nyp = _padded(p, fields, mesh)
    with pytest.raises(ValueError, match="halo 16 exceeds"):
        simulate_sharded_fused(p, b, r, pl, lix, liy, mesh, nxp, nyp,
                               halo=16)
    # the overlap split needs a 1D ("x", N) mesh (the JAX module's error)
    with pytest.raises(ValueError, match=r"1D \('x', N\) mesh"):
        simulate_sharded_fused(p, b, r, pl, lix, liy, mesh, nxp, nyp,
                               halo=8, overlap=True)
    with pytest.raises(ValueError, match="cover"):
        simulate_sharded_fused(p, b[:28, :28], r[:28, :28], pl, lix, liy,
                               mesh, 28, 28, halo=8)
    (bb,) = shard_fields(mesh, b)
    bb[1][1] = bb[1][1].to("meta")
    with pytest.raises(ValueError, match="meta"):
        simulate_sharded_fused(p, bb, r, pl, lix, liy, mesh, nxp, nyp,
                               halo=8)


def test_context_mesh_errors():
    cfg = tpv.PlaneverbConfig(10.0, 10.0, 275)
    mesh = _cpu_mesh((2, 2))
    with pytest.raises(ValueError, match="halo 16 exceeds"):
        tpv.Context(cfg, mesh=mesh, halo=16)
    with pytest.raises(ValueError, match="bf16"):
        tpv.Context(cfg, mesh=mesh, precision="bf16")
    with pytest.raises(ValueError, match="nothing moves"):
        tpv.Context(cfg, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="needs a mesh"):
        tpv.Context(cfg, halo=8, device="cpu")
    with pytest.raises(TypeError, match="grid_mesh"):
        tpv.Context(cfg, mesh=object(), device="cpu")
    ctx = tpv.Context(cfg, mesh=mesh)
    assert ctx.device == torch.device("cpu") and ctx._halo == 8
    # several listeners on a mesh: one sharded pass per view
    ctx.set_listener_positions([(5, 0, 5), (4, 0, 6)])
    assert ctx.get_listener_positions() == [(5.0, 0.0, 5.0),
                                            (4.0, 0.0, 6.0)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpv.Context(cfg, mesh=grid_mesh(["cuda:0"] * 4, (2, 2)))
