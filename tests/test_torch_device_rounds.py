"""One device's round over all of its shards (planeverb_tpu_torch.parallel:
``sharded_round`` / ``banded_round`` on a ``RoundLaunch``) on the CPU.

On the card a round is one launch per device over every region that
device holds, reading each region's ghosts on the device through a table of
the 3 x 3 states around its shard: in place from a neighbour on the same
device, from a ghost buffer where the neighbour sits on another device
(``_simulate_impl(..., slabs=True)`` forces the buffers on one device).
On CPU tensors the wrappers run the plain version of that round,
``device_round_reference``, which reads the same sources. Here, on
SmallRoom at 275 Hz (29 x 29 cells, 435 steps), on meshes of ``"cpu"``:

  - one device's plain round equals the per-shard plain rounds on
    ``_exchange_axes``'s extended blocks, bit for bit (recording rows,
    accumulators, new state), on 2x2, 4x1 and 1x2 meshes, B5 and B6;
  - whole passes equal the single-device plain pass bit for bit and hold
    the JAX package's sharded Pallas rounds (interpret mode) at the C1
    bound (recording, flux and energies max-abs <= 1e-6 of the peak, onset
    exactly equal; XLA contracts multiply-adds into FMAs, eager PyTorch
    does not) and the RT60 moments at scale-relative 1e-5;
  - the same with the listener on a shard corner and outside the field;
  - the forced slab path equals the direct one;
  - the overlap split runs one frame and one interior launch per device
    and round, each over every shard;
  - the wrappers launch nothing here (their ``launches`` stay 0), a pass
    frees its shards without the garbage collector, and the kernel's
    region table layout matches its ctypes mirror.
"""

import gc
import os
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import oracle
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.parallel import mesh as jmesh
from planeverb_tpu.parallel import solver_pallas as jsp
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import fdtd_fused
from planeverb_tpu_torch.ops._common import fresh_acc
from planeverb_tpu_torch.ops.fdtd import admittance
from planeverb_tpu_torch.parallel import grid_mesh, pad_to_mesh, shard_fields
from planeverb_tpu_torch.parallel import solver as tsolver
from planeverb_tpu_torch.parallel import solver_fused

CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
NINE = ("pressure", "onset", "flux_x", "flux_y", "e_dry", "e_wet",
        "e_total", "s0", "s1")
MESHES = [(2, 2), (4, 1), (1, 2)]
MESH_IDS = ["2x2", "4x1", "1x2"]
# B6's plain version's tile where band_rows forces it
BAND = 8


@pytest.fixture(scope="module")
def room():
    """SmallRoom fields (numpy and CPU tensors), the listener cell and the
    single-device plain pass (B1 + B2 plain versions)."""
    p = tcfg.compute_grid_params(CFG)
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(5.0, 5.0)
    fields = fields_from_numpy(beta, refl, pulse, device="cpu")
    return p, (beta, refl, pulse), fields, (lix, liy), _single(p, fields,
                                                              lix, liy)


def _single(p, fields, lix, liy):
    res, mom = fdtd_fused.simulate_moments_fused_reference(p, *fields, lix,
                                                           liy)
    return {**res._asdict(), **mom._asdict()}


def _cpu_mesh(shape):
    return grid_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _padded(p, fields, shape, multiple=8):
    mesh = _cpu_mesh(shape)
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh, multiple)
    pad = (0, ny_pad - p.ny, 0, nx_pad - p.nx)
    beta, refl, pulse = fields
    return mesh, F.pad(beta, pad), F.pad(refl, pad), pulse, nx_pad, ny_pad


def _pass(p, fields, shape, lix, liy, halo=4, band=None, overlap=False,
          slabs=False):
    """A sharded pass (the kernels' wrappers) with its nine outputs
    assembled and cropped."""
    mesh, b, r, pl, nxp, nyp = _padded(p, fields, shape)
    res, mom = solver_fused._simulate_impl(
        p, b, r, pl, lix, liy, mesh, nxp, nyp, halo, band, overlap,
        reference=False, with_moments=True, slabs=slabs)
    out = {k: v[..., :p.nx, :p.ny]
           for k, v in res.assemble("cpu")._asdict().items()}
    out.update({k: v[:p.nx, :p.ny]
                for k, v in mom.assemble("cpu")._asdict().items()})
    return out


def _equal(got, ref):
    for name in NINE:
        assert torch.equal(got[name], ref[name]), name


# --------------------------------------------- one round, one device
def _ghosts(shape, k, band):
    kx, ky = ((k, k) if band is not None
              else (k if shape[0] > 1 else 0, k if shape[1] > 1 else 0))
    return kx, ky


@pytest.mark.parametrize("band", [None, BAND], ids=["B5", "B6"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("t0", [8, 432], ids=["mid", "last-short"])
def test_device_round_equals_per_shard_rounds(room, shape, band, t0):
    """One round of one device's plain version over all its shards equals
    the per-shard plain rounds on ``_exchange_axes``'s extended blocks, on
    random round-start state: every shard's recording rows, accumulators
    and new state, bit for bit (a mid-pass round, and the short last one:
    435 = 108 * 4 + 3)."""
    p, _, fields, (lix, liy), _ = room
    k = 4
    kx, ky = _ghosts(shape, k, band)
    mesh, b, r, pl, nxp, nyp = _padded(p, fields, shape)
    bx, by = nxp // shape[0], nyp // shape[1]
    (bb,), (yb,) = shard_fields(mesh, b), shard_fields(mesh, admittance(r))
    shards = solver_fused._shards(mesh, bb, yb, bx, by, kx, ky,
                                  p.response_length)
    solver_fused._link(shards, kx, ky, False)
    rng = np.random.default_rng(7)
    for row in shards:
        for s in row:
            s.state[0] = torch.from_numpy(
                rng.standard_normal((3, bx, by)).astype(np.float32))
            s.rec.zero_()
    # the per-shard plain rounds, on copies
    ext = tsolver._exchange_axes([[s.state[0] for s in row]
                                  for row in shards], kx, ky)
    want = {}
    for i, row in enumerate(shards):
        for j, s in enumerate(row):
            acc, rec = s.acc.clone(), s.rec.clone()
            geo = (i * bx - kx, j * by - ky, lix, liy)
            if band is not None:
                out = solver_fused.banded_round_reference(
                    p, t0, k, pl, s.statics, geo, ext[i][j], acc, rec, BAND)
            else:
                planes = solver_fused.fold_planes(p, s.statics[0],
                                                  s.statics[1], *geo)
                out = solver_fused.sharded_round_reference(
                    p, t0, k, kx, ky, pl, planes, ext[i][j], acc, rec)
            want[i, j] = (rec, acc, out)
    regions = [(s, 0, bx) for row in shards for s in row]
    launch = solver_fused.RoundLaunch(p, regions, kx, ky, band is not None,
                                      k, pl, lix, liy, (BAND, BAND))
    fdtd_fused.reset_launch_counts()
    wrapper = (solver_fused.banded_round if band is not None
               else solver_fused.sharded_round)
    wrapper(p, t0, k, launch, 0)
    assert wrapper.launches == 0          # the plain version
    for (i, j), (rec, acc, out) in want.items():
        s = shards[i][j]
        assert torch.equal(s.rec, rec), (i, j)
        assert torch.equal(s.acc, acc), (i, j)
        assert torch.equal(s.state[1], out), (i, j)
        assert s.rec[t0:t0 + 3].abs().sum() > 0


def test_gather_equals_exchange_axes(room):
    """A region's extended state read through its sources equals the
    ``_exchange_axes`` block, corners included, and a row window of it
    equals those rows."""
    p, _, fields, _, _ = room
    shape, k = (2, 2), 3
    mesh, b, r, pl, nxp, nyp = _padded(p, fields, shape)
    bx, by = nxp // 2, nyp // 2
    (bb,), (yb,) = shard_fields(mesh, b), shard_fields(mesh, admittance(r))
    shards = solver_fused._shards(mesh, bb, yb, bx, by, k, k, 10)
    solver_fused._link(shards, k, k, False)
    rng = np.random.default_rng(8)
    for row in shards:
        for s in row:
            s.state[1] = torch.from_numpy(
                rng.standard_normal((3, bx, by)).astype(np.float32))
    ext = tsolver._exchange_axes([[s.state[1] for s in row]
                                  for row in shards], k, k)
    launch = solver_fused.RoundLaunch(p, [], k, k, True, k, pl, 0, 0,
                                      (BAND, BAND))
    for i, row in enumerate(shards):
        for j, s in enumerate(row):
            assert torch.equal(launch.gather(s, 0, bx, 1), ext[i][j])
            assert torch.equal(launch.gather(s, bx - k, k, 1),
                               ext[i][j][:, bx - k:bx + 2 * k])


# ------------------------------------------------- whole passes vs JAX
@pytest.mark.parametrize("band", [None, BAND], ids=["B5", "B6"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_device_rounds_match_single_device_and_jax(room, shape, band):
    """A pass of one launch per round on a mesh of one device equals the
    single-device plain pass bit for bit, all nine outputs, and holds the
    JAX sharded Pallas rounds (interpret mode) at C1."""
    p, (beta, refl, pulse), fields, (lix, liy), single = room
    fdtd_fused.reset_launch_counts()
    got = _pass(p, fields, shape, lix, liy, band=band)
    assert solver_fused.sharded_round.launches == 0
    assert solver_fused.banded_round.launches == 0
    _equal(got, single)
    jm = jmesh.grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)
    nx_pad, ny_pad = jmesh.pad_to_mesh(p.nx, p.ny, jm, multiple=8)
    pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
    jres, jmom = jsp.simulate_moments_sharded(
        p, np.pad(beta, pad), np.pad(refl, pad), pulse, jnp.int32(lix),
        jnp.int32(liy), jm, nx_pad, ny_pad, halo=4, band_rows=band,
        interpret=True)
    ref = {**jres._asdict(), **jmom._asdict()}
    for name in NINE:
        want = np.asarray(ref[name])[..., :p.nx, :p.ny]
        if name == "onset":
            np.testing.assert_array_equal(got[name].numpy(), want)
            continue
        rel = 1e-5 if name in ("s0", "s1") else 1e-6
        scale = np.abs(want).max() + 1e-30
        assert np.abs(got[name].numpy() - want).max() <= rel * scale, name


# ------------------------------------------------------- the listener
@pytest.mark.parametrize("slabs", [False, True], ids=["direct", "slabs"])
@pytest.mark.parametrize("band", [None, BAND], ids=["B5", "B6"])
@pytest.mark.parametrize("where", ["corner", "outside-x", "outside-y"])
def test_listener_on_corner_and_outside(room, where, band, slabs):
    """The listener 1 cell from the corner of four shards (its copies in
    three neighbours' ghosts, the diagonal one's through a corner source,
    are injected), or outside the field (injected nowhere, not even into
    the zero ghosts beyond the global edge): the 2x2 pass equals the
    single-device plain pass, through neighbours read in place and
    through ghost buffers."""
    p, _, fields, _, _ = room
    corner = pad_to_mesh(p.nx, p.ny, _cpu_mesh((2, 2)), 8)[0] // 2
    lix, liy = {"corner": (corner - 1, corner), "outside-x": (-1, 3),
                "outside-y": (4, p.ny)}[where]
    got = _pass(p, fields, (2, 2), lix, liy, band=band, slabs=slabs)
    _equal(got, _single(p, fields, lix, liy))


# ---------------------------------------------------- the slab path
# (mesh, overlap): the plain rounds on every mesh, the split on the 1D one
SLAB_CASES = [(shape, False) for shape in MESHES] + [((4, 1), True)]
SLAB_IDS = [f"{i}-rounds" for i in MESH_IDS] + ["4x1-split"]


@pytest.mark.parametrize("band", [None, BAND], ids=["B5", "B6"])
@pytest.mark.parametrize("shape,overlap", SLAB_CASES, ids=SLAB_IDS)
def test_forced_slab_path_equals_direct(room, shape, overlap, band,
                                        monkeypatch):
    """With ``slabs`` every neighbour is read through a ghost buffer
    refreshed after each round (the split: after each frame launch), the
    path of neighbours on other devices: one buffer for each side a shard
    has a neighbour and ghosts on. The pass equals the direct one."""
    p, _, fields, (lix, liy), single = room
    halo = 2 if overlap else 4
    linked = []
    real = solver_fused._link

    def spy(shards, kx, ky, slabs):
        real(shards, kx, ky, slabs)
        linked.append(sum(len(s.ghosts) for row in shards for s in row))

    monkeypatch.setattr(solver_fused, "_link", spy)
    direct = _pass(p, fields, shape, lix, liy, halo, band, overlap)
    slabs = _pass(p, fields, shape, lix, liy, halo, band, overlap,
                  slabs=True)
    mx, my = shape
    kx, ky = _ghosts(shape, halo, band)
    sides = {(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
             if (dx, dy) != (0, 0) and (kx or not dx) and (ky or not dy)}
    want = sum(1 for i in range(mx) for j in range(my)
               for dx, dy in sides
               if 0 <= i + dx < mx and 0 <= j + dy < my)
    assert linked == [0, want] and want > 0
    _equal(slabs, direct)
    _equal(slabs, single)


# ------------------------------------------------------- the split
@pytest.mark.parametrize("band", [None, BAND], ids=["B5", "B6"])
def test_split_launches_cover_every_shard(room, band, monkeypatch):
    """On a (4, 1) mesh of one device, a split round is one frame launch
    over the four shards' eight frames and one interior launch over their
    four interiors, in that order; the pass equals the plain rounds'."""
    p, _, fields, (lix, liy), single = room
    calls = []
    real = solver_fused.device_round_reference

    def spy(params, t0, halo, launch, parity):
        calls.append((t0, [(s.i, orow, rows)
                           for s, orow, rows in launch.regions]))
        real(params, t0, halo, launch, parity)

    monkeypatch.setattr(solver_fused, "device_round_reference", spy)
    got = _pass(p, fields, (4, 1), lix, liy, halo=2, band=band,
                overlap=True)
    k = 2
    bx = pad_to_mesh(p.nx, p.ny, _cpu_mesh((4, 1)), 8)[0] // 4
    frames = [(i, r, k) for i in range(4) for r in (0, bx - k)]
    inner = [(i, k, bx - 2 * k) for i in range(4)]
    rounds = -(-p.response_length // k)
    assert calls == [(t0, regions) for t0 in range(0, p.response_length, k)
                     for regions in (frames, inner)]
    assert len(calls) == 2 * rounds
    _equal(got, single)


# ---------------------------------------------------- bookkeeping
def test_a_pass_frees_its_shards_without_gc(room, monkeypatch):
    """No shard refers to another (neighbours are held as tensors), so a
    pass's shards, and their recordings, go when the pass's results do,
    with the garbage collector off."""
    p, _, fields, (lix, liy), _ = room
    made = weakref.WeakSet()
    real = solver_fused._Shard

    class Spy(real):
        def __init__(self, *args):
            super().__init__(*args)
            made.add(self)

    monkeypatch.setattr(solver_fused, "_Shard", Spy)
    gc.collect()
    gc.disable()
    try:
        got = _pass(p, fields, (2, 2), lix, liy, slabs=True)
        assert got["pressure"].shape[0] == p.response_length
        del got
        assert len(made) == 0
    finally:
        gc.enable()


def _c_fields(source: str, struct: str):
    body = re.search(r"struct " + struct + r" \{(.*?)\};", source,
                     re.S).group(1)
    names = []
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = stmt.strip()
        if not decl:
            continue
        first, *rest = (d.strip() for d in decl.split(","))
        names.append(re.split(r"[\s*]+", first)[-1].split("[")[0])
        names.extend(n.split("[")[0] for n in rest)
    return names


def test_region_table_mirrors_the_kernel():
    """kernels.RoundSource / RoundRegion list the fields of
    csrc/solver_rounds.cu's Source / Region in order (the library checks
    the size when it loads), and Region is 312 bytes."""
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "solver_rounds.cu")) as f:
        source = f.read()
    for struct, mirror in (("Source", kernels.RoundSource),
                           ("Region", kernels.RoundRegion)):
        assert _c_fields(source, struct) == [n for n, _ in mirror._fields_]
    import ctypes
    assert ctypes.sizeof(kernels.RoundRegion) == 312


def test_round_launch_on_cpu_has_no_table(room):
    """A CPU launch builds no region table (the plain version reads the
    shards' tensors); its blocks are the regions' extended blocks."""
    p, _, fields, (lix, liy), _ = room
    shape, k = (4, 1), 2
    mesh, b, r, pl, nxp, nyp = _padded(p, fields, shape)
    bx, by = nxp // 4, nyp
    (bb,), (yb,) = shard_fields(mesh, b), shard_fields(mesh, admittance(r))
    shards = solver_fused._shards(mesh, bb, yb, bx, by, k, 0, 10)
    regions = [(s, 0, k) for (s,) in shards] + [(s, k, bx - 2 * k)
                                                 for (s,) in shards]
    launch = solver_fused.RoundLaunch(p, regions, k, 0, False, k, pl, lix,
                                      liy, (BAND, BAND))
    assert not hasattr(launch, "table")
    assert launch.blocks() == [(3 * k, by)] * 4 + [(bx, by)] * 4
    fresh = torch.stack(fresh_acc((bx, by), "cpu"))
    assert all(torch.equal(s.acc, fresh) for (s,) in shards)
