"""The overlap split of the sharded rounds (planeverb_tpu_torch.parallel,
``overlap=True``) on the CPU.

On a 1D ("x", N) mesh each round is a frame launch (a shard's top and
bottom k rows, two 3k-row windows), the frames' exchange and an interior
launch (rows [k, bx - k) from the round-start state), both writing rows of
the shard's one recording in place. A mesh of ``"cpu"`` repeated runs the
plain versions of the round kernels on those windows; ``chip_smoke.py``
phase 17 holds the CUDA kernels to them on the card. Here, on SmallRoom at
275 Hz (29 x 29 cells, 435 steps):

  - the split equals the plain rounds and the single-device plain pass bit
    for bit (``torch.equal``), all nine outputs, for B5 and for forced B6
    (``band_rows``), with the listener at the field's center and on a
    shard seam;
  - it holds the JAX package's overlap rounds in interpret mode at the C1
    bound (recording, flux and energies max-abs <= 1e-6 of the peak, onset
    exactly equal; RT60 moments scale-relative 1e-5);
  - a frame or interior launch of the row-window wrappers equals the same
    rows of a plain round on the whole extended block, and the wrappers
    refuse windows that overlap or leave the shard;
  - the JAX module's preconditions (a 1D mesh, bx >= 3 * halo) raise its
    messages, and a 1x1 mesh takes the plain rounds;
  - ``Context._overlap`` follows the JAX Context's rule where both pad
    alike, and the one documented divergence (the port pads to the mesh
    only, JAX to 8 shards' worth) is pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import oracle
import planeverb_tpu as jpv
import planeverb_tpu_torch as tpv
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.parallel import grid_mesh as jax_grid_mesh
from planeverb_tpu.parallel import mesh as jmesh
from planeverb_tpu.parallel import solver_pallas as jsp
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import fdtd_fused
from planeverb_tpu_torch.ops._common import fresh_acc
from planeverb_tpu_torch.parallel import (grid_mesh, pad_to_mesh,
                                          simulate_moments_sharded,
                                          simulate_sharded_fused)
from planeverb_tpu_torch.parallel import solver as tsolver
from planeverb_tpu_torch.parallel import solver_fused

CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
NINE = ("pressure", "onset", "flux_x", "flux_y", "e_dry", "e_wet",
        "e_total", "s0", "s1")
# (mesh, halo, pad multiple, band_rows): bx = 16 >= 12 on (2, 1) with the
# JAX Context's multiple of 8, bx = 8 >= 6 on (4, 1)
SPLITS = [((2, 1), 4, 8, None), ((4, 1), 2, 1, None),
          ((2, 1), 4, 8, 8), ((4, 1), 2, 1, 8)]
SPLIT_IDS = ["B5-2x1-h4", "B5-4x1-h2", "B6-2x1-h4", "B6-4x1-h2"]


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


def _args(p, fields, shape, multiple, lix, liy):
    mesh = _cpu_mesh(shape)
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh, multiple)
    pad = (0, ny_pad - p.ny, 0, nx_pad - p.nx)
    beta, refl, pulse = fields
    return (p, F.pad(beta, pad), F.pad(refl, pad), pulse, lix, liy, mesh,
            nx_pad, ny_pad)


def _nine(p, res, mom):
    out = {k: v[..., :p.nx, :p.ny]
           for k, v in res.assemble("cpu")._asdict().items()}
    out.update({k: v[:p.nx, :p.ny]
                for k, v in mom.assemble("cpu")._asdict().items()})
    return out


def _equal(got, ref):
    for name in NINE:
        assert torch.equal(got[name], ref[name]), name


def _hold_to_jax(got, jax_fields, p):
    for name in NINE:
        ref = np.asarray(jax_fields[name])[..., :p.nx, :p.ny]
        if name == "onset":
            np.testing.assert_array_equal(got[name].numpy(), ref)
            continue
        rel = 1e-5 if name in ("s0", "s1") else 1e-6
        scale = np.abs(ref).max() + 1e-30
        assert np.abs(got[name].numpy() - ref).max() <= rel * scale, name


# ------------------------------------------------------------ the split
@pytest.mark.parametrize("shape,halo,multiple,band", SPLITS, ids=SPLIT_IDS)
def test_split_matches_plain_rounds_and_jax(room, shape, halo, multiple,
                                            band):
    """The split equals the plain rounds and the single-device pass, all
    nine outputs, and holds JAX's overlap rounds (interpret mode) at C1;
    one B2 or B4 pass per shard computes the split's moments."""
    p, (beta, refl, pulse), fields, (lix, liy), single = room
    args = _args(p, fields, shape, multiple, lix, liy)
    nx_pad, ny_pad = args[-2:]
    assert nx_pad // shape[0] >= 3 * halo
    fdtd_fused.reset_launch_counts()
    split = _nine(p, *simulate_moments_sharded(*args, halo=halo,
                                               band_rows=band, overlap=True))
    assert solver_fused.sharded_round.launches == 0     # plain versions
    assert solver_fused.banded_round.launches == 0
    plain = _nine(p, *simulate_moments_sharded(*args, halo=halo,
                                               band_rows=band))
    _equal(split, plain)
    _equal(split, single)

    jm = jmesh.grid_mesh(jax.devices()[:shape[0]], shape)
    assert jmesh.pad_to_mesh(p.nx, p.ny, jm, multiple) == (nx_pad, ny_pad)
    pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
    jres, jmom = jsp.simulate_moments_sharded(
        p, np.pad(beta, pad), np.pad(refl, pad), pulse, jnp.int32(lix),
        jnp.int32(liy), jm, nx_pad, ny_pad, halo=halo, band_rows=band,
        interpret=True, overlap=True)
    _hold_to_jax(split, {**jres._asdict(), **jmom._asdict()}, p)


@pytest.mark.parametrize("band", [None, 8], ids=["B5", "B6"])
@pytest.mark.parametrize("row", [15, 16], ids=["last-of-0", "first-of-1"])
def test_listener_on_shard_seam(room, band, row):
    """The listener on the seam of a (2, 1) mesh's 16-row shards: in one
    shard's frame and in its neighbour's ghost, so the frame windows must
    inject it (B5 from the folded mask, B6 from ``geo``) and the exchange
    must carry it. The split equals the single-device pass bit for bit."""
    p, _, fields, _, _ = room
    liy = 10
    args = _args(p, fields, (2, 1), 8, row, liy)
    got = _nine(p, *simulate_moments_sharded(*args, halo=4, band_rows=band,
                                             overlap=True))
    _equal(got, _single(p, fields, row, liy))


# ------------------------------------------------- the row-window wrappers
def _random(shape, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("banded", [False, True], ids=["B5", "B6"])
def test_round_windows_equal_plain_round_rows(room, banded):
    """On random state and statics, the per-shard plain rounds' row
    windows, the frames (two 3k-row windows) and the interior (the shard's
    bx rows), write exactly the rows a plain round on the whole extended
    block writes, in the recording, the accumulators and the new state, and
    leave every other row alone."""
    p, _, fields, _, _ = room
    bx, by, k, t0 = 12, 10, 4, 8
    ky = k if banded else 0
    rng = np.random.default_rng(3)
    pulse = fields[2]
    ext = _random((3, bx + 2 * k, by + 2 * ky), rng)
    statics = _random((2 if banded else 8, bx + 2 * k, by + 2 * ky), rng)
    if banded:
        statics = statics.abs()       # beta and Y are non-negative

    def fresh():
        return (torch.stack(fresh_acc((bx, by), "cpu")),
                torch.zeros((p.response_length, bx, by)))

    def run(stat, state, acc, rec, gi0, **win):
        if banded:
            return solver_fused.banded_round_reference(
                p, t0, k, pulse, stat, (gi0, -k, 9, 3), state, acc, rec,
                tile=(4, 8), **win)
        return solver_fused.sharded_round_reference(p, t0, k, k, 0, pulse,
                                                    stat, state, acc, rec,
                                                    **win)

    acc_p, rec_p = fresh()
    plain = run(statics, ext, acc_p, rec_p, 2)
    acc_s, rec_s = fresh()
    out = torch.full((3, bx, by), 7.0)

    def frames(x):
        return torch.cat([x[:, :3 * k], x[:, bx - k:]], dim=1)

    assert run(frames(statics), frames(ext), acc_s, rec_s, 2, row0=0,
               windows=2, out_stride=bx - k, out=out) is out
    assert (out[:, k:bx - k] == 7.0).all()         # the interior untouched
    assert torch.equal(rec_s[:, k:bx - k], torch.zeros_like(rec_s[:, k:-k]))
    run(statics[:, k:k + bx], ext[:, k:k + bx], acc_s, rec_s, 2 + k, row0=k,
        out=out)
    assert torch.equal(out, plain)
    assert torch.equal(acc_s, acc_p)
    assert torch.equal(rec_s, rec_p)
    assert rec_s[t0:t0 + k].abs().sum() > 0
    assert solver_fused.sharded_round.launches == 0
    assert solver_fused.banded_round.launches == 0


def test_round_window_checks(room):
    """The per-shard plain rounds check their row-window arguments before
    anything runs: one or two windows dividing the state's rows, disjoint
    and inside the shard, and an ``out`` of the shard's shape."""
    p, _, fields, _, _ = room
    bx, by, k = 12, 10, 4
    rng = np.random.default_rng(4)
    pulse = fields[2]
    acc = torch.stack(fresh_acc((bx, by), "cpu"))
    rec = torch.zeros((p.response_length, bx, by))
    fr_state, fr_planes = _random((3, 6 * k, by), rng), _random(
        (8, 6 * k, by), rng)

    def frames(**kw):
        return solver_fused.sharded_round_reference(p, 0, k, k, 0, pulse,
                                                    fr_planes, fr_state, acc,
                                                    rec, **kw)

    with pytest.raises(ValueError, match="windows must be 1 or 2"):
        frames(windows=3)
    with pytest.raises(ValueError, match="disjoint"):
        frames(windows=2, out_stride=k - 1)          # windows overlap
    with pytest.raises(ValueError, match="disjoint"):
        frames(windows=2, out_stride=bx - k, row0=1)  # past the shard
    with pytest.raises(ValueError, match="disjoint"):
        frames(windows=1, row0=-1)
    with pytest.raises(ValueError, match="out must be"):
        frames(windows=2, out_stride=bx - k, out=torch.zeros((3, bx, by - 1)))
    with pytest.raises(ValueError, match="planes"):
        solver_fused.banded_round_reference(
            p, 0, k, pulse, _random((2, 6 * k, by), rng), (0, 0, 1, 1),
            F.pad(fr_state, (k, k)), acc, rec, windows=2, out_stride=bx - k)
    with pytest.raises(ValueError, match="meta"):
        frames(windows=2, out_stride=bx - k,
               out=torch.zeros((3, bx, by), device="meta"))


# ------------------------------------------------------ preconditions
def test_overlap_preconditions_raise_jax_messages(room):
    """overlap=True on a 2D mesh, or with shards below 3 * halo rows,
    raises the JAX module's ValueError with its message."""
    p, (beta, refl, pulse), fields, (lix, liy), _ = room
    for shape, halo, match in (((2, 2), 4, r"1D \('x', N\) mesh"),
                               ((4, 1), 4, r"3\*halo")):
        args = _args(p, fields, shape, 1, lix, liy)
        nx_pad, ny_pad = args[-2:]
        with pytest.raises(ValueError, match=match) as port:
            simulate_sharded_fused(*args, halo=halo, overlap=True)
        jm = jmesh.grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)
        pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
        with pytest.raises(ValueError, match=match) as ref:
            jsp.simulate_sharded_pallas(
                p, np.pad(beta, pad), np.pad(refl, pad), pulse,
                jnp.int32(lix), jnp.int32(liy), jm, nx_pad, ny_pad,
                halo=halo, interpret=True, overlap=True)
        assert str(port.value) == str(ref.value)


def test_overlap_on_1x1_takes_plain_rounds(room, monkeypatch):
    """A single shard exchanges nothing: overlap=True on a 1x1 mesh runs
    the plain rounds (no split, even though bx < 3 * halo is allowed)."""
    p, _, fields, (lix, liy), single = room
    args = _args(p, fields, (1, 1), 1, lix, liy)
    calls = []
    real = solver_fused._overlap_rounds
    monkeypatch.setattr(solver_fused, "_overlap_rounds",
                        lambda *a: calls.append(a) or real(*a))
    got = _nine(p, *simulate_moments_sharded(*args, halo=16, overlap=True))
    assert calls == []
    _equal(got, single)


def test_frame_exchange_on_one_device():
    """The frame exchange copies each new frame into its ghost buffer; on
    one device on the current stream, with no copy across cards to wait
    for. (Shards sharing a device read each other's frames in place, and
    copy only on the forced slab path.)"""
    rng = np.random.default_rng(5)
    states = [_random((3, 9, 5), rng) for _ in range(3)]
    ghosts = [torch.zeros((3, 2, 5)) for _ in range(4)]
    pairs = [(states[0][:, -2:], ghosts[0]), (states[1][:, :2], ghosts[1]),
             (states[1][:, -2:], ghosts[2]), (states[2][:, :2], ghosts[3])]
    copies = tsolver._exchange_frames(pairs)
    for slab, ghost in pairs:
        assert torch.equal(ghost, slab)
        assert ghost.data_ptr() != slab.data_ptr()
    copies.wait(torch.device("cpu"))      # nothing crossed a device


# ---------------------------------------------------------- the Context
def _contexts(size, shape, halo, scene="SmallRoom"):
    """(the port's mesh Context, JAX's) on CPU meshes, not stepped."""
    cfg = (size, size, 275)
    kw = {} if halo is None else {"halo": halo}
    port = tpv.Context(tpv.PlaneverbConfig(*cfg),
                       scene=tpv.demo_scene(scene), mesh=_cpu_mesh(shape),
                       **kw)
    ref = jpv.Context(jpv.PlaneverbConfig(*cfg), scene=jpv.demo_scene(scene),
                      mesh=jax_grid_mesh(jax.devices()[:shape[0] * shape[1]],
                                         shape), **kw)
    return port, ref


@pytest.mark.parametrize("size,shape,halo,overlap", [
    (25.0, (4, 1), 4, True),      # bx 18 (JAX 24) >= 12
    (25.0, (2, 4), None, False),  # a 2D mesh
    (10.0, (8, 1), None, False),  # bx 4, halo 4 (JAX bx 8, halo 8)
], ids=["25m-4x1-h4", "25m-2x4", "10m-8x1"])
def test_context_overlap_rule_matches_jax(size, shape, halo, overlap):
    port, ref = _contexts(size, shape, halo)
    assert port._overlap is ref._overlap is overlap


def test_context_overlap_padding_divergence():
    """The documented divergence: 25 m (71 x 71 cells) on an (8, 1) mesh
    with halo 4. JAX pads to 128 rows (a multiple of 8 shards' worth: bx
    16 >= 12, the split); the port pads to 72 (bx 9 < 12, the plain
    rounds). Both publish the single-device results."""
    port, ref = _contexts(25.0, (8, 1), 4)
    assert (ref._nx_pad, port._nx_pad) == (128, 72)
    assert ref._overlap and not port._overlap


def _stepped(ctx, listeners):
    ctx.set_listener_positions(listeners)
    eids = [ctx.emissions.emit(6.5, 0.0, 5.0), ctx.emissions.emit(4.0, 0.0,
                                                                  5.0)]
    ctx.step()
    return ctx, eids


def test_mesh_context_split_matches_single_device_and_jax(monkeypatch):
    """25 m at 275 Hz on a (4, 1) mesh with halo 4: the port's Context takes
    the split, publishes exactly what the single-device Context publishes
    (every grid and the impulse responses), and holds JAX's mesh Context
    (which takes its split too) at the golden tolerances."""
    from test_torch_context import _assert_golden

    port, ref = _contexts(25.0, (4, 1), 4)
    assert port._overlap and ref._overlap
    calls = []
    real = solver_fused._overlap_rounds
    monkeypatch.setattr(solver_fused, "_overlap_rounds",
                        lambda *a: calls.append(1) or real(*a))
    _stepped(port, [(12.5, 0.0, 12.5)])
    assert calls == [1]
    _stepped(ref, [(12.5, 0.0, 12.5)])
    one, _ = _stepped(tpv.Context(tpv.PlaneverbConfig(25.0, 25.0, 275),
                                  scene=tpv.demo_scene("SmallRoom"),
                                  device="cpu"), [(12.5, 0.0, 12.5)])
    a, b = port._published, one._published
    for k in a.keys() - {"listener", "pressure"}:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, z in ((6.5, 5.0), (1.0, 8.5), (20.0, 20.0)):
        np.testing.assert_array_equal(port.get_impulse_response(x, z),
                                      one.get_impulse_response(x, z))
    _assert_golden(port, ref)


def test_mesh_context_split_with_two_views():
    """Two listeners on a (4, 1) mesh whose split is on (10 m, halo 2:
    bx 8 >= 6): one split pass per view, each view's grids equal the
    single-device Context's views."""
    cfg = tpv.PlaneverbConfig(10.0, 10.0, 275)
    views = [(5.0, 0.0, 5.0), (4.0, 0.0, 6.0)]
    mesh_ctx, _ = _stepped(tpv.Context(cfg, scene=tpv.demo_scene("SmallRoom"),
                                       mesh=_cpu_mesh((4, 1)), halo=2), views)
    assert mesh_ctx._overlap
    one, _ = _stepped(tpv.Context(cfg, scene=tpv.demo_scene("SmallRoom"),
                                  device="cpu"), views)
    a, b = mesh_ctx._published, one._published
    for k in a.keys() - {"listener", "listeners"}:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

