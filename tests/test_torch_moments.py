"""B2 over several recordings at once (``rt60_moments_many``) and its
launch's tiling, against the JAX package and the plain version, on the CPU.

The CUDA kernel (``csrc/moments.cu``) needs the card; ``chip_smoke.py``
phase 4 holds it bit for bit to the plain version there, on aligned and
unaligned rows. Here:

  - (a) ``moments_table``, the launch's tiling (plain integers): every cell
    of every recording covered exactly once by the kernel's block lookup,
    and each recording's alignment flag, over ragged shapes and the edges
    of a tile, B = 1 and 4, float32 and bf16;
  - (b) the new wrapper's plain path over several recordings
    ``torch.equal`` to ``rt60_moments_reference`` on each, and held to the
    JAX package's B2 (``fdtd_pallas.py::_moments_kernel`` through
    ``simulate_moments_pallas(..., interpret=True)``, as
    tests/test_torch_fused.py runs it) at scale-relative 1e-5 (the bound
    the JAX package holds its own kernel to; log implementations differ by
    ulps), at T = 37 (not a multiple of the kernel's 16-row chunks), float32
    and bf16 recordings cut into ragged shards; cells with +inf onsets and
    empty windows;
  - (c) the sharded pass on a ``["cpu"] * 4`` mesh calls the new wrapper
    once per device, in B5's plain rounds and in the split, and its
    moments equal the per-shard calls'.
"""

import ctypes
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from planeverb_tpu.ops import fdtd_pallas
from planeverb_tpu.ops import voxelize as jvox
from planeverb_tpu.scene import demo_scene
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.convert import fields_from_numpy
from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.parallel import (grid_mesh, pad_to_mesh,
                                          simulate_moments_sharded,
                                          simulate_moments_sharded_reference)

T = 37
CFG = tcfg.PlaneverbConfig(10.0, 10.0, 275)
# ragged shards of the 29 x 29 field: (rows, cols) slices
CUTS = ((slice(0, 17), slice(0, 23)), (slice(0, 17), slice(23, 29)),
        (slice(17, 29), slice(0, 29)))
SHAPES = ((29, 29), (17, 23), (96, 96), (48, 192))
# recordings at the edges of a 32-cell tile: one cell, one short of a tile,
# one over, whole tiles (rows 16-byte aligned) and one short of them
EDGES = ((1, 1), (1, 31), (1, 33), (32, 32), (33, 31))
# the shapes whose rows are 16-byte multiples in float32 and bf16
ALIGNED = ((96, 96), (48, 192), (32, 32))
DTYPES = (torch.float32, torch.bfloat16)


def _params(T_=T):
    p = tcfg.compute_grid_params(CFG)
    return dataclasses.replace(p, response_length=T_)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_case(request):
    """SmallRoom at 275 Hz, T = 37: JAX's recording, onset and B2 moments
    (interpret mode), in float32 or bf16 state."""
    p = _params()
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)
    lix, liy = p.world_to_cell(5.0, 5.0)
    jdt = jnp.bfloat16 if request.param == "bfloat16" else jnp.float32
    jres, jm = fdtd_pallas.simulate_moments_pallas(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.int32(lix), jnp.int32(liy), interpret=True, state_dtype=jdt)
    nx, ny = p.nx, p.ny
    rec = np.array(jres.pressure.astype(jnp.float32))[:T, :nx, :ny]
    dt = getattr(torch, request.param)
    return (p, torch.from_numpy(rec).to(dt),
            torch.from_numpy(np.array(jres.onset)[:nx, :ny]),
            {k: np.asarray(getattr(jm, k))[:nx, :ny] for k in ("s0", "s1")})


def _close(got, ref, rel, name):
    scale = np.abs(ref).max() + 1e-30
    assert np.abs(got.numpy() - ref).max() <= rel * scale, name


def _cells_of(rows, cells, total, tile):
    """Each entry's cell counts over the launch's blocks, by the kernel's
    lookup: block b is the last entry's whose tile0 is at or below b."""
    seen = [np.zeros(c, np.int64) for c in cells]
    for b in range(total):
        e = max(i for i, r in enumerate(rows) if r.tile0 <= b)
        lo = (b - rows[e].tile0) * tile
        hi = min(cells[e], lo + tile)
        assert lo < hi, f"block {b} covers no cell of entry {e}"
        seen[e][lo:hi] += 1
    return seen


# --------------------------------------------------------- (a) the tiling
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", [*((s,) for s in SHAPES + EDGES), SHAPES],
                         ids=[*(f"{x}x{y}" for x, y in SHAPES + EDGES),
                              "mixed"])
def test_table_covers_every_cell_once(shapes, dtype, B):
    """Every cell of every recording is read by exactly one block, no
    block is empty, and the flag says whether every row of a recording
    starts 16-byte aligned (its first sample and X * Y * bytes), for B
    recordings of each shape (also at a tile's edges): the [B, T, X, Y]
    batch's views and, from an odd offset, views that start mid-word."""
    tile = fdtd_fused.MOMENTS_TILE
    recs, expect = [], []
    for nx, ny in shapes:
        batch = torch.zeros((B, 3, nx, ny), dtype=dtype)
        recs.extend(batch.unbind(0))
        shifted = torch.zeros(3 * nx * ny + 1, dtype=dtype)[1:]
        recs.append(shifted.view(3, nx, ny))
        # 29x29 and 17x23 rows are not 16-byte multiples in either type,
        # 96x96, 48x192 and 32x32 rows are; the shifted view starts mid-word
        rows_ok = (nx * ny * batch.element_size()) % 16 == 0
        assert rows_ok == ((nx, ny) in ALIGNED)
        expect.extend([rows_ok and r.data_ptr() % 16 == 0
                       for r in batch.unbind(0)] + [False])
    entries = [(r[0].numel(), r.element_size(), r.data_ptr()) for r in recs]
    rows, total = fdtd_fused.moments_table(entries)
    cells = [c for c, _, _ in entries]
    assert total == sum(-(-c // tile) for c in cells)
    for e, seen in enumerate(_cells_of(rows, cells, total, tile)):
        assert (seen == 1).all(), f"entry {e}"
    assert [r.aligned for r in rows] == expect
    assert [r.tiles for r in rows] == [-(-c // tile) for c in cells]
    # a batch's first recording starts where the allocation does
    assert all(expect[i * (B + 1)] for i, s in enumerate(shapes)
               if s in ALIGNED)


def test_table_rejects_what_it_cannot_tile():
    with pytest.raises(ValueError, match="entry"):
        fdtd_fused.moments_table([(841, 0, 0)])
    with pytest.raises(ValueError, match="entry"):
        fdtd_fused.moments_table([(0, 4, 0)])
    assert fdtd_fused.moments_table([]) == ([], 0)


# ---------------------------------------- (b) the plain path, JAX included
def _shards(rec, onset):
    return ([rec[:, a, b].contiguous() for a, b in CUTS],
            [onset[a, b].contiguous() for a, b in CUTS])


def test_many_plain_matches_per_entry_and_jax(jax_case):
    """Ragged shards of JAX's T = 37 recording: each shard's moments
    torch.equal to the plain B2 on it, and within 1e-5 of JAX's B2 on the
    shard's cells."""
    p, rec, onset, jm = jax_case
    assert T % 16 != 0
    recs, onsets = _shards(rec, onset)
    fdtd_fused.reset_launch_counts()
    got = fdtd_fused.rt60_moments_many(p, recs, onsets)
    assert fdtd_fused.rt60_moments_many.launches == 0    # the plain path
    assert len(got) == len(CUTS)
    for (a, b), r, o, (s0, s1) in zip(CUTS, recs, onsets, got):
        r0, r1 = fdtd_fused.rt60_moments_reference(p, r, o)
        assert s0.shape == o.shape and s0.dtype == torch.float32
        assert torch.equal(s0, r0) and torch.equal(s1, r1)
        _close(s0, jm["s0"][a, b], 1e-5, "s0")
        _close(s1, jm["s1"][a, b], 1e-5, "s1")


def test_many_plain_on_sentinels_and_empty_windows(jax_case):
    """Onsets set to +inf (no window), to the regression end less the dry
    window (start == end: empty), past the end, and before 0 (the whole
    recording): each recording's moments equal the plain B2's, the +inf
    and empty ones are 0, and the full-window cells are not."""
    p, rec, onset, _ = jax_case
    dry_n1 = p.dry_gain_samples + 1
    end = T - p.schroeder_offset_samples
    onset = onset.clone()
    onset[0::4] = float("inf")
    onset[1::4] = float(end - dry_n1)
    onset[2::4, 0::2] = float(end + 3)
    onset[3::4] = -float(dry_n1) - 5.0
    recs, onsets = _shards(rec, onset)
    got = fdtd_fused.rt60_moments_many(p, recs, onsets)
    for r, o, (s0, s1) in zip(recs, onsets, got):
        r0, r1 = fdtd_fused.rt60_moments_reference(p, r, o)
        assert torch.equal(s0, r0) and torch.equal(s1, r1)
        empty = torch.isinf(o) | (o + dry_n1 >= end)
        assert (s0[empty] == 0).all() and (s1[empty] == 0).all()
        full = o + dry_n1 <= 0
        assert full.any() and (s0[full] != 0).all()


def test_batch_and_single_wrappers_agree_with_many(jax_case):
    """rt60_moments and rt60_moments_batch (one and B recordings of one
    shape) give what rt60_moments_many gives on the same recordings."""
    p, rec, onset, _ = jax_case
    batch = torch.stack([rec, rec.flip(-1)])
    onsets = torch.stack([onset, onset.flip(-1)])
    b0, b1 = fdtd_fused.rt60_moments_batch(p, batch, onsets)
    many = fdtd_fused.rt60_moments_many(p, list(batch), list(onsets))
    one = fdtd_fused.rt60_moments(p, rec, onset)
    for i, (s0, s1) in enumerate(many):
        assert torch.equal(b0[i], s0) and torch.equal(b1[i], s1)
    assert torch.equal(one[0], many[0][0]) and torch.equal(one[1], many[0][1])


def test_many_rejects_bad_arguments():
    p = _params()
    rec = torch.zeros((T, 5, 6))
    onset = torch.zeros((5, 6))
    many = fdtd_fused.rt60_moments_many
    with pytest.raises(ValueError, match="as many onsets"):
        many(p, [rec, rec], [onset])
    with pytest.raises(ValueError, match="as many onsets"):
        many(p, [], [])
    with pytest.raises(ValueError, match="one type"):
        many(p, [rec, rec.bfloat16()], [onset, onset])
    with pytest.raises(ValueError, match="rec must be"):
        many(p, [rec[:-1]], [onset])
    with pytest.raises(ValueError, match="several devices"):
        many(p, [rec, rec.to("meta")], [onset, onset.to("meta")])
    with pytest.raises(ValueError, match="meta"):
        many(p, [rec.to("meta")], [onset.to("meta")])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fdtd_fused.rt60_moments_probe(p, [rec], [onset])
    with pytest.raises(ValueError, match="no mode"):
        fdtd_fused.rt60_moments_probe(p, [rec], [onset], mode="fast")
    assert many.launches == 0


def _c_struct(source, name):
    body = re.search(r"struct " + name + r" \{(.*?)\};", source, re.S)
    names = []
    for stmt in re.sub(r"//[^\n]*", "", body.group(1)).split(";"):
        if stmt.strip():
            names.append(re.split(r"[\s*]+", stmt.strip())[-1])
    return names


def test_entry_mirrors_the_kernel():
    """kernels.MomentsEntry lists csrc/moments.cu's Entry fields in order
    (the library checks the size when it loads), and the tiling constants
    are the kernel's."""
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "moments.cu")) as f:
        source = f.read()
    assert _c_struct(source, "Entry") == [
        n for n, _ in kernels.MomentsEntry._fields_]
    assert ctypes.sizeof(kernels.MomentsEntry) == 48
    for const, value in (("kTile", fdtd_fused.MOMENTS_TILE),
                         ("kChunk", fdtd_fused.MOMENTS_CHUNK),
                         ("kMaxEntries", fdtd_fused.MOMENTS_MAX_ENTRIES)):
        m = re.search(r"constexpr int " + const + r" = (\d+);", source)
        assert int(m.group(1)) == value, const


# --------------------------------------------- (c) the sharded pass's site
@pytest.fixture(scope="module")
def room():
    p = tcfg.compute_grid_params(CFG)
    beta, refl = jvox.voxelize_np(p, demo_scene("SmallRoom").boxes)
    fields = fields_from_numpy(beta, refl, tcfg.gaussian_pulse(p),
                               device="cpu")
    return p, fields, p.world_to_cell(5.0, 5.0)


@pytest.mark.parametrize("shape,halo,overlap,band", [
    ((2, 2), 4, False, None), ((4, 1), 2, True, None),
    ((2, 2), 4, False, 8), ((4, 1), 2, True, 8)],
    ids=["B5-2x2", "B5-split-4x1", "B6-2x2", "B6-split-4x1"])
def test_sharded_pass_calls_many_once_per_device(room, monkeypatch, shape,
                                                 halo, overlap, band):
    """On a ["cpu"] * 4 mesh (one device) B5's moments are one
    rt60_moments_many call over the four shards' recordings, in the plain
    rounds and in the split, and equal rt60_moments on each shard; B6
    keeps one B4 call per shard. The plain pass
    (simulate_moments_sharded_reference) gives the same moments."""
    p, (beta, refl, pulse), (lix, liy) = room
    mesh = grid_mesh(["cpu"] * 4, shape)
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    pad = (0, ny_pad - p.ny, 0, nx_pad - p.nx)
    args = (p, F.pad(beta, pad), F.pad(refl, pad), pulse, lix, liy, mesh,
            nx_pad, ny_pad)
    calls = {"many": [], "tiled": 0}
    many, tiled = fdtd_fused.rt60_moments_many, fdtd_tiled.rt60_moments_tiled

    def many_spy(params, recs, onsets):
        calls["many"].append(len(recs))
        return many(params, recs, onsets)

    def tiled_spy(*a, **k):
        calls["tiled"] += 1
        return tiled(*a, **k)

    monkeypatch.setattr(fdtd_fused, "rt60_moments_many", many_spy)
    monkeypatch.setattr(fdtd_tiled, "rt60_moments_tiled", tiled_spy)
    res, mom = simulate_moments_sharded(*args, halo=halo, band_rows=band,
                                        overlap=overlap)
    assert calls == ({"many": [], "tiled": 4} if band else
                     {"many": [4], "tiled": 0})
    one = tiled if band else fdtd_fused.rt60_moments
    for i in range(shape[0]):
        for j in range(shape[1]):
            rec = res.blocks["pressure"][i][j]
            s0, s1 = one(p, rec, res.blocks["onset"][i][j])
            assert torch.equal(mom.blocks["s0"][i][j], s0)
            assert torch.equal(mom.blocks["s1"][i][j], s1)
    _, ref = simulate_moments_sharded_reference(
        *args, halo=halo, band_rows=band, overlap=overlap)
    for name in ("s0", "s1"):
        assert torch.equal(mom.field(name, "cpu"), ref.field(name, "cpu"))
