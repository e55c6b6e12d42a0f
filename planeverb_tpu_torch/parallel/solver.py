"""Shard layout and ghost exchange of the sharded engine.

Counterpart of the exchange part of ``planeverb_tpu/parallel/solver.py``.
A field sharded over a :class:`~planeverb_tpu_torch.parallel.mesh.Mesh` is
a block grid: a list of ``mesh.shape["x"]`` rows of ``mesh.shape["y"]``
tensors, block (i, j) on ``mesh.devices[i][j]``. The JAX package's
``shard_map`` body runs once per shard with ``ppermute`` between them; here
one process holds every block and a neighbour's slab crosses devices with
``.to(device)`` (a no-op when both shards share a device).

The exchange never writes a block it was given; on an axis with ghosts it
returns new tensors. The rounds (``parallel/solver_fused.py``) build every
shard's extended blocks from the previous round's outputs before any
kernel of the round runs, and write each round's state into new tensors.

``simulate_sharded`` and ``simulate_sharded_wide`` (the per-step scan
solvers of the JAX module) are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import torch

from planeverb_tpu_torch.parallel.mesh import Mesh

__all__ = ["shard_fields", "assemble"]


def shard_fields(mesh: Mesh, *tensors: torch.Tensor):
    """Split each [nx_pad, ny_pad] tensor into the mesh's [bx, by] blocks,
    each a contiguous copy on its mesh device. Returns one block grid per
    tensor."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    out = []
    for t in tensors:
        nx, ny = t.shape[-2:]
        if nx % mx or ny % my:
            raise ValueError(f"field {tuple(t.shape)} is not divisible by "
                             f"the {mx}x{my} mesh (see pad_to_mesh)")
        bx, by = nx // mx, ny // my
        out.append([[t[..., i * bx:(i + 1) * bx, j * by:(j + 1) * by]
                     .to(mesh.devices[i][j]).contiguous()
                     for j in range(my)] for i in range(mx)])
    return tuple(out)


def assemble(blocks, device) -> torch.Tensor:
    """Inverse of :func:`shard_fields`: the block grid (blocks [..., bx,
    by]) as one [..., nx_pad, ny_pad] tensor on ``device``."""
    rows = [torch.cat([b.to(device) for b in row], dim=-1) for row in blocks]
    return torch.cat(rows, dim=-2)


def _from_prev(slabs, axis: str):
    """Each shard's slab from its previous neighbour along ``axis`` (zeros
    at the global edge and on a size-1 axis), on the receiving shard's
    device. ``slabs`` is a block grid; so is the result."""
    mx, my = len(slabs), len(slabs[0])

    def take(i, j):
        mine = slabs[i][j]
        pi, pj = (i - 1, j) if axis == "x" else (i, j - 1)
        if pi < 0 or pj < 0:
            return torch.zeros_like(mine)
        return slabs[pi][pj].to(mine.device)

    return [[take(i, j) for j in range(my)] for i in range(mx)]


def _from_next(slabs, axis: str):
    """Each shard's slab from its next neighbour along ``axis`` (zeros at
    the global edge and on a size-1 axis)."""
    mx, my = len(slabs), len(slabs[0])

    def take(i, j):
        mine = slabs[i][j]
        ni, nj = (i + 1, j) if axis == "x" else (i, j + 1)
        if ni >= mx or nj >= my:
            return torch.zeros_like(mine)
        return slabs[ni][nj].to(mine.device)

    return [[take(i, j) for j in range(my)] for i in range(mx)]


def _exchange_axes(blocks, kx: int, ky: int):
    """Per-axis ghost exchange: extend every [..., bx, by] block by
    ``kx``/``ky`` neighbour ghost cells per side (a width of 0 skips the
    axis); leading axes ride along, so the sharded rounds exchange p, vx
    and vy as one [3, bx, by] block. The x phase runs first and the y phase
    exchanges the x-extended blocks, so the corners are carried, which the
    k-step dependency cone needs. Missing neighbours (global edges) fill
    with zeros, matching the zero padding of the single-device solver."""
    if kx:
        top = _from_prev([[b[..., -kx:, :] for b in row] for row in blocks],
                         "x")
        bot = _from_next([[b[..., :kx, :] for b in row] for row in blocks],
                         "x")
        blocks = [[torch.cat([t, b, u], dim=-2)
                   for t, b, u in zip(*rows)]
                  for rows in zip(top, blocks, bot)]
    if ky:
        left = _from_prev([[b[..., -ky:] for b in row] for row in blocks],
                          "y")
        right = _from_next([[b[..., :ky] for b in row] for row in blocks],
                           "y")
        blocks = [[torch.cat([lft, b, rgt], dim=-1)
                   for lft, b, rgt in zip(*rows)]
                  for rows in zip(left, blocks, right)]
    return blocks


def _exchange_halo(blocks, halo: int):
    """Symmetric form of :func:`_exchange_axes`: [..., bx, by] ->
    [..., bx+2h, by+2h]."""
    return _exchange_axes(blocks, halo, halo)
