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

The overlap split of the rounds exchanges only the new frames
(:func:`_exchange_frames`, after ``solver_pallas.py:667-672`` and
``:882-887``): each shard's new bottom k rows become the next shard's top
ghost, its new top k rows the previous shard's bottom ghost. It is enqueued
after the round's frame launches and before its interior launches. Where
the neighbour sits on another card the copy runs on side streams, after an
event recorded behind the sender's frame launches, so it can run under the
interior launches; the receiver's next frame windows wait on the copy's
event and its interior launches do not. Where both shards share a device
(a mesh of one card repeated, as on a one-card machine, or of ``"cpu"``)
the ghost is a view of the neighbour's new state: nothing is copied, no
side stream is used, and no exchange is left to hide.

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


def _from_prev(slabs, axis: str, move=torch.Tensor.to):
    """Each shard's slab from its previous neighbour along ``axis`` (zeros
    at the global edge and on a size-1 axis), on the receiving shard's
    device. ``slabs`` is a block grid; so is the result. ``move(slab,
    device)`` carries a slab to its receiver (default ``.to(device)``)."""
    mx, my = len(slabs), len(slabs[0])

    def take(i, j):
        mine = slabs[i][j]
        pi, pj = (i - 1, j) if axis == "x" else (i, j - 1)
        if pi < 0 or pj < 0:
            return torch.zeros_like(mine)
        return move(slabs[pi][pj], mine.device)

    return [[take(i, j) for j in range(my)] for i in range(mx)]


def _from_next(slabs, axis: str, move=torch.Tensor.to):
    """Each shard's slab from its next neighbour along ``axis`` (zeros at
    the global edge and on a size-1 axis); ``move`` as :func:`_from_prev`."""
    mx, my = len(slabs), len(slabs[0])

    def take(i, j):
        mine = slabs[i][j]
        ni, nj = (i + 1, j) if axis == "x" else (i, j + 1)
        if ni >= mx or nj >= my:
            return torch.zeros_like(mine)
        return move(slabs[ni][nj], mine.device)

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


_SIDE_STREAMS: dict = {}


def _side_stream(device) -> "torch.cuda.Stream":
    """The exchange's side stream on a CUDA device, made at first use."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _FrameCopies:
    """The cross-device copies of one frame exchange, on side streams.

    PyTorch runs a copy between two cards on the sender's current stream
    and makes the receiver's current stream wait for it; with both side
    streams current, the copy runs on the sender's side stream, after an
    event recorded on the sender's stream behind its frame launches, and
    ends with the receiver's side stream waiting on it. Each tensor used on
    a stream other than the one it was allocated on is recorded there
    (``record_stream``), so the allocator never hands its memory out while
    a copy still reads or writes it. Same-device slabs are returned as
    they are.
    """

    def __init__(self):
        self._sent = {}    # sender device -> event behind its frames
        self._copied = {}  # receiver device -> events of its copies

    def __call__(self, slab: torch.Tensor, device) -> torch.Tensor:
        if slab.device == device:
            return slab
        src = slab.device
        if src not in self._sent:
            sent = torch.cuda.Event()
            sent.record(torch.cuda.current_stream(src))
            self._sent[src] = sent
        side_src, side_dst = _side_stream(src), _side_stream(device)
        with torch.cuda.stream(side_src), torch.cuda.stream(side_dst):
            side_src.wait_event(self._sent[src])
            ghost = slab.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side_dst)
        slab.record_stream(side_src)
        ghost.record_stream(torch.cuda.current_stream(device))
        self._copied.setdefault(device, []).append(copied)
        return ghost

    def wait(self, device) -> None:
        """Make ``device``'s current stream wait for the copies it
        received (nothing to wait for where none crossed a device)."""
        for copied in self._copied.get(device, ()):
            torch.cuda.current_stream(device).wait_event(copied)


def _exchange_frames(states, k: int):
    """The overlap split's exchange on a 1D ("x", N) mesh: the shards' new
    [3, bx, by] states, in mesh order -> (top ghosts, bottom ghosts,
    copies), each ghost [3, k, by] on its receiver's device: the previous
    shard's new bottom k rows and the next shard's new top k rows (zeros at
    the global edges). Call ``copies.wait(device)`` before a receiver's
    next frame windows read its ghosts."""
    copies = _FrameCopies()
    top = _from_prev([[s[:, -k:]] for s in states], "x", copies)
    bot = _from_next([[s[:, :k]] for s in states], "x", copies)
    return [g for (g,) in top], [g for (g,) in bot], copies
