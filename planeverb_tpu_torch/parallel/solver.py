"""Shard layout and ghost exchange of the sharded engine.

Counterpart of the exchange part of ``planeverb_tpu/parallel/solver.py``.
A field sharded over a :class:`~planeverb_tpu_torch.parallel.mesh.Mesh` is
a block grid: a list of ``mesh.shape["x"]`` rows of ``mesh.shape["y"]``
tensors, block (i, j) on ``mesh.devices[i][j]``. The JAX package's
``shard_map`` body runs once per shard with ``ppermute`` between them; here
one process holds every block and a neighbour's slab crosses devices with
``.to(device)`` (a no-op when both shards share a device).

The exchange never writes a block it was given; on an axis with ghosts it
returns new tensors. It builds every shard's extended beta and Y once a
simulation; the rounds (``parallel/solver_fused.py``) read each round's
ghosts on the device instead, in place from a neighbour on the same device
and from a ghost buffer where the neighbour sits on another one. After a
round the rounds' loop copies the slab each ghost buffer holds from its sender.

The overlap split of the rounds copies only the new frames
(:func:`_exchange_frames`, after ``solver_pallas.py:667-672`` and
``:882-887``): each shard's new bottom k rows go to the next shard's top
ghost buffer, its new top k rows to the previous shard's bottom one. It is
enqueued after the round's frame launches and before its interior launches.
Between two cards the copy runs on side streams, after events recorded
behind both cards' frame launches, so it can run under the interior
launches; the receiver's next frame launch waits on the copy's event and
its interior launch does not. Shards sharing a device (a mesh of one card
repeated, as on a one-card machine, or of ``"cpu"``) read each other's
frames in place: nothing is copied, no side stream is used, and no exchange
is left to hide.

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
    the global edge and on a size-1 axis), on the receiving shard's
    device."""
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


_SIDE_STREAMS: dict = {}


def _side_stream(device) -> "torch.cuda.Stream":
    """The exchange's side stream on a CUDA device, made at first use."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _FrameCopies:
    """The copies of one frame exchange into the receivers' ghost buffers.

    A copy within one device runs on its current stream, in order with the
    launches. A copy between two cards runs on their side streams, after
    events recorded on both cards' current streams behind their frame
    launches (the sender's new frames are written; the receiver's frame
    launch has read the buffer's last contents), and the receiver waits on
    its end (:meth:`wait`) before its next frame launch. Each tensor used
    on a side stream is recorded there (``record_stream``), so the
    allocator never hands its memory out while a copy still reads or
    writes it.
    """

    def __init__(self):
        self._ready = {}   # device -> event behind its frame launches
        self._copied = {}  # receiver device -> events of its copies

    def _behind_frames(self, device) -> "torch.cuda.Event":
        if device not in self._ready:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            self._ready[device] = ready
        return self._ready[device]

    def __call__(self, slab: torch.Tensor, ghost: torch.Tensor) -> None:
        if slab.device == ghost.device:
            ghost.copy_(slab)
            return
        src, dst = slab.device, ghost.device
        sent, free = self._behind_frames(src), self._behind_frames(dst)
        side_src, side_dst = _side_stream(src), _side_stream(dst)
        with torch.cuda.stream(side_src), torch.cuda.stream(side_dst):
            side_src.wait_event(sent)
            side_src.wait_event(free)
            ghost.copy_(slab, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side_dst)
        slab.record_stream(side_src)
        ghost.record_stream(side_src)
        self._copied.setdefault(dst, []).append(copied)

    def wait(self, device) -> None:
        """Make ``device``'s current stream wait for the copies it
        received from other cards (nothing to wait for where none crossed
        a device)."""
        for copied in self._copied.get(device, ()):
            torch.cuda.current_stream(device).wait_event(copied)


def _exchange_frames(pairs) -> _FrameCopies:
    """The overlap split's exchange: each (slab, ghost) pair's slab, a
    shard's new frame rows [3, k, by], copied into the ghost buffer a
    neighbour reads in the next round's frame launch. Returns the copies;
    call ``copies.wait(device)`` before a receiver's next frame launch."""
    copies = _FrameCopies()
    for slab, ghost in pairs:
        copies(slab, ghost)
    return copies
