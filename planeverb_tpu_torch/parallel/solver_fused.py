"""Sharded engine: the rounds of B5 and B6 between ghost exchanges, one
launch per device and round.

Counterpart of ``planeverb_tpu/parallel/solver_pallas.py``. The field is
padded to the mesh (beta = 0, silent) and cut into [bx, by] shards. A pass
runs in rounds of k = ``halo`` steps (the last round has T - t0): each
round advances every shard on its ghost-extended block, whose ghosts are
its neighbours' state at the round's start. With ``overlap=True`` on a 1D
("x", N) mesh each round is split instead (:func:`_overlap_rounds`): a
frame launch advances every shard's top and bottom k rows, their new rows
are exchanged, and an interior launch that does not wait for the exchange
advances the rest.

A round is one launch per device (``csrc/solver_rounds.cu``), over every
region the device holds: a region is a shard's extended block in the plain
rounds, a frame or interior window of it in the split. The launch reads a
region's ghosts on the device, through a table of the 3 x 3 states around
its shard (:class:`RoundLaunch`): a neighbour on the same device is read in
place, a neighbour on another device through a ghost buffer on this one,
into which the round loop copies the slab the region reads after each round
(``.to``-style copies in the plain rounds, ``solver.py::_FrameCopies`` in
the split). On a mesh of several processes each process makes only its own
shards and launches; a neighbour of another process is read through a
ghost buffer too, filled by point-to-point transfers after each round
(``multihost.post``, every send and receive of the round in one
``batch_isend_irecv``, waited on before the next launch that reads them). Two wrappers, one kernel, each with the plain version of one
device's round (:func:`device_round_reference`: the exchange read through
the same table, then the per-shard plain rounds):

  - :func:`sharded_round` (B5, replaces ``solver_pallas.py::_round_kernel``):
    per-axis ghosts (k on a sharded axis, 0 on an unsharded one, whose
    block edge is the global edge). Its per-shard plain round,
    :func:`sharded_round_reference`, reads the eight planes
    :func:`fold_planes` folds once per simulation; the kernel folds the
    coefficients from beta and Y in its windows.
  - :func:`banded_round` (B6, replaces
    ``solver_pallas.py::_banded_round_kernel``): symmetric ghosts k. Its
    per-shard plain round, :func:`banded_round_reference`, folds in each
    of its tile windows, from the windows' global coordinates.

Why the interior is exact (the cone argument): one step reads one cell
back (velocities read p at i-1, j-1) and one cell ahead (pressure reads v
at i+1, j+1), so a value wrong at a block's edge at the start of a round
reaches at most s cells inward after s steps. The extended block's edge and
every window's edge are at least k cells from the cells that survive, and a
round has at most k steps, so the zero shifts at those edges, the wrong
folded coefficients on their first row and column, and whatever lies
beyond them never reach the interior: it evolves bit for bit as the
single-device solver does. This holds for the kernel's sub-rounds too,
each with its own windows. Every copy of the listener cell, ghosts
included, is injected, so ghost cells evolve as their owners do.

Each round records the interior's pre-injection pressure into rows
[t0, t0 + nsteps) of the shard's [T, bx, by] recording and streams the
interior accumulators (onset, flux, windowed energies), with the round's
time offset in every moment window. After the rounds each shard's moments
come from its own recording: after B5 one B2 launch per device over all its
shards' recordings (``fdtd_fused.rt60_moments_many``), after B6 one B4
launch per shard (``fdtd_tiled.rt60_moments_tiled``); the recordings stay
on their devices.

Route, per shard: B5 up to ``fdtd_fused.TILED_MIN_CELLS`` cells, B6 above;
``band_rows`` forces B6 (and sets the tile of B6's plain version; the
results do not depend on it). A 1x1 mesh that would take B6, without
``band_rows``, needs no exchange at all and delegates to the tiled route
(B3 + B4, ``ops/fdtd_tiled.py``). The JAX module's Mosaic constraints (the
128-lane width, band multiples of 8, VMEM budgets, recording-size checks)
are not carried over.

Dispatch as in ``ops/fdtd_fused.py``: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version, any other device raises, and
nothing falls back. Each wrapper counts its launches in ``launches``
(``fdtd_fused.reset_launch_counts`` resets them).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops import analyzer, fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.ops._common import (barrier_words, check_field,
                                             counted, fresh_acc, on_card,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import (FdtdResult, fdtd_step_folded,
                                          stencil_coefficients)
from planeverb_tpu_torch.parallel import multihost
from planeverb_tpu_torch.parallel.mesh import Mesh
from planeverb_tpu_torch.parallel.solver import (Sharded, _exchange_frames,
                                                 extend_statics,
                                                 fold_coefficients,
                                                 static_blocks)

__all__ = ["Sharded", "RoundLaunch", "fold_planes",
           "sharded_round", "sharded_round_reference", "banded_round",
           "banded_round_reference", "device_round_reference",
           "simulate_sharded_fused", "simulate_sharded_reference",
           "simulate_moments_sharded", "simulate_moments_sharded_reference",
           "pipeline_sharded", "REGION_TILES", "SUB_ROUND",
           "pick_region_tile"]

# A round launch's window tiles and sub-round depth on the card: a round of
# halo k runs as sub-rounds of at most SUB_ROUND steps, each window a tile
# of REGION_TILES with a SUB_ROUND-cell border (a 32 x 64 or 32 x 32
# window), the tiling the halo's fit in parallel/scaling.py
# (ROUND_OVERHEAD_S) was measured with; B3 plans its own rounds
# (ops/fdtd_tiled.py plan_tiled). :func:`pick_region_tile` chooses.
REGION_TILES = ((20, 52), (20, 20))
SUB_ROUND = 6
# The tile of B6's plain version's windows when band_rows gives none (the
# results do not depend on it)
REFERENCE_TILE = (32, 32)
# Global coordinates no window reaches: a listener outside the field
_NOWHERE = -(1 << 30)


def pick_region_tile(blocks, n_sm: int) -> tuple[int, int]:
    """The tile of :data:`REGION_TILES` with the least modelled round time
    for one launch over the given (rows, cols) extended blocks on a card
    with ``n_sm`` SMs: the windows the busiest SM steps one after another
    times the cells of a window. Ties go to the earlier tile."""
    def cost(tile):
        tx, ty = tile
        n = sum(-(-nx // tx) * -(-ny // ty) for nx, ny in blocks)
        return -(-n // n_sm) * (tx + 2 * SUB_ROUND) * (ty + 2 * SUB_ROUND)

    return min(REGION_TILES, key=cost)


def _tile(tile) -> tuple[int, int]:
    tx, ty = (tile, tile) if isinstance(tile, int) else tuple(tile)
    if min(tx, ty) < 1:
        raise ValueError(f"tile {tile} must be >= 1")
    return int(tx), int(ty)


def fold_planes(params: GridParams, beta_e, y_e, gi0: int, gj0: int,
                lix: int, liy: int) -> torch.Tensor:
    """The eight planes of an extended block B5's plain version reads:
    beta, the six coefficients
    of ``ops/fdtd.py::stencil_coefficients`` and the listener mask, as one
    [8, ex, ey] tensor. ``beta_e``/``y_e`` are the exchanged beta and
    admittance blocks, (gi0, gj0) the global coordinates of their cell
    (0, 0). Folded once per simulation; the wrong values the block edge's
    zero shifts give its first row and column lie outside the cone of the
    interior."""
    coefs, gi, gj = fold_coefficients(params, beta_e, y_e, gi0, gj0)
    src = ((gi == lix) & (gj == liy)).to(torch.float32).expand(beta_e.shape)
    return torch.stack([beta_e, *coefs, src])


def _nsteps(params: GridParams, t0: int, halo: int) -> int:
    return min(halo, params.response_length - t0)


def _check_round(where, params, t0, halo, kx, ky, pulse, planes, n_planes,
                 state_e, acc, rec, row0, windows, out_stride, out) -> int:
    """Argument checks of a per-shard plain round. Returns the rows each
    window advances."""
    T = params.response_length
    if not 0 <= t0 < T or halo < 1:
        raise ValueError(f"{where}: need 0 <= t0 < T ({t0}, {T}) and "
                         f"halo >= 1 ({halo})")
    if acc.dim() != 3 or state_e.dim() != 3:
        raise ValueError(f"{where}: acc must be [6, bx, by] and state_e "
                         f"[3, rows, cols], got {tuple(acc.shape)} and "
                         f"{tuple(state_e.shape)}")
    if windows not in (1, 2) or state_e.shape[1] % windows:
        raise ValueError(f"{where}: windows must be 1 or 2 and divide "
                         f"state_e's {state_e.shape[1]} rows, got {windows}")
    bx, by = acc.shape[-2:]
    rows = state_e.shape[1] // windows - 2 * kx
    end = row0 + (windows - 1) * out_stride + rows
    if (rows < 1 or row0 < 0 or end > bx
            or (windows == 2 and out_stride < rows)):
        raise ValueError(f"{where}: {windows} window(s) of {rows} rows from "
                         f"shard row {row0} (stride {out_stride}) must be "
                         f"disjoint and within the shard's {bx} rows")
    ext = (windows * (rows + 2 * kx), by + 2 * ky)
    check_field(where, "pulse", pulse, (T,))
    check_field(where, "planes", planes, (n_planes, *ext))
    check_field(where, "state_e", state_e, (3, *ext))
    check_field(where, "acc", acc, (6, bx, by))
    check_field(where, "rec", rec, (T, bx, by))
    written = (acc, rec)
    if out is not None:
        check_field(where, "out", out, (3, bx, by))
        written += (out,)
    on_card(where, pulse, planes, state_e, *written)   # one CUDA or CPU device
    return rows


def _window_rows(z: int, row0: int, out_stride: int, rows: int) -> slice:
    """The shard rows window ``z`` advances."""
    r = row0 + z * out_stride
    return slice(r, r + rows)



# ------------------------------------------------------------ B5 rounds
def sharded_round_reference(params: GridParams, t0: int, halo: int, kx: int,
                            ky: int, pulse, planes, state_e, acc, rec,
                            row0: int = 0, windows: int = 1,
                            out_stride: int = 0, out=None):
    """One round of one shard on its extended block (B5's plain version per
    shard), or on row windows of it (the overlap split's frames and
    interior): ``fdtd_step_folded`` on each window's whole extended block,
    on any device.

    Args:
      t0: the round's first step; it runs min(halo, T - t0) steps.
      halo: k, the round length.
      kx, ky: the extended block's ghost widths (0 on an unsharded axis).
      pulse: [T] source pulse.
      planes: [8, bx + 2kx, by + 2ky] from :func:`fold_planes`; with row
        windows, each window's extended block of rows + 2kx rows, stacked:
        [8, windows * (rows + 2kx), by + 2ky].
      state_e: [3, ...] the extended p, vx, vy in the planes' layout, p
        after the previous round's injection (zeros before the first
        round).
      acc: [6, bx, by] onset, flux_x, flux_y, e_dry, e_wet, e_total of the
        shard, the windows' rows updated in place.
      rec: [T, bx, by] the shard's recording; rows [t0, t0 + nsteps) of the
        windows' shard rows are written.
      row0, windows, out_stride: ``windows`` (1 or 2) row windows; window z
        advances shard rows [row0 + z * out_stride, + rows). The default,
        one window from row 0, is the plain round on the whole shard.
      out: [3, bx, by] buffer of the new state, written on the windows'
        rows (default: a new tensor).
    Returns ``out``: the new p (after the round's last injection), vx, vy.
    """
    t0, halo, kx, ky = int(t0), int(halo), int(kx), int(ky)
    row0, windows, out_stride = int(row0), int(windows), int(out_stride)
    rows = _check_round("sharded_round_reference", params, t0, halo, kx, ky,
                        pulse, planes, 8, state_e, acc, rec, row0, windows,
                        out_stride, out)
    scalars = window_scalars(params)
    bx, by = acc.shape[-2:]
    ex = state_e.shape[1] // windows
    if out is None:
        out = torch.empty((3, bx, by), dtype=torch.float32, device=acc.device)
    inner = (slice(kx, kx + rows), slice(ky, ky + by))
    for z in range(windows):
        r = _window_rows(z, row0, out_stride, rows)
        w = slice(z * ex, (z + 1) * ex)
        beta, *coefs, src = planes[:, w].unbind(0)
        p, vx, vy = state_e[:, w].unbind(0)
        a = tuple(acc[:, r].unbind(0))
        for t in range(t0, t0 + _nsteps(params, t0, halo)):
            p, vx, vy = fdtd_step_folded(p, vx, vy, beta, coefs, scalars[0])
            a = stream_step(t, p[inner], vx[inner], vy[inner], a, scalars)
            rec[t, r] = p[inner]   # record pre-injection, then inject
            p = p + src * pulse[t]
        acc[:, r] = torch.stack(a)
        out[:, r] = torch.stack([p[inner], vx[inner], vy[inner]])
    return out



# ------------------------------------------------------------ B6 rounds
def banded_round_reference(params: GridParams, t0: int, halo: int, pulse,
                           fields, geo, state_e, acc, rec, tile=None,
                           row0: int = 0, windows: int = 1,
                           out_stride: int = 0, out=None):
    """B6's plain version per shard: one round of one shard on its extended
    block with symmetric ghosts ``halo``, or on row windows of it, cut into
    tile windows (tile plus a halo-cell border, zeros beyond the extended
    block) batched, each folding its own coefficients and listener mask
    from its global coordinates; ``fdtd_step_folded`` on all of them, on
    any device.

    Arguments and returns as :func:`sharded_round_reference`, and:
      fields: [2, bx + 2k, by + 2k] beta and admittance Y of the extended
        block (with row windows, the windows' blocks stacked, as
        ``state_e``).
      geo: (gi0, gj0, lix, liy): the global coordinates of window 0's
        extended cell (0, 0) (window z's is z * out_stride rows further) and
        of the listener.
      tile: the windows' interior tile (default :data:`REFERENCE_TILE`; the
        results do not depend on it).
    """
    t0, k = int(t0), int(halo)
    row0, windows, out_stride = int(row0), int(windows), int(out_stride)
    rows = _check_round("banded_round_reference", params, t0, k, k, k, pulse,
                        fields, 2, state_e, acc, rec, row0, windows,
                        out_stride, out)
    tx, ty = _tile(REFERENCE_TILE if tile is None else tile)
    bx, by = acc.shape[-2:]
    ex = state_e.shape[1] // windows
    ntx, nty = -(-rows // tx), -(-by // ty)
    gi0, gj0, lix, liy = (int(v) for v in geo)
    scalars = window_scalars(params)
    dev = acc.device
    if out is None:
        out = torch.empty((3, bx, by), dtype=torch.float32, device=dev)

    def cut(x):
        # [rows + 2k, by + 2k] -> [ntx * nty, tx + 2k, ty + 2k], tile
        # window (a, b) at extended cell (a * tx, b * ty)
        x = F.pad(x, (0, nty * ty - by, 0, ntx * tx - rows))
        return (x.unfold(0, tx + 2 * k, tx).unfold(1, ty + 2 * k, ty)
                .reshape(ntx * nty, tx + 2 * k, ty + 2 * k))

    def tiles(x):
        x = F.pad(x, (0, nty * ty - by, 0, ntx * tx - rows))
        return (x.reshape(ntx, tx, nty, ty).permute(0, 2, 1, 3)
                .reshape(ntx * nty, tx, ty))

    def untile(x):
        return (x.reshape(ntx, nty, tx, ty).permute(0, 2, 1, 3)
                .reshape(ntx * tx, nty * ty)[:rows, :by])

    n = torch.arange(ntx * nty, device=dev)
    inner = (slice(None), slice(k, k + tx), slice(k, k + ty))
    for z in range(windows):
        r = _window_rows(z, row0, out_stride, rows)
        w = slice(z * ex, (z + 1) * ex)
        beta_w, y_w = cut(fields[0, w]), cut(fields[1, w])
        gi = ((gi0 + z * out_stride + (n // nty) * tx).view(-1, 1, 1)
              + torch.arange(tx + 2 * k, device=dev).view(1, -1, 1))
        gj = ((gj0 + (n % nty) * ty).view(-1, 1, 1)
              + torch.arange(ty + 2 * k, device=dev).view(1, 1, -1))
        coefs = stencil_coefficients(
            beta_w, y_w, F.pad(beta_w[:, :-1], (0, 0, 1, 0)),
            F.pad(y_w[:, :-1], (0, 0, 1, 0)),
            F.pad(beta_w[..., :-1], (1, 0)), F.pad(y_w[..., :-1], (1, 0)),
            gi, gj, params.grid_x, params.grid_y,
            params.boundary_type == BoundaryType.ABSORBING)
        src = ((gi == lix) & (gj == liy)).to(torch.float32)

        pw, vxw, vyw = (cut(s) for s in state_e[:, w].unbind(0))
        a = tuple(tiles(x) for x in acc[:, r].unbind(0))
        for t in range(t0, t0 + _nsteps(params, t0, halo)):
            pw, vxw, vyw = fdtd_step_folded(pw, vxw, vyw, beta_w, coefs,
                                            scalars[0])
            a = stream_step(t, pw[inner], vxw[inner], vyw[inner], a,
                            scalars)
            rec[t, r] = untile(pw[inner])
            pw = pw + src * pulse[t]
        acc[:, r] = torch.stack([untile(x) for x in a])
        out[:, r] = torch.stack([untile(v[inner]) for v in (pw, vxw, vyw)])
    return out


# ------------------------------------------------ one device's round launch
def _side(d: int, b: int, k: int) -> slice:
    """The rows (or columns) of a neighbour on side d (-1, 0, 1) that a
    shard's k ghosts read: its last k, all b, or its first k."""
    return (slice(b - k, b), slice(0, b), slice(0, k))[d + 1]


class _Shard:
    """One shard of a sharded pass: its state in two buffers (by round
    parity: round c reads ``state[c % 2]`` and writes the other), its
    accumulators [6, bx, by] and recording [T, bx, by], its extended beta
    and Y [2, bx + 2kx, by + 2ky] (exchanged once a simulation), and what
    it reads around it (:meth:`source`)."""

    def __init__(self, i: int, j: int, bx: int, by: int, T: int, device,
                 statics):
        self.i, self.j, self.bx, self.by = i, j, bx, by
        self.device = device
        self.state = torch.zeros((2, 3, bx, by), dtype=torch.float32,
                                 device=device)
        self.acc = torch.stack(fresh_acc((bx, by), device))
        self.rec = torch.empty((T, bx, by), dtype=torch.float32,
                               device=device)
        self.statics = statics.contiguous()
        # (dx, dy) -> (tensor, i0, j0, by parity): the neighbour's two
        # state buffers, read in place, or a ghost buffer [3, h, w] on this
        # shard's device. Tensors only: no shard refers to another, so a
        # pass's shards (and recordings) go as soon as it ends.
        self.near = {}
        # (buffer, the sender's state buffers, rows, cols): the slabs the
        # ghost buffers hold
        self.ghosts = []

    def source(self, dx: int, dy: int, parity: int):
        """(tensor [3, h, w], i0, j0): the state this shard's ghosts on side
        (dx, dy) read at the start of a round of ``parity``, and the shard
        cell of its element (0, 0); (0, 0) is the shard's own state. None
        beyond the global edge (zeros)."""
        if (dx, dy) == (0, 0):
            return self.state[parity], 0, 0
        n = self.near.get((dx, dy))
        if n is None:
            return None
        t, i0, j0, by_parity = n
        return (t[parity] if by_parity else t), i0, j0


class _Remote:
    """The ghost slabs a pass exchanges with other processes after a round:
    ``sends`` (a local shard's state buffers, the rows and columns a
    neighbour of another process reads, its rank, the tag) and ``recvs``
    (a local ghost buffer, the sender's rank, the tag), in one order on
    every process: by (sender position, receiver position, side)."""

    def __init__(self):
        self.sends, self.recvs = [], []

    def post(self, parity: int) -> multihost.Pending:
        """Start filling the ghost buffers from the senders' state of
        ``parity``; wait on the result before a launch reads them."""
        return multihost.post(
            [(state[parity][:, rows, cols], peer, tag)
             for state, rows, cols, peer, tag in self.sends], self.recvs)


def _pairs(mx: int, my: int, kx: int, ky: int):
    """Every (sender, receiver, side) of a pass's ghosts: the receiver's
    neighbour on side (dx, dy) sends the slab its ghosts there read."""
    out = []
    for i in range(mx):
        for j in range(my):
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    ni, nj = i + dx, j + dy
                    if ((dx, dy) == (0, 0) or (dx and not kx)
                            or (dy and not ky) or not 0 <= ni < mx
                            or not 0 <= nj < my):
                        continue
                    out.append(((ni, nj), (i, j), (dx, dy)))
    return out


def _ghost_buffer(s: _Shard, dx: int, dy: int, kx: int, ky: int):
    """A ghost buffer on shard ``s``'s device for its side (dx, dy), linked
    as that side's source; returns it with the neighbour's rows and
    columns it holds."""
    rows, cols = _side(dx, s.bx, kx), _side(dy, s.by, ky)
    buf = torch.zeros((3, rows.stop - rows.start, cols.stop - cols.start),
                      dtype=torch.float32, device=s.device)
    s.near[(dx, dy)] = (buf, (-kx, 0, s.bx)[dx + 1], (-ky, 0, s.by)[dy + 1],
                        False)
    return buf, rows, cols


def _link(shards, kx: int, ky: int, slabs: bool) -> None:
    """Give every local shard its neighbours of the same process on the
    sides its ghosts reach: a neighbour on the same device is read in
    place; one on another device (or every one, with ``slabs``) through a
    ghost buffer on the shard's device holding the slab its ghosts read.
    Neighbours of other processes are :func:`_link_remote`'s."""
    for (ni, nj), (i, j), (dx, dy) in _pairs(len(shards), len(shards[0]),
                                             kx, ky):
        s, n = shards[i][j], shards[ni][nj]
        if s is None or n is None:
            continue
        if n.device == s.device and not slabs:
            s.near[(dx, dy)] = (n.state, dx * s.bx, dy * s.by, True)
            continue
        buf, rows, cols = _ghost_buffer(s, dx, dy, kx, ky)
        s.ghosts.append((buf, n.state, rows, cols))


def _link_remote(shards, kx: int, ky: int, mesh: Mesh) -> _Remote:
    """Link every local shard's neighbours of other processes through
    ghost buffers, and list the slabs that cross processes after a round:
    the receives into those buffers and the sends of local shards' slabs
    to neighbours of other processes, tagged in one order on every
    process, by (sender position, receiver position, side)."""
    remote = _Remote()
    for tag, ((ni, nj), (i, j), (dx, dy)) in enumerate(sorted(_pairs(
            len(shards), len(shards[0]), kx, ky))):
        s, n = shards[i][j], shards[ni][nj]
        if s is not None and n is None:
            buf, _, _ = _ghost_buffer(s, dx, dy, kx, ky)
            remote.recvs.append((buf, mesh.ranks[ni][nj], tag))
        elif s is None and n is not None:
            remote.sends.append((n.state, _side(dx, n.bx, kx),
                                 _side(dy, n.by, ky), mesh.ranks[i][j], tag))
    return remote


class RoundLaunch:
    """One device's round launch for a simulation: a list of regions
    (shard, orow, rows), the extended blocks of ``rows`` interior rows of
    a shard from shard row ``orow``, with ghosts kx, ky, all on one device.

    On a card it holds the kernel's tile (:func:`pick_region_tile` over
    the regions' blocks), each region's scratch for the state between
    sub-rounds and the region table (``kernels.RoundRegion``) for either
    state parity, made once: the tensors the table points at live as long
    as the launch. The plain version (:func:`device_round_reference`)
    reads the same sources.
    """

    def __init__(self, params: GridParams, regions, kx: int, ky: int,
                 banded: bool, halo: int, pulse, lix: int, liy: int,
                 ref_tile):
        self.params = params
        self.regions = regions
        self.kx, self.ky, self.banded, self.halo = kx, ky, banded, halo
        self.pulse = pulse
        self.device = pulse.device
        self.lix, self.liy = lix, liy
        self.ref_tile = ref_tile
        self._planes = {}
        if self.device.type == "cuda":
            self._make_table()

    def blocks(self):
        """The regions' extended blocks, (rows, cols)."""
        return [(rows + 2 * self.kx, s.by + 2 * self.ky)
                for s, _, rows in self.regions]

    def _make_table(self) -> None:
        k = SUB_ROUND
        self.tile = tx, ty = pick_region_tile(
            self.blocks(), torch.cuda.get_device_properties(
                self.device).multi_processor_count)
        # the state between sub-rounds, where a round has more than one
        self.scratch = [torch.empty((2, 3, ex, ey), dtype=torch.float32,
                                    device=self.device)
                        if self.halo > k else None
                        for ex, ey in self.blocks()]
        n = len(self.regions)
        tables = []
        for parity in (0, 1):
            table = (kernels.RoundRegion * n)()
            tile0 = 0
            for q, ((s, orow, rows), (ex, ey)) in enumerate(
                    zip(self.regions, self.blocks())):
                reg = table[q]
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        src = s.source(dx, dy, parity)
                        if src is not None:
                            t, i0, j0 = src
                            reg.src[(dx + 1) * 3 + dy + 1] = \
                                kernels.RoundSource(t.data_ptr(), t.stride(0),
                                                    t.stride(1), i0, j0)
                reg.statics = s.statics[0, orow].data_ptr()
                reg.splane = s.statics.stride(0)
                if self.scratch[q] is not None:
                    reg.scratch = self.scratch[q].data_ptr()
                reg.rec, reg.acc = s.rec.data_ptr(), s.acc.data_ptr()
                reg.out = s.state[1 - parity].data_ptr()
                reg.ex, reg.ey, reg.kx, reg.ky = ex, ey, self.kx, self.ky
                reg.bx, reg.by, reg.orow, reg.rows = s.bx, s.by, orow, rows
                reg.oi = s.i * s.bx + orow - self.kx
                reg.oj = s.j * s.by - self.ky
                reg.tile0, reg.tiles_y = tile0, -(-ey // ty)
                tile0 += reg.tiles_y * -(-ex // tx)
            tables.append(bytes(table))
        self.tiles = tile0
        # one copy to the card, once a simulation
        self.table = torch.frombuffer(bytearray(b"".join(tables)),
                                      dtype=torch.uint8).to(self.device)
        bar = barrier_words(self.device, "round")
        size = ctypes.sizeof(kernels.RoundRegion)
        self.args = [(self.table.data_ptr() + parity * n * size,
                      self.pulse.data_ptr(), bar.data_ptr(), n, self.tiles,
                      tx, ty, k) for parity in (0, 1)]
        p = self.params
        self.tail = (self.lix, self.liy, p.grid_x, p.grid_y,
                     int(p.boundary_type == BoundaryType.ABSORBING),
                     int(self.banded), *window_scalars(p))

    def gather(self, s: _Shard, orow: int, rows: int, parity: int):
        """The extended state [3, rows + 2kx, by + 2ky] of a region at the
        start of a round of ``parity``, read from its shard's sources as
        the kernel reads them (zeros beyond the global edge): the exchange,
        as ``solver.py::_exchange_axes`` builds it, of the region's rows."""
        kx, ky, bx, by = self.kx, self.ky, s.bx, s.by
        lo, hi = orow - kx, orow + rows + kx

        def bands(a, b, n):
            return [(d, x, y) for d, x, y in ((-1, a, min(b, 0)),
                                              (0, max(a, 0), min(b, n)),
                                              (1, max(a, n), b)) if x < y]

        out = []
        for dx, a, b in bands(lo, hi, bx):
            row = []
            for dy, c, d in bands(-ky, by + ky, by):
                src = s.source(dx, dy, parity)
                if src is None:
                    row.append(torch.zeros((3, b - a, d - c),
                                           dtype=torch.float32,
                                           device=s.device))
                else:
                    t, i0, j0 = src
                    row.append(t[:, a - i0:b - i0, c - j0:d - j0])
            out.append(torch.cat(row, dim=-1))
        return torch.cat(out, dim=1)

    def planes(self, s: _Shard, orow: int, rows: int):
        """B5's plain version's eight planes of a region (folded once)."""
        key = (s.i, s.j, orow)
        if key not in self._planes:
            st = s.statics[:, orow:orow + rows + 2 * self.kx]
            self._planes[key] = fold_planes(
                self.params, st[0], st[1], s.i * s.bx + orow - self.kx,
                s.j * s.by - self.ky, self.lix, self.liy)
        return self._planes[key]


def device_round_reference(params: GridParams, t0: int, halo: int,
                           launch: RoundLaunch, parity: int) -> None:
    """Plain version of one device's round (B5 or B6, as ``launch``): each
    region's extended state read from its sources (:meth:`RoundLaunch.gather`,
    the exchange), then the per-shard plain round on it
    (:func:`sharded_round_reference` / :func:`banded_round_reference`),
    writing the region's rows of its shard's recording, accumulators and
    new state (``state[1 - parity]``); on any device."""
    kx, ky = launch.kx, launch.ky
    for s, orow, rows in launch.regions:
        ext = launch.gather(s, orow, rows, parity)
        out = s.state[1 - parity]
        if launch.banded:
            geo = (s.i * s.bx + orow - kx, s.j * s.by - ky, launch.lix,
                   launch.liy)
            banded_round_reference(
                params, t0, halo, launch.pulse,
                s.statics[:, orow:orow + rows + 2 * kx], geo, ext, s.acc,
                s.rec, launch.ref_tile, row0=orow, out=out)
        else:
            sharded_round_reference(params, t0, halo, kx, ky, launch.pulse,
                                    launch.planes(s, orow, rows), ext, s.acc,
                                    s.rec, row0=orow, out=out)


def _device_round(where: str, wrapper, params: GridParams, t0: int,
                  halo: int, launch: RoundLaunch, parity: int,
                  banded: bool) -> None:
    T = params.response_length
    t0, halo, parity = int(t0), int(halo), int(parity)
    if not 0 <= t0 < T or halo != launch.halo or parity not in (0, 1):
        raise ValueError(f"{where}: need 0 <= t0 < T ({t0}, {T}), the "
                         f"launch's halo ({halo}, {launch.halo}) and a "
                         f"parity of 0 or 1 ({parity})")
    if launch.banded != banded:
        raise ValueError(f"{where}: the launch's regions are "
                         f"{'B6' if launch.banded else 'B5'}'s")
    if not on_card(where, launch.pulse):
        device_round_reference(params, t0, halo, launch, parity)
        return
    lib = kernels.library()
    with torch.cuda.device(launch.device):
        stream = torch.cuda.current_stream(launch.device).cuda_stream
        err = lib.pv_device_round(*launch.args[parity], t0,
                                  _nsteps(params, t0, halo), *launch.tail,
                                  stream)
    kernels.check(err, where)
    wrapper.launches += 1


@counted
def sharded_round(params: GridParams, t0: int, halo: int,
                  launch: RoundLaunch, parity: int) -> None:
    """One round (B5) of every region of ``launch``, one device's shards or
    their row windows: min(halo, T - t0) steps from t0 on each region's
    extended block, reading the state of parity ``parity`` (the shards'
    and their neighbours', or ghost buffers) and writing the regions'
    rows of their shards' recording (rows [t0, t0 + nsteps)),
    accumulators and new state (``state[1 - parity]``, p after the round's
    last injection). One launch on a card; the plain version
    (:func:`device_round_reference`) on the CPU."""
    _device_round("sharded_round", sharded_round, params, t0, halo, launch,
                  parity, banded=False)


@counted
def banded_round(params: GridParams, t0: int, halo: int, launch: RoundLaunch,
                 parity: int) -> None:
    """:func:`sharded_round` for B6 launches (symmetric ghosts k on both
    axes), the route of shards above ``fdtd_fused.TILED_MIN_CELLS`` cells
    and of ``band_rows``."""
    _device_round("banded_round", banded_round, params, t0, halo, launch,
                  parity, banded=True)



# ------------------------------------------------------------ the engine
def _delegate_tiled_1x1(params, beta_b, refl_b, pulse, lix, liy,
                        nx_pad, ny_pad, reference, with_moments):
    """The exchange-free 1x1 route beyond B5's size: the tiled B3 (+ B4) on
    the field, padded to the sharded contract's [nx_pad, ny_pad] with
    silent cells (onset +inf, the rest 0)."""
    nx, ny = params.nx, params.ny
    beta, refl = beta_b[0][0][:nx, :ny], refl_b[0][0][:nx, :ny]
    args = (params, beta, refl, pulse.to(beta.device), lix, liy)
    if with_moments:
        fn = (fdtd_tiled.simulate_moments_tiled_reference if reference
              else fdtd_tiled.simulate_moments_tiled)
        res, mom = fn(*args)
    else:
        fn = (fdtd_tiled.fdtd_sim_tiled_reference if reference
              else fdtd_tiled.fdtd_sim_tiled)
        res, _ = fn(*args)
        mom = None

    def fit(x, value=0.0):
        if x.shape[-2:] == (nx_pad, ny_pad):
            return x
        return F.pad(x, (0, ny_pad - ny, 0, nx_pad - nx), value=value)

    def one(fields, infs=()):
        return {n: [[fit(v, float("inf") if n in infs else 0.0)]]
                for n, v in fields._asdict().items()}

    out = Sharded(FdtdResult, one(res, ("onset",)))
    return out, (None if mom is None else Sharded(Moments, one(mom)))


def _round_fn(banded: bool, reference: bool):
    if reference:
        return device_round_reference
    return banded_round if banded else sharded_round


def _shards(mesh: Mesh, beta, y, bx: int, by: int, kx: int, ky: int,
            T: int):
    """The calling process's shards (None at other processes' positions),
    their beta and Y extended by kx / ky ghosts (once a simulation):
    ``beta``/``y`` are block grids, or on a multi-process mesh the whole
    padded fields (``solver.py::extend_statics``)."""
    beta_e, y_e = extend_statics(mesh, beta, y, kx, ky)
    return [[_Shard(i, j, bx, by, T, d, torch.stack([beta_e[i][j],
                                                     y_e[i][j]]))
             if mesh.is_local(i, j) else None
             for j, d in enumerate(row)] for i, row in enumerate(mesh.devices)]


def _launches(params, shards, regions_of, kx, ky, banded, k, pulse_on, lix,
              liy, ref_tile):
    """One :class:`RoundLaunch` per device, over ``regions_of(shard)`` of
    each of its shards, in mesh order."""
    by_device = {}
    for row in shards:
        for s in row:
            if s is not None:
                by_device.setdefault(s.device, []).extend(regions_of(s))
    return [RoundLaunch(params, regions, kx, ky, banded, k, pulse_on(dev),
                        lix, liy, ref_tile)
            for dev, regions in by_device.items()]


def _results(shards):
    return ([[None if s is None else s.rec for s in row] for row in shards],
            [[None if s is None else s.acc for s in row] for row in shards])


def _ghosts(shards):
    return [g for row in shards for s in row if s is not None
            for g in s.ghosts]


def _plain_rounds(params, mesh, statics, pulse_on, lix, liy, bx, by, k,
                  ref_tile, banded, reference, slabs):
    """The plain rounds: every round, one launch per device advances each
    of its shards on its whole extended block, its ghosts read from its
    neighbours' round-start state (in place on the same device, else from
    ghost buffers refreshed after the round: ``.to``-style copies, ordered
    with both devices' streams, and from other processes one
    ``multihost.post``, waited on before the next launch). ``slabs``
    takes the ghost buffers for every neighbour. Returns the (rec, acc)
    block grids."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    T = params.response_length
    kx, ky = (k, k) if banded else (k if mx > 1 else 0, k if my > 1 else 0)
    shards = _shards(mesh, *statics, bx, by, kx, ky, T)
    remote = _link_remote(shards, kx, ky, mesh)
    _link(shards, kx, ky, slabs)
    launches = _launches(params, shards, lambda s: [(s, 0, bx)], kx, ky,
                         banded, k, pulse_on, lix, liy, ref_tile)
    ghosts = _ghosts(shards)
    step = _round_fn(banded, reference)
    parity = 0
    for t0 in range(0, T, k):
        for launch in launches:
            step(params, t0, k, launch, parity)
        parity ^= 1
        if t0 + k < T:
            for buf, sent, rows, cols in ghosts:
                buf.copy_(sent[parity][:, rows, cols], non_blocking=True)
            remote.post(parity).wait()
    return _results(shards)


def _overlap_rounds(params, mesh, statics, pulse_on, lix, liy, bx, by,
                    k, ref_tile, banded, reference, slabs):
    """The overlap split of the rounds on a 1D ("x", N) mesh with bx >= 3k,
    counterpart of ``solver_pallas.py::_overlap_impl`` (B5) and
    ``_overlap_banded_impl`` (B6). Per round (``solver_pallas.py:489-521``):

      1. one frame launch per device advances the top and bottom k rows of
         each of its shards, two regions of 3k rows, [top ghost k | rows
         0:2k] and [rows bx-2k:bx | bottom ghost k], from the round-start
         state; the ghosts are the neighbours' frames, read in place on the
         same device or from ghost buffers;
      2. the new frames are copied into the ghost buffers of neighbours on
         other devices (``solver.py::_exchange_frames``: side streams),
         which depends only on step 1; on one device nothing is copied;
         the frames of neighbours of other processes are posted
         (``multihost.post``) and waited on before the next frame launch;
      3. one interior launch per device advances rows [k, bx - k) of each
         of its shards, a region whose block is the shard's own bx rows; it
         does not wait for the exchange.

    The launches write their rows of the shard's one recording,
    accumulators and new state in place, so nothing is concatenated after
    them, and each cell goes through the plain rounds' ops: the split is
    bit-equal to them. B5's regions have no ghost columns (y is
    unsharded); B6's have k zero ones. ``slabs`` takes the ghost buffers
    on one device too. Returns the (rec, acc) block grids.
    """
    T = params.response_length
    ky = k if banded else 0
    shards = _shards(mesh, *statics, bx, by, k, ky, T)
    remote = _link_remote(shards, k, ky, mesh)
    _link(shards, k, ky, slabs)
    frames = _launches(params, shards,
                       lambda s: [(s, 0, k), (s, bx - k, k)], k, ky, banded,
                       k, pulse_on, lix, liy, ref_tile)
    inner = _launches(params, shards, lambda s: [(s, k, bx - 2 * k)], k, ky,
                      banded, k, pulse_on, lix, liy, ref_tile)
    ghosts = _ghosts(shards)
    step = _round_fn(banded, reference)
    parity = 0
    copies = pending = None
    for t0 in range(0, T, k):
        if pending is not None:
            pending.wait()
        for launch in frames:
            if copies is not None:
                copies.wait(launch.device)
            step(params, t0, k, launch, parity)
        copies = _exchange_frames(
            [(sent[1 - parity][:, rows, cols], buf)
             for buf, sent, rows, cols in ghosts])
        if t0 + k < T:
            pending = remote.post(1 - parity)
        for launch in inner:
            step(params, t0, k, launch, parity)
        parity ^= 1
    return _results(shards)


def _moments_by_device(params, rec, acc, many):
    """Each shard's (s0, s1) as a block grid, from one call of ``many``
    (B2 over a list of recordings) per device, over the recordings and
    onsets of every shard on it."""
    on = {}
    for i, row in enumerate(rec):
        for j, r in enumerate(row):
            if r is not None:
                on.setdefault(r.device, []).append((i, j))
    out = [[None] * len(row) for row in rec]
    for cells in on.values():
        got = many(params, [rec[i][j] for i, j in cells],
                   [acc[i][j][0] for i, j in cells])
        for (i, j), m in zip(cells, got):
            out[i][j] = m
    return out


def _simulate_impl(params: GridParams, beta, refl, pulse, lix, liy,
                   mesh: Mesh, nx_pad: int, ny_pad: int, halo: int,
                   band_rows, overlap: bool, reference: bool,
                   with_moments: bool, slabs: bool = False):
    """The sharded pass behind the public functions. ``slabs`` (for tests
    and the card's smoke run only) reads every neighbour's ghosts through
    ghost buffers, the path of neighbours on other devices, even where
    they share a device."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    if (nx_pad % mx or ny_pad % my or nx_pad < params.nx
            or ny_pad < params.ny):
        raise ValueError(f"padded field ({nx_pad}, {ny_pad}) must cover "
                         f"({params.nx}, {params.ny}) and divide over the "
                         f"{mx}x{my} mesh (see pad_to_mesh)")
    bx, by = nx_pad // mx, ny_pad // my
    k = int(halo)
    if not 1 <= k <= min(bx, by):
        raise ValueError(f"halo {k} exceeds shard block ({bx}, {by}) or is "
                         f"below 1")
    if overlap:
        # the JAX module's preconditions and messages
        if my != 1:
            raise ValueError(
                f"overlap=True needs a 1D ('x', N) mesh (y unsharded; "
                f"got {mx}x{my}) — the boundary-frame split exchanges "
                f"contiguous row slabs")
        if mx > 1 and bx < 3 * k:
            raise ValueError(
                f"overlap=True needs shard rows >= 3*halo (frame + "
                f"doomed fringe + frame), got bx={bx} < {3 * k}")
        # a single shard exchanges nothing: the plain rounds below are
        # already free of communication
        overlap = mx > 1
    beta_b, refl_b, statics = static_blocks("sharded", mesh, beta, refl,
                                            nx_pad, ny_pad)
    T = params.response_length
    check_field("sharded", "pulse", pulse, (T,))
    lix, liy = int(lix), int(liy)
    if not (0 <= lix < params.nx and 0 <= liy < params.ny):
        lix = liy = _NOWHERE    # a listener outside the field injects nothing
    banded = (band_rows is not None
              or bx * by > fdtd_fused.TILED_MIN_CELLS)
    if banded and mx == my == 1 and band_rows is None:
        return _delegate_tiled_1x1(params, beta_b, refl_b, pulse, lix, liy,
                                   nx_pad, ny_pad, reference, with_moments)

    pulses = {}

    def pulse_on(dev):
        if dev not in pulses:
            pulses[dev] = pulse.to(dev)
        return pulses[dev]

    rounds = _overlap_rounds if overlap else _plain_rounds
    ref_tile = REFERENCE_TILE if band_rows is None else _tile(band_rows)
    rec, acc = rounds(params, mesh, statics, pulse_on, lix, liy, bx, by,
                      k, ref_tile, banded, reference, slabs)

    def grid(c):
        return [[None if a is None else a[c] for a in row] for row in acc]

    res = Sharded(FdtdResult, {"pressure": rec, "onset": grid(0),
                               "flux_x": grid(1), "flux_y": grid(2)}, mesh)
    if not with_moments:
        return res, None
    # each shard's moments from its own recording, the split's included (a
    # cell's moments read only its own column): one B2 launch per device
    # over all its shards' recordings, or one B4 launch per shard
    if banded:
        moments = (fdtd_tiled.rt60_moments_tiled_reference if reference
                   else fdtd_tiled.rt60_moments_tiled)
        s = [[None if r is None else moments(params, r, a[0])
              for r, a in zip(*rows)] for rows in zip(rec, acc)]
    else:
        s = _moments_by_device(params, rec, acc,
                               fdtd_fused.rt60_moments_many_reference
                               if reference else fdtd_fused.rt60_moments_many)
    mom = Sharded(Moments, {
        "e_dry": grid(3), "e_wet": grid(4), "e_total": grid(5),
        "s0": [[None if v is None else v[0] for v in row] for row in s],
        "s1": [[None if v is None else v[1] for v in row] for row in s]},
        mesh)
    return res, mom



def simulate_sharded_fused(params: GridParams, beta, refl, pulse,
                           listener_ix: int, listener_iy: int, mesh: Mesh,
                           nx_pad: int, ny_pad: int, halo: int = 16,
                           band_rows: int | None = None,
                           overlap: bool = False) -> Sharded:
    """One simulation pass sharded over ``mesh``.

    ``beta``/``refl`` are the [nx_pad, ny_pad] fields padded with beta = 0
    (``mesh.pad_to_mesh``), as tensors or as ``shard_fields`` block grids;
    ``halo`` is the round length and ghost width k; ``band_rows`` forces
    B6 with ``band_rows`` x ``band_rows`` tiles. Returns the per-shard
    :class:`Sharded` FdtdResult, whose ``assemble(device)`` is the padded
    [T, nx_pad, ny_pad] recording and [nx_pad, ny_pad] onset/flux, equal to
    the single-device pass on [:nx, :ny].

    ``overlap=True`` takes the overlap split of the rounds
    (:func:`_overlap_rounds`: frame launch, frame exchange, interior
    launch), bit-equal to the plain rounds. As in the JAX module it needs
    a 1D ("x", N) mesh and shard rows bx >= 3 * halo where N > 1, and
    raises ValueError otherwise; on a 1x1 mesh it takes the plain rounds.
    """
    res, _ = _simulate_impl(params, beta, refl, pulse, listener_ix,
                            listener_iy, mesh, nx_pad, ny_pad, halo,
                            band_rows, overlap, reference=False,
                            with_moments=False)
    return res


def simulate_sharded_reference(params: GridParams, beta, refl, pulse,
                               listener_ix: int, listener_iy: int,
                               mesh: Mesh, nx_pad: int, ny_pad: int,
                               halo: int = 16,
                               band_rows: int | None = None,
                               overlap: bool = False) -> Sharded:
    """:func:`simulate_sharded_fused` with the plain versions of the round
    kernels (B3's on a delegated 1x1 mesh), on any device."""
    res, _ = _simulate_impl(params, beta, refl, pulse, listener_ix,
                            listener_iy, mesh, nx_pad, ny_pad, halo,
                            band_rows, overlap, reference=True,
                            with_moments=False)
    return res


def simulate_moments_sharded(params: GridParams, beta, refl, pulse,
                             listener_ix: int, listener_iy: int, mesh: Mesh,
                             nx_pad: int, ny_pad: int, halo: int = 16,
                             band_rows: int | None = None,
                             overlap: bool = False):
    """Sharded pass + analyzer moments: (Sharded FdtdResult, Sharded
    Moments), every grid per shard; each shard's RT60 moments come from its
    own recording (B2 after B5, B4 after B6). Arguments as
    :func:`simulate_sharded_fused`."""
    return _simulate_impl(params, beta, refl, pulse, listener_ix,
                          listener_iy, mesh, nx_pad, ny_pad, halo,
                          band_rows, overlap, reference=False,
                          with_moments=True)


def simulate_moments_sharded_reference(params: GridParams, beta, refl,
                                       pulse, listener_ix: int,
                                       listener_iy: int, mesh: Mesh,
                                       nx_pad: int, ny_pad: int,
                                       halo: int = 16,
                                       band_rows: int | None = None,
                                       overlap: bool = False):
    """:func:`simulate_moments_sharded` with the plain versions of every
    kernel (B5/B6, B2/B4; B3 on a delegated 1x1 mesh), on any device."""
    return _simulate_impl(params, beta, refl, pulse, listener_ix,
                          listener_iy, mesh, nx_pad, ny_pad, halo,
                          band_rows, overlap, reference=True,
                          with_moments=True)


def pipeline_sharded(params: GridParams, beta, refl, pulse,
                     listener_ix: int, listener_iy: int, mesh: Mesh,
                     nx_pad: int, ny_pad: int, efree: float,
                     listener_x: float, listener_z: float, halo: int = 16,
                     compute_directions: bool = True,
                     band_rows: int | None = None, overlap: bool = False
                     ) -> tuple[Sharded, AnalyzerResults]:
    """Full sharded pass: :func:`simulate_moments_sharded`, then the five
    moment grids and onset/flux assembled on the mesh's first device,
    cropped to [nx, ny], and parameter assembly (and DOA unless
    ``compute_directions`` is False) there. Returns (the per-shard
    Sharded FdtdResult, AnalyzerResults); the recordings stay on their
    shards."""
    res, mom = simulate_moments_sharded(
        params, beta, refl, pulse, listener_ix, listener_iy, mesh, nx_pad,
        ny_pad, halo=halo, band_rows=band_rows, overlap=overlap)
    dev = mesh.local_device
    nx, ny = params.nx, params.ny

    def crop(fields, name):
        return fields.field(name, dev)[:nx, :ny]

    moments = Moments(*(crop(mom, n) for n in Moments._fields))
    out = analyzer.analyze_moments(
        params, moments, crop(res, "onset"), crop(res, "flux_x"),
        crop(res, "flux_y"), efree, listener_x, listener_z,
        compute_directions=compute_directions)
    return res, out

