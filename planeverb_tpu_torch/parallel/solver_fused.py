"""Sharded engine: fused rounds (B5) and banded rounds (B6) between ghost
exchanges.

Counterpart of ``planeverb_tpu/parallel/solver_pallas.py``. The field is
padded to the mesh (beta = 0, silent) and cut into [bx, by] shards. A pass
runs in rounds of k = ``halo`` steps (the last round has T - t0): before
each round every shard's state is extended by ghosts from its neighbours
(``parallel/solver.py::_exchange_axes``), then each shard advances its
extended block alone. With ``overlap=True`` on a 1D ("x", N) mesh, each
round is split instead (:func:`_overlap_rounds`): a frame launch advances
the shard's top and bottom k rows, their new rows are exchanged, and an
interior launch that does not wait for the exchange advances the rest.
Two kernels, each with its hand-written CUDA kernel
(``csrc/solver_rounds.cu``) and a plain PyTorch version, both taking row
windows for the split:

  - :func:`sharded_round` (B5, replaces ``solver_pallas.py::_round_kernel``):
    per-axis ghosts (k on a sharded axis, 0 on an unsharded one, whose
    block edge is the global edge), reading eight planes folded once per
    simulation on the extended block in global coordinates
    (:func:`fold_planes`: beta, the six stencil coefficients of
    ``ops/fdtd.py::stencil_coefficients`` and the listener mask).
  - :func:`banded_round` (B6, replaces
    ``solver_pallas.py::_banded_round_kernel``): symmetric ghosts k,
    reading only beta and the wall admittance Y and folding the
    coefficients and the listener mask inside the round, in each window,
    from the window's global coordinates ``geo = (gi0, gj0, lix, liy)``.

Why the interior is exact (the cone argument): one step reads one cell
back (velocities read p at i-1, j-1) and one cell ahead (pressure reads v
at i+1, j+1), so a value wrong at a block's edge at the start of a round
reaches at most s cells inward after s steps. The extended block's edge and
every window's edge are at least k cells from the cells that survive, and a
round has at most k steps, so the zero shifts at those edges, the wrong
folded coefficients on their first row and column, and whatever lies
beyond them never reach the interior: it evolves bit for bit as the
single-device solver does. Every copy of the listener cell, ghosts
included, is injected, so ghost cells evolve as their owners do.

Each round records the interior's pre-injection pressure into rows
[t0, t0 + nsteps) of the shard's [T, bx, by] recording and streams the
interior accumulators (onset, flux, windowed energies), with the round's
time offset in every moment window. After the rounds each shard's moments
come from its own recording: B2 (``fdtd_fused.rt60_moments``) after B5, B4
(``fdtd_tiled.rt60_moments_tiled``) after B6; the recordings stay on their
devices.

Route, per shard: B5 up to ``fdtd_fused.TILED_MIN_CELLS`` cells, B6 above;
``band_rows`` forces B6. A 1x1 mesh that would take B6, without
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

import torch
import torch.nn.functional as F

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops import analyzer, fdtd_fused, fdtd_tiled
from planeverb_tpu_torch.ops._common import (check_field, counted,
                                             fresh_acc, on_card,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import (FdtdResult, admittance,
                                          fdtd_step_folded,
                                          stencil_coefficients)
from planeverb_tpu_torch.parallel.mesh import Mesh
from planeverb_tpu_torch.parallel.solver import (_exchange_axes,
                                                 _exchange_frames, assemble,
                                                 shard_fields)

__all__ = ["Sharded", "ROUND_TILES", "pick_round_tile", "fold_planes",
           "sharded_round", "sharded_round_reference", "banded_round",
           "banded_round_reference", "simulate_sharded_fused",
           "simulate_sharded_reference", "simulate_moments_sharded",
           "simulate_moments_sharded_reference", "pipeline_sharded"]

# Interior tiles the round kernels choose from (each block keeps its tile's
# window, the tile plus a halo-cell border, in shared memory):
# :func:`pick_round_tile` chooses by a model of the round's time.
ROUND_TILES = ((32, 32), (16, 32), (16, 16), (8, 8))
# Dynamic shared memory one block may use on Hopper (227 KB)
SMEM_BYTES = 232448
# Global coordinates no window reaches: a listener outside the field
_NOWHERE = -(1 << 30)


class Sharded:
    """Per-shard fields of a sharded pass.

    ``blocks[name]`` is a block grid: ``mesh.shape["x"]`` rows of
    ``mesh.shape["y"]`` tensors [..., bx, by], each on its shard's device
    (the recording [T, bx, by], the grids [bx, by]). ``kind`` is the
    NamedTuple the fields make up (``FdtdResult`` or ``analyzer.Moments``);
    :meth:`assemble` builds it, padded to [nx_pad, ny_pad], on one device.
    """

    def __init__(self, kind, blocks: dict):
        self.kind = kind
        self.blocks = blocks

    def field(self, name: str, device) -> torch.Tensor:
        """One field, assembled on ``device``."""
        return assemble(self.blocks[name], device)

    def assemble(self, device):
        return self.kind(**{n: self.field(n, device)
                            for n in self.kind._fields})

    def at(self, name: str, i: int, j: int) -> torch.Tensor:
        """The values of global cell (i, j), read from its owning shard."""
        grid = self.blocks[name]
        bx, by = grid[0][0].shape[-2:]
        return grid[i // bx][j // by][..., i % bx, j % by]


def round_smem_bytes(tile, halo: int) -> int:
    """Shared memory of one round block: 11 window planes and the tile's 6
    accumulator planes (``csrc/solver_rounds.cu::round_smem_bytes``)."""
    tx, ty = tile
    return ((tx + 2 * halo) * (ty + 2 * halo) * 11 + tx * ty * 6) * 4


def pick_round_tile(bx: int, by: int, halo: int, n_sm: int,
                    windows: int = 1):
    """The tile of :data:`ROUND_TILES` with the least modelled round time on
    a [bx, by] shard (or ``windows`` row windows of bx rows) and a card with
    ``n_sm`` SMs: waves of blocks (one block per SM) times the cells of a
    window, as ``fdtd_tiled.pick_tile``. Tiles whose window exceeds shared
    memory are skipped; with none left the smallest stays, and its launch
    raises."""
    def cost(tile):
        tx, ty = tile
        blocks = windows * -(-bx // tx) * -(-by // ty)
        return -(-blocks // n_sm) * (tx + 2 * halo) * (ty + 2 * halo)

    fits = [t for t in ROUND_TILES
            if round_smem_bytes(t, halo) <= SMEM_BYTES
            and t[1] + 2 * halo <= 1024]
    return min(fits or ROUND_TILES[-1:], key=cost)


def _tile(tile) -> tuple[int, int]:
    tx, ty = (tile, tile) if isinstance(tile, int) else tuple(tile)
    if min(tx, ty) < 1:
        raise ValueError(f"tile {tile} must be >= 1")
    return int(tx), int(ty)


def fold_planes(params: GridParams, beta_e, y_e, gi0: int, gj0: int,
                lix: int, liy: int) -> torch.Tensor:
    """B5's eight planes of an extended block: beta, the six coefficients
    of ``ops/fdtd.py::stencil_coefficients`` and the listener mask, as one
    [8, ex, ey] tensor. ``beta_e``/``y_e`` are the exchanged beta and
    admittance blocks, (gi0, gj0) the global coordinates of their cell
    (0, 0). Folded once per simulation; the wrong values the block edge's
    zero shifts give its first row and column lie outside the cone of the
    interior."""
    ex, ey = beta_e.shape
    dev = beta_e.device
    b_xm = F.pad(beta_e[:-1], (0, 0, 1, 0))
    y_xm = F.pad(y_e[:-1], (0, 0, 1, 0))
    b_ym = F.pad(beta_e[:, :-1], (1, 0))
    y_ym = F.pad(y_e[:, :-1], (1, 0))
    gi = (gi0 + torch.arange(ex, device=dev)).view(ex, 1)
    gj = (gj0 + torch.arange(ey, device=dev)).view(1, ey)
    coefs = stencil_coefficients(
        beta_e, y_e, b_xm, y_xm, b_ym, y_ym, gi, gj, params.grid_x,
        params.grid_y, params.boundary_type == BoundaryType.ABSORBING)
    src = ((gi == lix) & (gj == liy)).to(torch.float32).expand(ex, ey)
    return torch.stack([beta_e, *coefs, src])


def _nsteps(params: GridParams, t0: int, halo: int) -> int:
    return min(halo, params.response_length - t0)


def _check_round(where, params, t0, halo, kx, ky, pulse, planes, n_planes,
                 state_e, acc, rec, row0, windows, out_stride, out):
    """Argument checks of a round wrapper. Returns (True where it launches,
    the rows each window advances)."""
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
    card = on_card(where, pulse, planes, state_e, *written)
    if card and not all(t.is_contiguous() for t in written):
        raise ValueError(f"{where}: acc, rec and out must be contiguous (the "
                         f"kernel writes them in place)")
    return card, rows


def _window_rows(z: int, row0: int, out_stride: int, rows: int) -> slice:
    """The shard rows window ``z`` advances."""
    r = row0 + z * out_stride
    return slice(r, r + rows)


# ------------------------------------------------------------ B5 rounds
def sharded_round_reference(params: GridParams, t0: int, halo: int, kx: int,
                            ky: int, pulse, planes, state_e, acc, rec,
                            row0: int = 0, windows: int = 1,
                            out_stride: int = 0, out=None):
    """Plain version of B5: ``fdtd_step_folded`` on each window's whole
    extended block, on any device. Arguments and returns as
    :func:`sharded_round`."""
    scalars = window_scalars(params)
    bx, by = acc.shape[-2:]
    ex = state_e.shape[1] // windows
    rows = ex - 2 * kx
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


@counted
def sharded_round(params: GridParams, t0: int, halo: int, kx: int, ky: int,
                  pulse, planes, state_e, acc, rec, tile=None, row0: int = 0,
                  windows: int = 1, out_stride: int = 0, out=None):
    """One round of one shard on its extended block (B5), or on row windows
    of it (the overlap split's frames and interior).

    Args:
      t0: the round's first step; it runs min(halo, T - t0) steps.
      halo: k, the round length and the kernel's window border.
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
      tile: the kernel's interior tile (default :func:`pick_round_tile`'s);
        the results do not depend on it.
      row0, windows, out_stride: ``windows`` (1 or 2) row windows; window z
        advances shard rows [row0 + z * out_stride, + rows). The default,
        one window from row 0, is the plain round on the whole shard.
      out: [3, bx, by] buffer of the new state, written on the windows'
        rows (default: a new tensor).
    Returns ``out``: the new p (after the round's last injection), vx, vy.
    """
    where = "sharded_round"
    t0, halo, kx, ky = int(t0), int(halo), int(kx), int(ky)
    row0, windows, out_stride = int(row0), int(windows), int(out_stride)
    card, rows = _check_round(where, params, t0, halo, kx, ky, pulse, planes,
                              8, state_e, acc, rec, row0, windows,
                              out_stride, out)
    if not card:
        return sharded_round_reference(params, t0, halo, kx, ky, pulse,
                                       planes, state_e, acc, rec, row0,
                                       windows, out_stride, out)
    bx, by = acc.shape[-2:]
    dev = acc.device
    tx, ty = _tile(tile) if tile is not None else pick_round_tile(
        rows, by, halo,
        torch.cuda.get_device_properties(dev).multi_processor_count, windows)
    planes = planes.contiguous()
    state_e = state_e.contiguous()
    pulse = pulse.contiguous()
    if out is None:
        out = torch.empty((3, bx, by), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_sharded_round(
            planes.data_ptr(), state_e.data_ptr(),
            pulse.data_ptr(), rec.data_ptr(), acc.data_ptr(),
            out.data_ptr(), rows, by, kx, ky, windows, bx, row0, out_stride,
            t0, _nsteps(params, t0, halo), halo, tx, ty,
            *window_scalars(params), stream)
    kernels.check(err, where)
    sharded_round.launches += 1
    return out


# ------------------------------------------------------------ B6 rounds
def banded_round_reference(params: GridParams, t0: int, halo: int, pulse,
                           fields, geo, state_e, acc, rec, tile=None,
                           row0: int = 0, windows: int = 1,
                           out_stride: int = 0, out=None):
    """Plain version of B6: per row window, the kernel's tile windows
    (tile plus a halo-cell border, zeros beyond the extended block)
    batched, each folding its own coefficients and listener mask,
    ``fdtd_step_folded`` on all of them; on any device. Arguments and
    returns as :func:`banded_round` (default tile: the first of
    :data:`ROUND_TILES`)."""
    k = halo
    tx, ty = _tile(ROUND_TILES[0] if tile is None else tile)
    bx, by = acc.shape[-2:]
    ex = state_e.shape[1] // windows
    rows = ex - 2 * k
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


@counted
def banded_round(params: GridParams, t0: int, halo: int, pulse, fields,
                 geo, state_e, acc, rec, tile=None, row0: int = 0,
                 windows: int = 1, out_stride: int = 0, out=None):
    """One round of one shard on its extended block, or on row windows of
    it, folding in the round (B6).

    Arguments and returns as :func:`sharded_round`, with symmetric ghosts
    ``halo`` on both axes, and:
      fields: [2, bx + 2k, by + 2k] beta and admittance Y of the extended
        block (with row windows, the windows' blocks stacked, as
        ``state_e``).
      geo: (gi0, gj0, lix, liy): the global coordinates of window 0's
        extended cell (0, 0) (window z's is z * out_stride rows further) and
        of the listener.
      tile: the interior tile of the kernel and of the plain version's
        windows (the results do not depend on it).
    """
    where = "banded_round"
    t0, halo = int(t0), int(halo)
    row0, windows, out_stride = int(row0), int(windows), int(out_stride)
    card, rows = _check_round(where, params, t0, halo, halo, halo, pulse,
                              fields, 2, state_e, acc, rec, row0, windows,
                              out_stride, out)
    if not card:
        return banded_round_reference(params, t0, halo, pulse, fields, geo,
                                      state_e, acc, rec, tile, row0, windows,
                                      out_stride, out)
    bx, by = acc.shape[-2:]
    dev = acc.device
    tx, ty = _tile(tile) if tile is not None else pick_round_tile(
        rows, by, halo,
        torch.cuda.get_device_properties(dev).multi_processor_count, windows)
    gi0, gj0, lix, liy = (int(v) for v in geo)
    fields = fields.contiguous()
    state_e = state_e.contiguous()
    pulse = pulse.contiguous()
    if out is None:
        out = torch.empty((3, bx, by), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_banded_round(
            fields.data_ptr(), state_e.data_ptr(),
            pulse.data_ptr(), rec.data_ptr(), acc.data_ptr(),
            out.data_ptr(), rows, by, halo, windows, bx, row0, out_stride,
            t0, _nsteps(params, t0, halo), tx, ty, gi0, gj0, lix, liy,
            params.grid_x, params.grid_y,
            int(params.boundary_type == BoundaryType.ABSORBING),
            *window_scalars(params), stream)
    kernels.check(err, where)
    banded_round.launches += 1
    return out


# ------------------------------------------------------------ the engine
def _blocks(mesh: Mesh, name: str, x, nx_pad: int, ny_pad: int):
    """A [nx_pad, ny_pad] field as the mesh's block grid: a tensor is
    sharded, a block grid (from ``shard_fields``) is checked."""
    where = "sharded"
    if isinstance(x, torch.Tensor):
        check_field(where, name, x, (nx_pad, ny_pad))
        return shard_fields(mesh, x)[0]
    mx, my = mesh.shape["x"], mesh.shape["y"]
    if len(x) != mx or any(len(row) != my for row in x):
        raise ValueError(f"{where}: {name} is not a {mx}x{my} block grid")
    for i, row in enumerate(x):
        for j, b in enumerate(row):
            check_field(where, name, b, (nx_pad // mx, ny_pad // my))
            if b.device != mesh.devices[i][j]:
                raise ValueError(f"{where}: {name} block ({i}, {j}) is on "
                                 f"{b.device}, its shard on "
                                 f"{mesh.devices[i][j]}")
    return x


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


def _round_tile(mesh: Mesh, band_rows, rows: int, by: int, k: int,
                windows: int = 1):
    """The interior tile of a shard's round launches: ``band_rows``'s
    square when given, :func:`pick_round_tile`'s on a card, else the first
    of :data:`ROUND_TILES` (the plain B6's windows)."""
    if band_rows is not None:
        return int(band_rows), int(band_rows)
    if mesh.device_type == "cuda":
        return pick_round_tile(rows, by, k, torch.cuda.get_device_properties(
            mesh.first_device).multi_processor_count, windows)
    return ROUND_TILES[0]


def _plain_rounds(params, mesh, beta_b, y_b, pulse_on, lix, liy, bx, by, k,
                  band_rows, banded, reference):
    """The plain rounds: every round, each shard's state is extended by its
    neighbours' ghosts and advanced by one B5 or B6 launch on the whole
    extended block. Returns the (rec, acc) block grids."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    T = params.response_length
    tile = _round_tile(mesh, band_rows, bx, by, k)
    kx, ky = (k, k) if banded else (k if mx > 1 else 0, k if my > 1 else 0)
    beta_e = _exchange_axes(beta_b, kx, ky)
    y_e = _exchange_axes(y_b, kx, ky)

    if banded:
        statics = [[torch.stack([b, y]) for b, y in zip(*rows)]
                   for rows in zip(beta_e, y_e)]
        fn = banded_round_reference if reference else banded_round

        def run(i, j, t0, state_e):
            geo = (i * bx - k, j * by - k, lix, liy)
            return fn(params, t0, k, pulse_on(rec[i][j].device),
                      statics[i][j], geo, state_e, acc[i][j], rec[i][j],
                      tile=tile)
    else:
        statics = [[fold_planes(params, beta_e[i][j], y_e[i][j],
                                i * bx - kx, j * by - ky, lix, liy)
                    for j in range(my)] for i in range(mx)]

        def run(i, j, t0, state_e):
            args = (params, t0, k, kx, ky, pulse_on(rec[i][j].device),
                    statics[i][j], state_e, acc[i][j], rec[i][j])
            if reference:
                return sharded_round_reference(*args)
            return sharded_round(*args, tile=tile)

    devs = mesh.devices
    state = [[torch.zeros((3, bx, by), dtype=torch.float32, device=d)
              for d in row] for row in devs]
    acc = [[torch.stack(fresh_acc((bx, by), d)) for d in row]
           for row in devs]
    rec = [[torch.empty((T, bx, by), dtype=torch.float32, device=d)
            for d in row] for row in devs]
    for t0 in range(0, T, k):
        # every shard's extended state is built, from the previous round's
        # outputs, before any shard's round runs
        ext = _exchange_axes(state, kx, ky)
        state = [[run(i, j, t0, ext[i][j]) for j in range(my)]
                 for i in range(mx)]
    return rec, acc


def _overlap_rounds(params, mesh, beta_b, y_b, pulse_on, lix, liy, bx, by,
                    k, band_rows, banded, reference):
    """The overlap split of the rounds on a 1D ("x", N) mesh with bx >= 3k,
    counterpart of ``solver_pallas.py::_overlap_impl`` (B5) and
    ``_overlap_banded_impl`` (B6). Per round and shard
    (``solver_pallas.py:489-521``):

      1. one frame launch advances the shard's top and bottom k rows in two
         3k-row windows, [top ghost k | rows 0:2k] and [rows bx-2k:bx |
         bottom ghost k], from the round-start state and last round's
         ghosts (zeros in round 0: the field is at rest);
      2. the new frames are exchanged (``solver.py::_exchange_frames``),
         which depends only on step 1;
      3. the interior launch advances rows [k, bx - k) from the round-start
         state itself, a window of the shard's bx rows whose frame rows are
         its fringe; it does not wait for the exchange.

    Both launches write their rows of the shard's one recording,
    accumulators and new state in place (the row windows of
    :func:`sharded_round` / :func:`banded_round`), so nothing is
    concatenated after them, and each cell goes through the plain rounds'
    ops: the split is bit-equal to them. B5's windows read slices of the
    planes folded on the [bx + 2k, by] extended block (y is unsharded);
    B6's read beta and Y with symmetric ghosts (zero columns on a 1D mesh)
    and fold from ``geo``: frames from global row px*bx - k (then bx - k
    rows further), the interior from px*bx. The windows' statics are made
    contiguous once per simulation. Returns the (rec, acc) block grids.
    """
    T = params.response_length
    devs = [row[0] for row in mesh.devices]
    ky = k if banded else 0
    beta_e = _exchange_axes(beta_b, k, ky)
    y_e = _exchange_axes(y_b, k, ky)

    def split(x):
        # [P, bx + 2k, cols] -> (the frames' two 3k-row windows stacked,
        # [P, 6k, cols]; the interior's, [P, bx, cols])
        return (torch.cat([x[:, :3 * k], x[:, bx - k:]], dim=1),
                x[:, k:k + bx].contiguous())

    if banded:
        statics = [split(torch.stack([b, y])) for (b,), (y,) in
                   zip(beta_e, y_e)]
    else:
        statics = [split(fold_planes(params, b, y, i * bx - k, 0, lix, liy))
                   for i, ((b,), (y,)) in enumerate(zip(beta_e, y_e))]
    # the launches' row windows (0: the frames, 1: the interior) and tiles
    wins = ({"row0": 0, "windows": 2, "out_stride": bx - k}, {"row0": k})
    tiles = (_round_tile(mesh, band_rows, k, by, k, 2),
             _round_tile(mesh, band_rows, bx - 2 * k, by, k))

    def launch(i, t0, w, state_w, out):
        pulse = pulse_on(devs[i])
        if banded:
            geo = (i * bx - k if w == 0 else i * bx, -k, lix, liy)
            fn = banded_round_reference if reference else banded_round
            fn(params, t0, k, pulse, statics[i][w], geo,
               F.pad(state_w, (k, k)), acc[i], rec[i], tiles[w], out=out,
               **wins[w])
        elif reference:
            sharded_round_reference(params, t0, k, k, 0, pulse, statics[i][w],
                                    state_w, acc[i], rec[i], out=out,
                                    **wins[w])
        else:
            sharded_round(params, t0, k, k, 0, pulse, statics[i][w], state_w,
                          acc[i], rec[i], tiles[w], out=out, **wins[w])

    state = [torch.zeros((3, bx, by), dtype=torch.float32, device=d)
             for d in devs]
    acc = [torch.stack(fresh_acc((bx, by), d)) for d in devs]
    rec = [torch.empty((T, bx, by), dtype=torch.float32, device=d)
           for d in devs]
    top = [torch.zeros((3, k, by), dtype=torch.float32, device=d)
           for d in devs]
    bot = [torch.zeros_like(g) for g in top]
    copies = None
    for t0 in range(0, T, k):
        new = [torch.empty((3, bx, by), dtype=torch.float32, device=d)
               for d in devs]
        for i, d in enumerate(devs):
            if copies is not None:
                copies.wait(d)
            frames = torch.cat([top[i], state[i][:, :2 * k],
                                state[i][:, bx - 2 * k:], bot[i]], dim=1)
            launch(i, t0, 0, frames, new[i])
        top, bot, copies = _exchange_frames(new, k)
        for i in range(len(devs)):
            launch(i, t0, 1, state[i], new[i])
        state = new
    return [[r] for r in rec], [[a] for a in acc]


def _simulate_impl(params: GridParams, beta, refl, pulse, lix, liy,
                   mesh: Mesh, nx_pad: int, ny_pad: int, halo: int,
                   band_rows, overlap: bool, reference: bool,
                   with_moments: bool):
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
    beta_b = _blocks(mesh, "beta", beta, nx_pad, ny_pad)
    refl_b = _blocks(mesh, "refl", refl, nx_pad, ny_pad)
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

    y_b = [[admittance(r) for r in row] for row in refl_b]
    pulses = {}

    def pulse_on(dev):
        if dev not in pulses:
            pulses[dev] = pulse.to(dev)
        return pulses[dev]

    rounds = _overlap_rounds if overlap else _plain_rounds
    rec, acc = rounds(params, mesh, beta_b, y_b, pulse_on, lix, liy, bx, by,
                      k, band_rows, banded, reference)

    def grid(c):
        return [[a[c] for a in row] for row in acc]

    res = Sharded(FdtdResult, {"pressure": rec, "onset": grid(0),
                               "flux_x": grid(1), "flux_y": grid(2)})
    if not with_moments:
        return res, None
    # one B2 or B4 launch per shard on its recording, the split's included:
    # a cell's moments read only its own column of the recording
    if banded:
        moments = (fdtd_tiled.rt60_moments_tiled_reference if reference
                   else fdtd_tiled.rt60_moments_tiled)
    else:
        moments = (fdtd_fused.rt60_moments_reference if reference
                   else fdtd_fused.rt60_moments)
    s = [[moments(params, r, a[0]) for r, a in zip(*rows)]
         for rows in zip(rec, acc)]
    mom = Sharded(Moments, {
        "e_dry": grid(3), "e_wet": grid(4), "e_total": grid(5),
        "s0": [[v[0] for v in row] for row in s],
        "s1": [[v[1] for v in row] for row in s]})
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
    dev = mesh.first_device
    nx, ny = params.nx, params.ny

    def crop(fields, name):
        return fields.field(name, dev)[:nx, :ny]

    moments = Moments(*(crop(mom, n) for n in Moments._fields))
    out = analyzer.analyze_moments(
        params, moments, crop(res, "onset"), crop(res, "flux_x"),
        crop(res, "flux_y"), efree, listener_x, listener_z,
        compute_directions=compute_directions)
    return res, out
