"""Large-world route: temporally blocked FDTD (B3) and chunked RT60 moments
(B4).

Counterpart of ``planeverb_tpu/ops/fdtd_tiled.py``. Two wrappers, each with
its hand-written CUDA kernel (``csrc/fdtd_tiled.cu``) and a plain PyTorch
version of the same algorithm:

  - :func:`fdtd_sim_tiled` (B3, replaces ``fdtd_tiled.py::_tiled_kernel``):
    the whole pass of :func:`~planeverb_tpu_torch.ops.fdtd_fused.fdtd_sim`
    in rounds of ``halo`` steps. The field is cut into tiles; each tile's
    window (the tile plus a ``halo``-cell border on every side, zero outside
    the field) advances ``halo`` steps on its own, which leaves the tile
    interior exact because the stencil reaches one cell per step. The
    listener's pulse is injected in every window that holds the listener
    cell, halo copies included. The interiors are written back after each
    round; the last round runs the remaining ``T - c * halo`` steps.
  - :func:`rt60_moments_tiled` (B4, replaces
    ``fdtd_tiled.py::_tiled_moments_kernel``): B2's backward pass, walking
    reverse time chunks of ``chunk`` steps, newest first.

The outputs equal B1's and B2's: the recording is exactly [T, nx, ny], the
fields [nx, ny]. Dispatch is as in ``ops/fdtd_fused.py``: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version, any
other device raises, and nothing falls back. Each wrapper counts its
launches in its ``launches`` attribute (one per call);
``fdtd_fused.reset_launch_counts`` resets them. ``fdtd_fused.pipeline_auto``
routes grids above ``fdtd_fused.TILED_MIN_CELLS`` cells here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops._common import (check_field, coefficients,
                                             fresh_acc, moment_scalars,
                                             moment_step, on_card,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import Moments
from planeverb_tpu_torch.ops.fdtd import FdtdResult, fdtd_step_folded

__all__ = ["TILES", "HALO", "CHUNK", "pick_tile", "fdtd_sim_tiled",
           "fdtd_sim_tiled_reference", "rt60_moments_tiled",
           "rt60_moments_tiled_reference", "simulate_moments_tiled",
           "simulate_moments_tiled_reference"]

# Interior tiles the card's kernel chooses from, with HALO the border and
# steps per launch. probe_tiled.py sweeps the tilings: on an H100 80GB HBM3
# at 700 W a 32 x 64 interior (a 48 x 80 window: 10 planes plus the tile's
# 6 accumulator planes, 203 KB of shared memory) was the fastest at k = 8
# at 459^2 and 964^2, and 32 x 32 (117 KB) at 192^2 and 261^2, whose
# 32 x 64 tiles leave most SMs idle. Each holds one block per SM;
# :func:`pick_tile` chooses between them.
TILES = ((32, 64), (32, 32))
HALO = 8
# B4: reverse chunks of CHUNK steps (any chunk gives the same result). In
# probe_tiled.py's sweeps on the H100, chunks of 32 to 4096 ran within
# 10 % of B2 at 261^2 to 964^2, chunks of 8 up to 18 % behind it.
CHUNK = 32


def pick_tile(nx: int, ny: int, halo: int, n_sm: int) -> tuple[int, int]:
    """The tile of :data:`TILES` with the least modelled round time on a
    card with ``n_sm`` SMs: waves of blocks (one block per SM) times the
    cells of a window. Ties go to the earlier tile."""
    def cost(tile):
        tx, ty = tile
        blocks = -(-nx // tx) * -(-ny // ty)
        return -(-blocks // n_sm) * (tx + 2 * halo) * (ty + 2 * halo)

    return min(TILES, key=cost)


def _tiling(tile, halo) -> tuple[int, int, int]:
    """(tile_x, tile_y, k) from a tile (int or (x, y); None: the first of
    :data:`TILES`) and a halo (None: :data:`HALO`)."""
    if tile is None:
        tile = TILES[0]
    tx, ty = (tile, tile) if isinstance(tile, int) else tuple(tile)
    k = HALO if halo is None else halo
    tx, ty, k = int(tx), int(ty), int(k)
    if min(tx, ty, k) < 1:
        raise ValueError(f"tile {tile} and halo {halo} must be >= 1")
    return tx, ty, k


# ----------------------------------------------------------------- B3 sim
def _windows(x, tx: int, ty: int, k: int, ntx: int, nty: int):
    """[nx, ny] field -> [ntx * nty, tx + 2k, ty + 2k] windows, window
    (a, b) starting at global cell (a * tx - k, b * ty - k); cells outside
    the field are 0."""
    nx, ny = x.shape
    padded = F.pad(x, (k, nty * ty - ny + k, k, ntx * tx - nx + k))
    w = padded.unfold(0, tx + 2 * k, tx).unfold(1, ty + 2 * k, ty)
    return w.reshape(ntx * nty, tx + 2 * k, ty + 2 * k)


def _assemble(inner, ntx: int, nty: int, nx: int, ny: int):
    """[ntx * nty, tx, ty] tile interiors -> the [nx, ny] field."""
    _, tx, ty = inner.shape
    return (inner.reshape(ntx, nty, tx, ty).permute(0, 2, 1, 3)
            .reshape(ntx * tx, nty * ty)[:nx, :ny])


def _listener_slots(lix: int, liy: int, nx: int, ny: int, tx: int, ty: int,
                    k: int, ntx: int, nty: int):
    """Index of the listener cell in every window that holds it (interior
    or halo), as (window, i, j) index tensors; None without a listener in
    the field."""
    if not (0 <= lix < nx and 0 <= liy < ny):
        return None
    slots = []
    for a in range(ntx):
        for b in range(nty):
            i, j = lix - (a * tx - k), liy - (b * ty - k)
            if 0 <= i < tx + 2 * k and 0 <= j < ty + 2 * k:
                slots.append((a * nty + b, i, j))
    return tuple(torch.tensor(v) for v in zip(*slots))


def fdtd_sim_tiled_reference(params: GridParams, beta, refl, pulse,
                             lix: int, liy: int, tile=None, halo=None):
    """Plain version of B3: all windows batched, ``halo`` steps of
    ``fdtd_step_folded`` per round, on any device.

    Returns (FdtdResult, (e_dry, e_wet, e_total)), equal to
    ``fdtd_fused.fdtd_sim_reference``'s.
    """
    tx, ty, k = _tiling(tile, halo)
    nx, ny, T = params.nx, params.ny, params.response_length
    scalars = window_scalars(params)
    dev = beta.device
    ntx, nty = -(-nx // tx), -(-ny // ty)

    def windows(x):
        return _windows(x, tx, ty, k, ntx, nty)

    def assemble(w):
        return _assemble(w[:, k:k + tx, k:k + ty], ntx, nty, nx, ny)

    beta_w = windows(beta)
    coefs_w = tuple(windows(c) for c in coefficients(params, beta, refl))
    slots = _listener_slots(lix, liy, nx, ny, tx, ty, k, ntx, nty)

    p = vx = vy = torch.zeros((nx, ny), dtype=torch.float32, device=dev)
    acc = fresh_acc((ntx * nty, tx, ty), dev)
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)
    for t0 in range(0, T, k):
        pw, vxw, vyw = windows(p), windows(vx), windows(vy)
        for t in range(t0, min(t0 + k, T)):
            pw, vxw, vyw = fdtd_step_folded(pw, vxw, vyw, beta_w, coefs_w,
                                            scalars[0])
            inner = [w[:, k:k + tx, k:k + ty] for w in (pw, vxw, vyw)]
            acc = stream_step(t, *inner, acc, scalars)
            rec[t] = _assemble(inner[0], ntx, nty, nx, ny)
            if slots is not None:   # every copy of the listener cell
                pw[slots] = pw[slots] + pulse[t]
        p, vx, vy = assemble(pw), assemble(vxw), assemble(vyw)
    onset, fx, fy, ed, ew, et = (_assemble(a, ntx, nty, nx, ny) for a in acc)
    res = FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy)
    return res, (ed, ew, et)


def _launch_fdtd_sim_tiled(params: GridParams, beta, refl, pulse,
                           lix: int, liy: int, tx: int, ty: int, k: int):
    nx, ny, T = params.nx, params.ny, params.response_length
    courant, thr, src_dir_n, dry_n, wet_n = window_scalars(params)
    coefs = coefficients(params, beta, refl)
    fields = [c.contiguous() for c in (beta, *coefs)]
    pulse = pulse.contiguous()
    dev = beta.device
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)
    acc = torch.empty((6, nx, ny), dtype=torch.float32, device=dev)
    state = torch.empty((2, 3, nx, ny), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_fdtd_sim_tiled(
            *(f.data_ptr() for f in fields), pulse.data_ptr(),
            rec.data_ptr(), *(a.data_ptr() for a in acc),
            *(s.data_ptr() for s in state.flatten(0, 1)), nx, ny, T,
            tx, ty, k, lix, liy, courant, thr, src_dir_n, dry_n, wet_n,
            stream)
    kernels.check(err, "fdtd_sim_tiled")
    fdtd_sim_tiled.launches += 1
    onset, fx, fy, ed, ew, et = acc.unbind(0)
    return (FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


def fdtd_sim_tiled(params: GridParams, beta, refl, pulse, lix: int,
                   liy: int, tile=None, halo=None):
    """One simulation pass in rounds of ``halo`` steps over tiles (B3).

    Arguments and returns as ``fdtd_fused.fdtd_sim``; ``tile`` is the
    interior (int or (x, y)) and ``halo`` the border and steps per round
    (default :data:`HALO`). Without a tile the card's kernel takes
    :func:`pick_tile`'s and the plain version the first of :data:`TILES`;
    the results do not depend on it. On the card a window the kernel cannot
    hold (wider than 1024 cells or beyond the shared memory limit) fails at
    launch and raises.
    """
    where = "fdtd_sim_tiled"
    nx, ny = params.nx, params.ny
    check_field(where, "beta", beta, (nx, ny))
    check_field(where, "refl", refl, (nx, ny))
    check_field(where, "pulse", pulse, (params.response_length,))
    tx, ty, k = _tiling(tile, halo)
    lix, liy = int(lix), int(liy)
    if on_card(where, beta, refl, pulse):
        if tile is None:
            n_sm = torch.cuda.get_device_properties(
                beta.device).multi_processor_count
            tx, ty = pick_tile(nx, ny, k, n_sm)
        return _launch_fdtd_sim_tiled(params, beta, refl, pulse, lix, liy,
                                      tx, ty, k)
    return fdtd_sim_tiled_reference(params, beta, refl, pulse, lix, liy,
                                    tile=(tx, ty), halo=k)


fdtd_sim_tiled.launches = 0


# ------------------------------------------------------------- B4 moments
def _chunk(chunk) -> int:
    chunk = CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be >= 1")
    return chunk


def rt60_moments_tiled_reference(params: GridParams, rec, onset,
                                 chunk=None):
    """Plain version of B4: reverse chunks of ``chunk`` steps, newest
    first, each walked backward in B2's summation order. Returns (s0, s1),
    equal to ``fdtd_fused.rt60_moments_reference``'s."""
    chunk = _chunk(chunk)
    dry_n1, end, log10_scale = moment_scalars(params)
    start = onset + dry_n1
    carry = (torch.zeros_like(onset),) * 3
    T = rec.shape[0]
    for t_lo in reversed(range(0, T, chunk)):
        for t in reversed(range(t_lo, min(t_lo + chunk, T))):
            carry = moment_step(t, rec[t], start, end, log10_scale, carry)
    return carry[1], carry[2]


def rt60_moments_tiled(params: GridParams, rec, onset, chunk=None):
    """RT60 regression moments (s0, s1) from the [T, nx, ny] recording and
    the [nx, ny] onset, walked in reverse chunks of ``chunk`` steps (B4;
    default :data:`CHUNK`). The kernel reads the recording in place."""
    where = "rt60_moments_tiled"
    nx, ny, T = params.nx, params.ny, params.response_length
    check_field(where, "rec", rec, (T, nx, ny))
    check_field(where, "onset", onset, (nx, ny))
    chunk = _chunk(chunk)
    if not on_card(where, rec, onset):
        return rt60_moments_tiled_reference(params, rec, onset, chunk)
    if not rec.is_contiguous():
        raise ValueError(f"{where}: the recording must be contiguous (the "
                         f"kernel reads it in place; no copy is made)")
    onset = onset.contiguous()
    s = torch.empty((2, nx, ny), dtype=torch.float32, device=rec.device)
    dry_n1, end, log10_scale = moment_scalars(params)
    lib = kernels.library()
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        err = lib.pv_rt60_moments_tiled(
            rec.data_ptr(), onset.data_ptr(), s[0].data_ptr(),
            s[1].data_ptr(), nx, ny, T, chunk, dry_n1, end, log10_scale,
            stream)
    kernels.check(err, where)
    rt60_moments_tiled.launches += 1
    return s[0], s[1]


rt60_moments_tiled.launches = 0


# ------------------------------------------------------------ compositions
def simulate_moments_tiled(params: GridParams, beta, refl, pulse,
                           lix: int, liy: int, tile=None, halo=None,
                           chunk=None):
    """Sim + analyzer moments: B3 then B4. Returns (FdtdResult, Moments)."""
    res, (ed, ew, et) = fdtd_sim_tiled(params, beta, refl, pulse, lix, liy,
                                       tile=tile, halo=halo)
    s0, s1 = rt60_moments_tiled(params, res.pressure, res.onset, chunk)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_tiled_reference(params: GridParams, beta, refl, pulse,
                                     lix: int, liy: int, tile=None,
                                     halo=None, chunk=None):
    """Plain versions of B3 then B4 on any device."""
    res, (ed, ew, et) = fdtd_sim_tiled_reference(
        params, beta, refl, pulse, lix, liy, tile=tile, halo=halo)
    s0, s1 = rt60_moments_tiled_reference(params, res.pressure, res.onset,
                                          chunk)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)
