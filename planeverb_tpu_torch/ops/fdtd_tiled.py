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
``fdtd_fused.reset_launch_counts`` resets them. ``fdtd_fused.route_tiled``
decides which passes come here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops._common import (barrier_words, check_field,
                                             coefficients, counted,
                                             fresh_acc,
                                             moment_scalars, moment_step,
                                             moments_shape, on_card,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import Moments
from planeverb_tpu_torch.ops.fdtd import (FdtdResult, admittance,
                                          fdtd_step_folded)
from planeverb_tpu_torch.utils.profiling import count, spanned

__all__ = ["CHUNK", "RUN", "MAX_THREADS", "K_RANGE", "C_ROUND", "C_STEP",
           "GLOBAL_ACC_COST", "PLAIN_PLAN", "PLANS", "block_shape",
           "acc_fits", "plan_cost", "plan_tiled", "window_rounds",
           "fdtd_sim_tiled", "fdtd_sim_tiled_probe",
           "fdtd_sim_tiled_reference", "rt60_moments_tiled",
           "rt60_moments_tiled_reference", "simulate_moments_tiled",
           "simulate_moments_tiled_reference"]

# B4: reverse chunks of CHUNK steps (any chunk gives the same result). In
# probe_tiled.py's sweeps on the H100, chunks of 32 to 4096 ran within
# 10 % of B2 at 261^2 to 964^2, chunks of 8 up to 18 % behind it.
CHUNK = 32
# Rows of a window column each thread of the card's kernel holds
# (csrc/fdtd_tiled.cu kRun), and the most threads a block takes (its
# __launch_bounds__): about 110 registers a thread hold one 512-thread block
# per SM.
RUN = 4
MAX_THREADS = 512
# B3's round plan (:func:`plan_tiled`): the round depths k it considers;
# in window cells (what a round's loads, fold and write-back cost a window
# cell), a round's fixed cost (its grid barrier and loop) and a window's
# step (two block barriers and the shuffles: a latency, much the same for
# any window of up to MAX_THREADS threads); and the cost of a plan whose
# accumulators stay in global memory against the same plan's in shared
# memory. C_ROUND and C_STEP are probe_tiled.py's fit over all 111 plans at
# 192^2, 459^2 and 964^2 on an H100 80GB HBM3 at 700 W: its passes of
# 0-step rounds give 3.510 us a round and 1.332 ns a window cell, the
# full passes' rest 0.703 us a window's step; GLOBAL_ACC_COST is the
# median of its global-memory passes over the same plans' (1.135 to 1.344
# at 459^2 and 964^2, PERF.md).
K_RANGE = range(4, 9)
C_ROUND = 2635
C_STEP = 528
GLOBAL_ACC_COST = 1.18
# The plan the plain version takes without one (its results do not depend
# on the plan).
PLAIN_PLAN = (20, 52, 6)


def block_shape(tile_x: int, tile_y: int, k: int) -> tuple[int, int]:
    """(lanes, runs) of a B3 block on the card: one thread a window column,
    rounded up to whole warps of 32, by runs of :data:`RUN` window rows. A
    block of more than :data:`MAX_THREADS` fails at launch and raises."""
    lanes = -(-(tile_y + 2 * k) // 32) * 32
    return lanes, -(-(tile_x + 2 * k) // RUN)


def _plans() -> tuple[tuple[int, int, int], ...]:
    """Every (tile_x, tile_y, k) B3's plan chooses from: for each k of
    :data:`K_RANGE` and each block of whole warps and at most
    :data:`MAX_THREADS` threads, the largest tile its window holds (a
    smaller tile in the same block costs as much a window and makes no
    fewer windows); the widest windows first, which win ties (32 x 64
    windows ran 3 % faster than 64 x 32 at 964^2, PERF.md)."""
    out = []
    for k in K_RANGE:
        for lanes in range(MAX_THREADS, 31, -32):
            for runs in range(1, MAX_THREADS // lanes + 1):
                tx, ty = RUN * runs - 2 * k, lanes - 2 * k
                if tx >= 1 and ty >= 1:
                    out.append((tx, ty, k))
    return tuple(out)


PLANS = _plans()


def _windows_of(nx: int, ny: int, tx: int, ty: int) -> int:
    return -(-nx // tx) * -(-ny // ty)


def acc_fits(nx: int, ny: int, plan, n_sm: int, smem_optin: int) -> bool:
    """Whether the card's launcher keeps the plan's accumulators in shared
    memory (csrc/windows.cuh acc_fits): the block's run and warp edges and a
    [6][tile cells] float slot for each tile it steps fit the shared memory
    a block may opt into."""
    tx, ty, k = plan
    lanes, runs = block_shape(tx, ty, k)
    edges = 2 * runs * lanes + 2 * (lanes // 32) * runs * RUN
    windows = _windows_of(nx, ny, tx, ty)
    per_block = -(-windows // min(windows, n_sm))
    return 4 * (edges + per_block * 6 * tx * ty) <= smem_optin


def plan_cost(nx: int, ny: int, T: int, plan, n_sm: int,
              smem_optin: int) -> float:
    """The modelled time of a B3 pass of T steps over an [nx, ny] field on
    a card of ``n_sm`` SMs, in window cells: every round waits at the grid
    barrier for the busiest SM, which loads, steps and writes back its
    windows one after another. So a pass costs its rounds times (the
    busiest SM's windows times a block's cells, plus :data:`C_ROUND`), and
    the busiest SM's windows times T steps of :data:`C_STEP` each (the
    rounds' steps add up to T); times :data:`GLOBAL_ACC_COST` where the
    accumulators do not fit shared memory."""
    tx, ty, k = plan
    lanes, runs = block_shape(tx, ty, k)
    busiest = -(-_windows_of(nx, ny, tx, ty) // n_sm)
    cost = (-(-T // k) * (busiest * lanes * runs * RUN + C_ROUND)
            + busiest * T * C_STEP)
    if not acc_fits(nx, ny, plan, n_sm, smem_optin):
        cost *= GLOBAL_ACC_COST
    return cost


@functools.lru_cache(maxsize=64)
def plan_tiled(nx: int, ny: int, T: int, n_sm: int,
               smem_optin: int) -> tuple[int, int, int]:
    """B3's round plan (tile_x, tile_y, k) for an [nx, ny] field and T
    steps on a card of ``n_sm`` SMs whose blocks may opt into
    ``smem_optin`` bytes of shared memory: the plan of :data:`PLANS` with
    the least :func:`plan_cost`, ties to the earlier one. Cached: the
    engine asks once a pass."""
    return min(PLANS, key=lambda plan: plan_cost(nx, ny, T, plan, n_sm,
                                                   smem_optin))


def window_rounds(nx: int, ny: int, T: int, plan, n_sm: int) -> int:
    """The window-rounds a B3 pass waits for: its rounds times the windows
    the busiest SM steps in each (the program's ``solver.window_rounds``
    counter)."""
    tx, ty, k = plan
    return -(-T // k) * -(-_windows_of(nx, ny, tx, ty) // n_sm)


def _tiling(tile, halo) -> tuple[int, int, int]:
    """(tile_x, tile_y, k) from a tile (int or (x, y)) and a halo, each
    None for :data:`PLAIN_PLAN`'s."""
    if tile is None:
        tile = PLAIN_PLAN[:2]
    tx, ty = (tile, tile) if isinstance(tile, int) else tuple(tile)
    k = PLAIN_PLAN[2] if halo is None else halo
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
                           lix: int, liy: int, tx: int, ty: int, k: int,
                           probe=None):
    """The card's B3 pass: one cooperative launch (the C launcher keeps the
    accumulators in shared memory where they fit). ``probe``: (dry,
    global_acc) of :func:`fdtd_sim_tiled_probe`, through the probe's own
    entry point."""
    nx, ny, T = params.nx, params.ny, params.response_length
    courant, thr, src_dir_n, dry_n, wet_n = window_scalars(params)
    # the kernel folds the coefficients from beta and the admittance
    fields = [beta.contiguous(), admittance(refl).contiguous()]
    pulse = pulse.contiguous()
    dev = beta.device
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)
    acc = torch.empty((6, nx, ny), dtype=torch.float32, device=dev)
    state = torch.empty((2, 3, nx, ny), dtype=torch.float32, device=dev)
    bar = barrier_words(dev, "fdtd_tiled")
    absorbing = params.boundary_type == BoundaryType.ABSORBING
    lib = kernels.library()
    args = (*(f.data_ptr() for f in fields), pulse.data_ptr(),
            rec.data_ptr(), *(a.data_ptr() for a in acc),
            *(s.data_ptr() for s in state.flatten(0, 1)), bar.data_ptr(),
            nx, ny, T, tx, ty, k, lix, liy, params.grid_x, params.grid_y,
            int(absorbing), courant, thr, src_dir_n, dry_n, wet_n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if probe is None:
            err = lib.pv_fdtd_sim_tiled(*args, stream)
        else:
            err = lib.pv_fdtd_sim_tiled_probe(*args, *map(int, probe),
                                              stream)
    kernels.check(err, "fdtd_sim_tiled")
    onset, fx, fy, ed, ew, et = acc.unbind(0)
    return (FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


@counted
@spanned("solver")
def fdtd_sim_tiled(params: GridParams, beta, refl, pulse, lix: int,
                   liy: int, tile=None, halo=None):
    """One simulation pass in rounds of ``halo`` steps over tiles (B3).

    Arguments and returns as ``fdtd_fused.fdtd_sim``; ``tile`` is the
    interior (int or (x, y)) and ``halo`` the border and steps per round.
    Without either the card's kernel takes :func:`plan_tiled`'s plan for
    the field and the card, and the plain version :data:`PLAIN_PLAN`; the
    results do not depend on the plan. On the card the pass is one
    cooperative launch, and it adds its :func:`window_rounds` to the
    step's ``solver.window_rounds`` counter; a window the kernel cannot
    hold (more than :data:`MAX_THREADS` threads, :func:`block_shape`)
    fails at launch and raises.
    """
    where = "fdtd_sim_tiled"
    nx, ny = params.nx, params.ny
    check_field(where, "beta", beta, (nx, ny))
    check_field(where, "refl", refl, (nx, ny))
    check_field(where, "pulse", pulse, (params.response_length,))
    tx, ty, k = _tiling(tile, halo)
    lix, liy = int(lix), int(liy)
    if on_card(where, beta, refl, pulse):
        props = torch.cuda.get_device_properties(beta.device)
        n_sm = props.multi_processor_count
        T = params.response_length
        if tile is None and halo is None:
            tx, ty, k = plan_tiled(nx, ny, T, n_sm,
                                   props.shared_memory_per_block_optin)
        out = _launch_fdtd_sim_tiled(params, beta, refl, pulse, lix, liy,
                                     tx, ty, k)
        fdtd_sim_tiled.launches += 1
        count("solver.window_rounds",
              window_rounds(nx, ny, T, (tx, ty, k), n_sm))
        return out
    return fdtd_sim_tiled_reference(params, beta, refl, pulse, lix, liy,
                                    tile=(tx, ty), halo=k)


def fdtd_sim_tiled_probe(params: GridParams, beta, refl, pulse, lix: int,
                         liy: int, tile, halo, *, dry: bool = False,
                         global_acc: bool = False):
    """B3's card kernel with a probe's options, for ``probe_tiled.py`` and
    ``chip_smoke.py``; the engine never calls it, and it counts in no
    wrapper's ``launches``. ``dry``: every round loads, folds and writes
    back its windows but runs no step (the cost of those alone; the
    recording is left unwritten). ``global_acc``: the accumulators stay in
    global memory where they would fit shared memory (the kernel's mode
    above ~1100^2 cells). CUDA tensors only: the plain version has neither
    option."""
    where = "fdtd_sim_tiled_probe"
    check_field(where, "beta", beta, (params.nx, params.ny))
    if not on_card(where, beta, refl, pulse):
        raise ValueError(f"{where}: needs CUDA tensors (a probe of the card's "
                         f"kernel), got {beta.device}")
    tx, ty, k = _tiling(tile, halo)
    return _launch_fdtd_sim_tiled(params, beta, refl, pulse, int(lix),
                                  int(liy), tx, ty, k,
                                  probe=(dry, global_acc))


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


@counted
@spanned("solver")
def rt60_moments_tiled(params: GridParams, rec, onset, chunk=None):
    """RT60 regression moments (s0, s1) from the [T, X, Y] recording and
    the [X, Y] onset (the whole field, or one shard of it), walked in
    reverse chunks of ``chunk`` steps (B4; default :data:`CHUNK`). The
    kernel reads the recording in place."""
    where = "rt60_moments_tiled"
    nx, ny = moments_shape(where, params, rec, onset)
    T = params.response_length
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
