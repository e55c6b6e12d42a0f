"""Fused FDTD simulation + RT60 moments: the two kernels of an engine step.

Counterpart of ``planeverb_tpu/ops/fdtd_pallas.py``. Two kernels, each
hand-written in CUDA (``csrc/fdtd_fused.cu``) with a plain PyTorch version
of the same function, and a wrapper for one listener and one for B:

  - B1 (replaces ``fdtd_pallas.py::_kernel``): all T FDTD steps, recording
    the pre-injection pressure, streaming the onset, the source-directivity
    flux and the windowed energies. :func:`fdtd_sim` for one listener,
    :func:`fdtd_sim_batch` for B listeners in one pass (its ``batched``
    mode: the B listeners share the field planes). Up to
    :data:`CLUSTER_CELLS` cells a pass is one launch, a thread-block
    cluster a listener holding the field on chip for all T steps; above
    it, one launch a step (:func:`b1_mode`).
  - B2 (replaces ``fdtd_pallas.py::_moments_kernel``): one backward pass
    over the recording for the RT60 regression moments.
    :func:`rt60_moments`, :func:`rt60_moments_batch`.

``state_dtype=torch.bfloat16`` is the half-precision wave-state mode of
the TPU kernel: p/vx/vy, beta and the coefficient planes and the recording
are bf16, each operation computed in float and rounded once; onset, flux
and the energies stay float32, and B2 reads the bf16 recording.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version, any other device raises.
There is no fallback from the kernel to the plain version. Each wrapper
counts its kernel launches in its ``launches`` attribute;
:func:`reset_launch_counts` zeroes every kernel's counter.

:func:`simulate_auto`, :func:`pipeline_auto` and :func:`pipeline_auto_batch`
route a grid above :data:`TILED_MIN_CELLS` cells to the tiled kernels of
``ops/fdtd_tiled.py`` (B3, B4; float32 state, one listener a pass), on the
card and in the plain versions alike.

Fields are exactly [nx, ny] and a recording exactly [T, nx, ny]: no
padding, no chunking, and no element limit (offsets are 64-bit); a batch
too large for the card fails in ``torch.empty`` with its out-of-memory
error.
"""

from __future__ import annotations

import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops import analyzer, fdtd_tiled
from planeverb_tpu_torch.ops._common import (check_field, coefficients,
                                             counted, fresh_acc,
                                             moment_scalars, moment_step,
                                             moments_shape, on_card,
                                             reset_launch_counts,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import FdtdResult, fdtd_step_folded

__all__ = ["STATE_DTYPES", "CLUSTER_CELLS", "b1_mode", "fdtd_sim",
           "fdtd_sim_reference", "fdtd_sim_per_step", "fdtd_sim_batch",
           "fdtd_sim_batch_reference", "rt60_moments",
           "rt60_moments_reference", "rt60_moments_batch",
           "rt60_moments_batch_reference", "simulate_moments_fused",
           "simulate_moments_fused_reference", "simulate_moments_fused_batch",
           "simulate_auto", "pipeline_auto", "pipeline_auto_batch",
           "reset_launch_counts", "TILED_MIN_CELLS"]

# the wave-state types of B1 (and recording types of B2)
STATE_DTYPES = (torch.float32, torch.bfloat16)
# the most cells B1's cluster mode holds: 16 blocks of 768 threads, three
# cells a thread (csrc/fdtd_fused.cu kCluster, kClusterThreads, kClusterRun)
CLUSTER_CELLS = 16 * 768 * 3


def _listener_cells(where: str, lcells) -> list[tuple[int, int]]:
    """A host [B, 2] integer array-like (list, numpy, CPU tensor) ->
    B (ix, iy) pairs."""
    cells = [tuple(int(v) for v in c) for c in lcells]
    if not cells or any(len(c) != 2 for c in cells):
        raise ValueError(f"{where}: listener cells must be [B, 2] with "
                         f"B >= 1, got {cells}")
    return cells


def _check_sim(where: str, params: GridParams, beta, refl, pulse,
               state_dtype) -> None:
    nx, ny = params.nx, params.ny
    check_field(where, "beta", beta, (nx, ny))
    check_field(where, "refl", refl, (nx, ny))
    check_field(where, "pulse", pulse, (params.response_length,))
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"{where}: state_dtype must be one of "
                         f"{STATE_DTYPES}, got {state_dtype}")


# ----------------------------------------------------------------- B1 sim
def fdtd_sim_batch_reference(params: GridParams, beta, refl, pulse, lcells,
                             state_dtype=torch.float32):
    """Plain version of B1 for B listeners: a Python loop over T of
    ``fdtd_step_folded`` on [B, nx, ny] state plus the kernel's streaming
    predicates, on any device. In bf16 the state, the fields and the pulse
    are bf16 and the accumulators read the state as float32.

    Returns (FdtdResult, (e_dry, e_wet, e_total)), every field with a
    leading [B] axis; the recording is [B, T, nx, ny] of ``state_dtype``.
    """
    cells = _listener_cells("fdtd_sim_batch_reference", lcells)
    B = len(cells)
    nx, ny, T = params.nx, params.ny, params.response_length
    scalars = window_scalars(params, state_dtype)
    beta_s, *coefs = (c.to(state_dtype) for c in
                      (beta, *coefficients(params, beta, refl)))
    pulse_s = pulse.to(state_dtype)
    dev = beta.device

    p = vx = vy = torch.zeros((B, nx, ny), dtype=state_dtype, device=dev)
    acc = fresh_acc((B, nx, ny), dev)
    rec = torch.empty((B, T, nx, ny), dtype=state_dtype, device=dev)
    # a listener outside the field injects nothing (the kernel compares
    # cell indices)
    inside = [(b, i, j) for b, (i, j) in enumerate(cells)
              if 0 <= i < nx and 0 <= j < ny]
    src = tuple(torch.tensor(v, device=dev) for v in zip(*inside))

    for t in range(T):
        p, vx, vy = fdtd_step_folded(p, vx, vy, beta_s, coefs, scalars[0])
        acc = stream_step(t, p.float(), vx.float(), vy.float(), acc,
                          scalars)
        rec[:, t] = p  # record pre-injection, then inject at the listener
        if inside:
            p[src] = p[src] + pulse_s[t]
    onset, fx, fy, ed, ew, et = acc
    res = FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy)
    return res, (ed, ew, et)


def fdtd_sim_reference(params: GridParams, beta, refl, pulse,
                       lix: int, liy: int, state_dtype=torch.float32):
    """Plain version of B1 for one listener (the batched plain version with
    B = 1), on any device. Returns (FdtdResult, (e_dry, e_wet, e_total))."""
    res, acc = fdtd_sim_batch_reference(params, beta, refl, pulse,
                                        [(lix, liy)], state_dtype)
    return FdtdResult(*(x[0] for x in res)), tuple(x[0] for x in acc)


def b1_mode(nx: int, ny: int, state_dtype, B: int) -> str:
    """B1's kernel mode for a pass, chosen before launch from the kernel's
    capacity alone: ``"cluster"`` (one thread-block cluster a listener
    holds the field for all T steps, one launch a pass) for every field of
    at most :data:`CLUSTER_CELLS` cells, in float32 and bf16 and for any
    number of listeners B; ``"step"`` (one launch a step) above it. The
    route (``pipeline_auto``, :data:`TILED_MIN_CELLS`) sends B1 no grid
    above the cluster's capacity."""
    if state_dtype not in STATE_DTYPES or B < 1 or min(nx, ny) < 1:
        raise ValueError(f"b1_mode: no mode for {nx}x{ny}, {state_dtype}, "
                         f"B = {B}")
    return "cluster" if nx * ny <= CLUSTER_CELLS else "step"


def _launch_fdtd_sim(params: GridParams, beta, refl, pulse, cells,
                     state_dtype, mode=None):
    nx, ny, T = params.nx, params.ny, params.response_length
    B = len(cells)
    if mode is None:
        mode = b1_mode(nx, ny, state_dtype, B)
    courant, thr, src_dir_n, dry_n, wet_n = window_scalars(params,
                                                           state_dtype)
    coefs = coefficients(params, beta, refl)
    fields = [c.to(state_dtype).contiguous() for c in (beta, *coefs)]
    pulse = pulse.contiguous()
    dev = beta.device
    rec = torch.empty((B, T, nx, ny), dtype=state_dtype, device=dev)
    acc = torch.empty((6, B, nx, ny), dtype=torch.float32, device=dev)
    # the per-step mode's velocity buffers; the cluster mode keeps its state
    # on chip
    vel = (torch.empty((B, 4, nx, ny), dtype=state_dtype, device=dev)
           if mode == "step" else None)
    # the [B, 2] listener table, copied without a host sync
    lc = torch.tensor(cells, dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_fdtd_sim(
            *(f.data_ptr() for f in fields), pulse.data_ptr(),
            rec.data_ptr(), acc.data_ptr(),
            None if vel is None else vel.data_ptr(), lc.data_ptr(), nx, ny,
            T, B, int(state_dtype == torch.bfloat16), int(mode == "cluster"),
            courant, thr, src_dir_n, dry_n, wet_n, stream)
    return err, rec, acc


@counted
def fdtd_sim(params: GridParams, beta, refl, pulse, lix: int, liy: int,
             state_dtype=torch.float32):
    """One full simulation pass with streaming onset/flux/energies (B1).

    Args:
      beta, refl: [nx, ny] float32 air flags and reflection coefficients.
      pulse: [T] float32 source pulse.
      lix, liy: listener cell (a cell outside the field injects nothing).
      state_dtype: torch.float32 or torch.bfloat16 wave state.
    Returns (FdtdResult, (e_dry, e_wet, e_total)): the [T, nx, ny]
    pre-injection recording (of ``state_dtype``), onset (+inf where never
    crossed), flux, and the windowed energies of :class:`analyzer.Moments`.
    """
    where = "fdtd_sim"
    _check_sim(where, params, beta, refl, pulse, state_dtype)
    lix, liy = int(lix), int(liy)
    if not on_card(where, beta, refl, pulse):
        return fdtd_sim_reference(params, beta, refl, pulse, lix, liy,
                                  state_dtype)
    err, rec, acc = _launch_fdtd_sim(params, beta, refl, pulse,
                                     [(lix, liy)], state_dtype)
    kernels.check(err, where)
    fdtd_sim.launches += 1
    onset, fx, fy, ed, ew, et = (a[0] for a in acc)
    return (FdtdResult(pressure=rec[0], onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


@counted
def fdtd_sim_batch(params: GridParams, beta, refl, pulse, lcells,
                   state_dtype=torch.float32):
    """B1 for B listeners in one pass (the TPU kernel's batched mode): one
    launch (B clusters; or one a step above :data:`CLUSTER_CELLS`)
    advances every listener, all reading one copy of the field planes.
    Bit-equal to B :func:`fdtd_sim` passes.

    ``lcells`` is a host [B, 2] integer array-like of listener cells; the
    other arguments as :func:`fdtd_sim`. Returns (FdtdResult,
    (e_dry, e_wet, e_total)) with a leading [B] axis on every field (the
    recording [B, T, nx, ny])."""
    where = "fdtd_sim_batch"
    _check_sim(where, params, beta, refl, pulse, state_dtype)
    cells = _listener_cells(where, lcells)
    if not on_card(where, beta, refl, pulse):
        return fdtd_sim_batch_reference(params, beta, refl, pulse, cells,
                                        state_dtype)
    err, rec, acc = _launch_fdtd_sim(params, beta, refl, pulse, cells,
                                     state_dtype)
    kernels.check(err, where)
    fdtd_sim_batch.launches += 1
    onset, fx, fy, ed, ew, et = acc
    return (FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


@counted
def fdtd_sim_per_step(params: GridParams, beta, refl, pulse, lix: int,
                      liy: int, state_dtype=torch.float32):
    """:func:`fdtd_sim` in B1's per-step mode at any size: one launch a
    step, the mode :func:`b1_mode` takes above :data:`CLUSTER_CELLS`.
    ``chip_smoke.py`` holds the cluster mode to it; the engine does not
    call it."""
    where = "fdtd_sim_per_step"
    _check_sim(where, params, beta, refl, pulse, state_dtype)
    lix, liy = int(lix), int(liy)
    if not on_card(where, beta, refl, pulse):
        return fdtd_sim_reference(params, beta, refl, pulse, lix, liy,
                                  state_dtype)
    err, rec, acc = _launch_fdtd_sim(params, beta, refl, pulse,
                                     [(lix, liy)], state_dtype, mode="step")
    kernels.check(err, where)
    fdtd_sim_per_step.launches += 1
    onset, fx, fy, ed, ew, et = (a[0] for a in acc)
    return (FdtdResult(pressure=rec[0], onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


# ------------------------------------------------------------- B2 moments
def rt60_moments_reference(params: GridParams, rec, onset):
    """Plain version of B2: a backward Python loop over the recording
    ([T, X, Y], or [B, T, X, Y] for B listeners; each sample read as
    float32) against the [X, Y] (or [B, X, Y]) onset, in the kernel's
    summation order, on any device. Returns (s0, s1)."""
    dry_n1, end, log10_scale = moment_scalars(params)
    start = onset + dry_n1
    carry = (torch.zeros_like(onset),) * 3
    for t in reversed(range(rec.shape[-3])):
        carry = moment_step(t, rec.select(-3, t).float(), start, end,
                            log10_scale, carry)
    return carry[1], carry[2]


# the plain version takes a leading listener axis as it is
rt60_moments_batch_reference = rt60_moments_reference


def _launch_moments(params: GridParams, rec, onset):
    """B2 on [B, T, X, Y] recordings and [B, X, Y] onsets -> (err, s0, s1),
    s0/s1 [B, X, Y]."""
    B, T, nx, ny = rec.shape
    rec = rec.contiguous()
    onset = onset.contiguous()
    s = torch.empty((2, B, nx, ny), dtype=torch.float32, device=rec.device)
    dry_n1, end, log10_scale = moment_scalars(params)
    lib = kernels.library()
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        err = lib.pv_rt60_moments(rec.data_ptr(), onset.data_ptr(),
                                  s[0].data_ptr(), s[1].data_ptr(), nx, ny,
                                  T, B, int(rec.dtype == torch.bfloat16),
                                  dry_n1, end, log10_scale, stream)
    return err, s[0], s[1]


@counted
def rt60_moments(params: GridParams, rec, onset):
    """RT60 regression moments (s0, s1) of :class:`analyzer.Moments` from
    the [T, X, Y] recording (float32 or bf16) and the [X, Y] onset: the
    whole field, or one shard of it (B2)."""
    where = "rt60_moments"
    moments_shape(where, params, rec, onset, rec_dtypes=STATE_DTYPES)
    if not on_card(where, rec, onset):
        return rt60_moments_reference(params, rec, onset)
    err, s0, s1 = _launch_moments(params, rec[None], onset[None])
    kernels.check(err, where)
    rt60_moments.launches += 1
    return s0[0], s1[0]


@counted
def rt60_moments_batch(params: GridParams, rec, onset):
    """B2 for B listeners in one launch: the [B, T, X, Y] recordings
    (float32 or bf16) and [B, X, Y] onsets -> (s0, s1), each [B, X, Y].
    Bit-equal to B :func:`rt60_moments` calls."""
    where = "rt60_moments_batch"
    moments_shape(where, params, rec, onset, batched=True,
                  rec_dtypes=STATE_DTYPES)
    if not on_card(where, rec, onset):
        return rt60_moments_batch_reference(params, rec, onset)
    err, s0, s1 = _launch_moments(params, rec, onset)
    kernels.check(err, where)
    rt60_moments_batch.launches += 1
    return s0, s1


# ------------------------------------------------------------ compositions
def simulate_moments_fused(params: GridParams, beta, refl, pulse,
                           lix: int, liy: int, state_dtype=torch.float32):
    """Sim + analyzer moments: B1 then B2. Returns (FdtdResult, Moments)."""
    res, (ed, ew, et) = fdtd_sim(params, beta, refl, pulse, lix, liy,
                                 state_dtype)
    s0, s1 = rt60_moments(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_fused_reference(params: GridParams, beta, refl, pulse,
                                     lix: int, liy: int):
    """Plain versions of B1 then B2 on any device."""
    res, (ed, ew, et) = fdtd_sim_reference(params, beta, refl, pulse,
                                           lix, liy)
    s0, s1 = rt60_moments_reference(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_fused_batch(params: GridParams, beta, refl, pulse,
                                 lcells, state_dtype=torch.float32):
    """Batched sim + moments for B listeners: one B1 pass and one B2 launch
    (the counterpart of ``simulate_moments_pallas_batch``). Returns
    (FdtdResult, Moments), every field with a leading [B] axis; the caller
    may drop the [B, T, nx, ny] recordings."""
    res, (ed, ew, et) = fdtd_sim_batch(params, beta, refl, pulse, lcells,
                                       state_dtype)
    s0, s1 = rt60_moments_batch(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


# Grids of more than this many solver cells (nx * ny) take the tiled route
# (B3 + B4, ops/fdtd_tiled.py); smaller ones B1 (its cluster mode) + B2.
# chip_smoke.py phase 10 measures the crossover (PERF.md). The threshold
# sits at the headline's 192^2 = 36,864 cells, which is also the most B1's
# cluster mode holds: the headline, batches of listeners and every
# calibration grid (at most 25 m, so at most 192^2) stay on B1 + B2, and
# every larger grid is tiled. On an H100 the redesigned B3 + B4 now beat B1
# + B2 for one listener at 192^2 too (ROADMAP records the move).
TILED_MIN_CELLS = 192 * 192


def _use_tiled(params: GridParams) -> bool:
    return params.nx * params.ny > TILED_MIN_CELLS


def simulate_auto(params: GridParams, beta, refl, pulse,
                  lix: int, liy: int) -> FdtdResult:
    """One simulation pass on the fields' device: B1, or B3 above
    :data:`TILED_MIN_CELLS` cells."""
    if _use_tiled(params):
        res, _ = fdtd_tiled.fdtd_sim_tiled(params, beta, refl, pulse, lix, liy)
    else:
        res, _ = fdtd_sim(params, beta, refl, pulse, lix, liy)
    return res


def pipeline_auto(params: GridParams, beta, refl, pulse, lix: int, liy: int,
                  efree: float, listener_x: float, listener_z: float,
                  compute_directions: bool = True,
                  state_dtype=torch.float32
                  ) -> tuple[FdtdResult, AnalyzerResults]:
    """Full pass on the fields' device: B1 + B2 (B3 + B4 above
    :data:`TILED_MIN_CELLS` cells), then parameter assembly and, unless
    ``compute_directions`` is False, DOA. Returns (FdtdResult,
    AnalyzerResults); the recording is the exact [T, nx, ny] buffer the
    sim kernel wrote. ``state_dtype`` picks B1's wave state; the tiled
    route runs float32 whatever it is, as the JAX package's does."""
    if _use_tiled(params):
        res, moments = fdtd_tiled.simulate_moments_tiled(
            params, beta, refl, pulse, lix, liy)
    else:
        res, moments = simulate_moments_fused(params, beta, refl, pulse,
                                              lix, liy, state_dtype)
    out = analyzer.analyze_moments(params, moments, res.onset, res.flux_x,
                                   res.flux_y, efree, listener_x, listener_z,
                                   compute_directions=compute_directions)
    return res, out


def pipeline_auto_batch(params: GridParams, beta, refl, pulse, lcells,
                        efree: float, lpos, compute_directions: bool = True,
                        state_dtype=torch.float32) -> AnalyzerResults:
    """Full pass for B listeners: AnalyzerResults with a leading [B] axis
    on every grid; the recordings are dropped.

    Up to :data:`TILED_MIN_CELLS` cells the listeners run together in the
    batched kernels (:func:`simulate_moments_fused_batch`: one B1 pass, one
    B2 launch), then each view is assembled on the device in turn. Above
    it each listener runs its own :func:`pipeline_auto` (B3 + B4, float32),
    as the JAX package's ``lax.map`` does, and its recording is freed before
    the next pass starts, so the route holds one recording at a time.

    ``lcells``: host [B, 2] listener cells; ``lpos``: B listener world
    positions (x, z), float32 values.
    """
    cells = _listener_cells("pipeline_auto_batch", lcells)
    lpos = [(float(x), float(z)) for x, z in lpos]
    if len(lpos) != len(cells):
        raise ValueError(f"pipeline_auto_batch: {len(cells)} listener cells "
                         f"but {len(lpos)} positions")
    outs = []
    if _use_tiled(params):
        for (cix, ciy), (lx, lz) in zip(cells, lpos):
            res, out = pipeline_auto(params, beta, refl, pulse, cix, ciy,
                                     efree, lx, lz, compute_directions)
            del res   # this listener's recording goes before the next pass
            outs.append(out)
    else:
        res, mom = simulate_moments_fused_batch(params, beta, refl, pulse,
                                                cells, state_dtype)
        onset, fx, fy = res.onset, res.flux_x, res.flux_y
        del res
        for b, (lx, lz) in enumerate(lpos):
            outs.append(analyzer.analyze_moments(
                params, Moments(*(m[b] for m in mom)), onset[b], fx[b],
                fy[b], efree, lx, lz, compute_directions=compute_directions))
    return AnalyzerResults(*(torch.stack(g) for g in zip(*outs)))
