"""Fused FDTD simulation + RT60 moments: the two kernels of an engine step.

Counterpart of ``planeverb_tpu/ops/fdtd_pallas.py``. Two wrappers, each with
its hand-written CUDA kernel (``csrc/fdtd_fused.cu``) and a plain PyTorch
version of the same function:

  - :func:`fdtd_sim` (B1, replaces ``fdtd_pallas.py::_kernel``): all T FDTD
    steps, recording the pre-injection pressure, streaming the onset, the
    source-directivity flux and the windowed energies.
  - :func:`rt60_moments` (B2, replaces ``fdtd_pallas.py::_moments_kernel``):
    one backward pass over the recording for the RT60 regression moments.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version, any other device raises.
There is no fallback from the kernel to the plain version. Each wrapper
counts its kernel launches in its ``launches`` attribute.

:func:`simulate_auto` and :func:`pipeline_auto` route a grid above
:data:`TILED_MIN_CELLS` cells to the tiled kernels of ``ops/fdtd_tiled.py``
(B3, B4), on the card and in the plain versions alike.

Fields are exactly [nx, ny] and the recording exactly [T, nx, ny]: no
padding, no chunking.
"""

from __future__ import annotations

import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops import analyzer, fdtd_tiled
from planeverb_tpu_torch.ops._common import (check_field, coefficients,
                                             fresh_acc, moment_scalars,
                                             moment_step, on_card,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import FdtdResult, fdtd_step_folded

__all__ = ["fdtd_sim", "fdtd_sim_reference", "rt60_moments",
           "rt60_moments_reference", "simulate_moments_fused",
           "simulate_moments_fused_reference", "simulate_auto",
           "pipeline_auto", "reset_launch_counts", "TILED_MIN_CELLS"]


def _inject(p, lix: int, liy: int, value) -> torch.Tensor:
    """p with ``value`` added at the listener cell. A listener outside the
    field injects nothing (the kernel compares cell indices)."""
    nx, ny = p.shape
    if 0 <= lix < nx and 0 <= liy < ny:
        p = p.clone()
        p[lix, liy] += value
    return p


# ----------------------------------------------------------------- B1 sim
def fdtd_sim_reference(params: GridParams, beta, refl, pulse,
                       lix: int, liy: int):
    """Plain version of B1: a Python loop over T of ``fdtd_step_folded``
    plus the kernel's streaming predicates, on any device.

    Returns (FdtdResult, (e_dry, e_wet, e_total)).
    """
    nx, ny, T = params.nx, params.ny, params.response_length
    scalars = window_scalars(params)
    coefs = coefficients(params, beta, refl)
    dev = beta.device

    p = vx = vy = torch.zeros((nx, ny), dtype=torch.float32, device=dev)
    acc = fresh_acc((nx, ny), dev)
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)

    for t in range(T):
        p, vx, vy = fdtd_step_folded(p, vx, vy, beta, coefs, scalars[0])
        acc = stream_step(t, p, vx, vy, acc, scalars)
        rec[t] = p  # record pre-injection, then inject at the listener
        p = _inject(p, lix, liy, pulse[t])
    onset, fx, fy, ed, ew, et = acc
    res = FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy)
    return res, (ed, ew, et)


def _launch_fdtd_sim(params: GridParams, beta, refl, pulse,
                     lix: int, liy: int):
    nx, ny, T = params.nx, params.ny, params.response_length
    courant, thr, src_dir_n, dry_n, wet_n = window_scalars(params)
    coefs = coefficients(params, beta, refl)
    fields = [c.contiguous() for c in (beta, *coefs)]
    pulse = pulse.contiguous()
    dev = beta.device
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)
    acc = torch.empty((6, nx, ny), dtype=torch.float32, device=dev)
    vel = torch.empty((4, nx, ny), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_fdtd_sim(
            *(f.data_ptr() for f in fields), pulse.data_ptr(),
            rec.data_ptr(), *(a.data_ptr() for a in acc),
            *(v.data_ptr() for v in vel), nx, ny, T, lix, liy,
            courant, thr, src_dir_n, dry_n, wet_n, stream)
    kernels.check(err, "fdtd_sim")
    fdtd_sim.launches += 1
    onset, fx, fy, ed, ew, et = acc.unbind(0)
    return (FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


def fdtd_sim(params: GridParams, beta, refl, pulse, lix: int, liy: int):
    """One full simulation pass with streaming onset/flux/energies (B1).

    Args:
      beta, refl: [nx, ny] float32 air flags and reflection coefficients.
      pulse: [T] float32 source pulse.
      lix, liy: listener cell (a cell outside the field injects nothing).
    Returns (FdtdResult, (e_dry, e_wet, e_total)): the [T, nx, ny]
    pre-injection recording, onset (+inf where never crossed), flux, and
    the windowed energies of :class:`analyzer.Moments`.
    """
    where = "fdtd_sim"
    nx, ny = params.nx, params.ny
    check_field(where, "beta", beta, (nx, ny))
    check_field(where, "refl", refl, (nx, ny))
    check_field(where, "pulse", pulse, (params.response_length,))
    lix, liy = int(lix), int(liy)
    if on_card(where, beta, refl, pulse):
        return _launch_fdtd_sim(params, beta, refl, pulse, lix, liy)
    return fdtd_sim_reference(params, beta, refl, pulse, lix, liy)


fdtd_sim.launches = 0


# ------------------------------------------------------------- B2 moments
def rt60_moments_reference(params: GridParams, rec, onset):
    """Plain version of B2: a backward Python loop over the recording, in
    the kernel's summation order, on any device. Returns (s0, s1)."""
    dry_n1, end, log10_scale = moment_scalars(params)
    start = onset + dry_n1
    carry = (torch.zeros_like(onset),) * 3
    for t in reversed(range(rec.shape[0])):
        carry = moment_step(t, rec[t], start, end, log10_scale, carry)
    return carry[1], carry[2]


def rt60_moments(params: GridParams, rec, onset):
    """RT60 regression moments (s0, s1) of :class:`analyzer.Moments` from
    the [T, nx, ny] recording and the [nx, ny] onset (B2)."""
    where = "rt60_moments"
    nx, ny, T = params.nx, params.ny, params.response_length
    check_field(where, "rec", rec, (T, nx, ny))
    check_field(where, "onset", onset, (nx, ny))
    if not on_card(where, rec, onset):
        return rt60_moments_reference(params, rec, onset)
    rec = rec.contiguous()
    onset = onset.contiguous()
    s = torch.empty((2, nx, ny), dtype=torch.float32, device=rec.device)
    dry_n1, end, log10_scale = moment_scalars(params)
    lib = kernels.library()
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        err = lib.pv_rt60_moments(rec.data_ptr(), onset.data_ptr(),
                                  s[0].data_ptr(), s[1].data_ptr(), nx, ny,
                                  T, dry_n1, end, log10_scale, stream)
    kernels.check(err, where)
    rt60_moments.launches += 1
    return s[0], s[1]


rt60_moments.launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counters of B1, B2 and the tiled B3, B4."""
    for fn in (fdtd_sim, rt60_moments, fdtd_tiled.fdtd_sim_tiled,
               fdtd_tiled.rt60_moments_tiled):
        fn.launches = 0


# ------------------------------------------------------------ compositions
def simulate_moments_fused(params: GridParams, beta, refl, pulse,
                           lix: int, liy: int):
    """Sim + analyzer moments: B1 then B2. Returns (FdtdResult, Moments)."""
    res, (ed, ew, et) = fdtd_sim(params, beta, refl, pulse, lix, liy)
    s0, s1 = rt60_moments(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_fused_reference(params: GridParams, beta, refl, pulse,
                                     lix: int, liy: int):
    """Plain versions of B1 then B2 on any device."""
    res, (ed, ew, et) = fdtd_sim_reference(params, beta, refl, pulse,
                                           lix, liy)
    s0, s1 = rt60_moments_reference(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


# Grids of more than this many solver cells (nx * ny) take the tiled route
# (B3 + B4, ops/fdtd_tiled.py); smaller ones the one-launch-per-step B1 +
# B2. chip_smoke.py phase 10 measures the crossover. On an H100 80GB HBM3
# at 700 W, B3 + B4 against B1 + B2 took 4.8 vs 6.9 ms at 261^2, 8.0 vs
# 12.0 ms at 459^2 and 42.7 vs 102.2 ms at 964^2; at 192^2 the order
# changes from run to run (4.2 vs 5.1 ms, and 5.8 vs 5.1 ms in another
# run), inside the noise. So the threshold sits at the headline's 192^2 =
# 36,864 cells: the headline and every calibration grid (at most 25 m, so
# at most 192^2) stay on B1 + B2, and every larger grid is tiled.
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
                  compute_directions: bool = True
                  ) -> tuple[FdtdResult, AnalyzerResults]:
    """Full pass on the fields' device: B1 + B2 (B3 + B4 above
    :data:`TILED_MIN_CELLS` cells), then parameter assembly and, unless
    ``compute_directions`` is False, DOA. Returns (FdtdResult,
    AnalyzerResults); the recording is the exact [T, nx, ny] buffer the
    sim kernel wrote."""
    if _use_tiled(params):
        res, moments = fdtd_tiled.simulate_moments_tiled(
            params, beta, refl, pulse, lix, liy)
    else:
        res, moments = simulate_moments_fused(params, beta, refl, pulse,
                                              lix, liy)
    out = analyzer.analyze_moments(params, moments, res.onset, res.flux_x,
                                   res.flux_y, efree, listener_x, listener_z,
                                   compute_directions=compute_directions)
    return res, out
