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

Fields are exactly [nx, ny] and the recording exactly [T, nx, ny]: no
padding, no chunking.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops import analyzer
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import (FdtdResult, admittance,
                                          coefficients_from_fields,
                                          fdtd_step_folded)

__all__ = ["fdtd_sim", "fdtd_sim_reference", "rt60_moments",
           "rt60_moments_reference", "simulate_moments_fused",
           "simulate_moments_fused_reference", "simulate_auto",
           "pipeline_auto", "reset_launch_counts"]

# 10/ln(10) rounded to f32, the scale of y_db = 10 log10(EDC) from ln
_LOG10_SCALE = np.float32(10.0 / np.log(10.0))


def _on_card(where: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (kernel), False for CPU tensors (plain
    version); raises for any other device or a device mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{where}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{where}: no kernel and no plain path for device {dev}")


def _check_field(where: str, name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: {name} must be float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _coefficients(params: GridParams, beta, refl):
    return coefficients_from_fields(
        beta, admittance(refl), params.grid_x, params.grid_y,
        params.boundary_type == BoundaryType.ABSORBING)


def _inject(p, lix: int, liy: int, value) -> torch.Tensor:
    """p with ``value`` added at the listener cell. A listener outside the
    field injects nothing (the kernel compares cell indices)."""
    nx, ny = p.shape
    if 0 <= lix < nx and 0 <= liy < ny:
        p = p.clone()
        p[lix, liy] += value
    return p


def _window_scalars(params: GridParams):
    return (float(np.float32(params.courant)),
            float(np.float32(params.constants.audible_threshold_gain)),
            float(params.source_dir_samples), float(params.dry_gain_samples),
            float(params.wet_gain_samples))


# ----------------------------------------------------------------- B1 sim
def fdtd_sim_reference(params: GridParams, beta, refl, pulse,
                       lix: int, liy: int):
    """Plain version of B1: a Python loop over T of ``fdtd_step_folded``
    plus the kernel's streaming predicates, on any device.

    Returns (FdtdResult, (e_dry, e_wet, e_total)).
    """
    nx, ny, T = params.nx, params.ny, params.response_length
    courant, thr, src_dir_n, dry_n, wet_n = _window_scalars(params)
    coefs = _coefficients(params, beta, refl)
    dev = beta.device

    zeros = torch.zeros((nx, ny), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p, vx, vy = zeros, zeros, zeros
    onset = torch.full((nx, ny), float("inf"), dtype=torch.float32,
                       device=dev)
    fx = fy = ed = ew = et = zeros
    rec = torch.empty((T, nx, ny), dtype=torch.float32, device=dev)

    for t in range(T):
        p, vx, vy = fdtd_step_folded(p, vx, vy, beta, coefs, courant)

        # window bounds are small-integer-valued, so exact in f32
        tf = float(t)
        c_flux = tf - src_dir_n
        c_dry = tf - dry_n
        c_wet_lo = tf - dry_n - 1.0
        c_wet_hi = tf - dry_n - 1.0 - wet_n

        onset = torch.minimum(onset, torch.where(p.abs() > thr,
                                                 torch.full_like(p, tf), inf))
        mp = torch.where(onset > c_flux, p, zero)
        fx = fx + mp * vx
        fy = fy + mp * vy
        sq = p * p
        ed = torch.where(onset > c_dry, ed + sq, ed)
        ew = torch.where((onset <= c_wet_lo) & (onset > c_wet_hi), ew + sq,
                         ew)
        et = et + sq

        rec[t] = p  # record pre-injection, then inject at the listener
        p = _inject(p, lix, liy, pulse[t])
    res = FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy)
    return res, (ed, ew, et)


def _launch_fdtd_sim(params: GridParams, beta, refl, pulse,
                     lix: int, liy: int):
    nx, ny, T = params.nx, params.ny, params.response_length
    courant, thr, src_dir_n, dry_n, wet_n = _window_scalars(params)
    coefs = _coefficients(params, beta, refl)
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
    _check_field(where, "beta", beta, (nx, ny))
    _check_field(where, "refl", refl, (nx, ny))
    _check_field(where, "pulse", pulse, (params.response_length,))
    lix, liy = int(lix), int(liy)
    if _on_card(where, beta, refl, pulse):
        return _launch_fdtd_sim(params, beta, refl, pulse, lix, liy)
    return fdtd_sim_reference(params, beta, refl, pulse, lix, liy)


fdtd_sim.launches = 0


# ------------------------------------------------------------- B2 moments
def _moment_scalars(params: GridParams):
    T = params.response_length
    return (float(params.dry_gain_samples + 1),
            float(T - params.schroeder_offset_samples), float(_LOG10_SCALE))


def rt60_moments_reference(params: GridParams, rec, onset):
    """Plain version of B2: a backward Python loop over the recording, in
    the kernel's summation order, on any device. Returns (s0, s1)."""
    dry_n1, end, log10_scale = _moment_scalars(params)
    start = onset + dry_n1
    edc = torch.zeros_like(onset)
    s0 = torch.zeros_like(onset)
    s1 = torch.zeros_like(onset)
    for t in reversed(range(rec.shape[0])):
        p = rec[t]
        edc = edc + p * p                     # suffix sum incl. current
        y = torch.log(torch.clamp(edc, min=1e-37)) * log10_scale
        tf = float(t)
        m = (tf >= start) & (tf < end)
        s0 = torch.where(m, s0 + y, s0)
        s1 = torch.where(m, s1 + (tf - start) * y, s1)
    return s0, s1


def rt60_moments(params: GridParams, rec, onset):
    """RT60 regression moments (s0, s1) of :class:`analyzer.Moments` from
    the [T, nx, ny] recording and the [nx, ny] onset (B2)."""
    where = "rt60_moments"
    nx, ny, T = params.nx, params.ny, params.response_length
    _check_field(where, "rec", rec, (T, nx, ny))
    _check_field(where, "onset", onset, (nx, ny))
    if not _on_card(where, rec, onset):
        return rt60_moments_reference(params, rec, onset)
    rec = rec.contiguous()
    onset = onset.contiguous()
    s = torch.empty((2, nx, ny), dtype=torch.float32, device=rec.device)
    dry_n1, end, log10_scale = _moment_scalars(params)
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
    fdtd_sim.launches = 0
    rt60_moments.launches = 0


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


def simulate_auto(params: GridParams, beta, refl, pulse,
                  lix: int, liy: int) -> FdtdResult:
    """One simulation pass (B1) on the fields' device."""
    res, _ = fdtd_sim(params, beta, refl, pulse, lix, liy)
    return res


def pipeline_auto(params: GridParams, beta, refl, pulse, lix: int, liy: int,
                  efree: float, listener_x: float, listener_z: float,
                  compute_directions: bool = True
                  ) -> tuple[FdtdResult, AnalyzerResults]:
    """Full pass on the fields' device: B1 + B2, then parameter assembly
    and DOA. Returns (FdtdResult, AnalyzerResults); the recording is the
    exact [T, nx, ny] buffer B1 wrote."""
    res, moments = simulate_moments_fused(params, beta, refl, pulse,
                                          lix, liy)
    out = analyzer.analyze_moments(params, moments, res.onset, res.flux_x,
                                   res.flux_y, efree, listener_x, listener_z,
                                   compute_directions=compute_directions)
    return res, out
