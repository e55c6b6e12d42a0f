"""Acoustic parameter encoder — vectorized analysis post-pass.

Counterpart of ``planeverb_tpu/ops/analyzer.py`` (the reference's per-cell
scan loops, ProjectPlaneverb/src/DSP/Analyzer.cpp:139-328): every stage is
a masked reduction over the recorded [T, nx, ny] pressure tensor, or an
elementwise pass over per-cell moments:

  - onset delay:        streaming min from the solver (Analyzer.cpp:146-165)
  - obstruction:        sqrt(Edry / (EFree/r)) with Edry a masked windowed
                        energy sum (Analyzer.cpp:170-219)
  - source directivity: -normalized flux, accumulated by the solver
                        (Analyzer.cpp:178-220)
  - lowpass cutoff:     -147 + 18390/(1+(r/12)^0.8) (Analyzer.cpp:226-230)
  - wet gain:           sqrt(Ewet/E1m) over 80 ms post-dry (Analyzer.cpp:234-247)
  - RT60:               backward Schroeder integral + the closed-form
                        regression (Analyzer.cpp:250-327)

Direction-of-arrival (pass 2) lives in ops/doa.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops.doa import encode_directions
from planeverb_tpu_torch.utils.profiling import span, spanned

__all__ = ["AnalyzerResults", "Moments", "analyze", "analyze_moments",
           "moments_from_pressure", "free_field_normalizer"]


def _div(a, b):
    """``a / b`` as one correctly rounded f32 division where either side is
    a Python scalar: PyTorch computes ``scalar / tensor`` as
    ``reciprocal(tensor) * scalar``, and on CUDA ``tensor / scalar`` as
    ``tensor * (1 / scalar)``; both round twice."""
    like = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return a / b


class AnalyzerResults(NamedTuple):
    """Per-cell acoustic parameters over the [grid_x, grid_y] analysis grid.

    Mirrors AnalyzerResult (Analyzer.h:13-21) as SoA tensors.
    """

    occlusion: torch.Tensor           # [gx, gy] obstruction gain
    wet_gain: torch.Tensor            # [gx, gy]
    rt60: torch.Tensor                # [gx, gy] seconds
    lowpass: torch.Tensor             # [gx, gy] cutoff Hz
    direction: torch.Tensor           # [gx, gy, 2] listener-relative DOA
    source_directivity: torch.Tensor  # [gx, gy, 2] radiated unit vector
    delay_samples: torch.Tensor       # [gx, gy] onset (f32; FLT_MAX if none)


def free_field_normalizer(params: GridParams, listener_ix: int,
                          listener_iy: int, device=None):
    """Per-cell EFree/r denominators (FreeGrid::GetEFreePerR, FreeGrid.cpp:41-59).

    Returns [gx, gy] of 1/r falloff factors (r in meters between cell and the
    listener *cell* indices); the caller multiplies by the calibrated EFree.
    r == 0 cells use falloff 1 (the reference returns EFree unchanged).
    """
    gx, gy = params.grid_x, params.grid_y
    dx = float(np.float32(params.dx))
    rr = torch.arange(gx, dtype=torch.int32, device=device).view(gx, 1)
    cc = torch.arange(gy, dtype=torch.int32, device=device).view(1, gy)
    # distance in integer index space keeps the r == 0 test exact
    di = (rr - listener_ix).to(torch.float32)
    dj = (cc - listener_iy).to(torch.float32)
    r = torch.sqrt(di * di + dj * dj) * dx
    at_listener = (rr == listener_ix) & (cc == listener_iy)
    one = torch.ones((), dtype=torch.float32, device=device)
    return torch.where(at_listener, one, 1.0 / torch.where(at_listener, one, r))


class Moments(NamedTuple):
    """Sufficient statistics of one recording for parameter assembly.

    All [nx, ny] (or [gx, gy]) per-cell grids; assembly crops to [gx, gy]:
      e_dry:   energy over [0, onset + dry_n)
      e_wet:   energy over [onset + dry_n + 1, + wet_n)
      e_total: total recorded energy (EDC[0])
      s0:      sum of y_db over the RT60 regression window
      s1:      sum of (t - start) * y_db over the window, start the per-cell
               window origin (onset + dry_n + 1)
    where y_db[t] = 10 log10(max(EDC[t], 1e-37)).

    Streaming accumulation (during the sim, or in one backward pass over the
    recording) is exact because every window condition at time t depends only
    on whether onset <= t.
    """

    e_dry: torch.Tensor
    e_wet: torch.Tensor
    e_total: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor


def moments_from_pressure(params: GridParams, pressure, onset) -> Moments:
    """Plain reduction form of :class:`Moments` from a full recording.

    The engine computes the same moments in its kernels (ops/fdtd_fused.py)
    without materializing the [T, gx, gy] temporaries.
    """
    gx, gy = params.grid_x, params.grid_y
    T = params.response_length
    dry_n = params.dry_gain_samples
    wet_n = params.wet_gain_samples
    schro_off = params.schroeder_offset_samples

    p = pressure[:T, :gx, :gy]
    onset = onset[:gx, :gy]

    sq = p * p
    t_idx = torch.arange(T, device=p.device).to(torch.float32).view(T, 1, 1)
    # inf onset (never crossed) keeps the dry window open and the wet/
    # regression windows closed; moments of never-found cells are
    # don't-care (masked by ``found`` in assembly)
    direct_end = onset + float(dry_n)

    e_dry = torch.sum(sq * (t_idx < direct_end), dim=0)
    wet_start = direct_end + 1.0
    wet_mask = (t_idx >= wet_start) & (t_idx < wet_start + float(wet_n))
    e_wet = torch.sum(sq * wet_mask, dim=0)
    e_total = torch.sum(sq, dim=0)

    # EDC[t] = sum_{j>=t} sq[j] via *backward* accumulation (the forward
    # alternative cancels catastrophically in the decay tail)
    edc = torch.flip(torch.cumsum(torch.flip(sq, [0]), dim=0), [0])
    y_db = 10.0 * torch.log10(torch.clamp(edc, min=1e-37))
    start = direct_end + 1.0
    end = float(T - schro_off)
    reg_mask = (t_idx >= start) & (t_idx < end)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    s0 = torch.sum(torch.where(reg_mask, y_db, zero), dim=0)
    s1 = torch.sum(torch.where(reg_mask, y_db * (t_idx - start), zero), dim=0)
    return Moments(e_dry=e_dry, e_wet=e_wet, e_total=e_total, s0=s0, s1=s1)


@spanned("analysis")
def analyze_moments(params: GridParams, moments: Moments, onset,
                    flux_x, flux_y, efree: float,
                    listener_x: float, listener_y: float,
                    compute_directions: bool = True) -> AnalyzerResults:
    """Assemble per-cell acoustic parameters from precomputed moments.

    Elementwise math on [gx, gy] grids plus the DOA pass — no [T, ...]
    traffic. Semantics per Analyzer.cpp:139-328 (see :func:`analyze`).
    ``efree`` and the listener position are host scalars (f32 values).
    """
    gx, gy = params.grid_x, params.grid_y
    T = params.response_length
    fs = float(np.float32(params.fs))
    dry_n = params.dry_gain_samples
    schro_off = params.schroeder_offset_samples
    dev = onset.device
    efree = float(np.float32(efree))

    lwx = np.float32(listener_x) + np.float32(params.grid_offset_x)
    lwy = np.float32(listener_y) + np.float32(params.grid_offset_y)

    onset = onset[:gx, :gy]
    fx = flux_x[:gx, :gy]
    fy = flux_y[:gx, :gy]
    e_dry = moments.e_dry[:gx, :gy]
    e_wet = moments.e_wet[:gx, :gy]
    s0 = moments.s0[:gx, :gy]
    s1 = moments.s1[:gx, :gy]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    found = torch.isfinite(onset)
    onset_c = torch.where(found, onset, zero)
    direct_end = onset_c + float(dry_n)

    # -- obstruction = sqrt(Edry / (EFree/r))  (Analyzer.cpp:199-219)
    inv_dx = np.float32(1.0) / np.float32(params.dx)
    lix = int(lwx * inv_dx)
    liy = int(lwy * inv_dx)
    inv_r = free_field_normalizer(params, lix, liy, device=dev)
    occlusion = torch.sqrt(e_dry / (efree * inv_r))
    occlusion = torch.where(found, occlusion, zero)

    # -- source directivity = -flux/|flux|  (Analyzer.cpp:222-228)
    norm = torch.sqrt(fx * fx + fy * fy)
    inv_norm = -1.0 / torch.where(norm > 0.0, norm, torch.ones_like(norm))
    sdir = torch.stack([fx * inv_norm, fy * inv_norm], dim=-1)
    sdir = torch.where(found[..., None], sdir, zero)

    # -- lowpass cutoff  (Analyzer.cpp:226-230)
    r_occ = 1.0 / torch.clamp(occlusion, min=0.001)
    lowpass = -147.0 + _div(18390.0, 1.0 + torch.pow(_div(r_occ, 12.0), 0.8))
    lowpass = torch.where(found, lowpass, zero)

    # -- wet gain  (Analyzer.cpp:234-247)
    wet_gain = torch.where(found, torch.sqrt(_div(e_wet, efree)), zero)

    # -- RT60 closed-form regression from the y_db moments
    #    (Analyzer.cpp:250-327); s1 is accumulated against x = t - start.
    start = direct_end + 1.0
    end = float(T - schro_off)
    rn = end - start
    # degenerate regression window (fewer than two samples): no defined
    # slope; emit the no-reverb value 0, like never-found cells
    window_ok = rn > 1.0
    rn_s = torch.where(window_ok, rn, torch.full_like(rn, 2.0))
    xmean = (rn_s - 1.0) * 0.5
    xsum = rn_s * xmean
    denom = (1.0 / 12.0) * rn_s * (rn_s * rn_s - 1.0)
    ysum = s0
    xysum = s1
    ymean = ysum / rn_s
    numerator = xysum - ymean * xsum - xmean * ysum + rn_s * xmean * ymean
    slope_db_per_sec = numerator / denom * fs
    rt60 = _div(-60.0, slope_db_per_sec)
    rt60 = torch.where(found & window_ok, rt60, zero)

    delay = torch.where(found, onset, torch.full_like(onset, np.finfo(np.float32).max))

    # -- pass 2: direction via parallel delay-field descent (ops/doa.py)
    if compute_directions:
        # not forwarded to a trace: its kernels stay the analysis's
        with span("doa", forward=False):
            direction = encode_directions(params, occlusion, delay,
                                          float(lwx), float(lwy))
    else:
        direction = torch.zeros((gx, gy, 2), dtype=torch.float32, device=dev)

    return AnalyzerResults(
        occlusion=occlusion, wet_gain=wet_gain, rt60=rt60, lowpass=lowpass,
        direction=direction, source_directivity=sdir, delay_samples=delay)


def analyze(params: GridParams, pressure, onset, flux_x, flux_y,
            efree: float, listener_x: float,
            listener_y: float) -> AnalyzerResults:
    """Encode per-cell acoustic parameters from one simulation pass.

    Args:
      params: static grid parameters.
      pressure: [T, nx, ny] recorded pressure (solver output).
      onset: [nx, ny] onset sample per cell (f32, +inf when none).
      flux_x, flux_y: [nx, ny] in-loop directivity flux sums.
      efree: free-field energy at 1 m (calibration).
      listener_x, listener_y: listener world position (grid offset NOT yet
        applied — applied here as in Analyzer.cpp:60-62).
    """
    moments = moments_from_pressure(params, pressure, onset)
    return analyze_moments(params, moments, onset, flux_x, flux_y,
                           efree, listener_x, listener_y)
