"""Pieces shared by the kernel modules ``ops/fdtd_fused.py`` (B1, B2),
``ops/fdtd_tiled.py`` (B3, B4) and ``parallel/solver_fused.py`` (B5, B6):
the device dispatch, argument checks and launch counters of their wrappers,
the scalars their kernels take, and the per-step functions their plain
versions are built from.

The kernels evaluate each expression in the order written here, one
rounding per op, so a kernel and its plain version agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops.fdtd import admittance, coefficients_from_fields
from planeverb_tpu_torch.utils.profiling import spanned

# 10/ln(10) rounded to f32, the scale of y_db = 10 log10(EDC) from ln
LOG10_SCALE = np.float32(10.0 / np.log(10.0))


def on_card(where: str, *tensors: torch.Tensor) -> bool:
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


def check_field(where: str, name: str, t: torch.Tensor, shape,
                dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{where}: {name} must be {want} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def moments_shape(where: str, params: GridParams, rec, onset,
                  batched: bool = False, rec_dtypes=(torch.float32,)):
    """(X, Y) of a moments call: any [X, Y] onset (the whole field or one
    shard of it) with its [T, X, Y] recording; ``batched``: a [B, X, Y]
    onset with its [B, T, X, Y] recordings. ``rec_dtypes`` are the
    recording types the kernel reads."""
    lead = 1 if batched else 0
    if onset.dim() != 2 + lead:
        raise ValueError(f"{where}: onset must be {2 + lead}D, got "
                         f"{tuple(onset.shape)}")
    *b, nx, ny = onset.shape
    check_field(where, "onset", onset, onset.shape)
    check_field(where, "rec", rec, (*b, params.response_length, nx, ny),
                rec_dtypes)
    return nx, ny


_COUNTED = []


def counted(fn):
    """Give a kernel wrapper its launch counter, ``fn.launches`` (0): the
    wrapper adds one where it launches its kernel, and nowhere else."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


_BARRIERS: dict = {}


def barrier_words(device, kernel: str) -> torch.Tensor:
    """The two grid-barrier words a cooperative kernel (``kernel``) uses on
    ``device``: zeroed once, at first use, and kept. Every barrier leaves
    them at rest (the arrival count back at 0, the generation only moving
    on), so launch after launch reuses them with no fill; each kernel has
    its own pair, so two cooperative kernels never share one."""
    key = (torch.device(device), kernel)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _BARRIERS[key]


def reset_launch_counts() -> None:
    """Zero the launch counter of every kernel wrapper imported so far."""
    for fn in _COUNTED:
        fn.launches = 0


# a span of its own (its count is the folds a step), not forwarded to a
# trace: its kernels stay the solver's
@spanned("fold", forward=False)
def coefficients(params: GridParams, beta, refl):
    """The six folded stencil coefficient planes of the whole field (the
    edge ABC at the global edge)."""
    return coefficients_from_fields(
        beta, admittance(refl), params.grid_x, params.grid_y,
        params.boundary_type == BoundaryType.ABSORBING)


# ---------------------------------------------------------------- the sims
def window_scalars(params: GridParams, state_dtype=torch.float32):
    """(courant, threshold, source-directivity, dry and wet window lengths)
    as the sim kernels take them. The Courant number multiplies the wave
    state, so it is rounded to the state type: in bf16 that is what JAX
    does with the Python scalar (a weakly typed bf16 operand), while
    PyTorch would keep it in float."""
    courant = torch.tensor(float(np.float32(params.courant)))
    return (float(courant.to(state_dtype)),
            float(np.float32(params.constants.audible_threshold_gain)),
            float(params.source_dir_samples), float(params.dry_gain_samples),
            float(params.wet_gain_samples))


def stream_step(t: int, p, vx, vy, acc, scalars):
    """The kernels' streaming predicates for step ``t`` (onset, flux and
    windowed energies), on this step's pre-injection p and its velocities.
    ``acc`` is (onset, fx, fy, ed, ew, et); returns the updated tuple."""
    _, thr, src_dir_n, dry_n, wet_n = scalars
    onset, fx, fy, ed, ew, et = acc
    # window bounds are small-integer-valued, so exact in f32
    tf = float(t)
    c_flux = tf - src_dir_n
    c_dry = tf - dry_n
    c_wet_lo = tf - dry_n - 1.0
    c_wet_hi = tf - dry_n - 1.0 - wet_n

    inf = torch.full((), float("inf"), dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    onset = torch.minimum(onset, torch.where(p.abs() > thr,
                                             torch.full_like(p, tf), inf))
    mp = torch.where(onset > c_flux, p, zero)
    fx = fx + mp * vx
    fy = fy + mp * vy
    sq = p * p
    ed = torch.where(onset > c_dry, ed + sq, ed)
    ew = torch.where((onset <= c_wet_lo) & (onset > c_wet_hi), ew + sq, ew)
    et = et + sq
    return onset, fx, fy, ed, ew, et


def fresh_acc(shape, device):
    """Accumulators at rest: onset +inf (never crossed), the rest 0."""
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    onset = torch.full(shape, float("inf"), dtype=torch.float32,
                       device=device)
    return onset, zeros, zeros, zeros, zeros, zeros


# ------------------------------------------------------------- the moments
def moment_scalars(params: GridParams):
    """(dry window + 1, regression end, 10/ln 10) as the moment kernels
    take them."""
    T = params.response_length
    return (float(params.dry_gain_samples + 1),
            float(T - params.schroeder_offset_samples), float(LOG10_SCALE))


def moment_step(t: int, p, start, end: float, log10_scale: float, carry):
    """One backward step of the moments at time ``t`` on the [nx, ny]
    sample ``p``: carry (edc, s0, s1) -> updated carry. The select form,
    never m * (t - start) * y: that is 0 * -inf = NaN where the onset is
    +inf."""
    edc, s0, s1 = carry
    edc = edc + p * p                         # suffix sum incl. current
    y = torch.log(torch.clamp(edc, min=1e-37)) * log10_scale
    tf = float(t)
    m = (tf >= start) & (tf < end)
    s0 = torch.where(m, s0 + y, s0)
    s1 = torch.where(m, s1 + (tf - start) * y, s1)
    return edc, s0, s1
