"""2nd-order Butterworth lowpass (reference PlaneverbDSP/src/DSP/Lowpass.h).

Coefficient law (Lowpass.h:14-26): with T = 2*pi*cutoff / fs and
Y = 1/(1 + sqrt(2) T + T^2):

    y[n] = (T^2 Y) x[n] + (2 + sqrt(2) T) Y y[n-1] - Y y[n-2]

Three implementations share this law:
  - ``coefficients``: the pure coefficient function
  - ``process``:      streaming numpy biquad with persistent state
  - ``process_scan``: batched biquad over [S, N] blocks, the recurrence
    carried over N. On a CUDA tensor it launches D1 (``csrc/dsp_scan.cu``
    ``biquad_scan_kernel``: one launch, a warp per 32 sources, a lane a
    source, fed from coalesced shared-memory tiles of x), on a CPU tensor
    it runs its plain version, :func:`process_scan_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.ops._common import counted, on_card
from planeverb_tpu_torch.ops.analyzer import _div

SQRT_2 = 1.4142136
PI = 3.141593

__all__ = ["coefficients", "LowpassState", "process", "process_scan",
           "process_scan_reference"]


def coefficients(cutoff_hz, sampling_rate, xp=np):
    """Returns (cx, cy1, cy2) Butterworth coefficients (Lowpass.h:14-26)."""
    t = 2.0 * xp.float32(PI) * cutoff_hz / sampling_rate
    y = 1.0 / (1.0 + xp.float32(SQRT_2) * t + t * t)
    cx = t * t * y
    cy1 = (2.0 + xp.float32(SQRT_2) * t) * y
    cy2 = -1.0 * y
    return cx, cy1, cy2


class LowpassState:
    """Persistent filter memory for the streaming path (y[n-1], y[n-2])."""

    def __init__(self):
        self.y1 = np.float32(0.0)
        self.y2 = np.float32(0.0)


def process(x: np.ndarray, state: LowpassState, cutoff_hz: float,
            sampling_rate: float) -> np.ndarray:
    """Filter a mono block in place-semantics (returns new array), updating
    ``state``. Matches the reference's net behavior: coefficients are set
    directly from the submitted cutoff (SetCutoff before Process makes the
    reference's coefficient lerp a no-op — PvDSPContext.cpp:286,354).

    The recursion y[n] = cx*x[n] + cy1*y[n-1] + cy2*y[n-2] is evaluated with
    scipy's C lfilter (the same IIR with a = [1, -cy1, -cy2]) — a per-sample
    Python loop here would dominate every submit_source call.
    """
    from scipy.signal import lfilter

    cx, cy1, cy2 = coefficients(np.float32(cutoff_hz),
                                np.float32(sampling_rate))
    # direct-form II transposed initial conditions reproducing the carried
    # (y[-1], y[-2]) memory: z0 = cy1*y1 + cy2*y2, z1 = cy2*y1
    zi = np.array([cy1 * state.y1 + cy2 * state.y2, cy2 * state.y1],
                  np.float32)
    out, zf = lfilter(np.array([cx], np.float32),
                      np.array([1.0, -cy1, -cy2], np.float32),
                      np.asarray(x, np.float32), zi=zi)
    out = out.astype(np.float32)
    if len(x) >= 2:
        state.y1, state.y2 = np.float32(out[-1]), np.float32(out[-2])
    elif len(x) == 1:
        state.y1, state.y2 = np.float32(out[-1]), state.y1
    return out


# 2 * pi and sqrt(2) as the float32 constants of ``coefficients``
_TWO_PI = float(2.0 * np.float32(PI))
_SQRT_2 = float(np.float32(SQRT_2))


def _coefficients_torch(cutoff, fs: float):
    """:func:`coefficients` on an [S] float32 tensor, each op rounded once,
    in the order D1 computes them (the divisions are tensor by tensor: see
    ``ops/analyzer.py::_div``)."""
    t = _div(_TWO_PI * cutoff, fs)
    y = _div(1.0, (1.0 + _SQRT_2 * t) + t * t)
    return (t * t) * y, (2.0 + _SQRT_2 * t) * y, -1.0 * y


def process_scan_reference(x, y1, y2, cutoff_hz, sampling_rate):
    """D1's plain version: the biquad one sample at a time over [S]
    sources, ``(cx x + cy1 y1) + cy2 y2``."""
    cx, cy1, cy2 = _coefficients_torch(cutoff_hz, float(sampling_rate))
    out = torch.empty_like(x)
    for t in range(x.shape[1]):
        v = (cx * x[:, t] + cy1 * y1) + cy2 * y2
        out[:, t] = v
        y1, y2 = v, y1
    return out, y1, y2


def _check_scan(where, x, y1, y2, cutoff):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{where}: x must be float32 [S, N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    for name, t in (("y1", y1), ("y2", y2), ("cutoff_hz", cutoff)):
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0],):
            raise ValueError(f"{where}: {name} must be float32 "
                             f"[{x.shape[0]}], got {t.dtype} "
                             f"{tuple(t.shape)}")


@counted
def process_scan(x, y1, y2, cutoff_hz, sampling_rate):
    """Batched biquad over [S, N] (D1).

    Args:
      x: [S, N] float32 mono blocks.
      y1, y2: [S] carried filter memories.
      cutoff_hz: [S] per-source cutoffs.
    Returns (filtered [S, N], y1', y2'). A CUDA tensor launches D1, a CPU
    tensor runs :func:`process_scan_reference`.
    """
    where = "process_scan"
    _check_scan(where, x, y1, y2, cutoff_hz)
    if not on_card(where, x, y1, y2, cutoff_hz):
        return process_scan_reference(x, y1, y2, cutoff_hz, sampling_rate)
    s, n = x.shape
    x, y1, y2, cutoff_hz = (t.contiguous() for t in (x, y1, y2, cutoff_hz))
    out = torch.empty_like(x)
    y1o = torch.empty_like(y1)
    y2o = torch.empty_like(y2)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pv_biquad_scan(
            x.data_ptr(), y1.data_ptr(), y2.data_ptr(), cutoff_hz.data_ptr(),
            out.data_ptr(), y1o.data_ptr(), y2o.data_ptr(), s, n,
            float(np.float32(sampling_rate)), _TWO_PI, _SQRT_2, stream)
    kernels.check(err, where)
    process_scan.launches += s > 0      # no sources: nothing launched
    return out, y1o, y2o
