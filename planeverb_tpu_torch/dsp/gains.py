"""DSP gain math shared by the streaming, batched, and native renderers.

Reproduces the reference's wet-bus split and spatialization math
(reference PlaneverbDSP/src/PvDSPContext.cpp:158-247, 294-318):

  - ``find_gain_a/b/c``: split a source's wet gain across the three canonical
    reverbs (0.5 s / 1 s / 3 s decay) so the combined energy envelope at
    T* = 0.1 s matches the target RT60.
  - ``pan_gains``: constant-power stereo pan from DOA vs listener forward,
    theta = (listener_angle - doa_angle)/2, L,R = (cos∓sin)/sqrt(2).
  - directivity patterns (omni / cardioid) and 1/r distance attenuation.

Written against the ``numpy`` namespace (the streaming renderer,
dsp/context.py); the batched renderer (dsp/ops.py) has torch counterparts of
the functions it calls.
"""

from __future__ import annotations

import numpy as np

T_ER_1 = 0.5   # PV_DSP_T_ER_1..3 (PvDSPTypes.h:13-15)
T_ER_2 = 1.0
T_ER_3 = 3.0
TSTAR = 0.1
MIN_DRY_GAIN = 0.01
INV_SQRT_2 = float(1.0 / np.sqrt(2.0))
MAX_AUDIBLE_FREQ = 20000.0
MIN_AUDIBLE_FREQ = 20.0

__all__ = ["db_to_gain", "gain_to_db", "find_gain_a", "find_gain_b", "find_gain_c", "find_wet_gains",
           "pan_gains", "cardioid", "omni", "distance_attenuation",
           "lerp_ramp", "lerp_final",
           "T_ER_1", "T_ER_2", "T_ER_3", "MIN_DRY_GAIN",
           "MAX_AUDIBLE_FREQ", "MIN_AUDIBLE_FREQ", "INV_SQRT_2"]


def db_to_gain(db, xp=np):
    """Volume dB -> linear gain (PlaneverbEmitter.cs volume handling)."""
    return xp.power(xp.float32(10.0), xp.asarray(db, dtype=xp.float32) / 20.0)


def gain_to_db(gain, xp=np):
    """Linear gain -> dB with a -200 dB floor (Editor.cpp:396-434 readouts)."""
    g = xp.maximum(xp.abs(xp.asarray(gain, dtype=xp.float32)), 1e-10)
    return 20.0 * xp.log10(g)


def find_gain_a(rt60, dry_gain, xp=np):
    """Bus-A (0.5 s reverb) gain (PvDSPContext.cpp:165-181)."""
    rt60 = xp.asarray(rt60, dtype=xp.float32)
    dry_gain = xp.asarray(dry_gain, dtype=xp.float32)
    term1 = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_2)
    term2 = xp.power(xp.float32(10.0), -3.0 * TSTAR / xp.maximum(rt60, 1e-20))
    term3 = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_1)
    a = dry_gain * (term1 - term2) / (term1 - term3)
    out = xp.where(rt60 > T_ER_2, xp.float32(0.0),
                   xp.where(rt60 < T_ER_1, xp.float32(1.0), a))
    return out


def find_gain_b(rt60, dry_gain, xp=np):
    """Bus-B (1 s reverb) gain (PvDSPContext.cpp:183-207)."""
    rt60 = xp.asarray(rt60, dtype=xp.float32)
    dry_gain = xp.asarray(dry_gain, dtype=xp.float32)
    term2 = xp.power(xp.float32(10.0), -3.0 * TSTAR / xp.maximum(rt60, 1e-20))
    # branch rt60 > T_ER_2: interpolate between buses B and C
    t1_hi = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_3)
    t3_hi = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_2)
    a_hi = dry_gain * (t1_hi - term2) / (t1_hi - t3_hi)
    # branch rt60 <= T_ER_2: interpolate between buses A and B
    t1_lo = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_2)
    t3_lo = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_1)
    a_lo = dry_gain * (t1_lo - term2) / (t1_lo - t3_lo)
    out = xp.where(rt60 > T_ER_2, a_hi, dry_gain - a_lo)
    return xp.where(rt60 < T_ER_1, xp.float32(0.0), out)


def find_gain_c(rt60, dry_gain, xp=np):
    """Bus-C (3 s reverb) gain (PvDSPContext.cpp:209-228)."""
    rt60 = xp.asarray(rt60, dtype=xp.float32)
    dry_gain = xp.asarray(dry_gain, dtype=xp.float32)
    term1 = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_3)
    term2 = xp.power(xp.float32(10.0), -3.0 * TSTAR / xp.maximum(rt60, 1e-20))
    term3 = 10.0 ** xp.float32(-3.0 * TSTAR / T_ER_2)
    a = dry_gain * (term1 - term2) / (term1 - term3)
    out = xp.where(rt60 > T_ER_3, xp.float32(1.0),
                   xp.where(rt60 < T_ER_2, xp.float32(0.0), dry_gain - a))
    return out


def find_wet_gains(rt60, wet_gain, xp=np):
    return (find_gain_a(rt60, wet_gain, xp),
            find_gain_b(rt60, wet_gain, xp),
            find_gain_c(rt60, wet_gain, xp))


def pan_gains(direction_x, direction_y, listener_fwd_x, listener_fwd_z, xp=np):
    """Constant-power stereo pan (PvDSPContext.cpp:294-318).

    Returns (left, right).
    """
    angle = xp.arctan2(listener_fwd_z, listener_fwd_x)
    phi = xp.arctan2(direction_y, direction_x)
    theta = (angle - phi) * 0.5
    ct = xp.cos(theta)
    st = xp.sin(theta)
    return (INV_SQRT_2 * (ct - st), INV_SQRT_2 * (ct + st))


def omni(directivity_x, directivity_y, forward_x, forward_y, xp=np):
    return xp.ones_like(xp.asarray(directivity_x, dtype=xp.float32))


def cardioid(directivity_x, directivity_y, forward_x, forward_y, xp=np):
    """Cardioid source pattern, floored at MIN_DRY_GAIN
    (PvDSPContext.cpp:236-242)."""
    dot = directivity_x * forward_x + directivity_y * forward_y
    card = (1.0 + dot) * 0.5
    return xp.maximum(card, xp.float32(MIN_DRY_GAIN))


def distance_attenuation(listener_x, listener_z, emitter_x, emitter_y, xp=np):
    """1/r with a 1 m floor (PvDSPContext.cpp:321-331)."""
    dx = listener_x - emitter_x
    dz = listener_z - emitter_y
    d = xp.sqrt(dx * dx + dz * dz)
    return 1.0 / xp.maximum(d, xp.float32(1.0))


def lerp_ramp(current, target, factor, n, xp=np):
    """Closed form of the reference's per-sample LERP_FLOAT recursion.

    g_{j+1} = g_j (1-f) + T f  =>  g_j = T + (g_0 - T)(1-f)^j.
    Returns the length-``n`` ramp g_0..g_{n-1} (values *used* at each sample)
    and g_n (the post-loop state). Shapes broadcast: current/target may be
    [...] and the ramp gains an appended axis of length n. ``factor`` may be
    a traced scalar; ``n`` must be a static int.
    """
    current = xp.asarray(current, dtype=xp.float32)
    target = xp.asarray(target, dtype=xp.float32)
    f = xp.asarray(factor, dtype=xp.float32)
    j = xp.arange(n, dtype=xp.float32)
    decay = xp.power(1.0 - f, j)
    ramp = target[..., None] + (current - target)[..., None] * decay
    final = target + (current - target) * xp.power(1.0 - f, xp.float32(n))
    return ramp, final


def lerp_final(current, target, factor, n, xp=np):
    """Just the post-loop state of :func:`lerp_ramp` (no ramp allocation)."""
    current = xp.asarray(current, dtype=xp.float32)
    target = xp.asarray(target, dtype=xp.float32)
    f = xp.asarray(factor, dtype=xp.float32)
    return target + (current - target) * xp.power(1.0 - f, xp.float32(n))
