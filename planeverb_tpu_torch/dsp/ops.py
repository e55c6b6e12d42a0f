"""Batched DSP renderer — many sources in one call on a torch device.

Counterpart of the JAX package's batched renderer, the replacement for the
reference's one-source-at-a-time audio-thread loop (reference
PlaneverbDSP/src/PvDSPContext.cpp:250-425): all S sources are rendered in
parallel over a [S, N] block. Per-sample smoothing recursions become
closed-form geometric ramps (the torch counterparts of dsp/gains.py below);
the only true recurrence, the Butterworth biquad, runs as one D1 launch
over the frame axis carrying [S] filter memories (``dsp/lowpass.py
process_scan``; its plain version on the CPU). Output buses are summed over
sources on the device; everything but the biquad is elementwise torch.

Semantics match dsp/context.py (the streaming renderer); tests cross-check
the two block for block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planeverb_tpu_torch.config import PlaneverbDSPConfig
from planeverb_tpu_torch.dsp import gains
from planeverb_tpu_torch.dsp.lowpass import process_scan
from planeverb_tpu_torch.ops.analyzer import _div

__all__ = ["SourceParams", "DSPState", "render_block", "init_state",
           "find_wet_gains", "pan_gains", "cardioid", "distance_attenuation",
           "lerp_ramp", "lerp_final"]


class SourceParams(NamedTuple):
    """SoA per-source parameter set ([S] leading axis everywhere)."""

    occlusion: torch.Tensor       # [S]
    wet_gain: torch.Tensor        # [S]
    rt60: torch.Tensor            # [S]
    lowpass: torch.Tensor         # [S]
    direction: torch.Tensor       # [S, 2]
    position: torch.Tensor        # [S, 2]
    forward: torch.Tensor         # [S, 2]
    directivity: torch.Tensor     # [S, 2]
    pattern: torch.Tensor         # [S] int32 (0 omni, 1 cardioid)


class DSPState(NamedTuple):
    current: SourceParams
    lpf_y1: torch.Tensor          # [S]
    lpf_y2: torch.Tensor          # [S]


def init_state(num_sources: int, device=None) -> DSPState:
    """Default per-source state (EmissionData defaults,
    PlaneverbDSP EmissionManager.h:20-31) on ``device`` (default "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    s = num_sources

    def full(v, shape=(s,), dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    z2 = full(0.0, (s, 2))
    cur = SourceParams(
        occlusion=full(1.0), wet_gain=full(1.0), rt60=full(0.0),
        lowpass=full(20000.0), direction=z2, position=z2, forward=z2,
        directivity=z2, pattern=full(1, dtype=torch.int32))
    return DSPState(current=cur, lpf_y1=full(0.0), lpf_y2=full(0.0))


# --------------------------------------------------- dsp/gains.py in torch
# The functions render_block calls, on float32 tensors, each op rounded once
# in dsp/gains.py's order. Constants are gains.py's, rounded to float32 as
# the JAX renderer rounds them; every division by a tensor or of a scalar is
# a tensor-by-tensor division (ops/analyzer.py _div).
def _f32(v) -> float:
    return float(np.float32(v))


def _pow10(e) -> float:
    """gains.py ``10.0 ** xp.float32(e)``: a float32 power of ten."""
    return float(np.float32(10.0) ** np.float32(e))


# each canonical reverb's envelope at T*, 10 ** (-3 T* / T_ER_k)
_ENV1, _ENV2, _ENV3 = (_pow10(-3.0 * gains.TSTAR / t)
                       for t in (gains.T_ER_1, gains.T_ER_2, gains.T_ER_3))


def _term2(rt60):
    """10 ** (-3 T* / max(rt60, 1e-20))."""
    e = _div(-3.0 * gains.TSTAR, torch.clamp(rt60, min=1e-20))
    return torch.pow(torch.full_like(e, 10.0), e)


def _split(dry_gain, t1: float, term2, t3: float):
    """dry_gain * (t1 - term2) / (t1 - t3), t1 - t3 in float32."""
    return _div(dry_gain * (t1 - term2), _f32(np.float32(t1)
                                              - np.float32(t3)))


def find_wet_gains(rt60, wet_gain):
    """gains.py ``find_wet_gains``: the (A, B, C) bus gains of [S] sources.
    gains.py's ``find_gain_a`` and ``find_gain_b``'s lower branch share one
    split (between buses A and B), ``find_gain_b``'s upper branch and
    ``find_gain_c`` another (B and C); each is computed once."""
    zero = torch.zeros_like(rt60)
    one = torch.ones_like(rt60)
    term2 = _term2(rt60)
    lo = _split(wet_gain, _ENV2, term2, _ENV1)
    hi = _split(wet_gain, _ENV3, term2, _ENV2)
    ga = torch.where(rt60 > gains.T_ER_2, zero,
                     torch.where(rt60 < gains.T_ER_1, one, lo))
    gb = torch.where(rt60 > gains.T_ER_2, hi, wet_gain - lo)
    gb = torch.where(rt60 < gains.T_ER_1, zero, gb)
    gc = torch.where(rt60 > gains.T_ER_3, one,
                     torch.where(rt60 < gains.T_ER_2, zero, wet_gain - hi))
    return ga, gb, gc


def pan_gains(direction_x, direction_y, listener_fwd_x, listener_fwd_z):
    """gains.py ``pan_gains``: constant-power (left, right)."""
    angle = torch.atan2(listener_fwd_z, listener_fwd_x)
    phi = torch.atan2(direction_y, direction_x)
    theta = (angle - phi) * 0.5
    ct = torch.cos(theta)
    st = torch.sin(theta)
    inv = _f32(gains.INV_SQRT_2)
    return inv * (ct - st), inv * (ct + st)


def cardioid(directivity_x, directivity_y, forward_x, forward_y):
    """gains.py ``cardioid``, floored at MIN_DRY_GAIN."""
    dot = directivity_x * forward_x + directivity_y * forward_y
    card = (1.0 + dot) * 0.5
    return torch.clamp(card, min=_f32(gains.MIN_DRY_GAIN))


def distance_attenuation(listener_x, listener_z, emitter_x, emitter_y):
    """gains.py ``distance_attenuation``: 1/r with a 1 m floor."""
    dx = listener_x - emitter_x
    dz = listener_z - emitter_y
    d = torch.sqrt(dx * dx + dz * dz)
    return _div(1.0, torch.clamp(d, min=1.0))


def _decay(factor: float, exponent):
    """(1 - f) ** exponent, exponent a float32 tensor."""
    base = torch.full_like(exponent, _f32(np.float32(1.0)
                                          - np.float32(factor)))
    return torch.pow(base, exponent)


def lerp_ramp(current, target, factor: float, n: int):
    """gains.py ``lerp_ramp``: the [..., n] ramp g_0..g_{n-1} and g_n."""
    j = torch.arange(n, dtype=torch.float32, device=current.device)
    ramp = target[..., None] + (current - target)[..., None] * _decay(factor,
                                                                      j)
    return ramp, lerp_final(current, target, factor, n)


def lerp_final(current, target, factor: float, n: int):
    """gains.py ``lerp_final``: g_n alone."""
    nn = torch.full((), float(n), dtype=torch.float32, device=current.device)
    return target + (current - target) * _decay(factor, nn)


# ------------------------------------------------------------- the render
def render_block(config: PlaneverbDSPConfig, audio, target: SourceParams,
                 state: DSPState, listener_pos, listener_fwd):
    """Render one block for all sources, on the device of ``audio``.

    Args:
      config: DSP configuration.
      audio: [S, N, 2] stereo blocks (or [S, N] mono), float32.
      target: latest per-source acoustic params (tensors on that device).
      state: carried smoothing + filter state (:func:`init_state`).
      listener_pos: [3], listener_fwd: [3] (tensors or sequences).

    Returns:
      (buses, new_state) where buses = (dry, wetA, wetB, wetC), each [N, 2].
    """
    dev = audio.device
    listener_pos = torch.as_tensor(listener_pos, dtype=torch.float32,
                                   device=dev)
    listener_fwd = torch.as_tensor(listener_fwd, dtype=torch.float32,
                                   device=dev)
    if audio.dim() == 2:
        mono_in = audio
    else:
        mono_in = (audio[..., 0] + audio[..., 1]) * 0.5
    s, n = mono_in.shape
    cur = state.current

    # input rejection (PvDSPContext.cpp:258-263): rejected sources render
    # silence and keep their current params/filters frozen
    valid = ((target.lowpass >= gains.MIN_AUDIBLE_FREQ)
             & (target.lowpass <= gains.MAX_AUDIBLE_FREQ)
             & (target.occlusion > 0.0)
             & ((target.direction[:, 0] != 0.0)
                | (target.direction[:, 1] != 0.0)))
    # extend the reference gate with finiteness: NaN passes every range
    # comparison above (NaN < x is false), and one non-finite param would
    # poison the cross-source bus sums for the whole batch
    valid = (valid
             & torch.isfinite(target.occlusion)
             & torch.isfinite(target.wet_gain)
             & torch.isfinite(target.rt60) & torch.isfinite(target.lowpass)
             & torch.isfinite(target.direction).all(-1)
             & torch.isfinite(target.position).all(-1)
             & torch.isfinite(target.forward).all(-1)
             & torch.isfinite(target.directivity).all(-1))

    # Sanitize rejected sources' params to their current values BEFORE any
    # math: a NaN/Inf param would otherwise flow through the filter/gain
    # chains, and NaN * 0 masking still poisons the cross-source bus sums
    # (the streaming renderer isolates invalid sources by early return).
    def _san(t, c):
        return torch.where(valid[:, None] if t.dim() == 2 else valid, t, c)

    target = SourceParams(*(_san(t, c) for t, c in zip(target, cur)))

    factor = 1.0 / (n * config.dsp_smoothing_factor)

    # wet-bus split
    tg = find_wet_gains(target.rt60, target.wet_gain)
    cg = find_wet_gains(cur.rt60, cur.wet_gain)

    # pan
    lfx = listener_fwd[0]
    lfz = listener_fwd[2]
    if config.use_spatialization:
        t_l, t_r = pan_gains(target.direction[:, 0], target.direction[:, 1],
                             lfx, lfz)
        c_l, c_r = pan_gains(cur.direction[:, 0], cur.direction[:, 1],
                             lfx, lfz)
    else:
        t_l = t_r = c_l = c_r = torch.ones(s, dtype=torch.float32,
                                           device=dev)

    # source directivity (current map's pattern, target forward)
    def dir_gain(d, fwd):
        card = cardioid(d[:, 0], d[:, 1], fwd[:, 0], fwd[:, 1])
        return torch.where(cur.pattern == 1, card, torch.ones_like(card))

    t_dir = dir_gain(target.directivity, target.forward)
    c_dir = dir_gain(cur.directivity, target.forward)

    # distance attenuation
    lx = listener_pos[0]
    lz = listener_pos[2]
    t_dist = distance_attenuation(lx, lz, target.position[:, 0],
                                  target.position[:, 1])
    c_dist = distance_attenuation(lx, lz, cur.position[:, 0],
                                  cur.position[:, 1])

    t_dry = torch.clamp(target.occlusion, min=_f32(gains.MIN_DRY_GAIN))
    c_dry = cur.occlusion

    # ---- lowpass all sources (one D1 launch over the frame axis)
    mono_f, y1, y2 = process_scan(mono_in.contiguous(), state.lpf_y1,
                                  state.lpf_y2, target.lowpass,
                                  config.sampling_rate)
    # frozen filters for rejected sources
    y1 = torch.where(valid, y1, state.lpf_y1)
    y2 = torch.where(valid, y2, state.lpf_y2)
    mono_f = torch.where(valid[:, None], mono_f, torch.zeros_like(mono_f))

    # ---- wet buses
    ratio = _f32(config.wet_gain_ratio)
    wet_buses = []
    for cgi, tgi in zip(cg, tg):
        ramp, _ = lerp_ramp(cgi, tgi, factor, n)
        wet = torch.sum(mono_f * ramp, dim=0) * ratio       # [N]
        wet_buses.append(torch.stack([wet, wet], dim=-1))   # [N, 2]

    # ---- dry chain
    dry_ramp, dry_final = lerp_ramp(c_dry, t_dry, factor, n)
    dir_ramp, _ = lerp_ramp(c_dir, t_dir, factor, n)
    dist_ramp, _ = lerp_ramp(c_dist, t_dist, factor, n)
    dry = mono_f * (dry_ramp * dir_ramp * dist_ramp)       # [S, N]

    l_ramp, _ = lerp_ramp(c_l, t_l, factor, n)
    r_ramp, _ = lerp_ramp(c_r, t_r, factor, n)
    dry_bus = torch.stack([torch.sum(dry * l_ramp, dim=0),
                           torch.sum(dry * r_ramp, dim=0)], dim=-1)

    # ---- settle current params toward targets (valid sources only)
    def settle(c, t):
        return _san(lerp_final(c, t, factor, n), c)

    new_cur = SourceParams(
        occlusion=torch.where(valid, dry_final, cur.occlusion),
        wet_gain=settle(cur.wet_gain, target.wet_gain),
        rt60=settle(cur.rt60, target.rt60),
        lowpass=torch.where(valid, target.lowpass, cur.lowpass),
        direction=settle(cur.direction, target.direction),
        position=settle(cur.position, target.position),
        forward=settle(cur.forward, target.forward),
        directivity=settle(cur.directivity, target.directivity),
        pattern=torch.where(valid, target.pattern, cur.pattern),
    )

    buses = (dry_bus, wet_buses[0], wet_buses[1], wet_buses[2])
    return buses, DSPState(current=new_cur, lpf_y1=y1, lpf_y2=y2)
