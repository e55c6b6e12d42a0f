"""Streaming DSP renderer — per-callback parameter renderer (PvDSPContext analog).

Re-design of reference PlaneverbDSP/src/PvDSPContext.cpp:250-452 around
closed-form gain ramps: every per-sample LERP_FLOAT recursion in the reference
(g <- g(1-f) + T f) has the exact solution g_j = T + (g0 - T)(1-f)^j, so all
gain ramps (wet buses, dry gain, directivity, distance, pan) are vectorized
with one power evaluation instead of per-sample loops. The Butterworth LPF is
the only true recursion and runs in dsp/lowpass.py.

Intentional deviations from the reference, documented:
  - Wet buses **accumulate** across sources (+=). The reference overwrites
    them per SubmitSource (PvDSPContext.cpp:357-381, ``*buf++ =``), so only
    the last submitted source was ever audible in the reverbs — an evident
    bug for multi-source scenes.
  - Loop lengths use this call's ``num_frames``; the reference sizes some
    loops by the running *max* frames seen (m_numFrames, PvDSPContext.cpp:253)
    which reads stale input when callbacks shrink.
  - Directivity pattern changes take effect: the reference stores the new
    pattern only in the target map and reads the current map's pattern,
    which it never assigns (PvDSPContext.cpp:84-88, 321) — so
    SetEmitterDirectivityPattern is a no-op there. Here the pattern
    propagates target -> current each submit.

For bulk rendering of many sources use the batched renderer (dsp/ops.py),
which runs on the context's torch device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from planeverb_tpu_torch.config import PlaneverbDSPConfig
from planeverb_tpu_torch.dsp import gains
from planeverb_tpu_torch.dsp.lowpass import LowpassState, process as lpf_process

__all__ = ["DSPContext", "EmissionParams", "DirectivityPattern"]

f32 = np.float32


class DirectivityPattern:
    OMNI = 0
    CARDIOID = 1


_PATTERNS = {
    DirectivityPattern.OMNI: gains.omni,
    DirectivityPattern.CARDIOID: gains.cardioid,
}


@dataclasses.dataclass
class EmissionParams:
    """Per-emitter smoothed parameter state (EmissionData analog,
    PlaneverbDSP EmissionManager.h:10-32, including its defaults)."""

    occlusion: float = 1.0
    wet_gain: float = 1.0
    rt60: float = 0.0
    lowpass: float = 20000.0
    direction: tuple = (0.0, 0.0)
    position: tuple = (0.0, 0.0)
    forward: tuple = (0.0, 0.0)
    directivity: tuple = (0.0, 0.0)
    pattern: int = DirectivityPattern.CARDIOID


class DSPContext:
    def __init__(self, config: PlaneverbDSPConfig | None = None):
        self.config = config or PlaneverbDSPConfig()
        self.config.validate()
        n = self.config.max_callback_length
        # double-buffered output buses [2][n, 2]
        self._buses = np.zeros((2, 4, n, 2), f32)  # dry, A, B, C
        self._front = 0
        self._current: dict[int, EmissionParams] = {}
        self._target: dict[int, EmissionParams] = {}
        self._lpf: dict[int, LowpassState] = {}
        self._listener_pos = (0.0, 0.0, 0.0)
        self._listener_fwd = (1.0, 0.0, 0.0)

    # ------------------------------------------------------------- setters
    def set_listener_transform(self, position, forward) -> None:
        # normalize to 3D here so a 2D tuple fails loudly at the setter, not
        # as an IndexError deep inside the next submit_source
        self._listener_pos = self._vec3(position)
        self._listener_fwd = self._vec3(forward)

    @staticmethod
    def _vec3(v) -> tuple:
        v = tuple(float(c) for c in v)
        if len(v) == 2:
            return (v[0], 0.0, v[1])
        if len(v) != 3:
            raise ValueError(f"expected a 2D or 3D vector, got {v!r}")
        return v

    def update_emitter(self, eid: int, position, forward) -> None:
        t = self._target.setdefault(eid, EmissionParams())
        t.position = (position[0], position[2] if len(position) > 2 else position[1])
        t.forward = (forward[0], forward[2] if len(forward) > 2 else forward[1])

    def set_emitter_directivity_pattern(self, eid: int, pattern: int) -> None:
        self._target.setdefault(eid, EmissionParams()).pattern = pattern

    def remove_emitter(self, eid: int) -> None:
        self._current.pop(eid, None)
        self._target.pop(eid, None)
        self._lpf.pop(eid, None)

    # ------------------------------------------------------------ pipeline
    def submit_source(self, eid: int, dsp_input, audio: np.ndarray) -> None:
        """Process one source's block into the output buses.

        Args:
          eid: emission id.
          dsp_input: PlaneverbOutput-like with occlusion/wet_gain/rt60/
            lowpass/direction/source_directivity.
          audio: [N, 2] stereo or [N] mono float32 block.
        """
        cfg = self.config
        audio = np.asarray(audio, f32)
        if audio.ndim == 1:
            mono_in = audio
        else:
            mono_in = (audio[:, 0] + audio[:, 1]) * f32(0.5)
        n = len(mono_in)
        if n == 0 or n > cfg.max_callback_length:
            return

        lp = float(dsp_input.lowpass)
        obst = float(dsp_input.occlusion)
        dvec = (float(dsp_input.direction.x), float(dsp_input.direction.y))
        # input rejection (PvDSPContext.cpp:258-263), extended with
        # finiteness (NaN passes every range comparison and would poison
        # the filter/gain state for this source permanently)
        if (lp < gains.MIN_AUDIBLE_FREQ or lp > gains.MAX_AUDIBLE_FREQ
                or obst <= 0.0 or (dvec[0] == 0.0 and dvec[1] == 0.0)):
            return
        import math as _math
        params_all = (lp, obst, float(dsp_input.wet_gain),
                      float(dsp_input.rt60), dvec[0], dvec[1],
                      float(dsp_input.source_directivity.x),
                      float(dsp_input.source_directivity.y))
        if not all(_math.isfinite(v) for v in params_all):
            return

        cur = self._current.setdefault(eid, EmissionParams())
        tgt = self._target.setdefault(eid, EmissionParams())
        lpf_state = self._lpf.setdefault(eid, LowpassState())

        # update targets from this submission (PvDSPContext.cpp:277-287)
        sdir = dsp_input.source_directivity
        tgt.occlusion = obst
        tgt.wet_gain = float(dsp_input.wet_gain)
        tgt.rt60 = float(dsp_input.rt60)
        tgt.lowpass = lp
        tgt.direction = dvec
        tgt.directivity = (float(sdir.x), float(sdir.y))

        factor = 1.0 / (n * cfg.dsp_smoothing_factor)

        # wet-bus gains: current & target splits (PvDSPContext.cpp:268-296)
        tga, tgb, tgc = gains.find_wet_gains(tgt.rt60, tgt.wet_gain)
        cga, cgb, cgc = gains.find_wet_gains(cur.rt60, cur.wet_gain)

        # pan gains (PvDSPContext.cpp:298-318)
        lfx, lfz = self._listener_fwd[0], self._listener_fwd[2]
        if cfg.use_spatialization:
            t_l, t_r = gains.pan_gains(tgt.direction[0], tgt.direction[1], lfx, lfz)
            c_l, c_r = gains.pan_gains(cur.direction[0], cur.direction[1], lfx, lfz)
        else:
            t_l = t_r = c_l = c_r = 1.0

        # directivity gains: pattern of *current* map entry, target forward
        # (PvDSPContext.cpp:320-323)
        pattern = _PATTERNS[cur.pattern if cur.pattern in _PATTERNS
                            else DirectivityPattern.OMNI]
        t_dir = float(pattern(tgt.directivity[0], tgt.directivity[1],
                              tgt.forward[0], tgt.forward[1]))
        c_dir = float(pattern(cur.directivity[0], cur.directivity[1],
                              tgt.forward[0], tgt.forward[1]))

        # distance attenuation (PvDSPContext.cpp:325-337)
        lx, lz = self._listener_pos[0], self._listener_pos[2]
        t_dist = float(gains.distance_attenuation(lx, lz, *tgt.position))
        c_dist = float(gains.distance_attenuation(lx, lz, *cur.position))

        t_dry = max(tgt.occlusion, gains.MIN_DRY_GAIN)
        c_dry = cur.occlusion

        # ---- processing (all ramps closed-form) ----
        mono = lpf_process(mono_in, lpf_state, tgt.lowpass, cfg.sampling_rate)

        buses = self._buses[self._front]
        ratio = f32(cfg.wet_gain_ratio)
        for bus, cg, tg in ((buses[1], cga, tga), (buses[2], cgb, tgb),
                            (buses[3], cgc, tgc)):
            ramp, _ = gains.lerp_ramp(cg, tg, factor, n)
            wet = mono * ramp.reshape(n) * ratio
            bus[:n, 0] += wet
            bus[:n, 1] += wet

        dry_ramp, dry_final = gains.lerp_ramp(c_dry, t_dry, factor, n)
        dir_ramp, _ = gains.lerp_ramp(c_dir, t_dir, factor, n)
        dist_ramp, _ = gains.lerp_ramp(c_dist, t_dist, factor, n)
        dry = mono * (dry_ramp * dir_ramp * dist_ramp).reshape(n)

        l_ramp, _ = gains.lerp_ramp(c_l, t_l, factor, n)
        r_ramp, _ = gains.lerp_ramp(c_r, t_r, factor, n)
        buses[0][:n, 0] += dry * l_ramp.reshape(n)
        buses[0][:n, 1] += dry * r_ramp.reshape(n)

        # ---- smooth current params toward targets (PvDSPContext.cpp:407-424)
        def settle(c, t):
            return gains.lerp_final(np.asarray(c, f32), np.asarray(t, f32),
                                    factor, n)

        cur.occlusion = float(dry_final)
        cur.direction = tuple(settle(np.array(cur.direction),
                                     np.array(tgt.direction)))
        cur.wet_gain = float(settle(cur.wet_gain, tgt.wet_gain))
        cur.rt60 = float(settle(cur.rt60, tgt.rt60))
        cur.forward = tuple(settle(np.array(cur.forward), np.array(tgt.forward)))
        cur.directivity = tuple(settle(np.array(cur.directivity),
                                       np.array(tgt.directivity)))
        cur.position = tuple(settle(np.array(cur.position),
                                    np.array(tgt.position)))
        cur.lowpass = tgt.lowpass
        cur.pattern = tgt.pattern

    def get_output(self):
        """Return (dry, wetA, wetB, wetC) [max_callback, 2] and swap/zero the
        back buffers (PvDSPContext.cpp:427-452)."""
        out = self._buses[self._front]
        self._front ^= 1
        self._buses[self._front][:] = 0.0
        return out[0], out[1], out[2], out[3]
