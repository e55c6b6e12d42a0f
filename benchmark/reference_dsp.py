"""The plain DSP the audio cell is judged against: the audio callback's
renderer and its three reverbs, replayed from the DSP's creation on what
each block was fed.

Frozen from the port's plain versions, importing nothing of the port (as
``reference.py`` is):

- the per-voice renderer of ``dsp/context.py``, ``dsp/gains.py`` and
  ``dsp/lowpass.py`` (PvDSPContext.cpp:250-452, EmissionManager.h:10-32,
  Lowpass.h:14-26), with that renderer's documented departures from
  PvDSPContext.cpp: the wet buses accumulate across voices (the C++ source
  overwrites them), loops run over the block's own frames, and a voice's
  directivity pattern passes from its target to its current state at each
  submission;
- the reverbs of ``dsp/reverb.py::reverb_scan_reference`` (Reverb.h's four
  damped combs and two allpasses, the comb feedback from the decay).

Arithmetic. The signal path (each voice's mono block, the lowpass, every
gain ramp in closed form, the buses, the reverbs, the mix) runs in float64.
The smoothed parameters a voice carries from one block to the next are kept
and settled in float32, as the DSP keeps them: the wet split's thresholds
(0.5 s and 3 s) and the pan's angle branch on them, and a float64 state
would take the other branch wherever rounding left a value on the far side.
The DSP's inputs (settings, transforms, rows) cross its C interface as
float32 and are taken so.

Vectorised over the voices within a block; the reverbs run after the voices
over the whole stream, in chunks no longer than the shortest delay, which
is as far as their recursions allow.

``store`` (optional) is applied to every array the DSP keeps between its
steps: the clips, the parameter rows and carried state, the buses, the delay
lines, the mix. :func:`bf16` there makes the control that the comparison has
to fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.signal import lfilter

# the three canonical decays and the wet split (gains.py, PvDSPTypes.h:13-15)
T_ER = (0.5, 1.0, 3.0)
TSTAR = 0.1
MIN_DRY_GAIN = 0.01
INV_SQRT_2 = 1.0 / math.sqrt(2.0)
MIN_FREQ, MAX_FREQ = 20.0, 20000.0
# the lowpass law's constants, as float32 (lowpass.py)
PI = float(np.float32(3.141593))
SQRT_2 = float(np.float32(1.4142136))
# a voice's pattern before its first submission (EmissionManager.h:31)
CARDIOID = 1
# the reverb (reverb.py, Reverb.h:16-24)
COMB_DELAYS_S = (0.0297, 0.0371, 0.0411, 0.0437)
ALLPASS_DELAYS_S = (0.005, 0.0017)
ALLPASS_G = 0.5
DAMP = float(np.float32(0.2))
ONE_MINUS_DAMP = float(np.float32(1.0) - np.float32(0.2))
# a parameter row's columns
OCC, WET, RT60, LOWPASS, DIR_X, DIR_Y, SDIR_X, SDIR_Y = range(8)

f32 = np.float32


def _keep(x):
    return x


def bf16(x) -> np.ndarray:
    """Round to bfloat16 (via float32, nearest, ties to even), as float64:
    the nearest precision below the configuration's float32."""
    a = np.ascontiguousarray(x, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Stream:
    """The DSP's settings, as a traffic file's ``audio`` states them."""
    rate: int
    frames: int
    smoothing: float
    spatialization: bool
    wet_ratio: float
    rt60s: tuple

    @classmethod
    def of(cls, audio: dict) -> "Stream":
        return cls(int(audio["rate_hz"]), int(audio["frames"]),
                   float(f32(audio["smoothing"])),
                   bool(audio["spatialization"]),
                   float(f32(audio["wet_gain_ratio"])),
                   tuple(float(r) for r in audio["reverb_rt60_s"]))


def wet_gains(rt60, gain) -> np.ndarray:
    """[..., 3]: the wet gain split over the three reverbs so that their
    energy at T* matches ``rt60`` (FindGainA/B/C, PvDSPContext.cpp:165-228;
    no clamp above T_ER_3 in B, as there)."""
    rt60 = np.asarray(rt60, np.float64)
    gain = np.asarray(gain, np.float64)

    def p(t):
        return 10.0 ** (-3.0 * TSTAR / t)

    t1, t2, t3 = T_ER
    r = p(np.maximum(rt60, 1e-20))
    a = np.where(rt60 > t2, 0.0, np.where(
        rt60 < t1, 1.0, gain * (p(t2) - r) / (p(t2) - p(t1))))
    b = np.where(rt60 < t1, 0.0, np.where(
        rt60 > t2, gain * (p(t3) - r) / (p(t3) - p(t2)),
        gain - gain * (p(t2) - r) / (p(t2) - p(t1))))
    c = np.where(rt60 > t3, 1.0, np.where(
        rt60 < t2, 0.0, gain - gain * (p(t3) - r) / (p(t3) - p(t2))))
    return np.stack([a, b, c], -1)


def pan(dx, dy, fx, fz):
    """Constant-power pan of an arrival direction against the listener's
    forward (PvDSPContext.cpp:294-318): (left, right)."""
    theta = (np.arctan2(fz, fx) - np.arctan2(dy, dx)) * 0.5
    c, s = np.cos(theta), np.sin(theta)
    return INV_SQRT_2 * (c - s), INV_SQRT_2 * (c + s)


def directivity(pattern, d, f):
    """Cardioid (pattern 1) floored at MIN_DRY_GAIN, else omni
    (PvDSPContext.cpp:236-242); ``d`` and ``f`` [..., 2]."""
    card = ((1.0 + d[..., 0] * f[..., 0]) + d[..., 1] * f[..., 1]) * 0.5
    return np.where(pattern == CARDIOID, np.maximum(card, MIN_DRY_GAIN), 1.0)


def distance(lx, lz, pos):
    """1/r with a 1 m floor (PvDSPContext.cpp:321-337)."""
    return 1.0 / np.maximum(np.hypot(lx - pos[..., 0], lz - pos[..., 1]),
                            1.0)


def lowpass(x, y1, y2, cutoff, rate):
    """The Butterworth lowpass (Lowpass.h:14-26) over [V, n] blocks, each
    row from its own cutoff [V] and memories y[-1], y[-2] [V]:
    y[t] = cx x[t] + cy1 y[t-1] + cy2 y[t-2].

    The coefficients are the law evaluated in float32, each operation
    rounded in the DSP's order, as the DSP evaluates them: at a low cutoff
    1 - cy1 - cy2 is about T^2, and its float32 rounding moves the filter's
    gain by up to a part in a thousand; the configuration's filter is that
    one. The recursion then runs in float64, in closed form: its poles are
    r e^(+-i theta) with r^2 = -cy2 and 2 r cos theta = cy1, never real;
    h[t] = r^t sin((t + 1) theta) / sin theta is its impulse response, and
    the block is cx (h * x) (by FFT) plus the memories' own decay,
    (cy1 y[-1] + cy2 y[-2]) h[t] + cy2 y[-1] h[t - 1]."""
    t = f32(2.0) * f32(PI) * np.asarray(cutoff, f32) / f32(rate)
    y = f32(1.0) / (f32(1.0) + f32(SQRT_2) * t + t * t)
    c = (t * t * y, (f32(2.0) + f32(SQRT_2) * t) * y, f32(-1.0) * y)
    cx, c1, c2 = (v.astype(np.float64) for v in c)
    r = np.sqrt(-c2)
    theta = np.arctan2(np.sqrt(np.maximum(4.0 * r * r - c1 * c1, 0.0)), c1)
    n = x.shape[-1]
    # p^(t + 1) = p^(w q) p^(l + 1) for t = w q + l, p = r e^(i theta)
    w = 32
    p = (r * np.exp(1j * theta))[:, None]
    rows = -(-n // w)
    power = ((p ** (w * np.arange(rows)))[:, :, None]
             * (p ** np.arange(1, w + 1))[:, None, :])
    h = power.reshape(len(r), -1)[:, :n].imag / (r * np.sin(theta))[:, None]
    forced = np.fft.irfft(np.fft.rfft(x, 2 * n) * np.fft.rfft(h, 2 * n),
                          2 * n)[:, :n]
    out = cx[:, None] * forced + (c1 * y1 + c2 * y2)[:, None] * h
    out[:, 1:] += (c2 * y1)[:, None] * h[:, :-1]
    return out


def accepted(rows: np.ndarray) -> np.ndarray:
    """[V] the rows the renderer takes: a cutoff within the audible band,
    a positive occlusion, a non-zero direction, every value finite
    (PvDSPContext.cpp:258-263, with the port's finiteness rule)."""
    r = rows.astype(np.float64)
    with np.errstate(invalid="ignore"):
        return (np.isfinite(r).all(-1)
                & (r[:, LOWPASS] >= MIN_FREQ) & (r[:, LOWPASS] <= MAX_FREQ)
                & (r[:, OCC] > 0.0)
                & ~((r[:, DIR_X] == 0.0) & (r[:, DIR_Y] == 0.0)))


class Voices:
    """Every voice's renderer state (EmissionData's defaults), in float32
    as the DSP keeps it, and its lowpass memory."""

    def __init__(self, n: int, stream: Stream, store=_keep):
        self.s, self.store = stream, store
        z2 = np.zeros((n, 2), f32)
        # current (smoothed) state
        self.occ = np.ones(n, f32)
        self.wet = np.ones(n, f32)
        self.rt60 = np.zeros(n, f32)
        self.dir, self.sdir, self.pos = z2.copy(), z2.copy(), z2.copy()
        self.pattern = np.full(n, CARDIOID, np.int64)
        # lowpass memory y[n-1], y[n-2]
        self.y1 = np.zeros(n)
        self.y2 = np.zeros(n)
        frames = stream.frames
        self.factor = 1.0 / (frames * stream.smoothing)
        # the ramp's decay at each sample, and after the block (float32,
        # as the DSP settles)
        self.decay = (1.0 - self.factor) ** np.arange(frames)
        self.settle = f32(f32(1.0) - f32(self.factor)) ** f32(frames)

    def _settle(self, cur, tgt):
        return self.store(tgt + (cur - tgt) * self.settle).astype(f32)

    def block(self, mono, rows, fed, listener, epos, efwd, epattern):
        """One block of every voice.

        mono [V, n] float64 input, rows [V, 8] float32, fed [V] (a row was
        submitted), listener [6] (position, forward) float32, epos / efwd
        [V, 2] float32 and epattern [V] the targets set by the engine sync.
        Returns (wet [3, n], dry [n, 2]).
        """
        s, store = self.s, self.store
        n = s.frames
        wet = np.zeros((3, n))
        dry = np.zeros((n, 2))
        k = np.flatnonzero(fed & accepted(rows))
        if k.size == 0:
            return wet, dry
        r32 = rows[k]                    # the targets, as the DSP got them
        r = r32.astype(np.float64)
        d64 = np.float64
        lx, lz = float(listener[0]), float(listener[2])
        fx, fz = float(listener[3]), float(listener[5])
        tpos, tfwd = epos[k], efwd[k]
        cur_pattern = self.pattern[k]
        # the buses' split, pan, directivity, distance and dry gains at the
        # block's start (current) and its target
        tg = wet_gains(r[:, RT60], r[:, WET])
        cg = wet_gains(self.rt60[k], self.wet[k])
        if s.spatialization:
            tl, tr = pan(r[:, DIR_X], r[:, DIR_Y], fx, fz)
            cur = self.dir[k].astype(d64)
            cl, cr = pan(cur[:, 0], cur[:, 1], fx, fz)
        else:
            tl = tr = cl = cr = np.ones(k.size)
        tdg = directivity(cur_pattern, r[:, [SDIR_X, SDIR_Y]], tfwd)
        cdg = directivity(cur_pattern, self.sdir[k].astype(d64), tfwd)
        tdist = distance(lx, lz, tpos.astype(d64))
        cdist = distance(lx, lz, self.pos[k].astype(d64))
        tdry = np.maximum(r[:, OCC], MIN_DRY_GAIN)
        cdry = self.occ[k].astype(d64)

        # the lowpass, from the target cutoff
        m = store(lowpass(mono[k], self.y1[k], self.y2[k], r32[:, LOWPASS],
                          s.rate))
        self.y1[k], self.y2[k] = m[:, -1], m[:, -2]

        def ramp(c, t):
            return t[..., None] + (c - t)[..., None] * self.decay

        wet[:] = s.wet_ratio * np.einsum("vn,vbn->bn", m, ramp(cg, tg))
        d = m * ramp(cdry, tdry) * ramp(cdg, tdg) * ramp(cdist, tdist)
        dry[:, 0] = (d * ramp(cl, tl)).sum(0)
        dry[:, 1] = (d * ramp(cr, tr)).sum(0)

        # settle the current state toward the targets
        self.occ[k] = self._settle(self.occ[k], tdry.astype(f32))
        self.wet[k] = self._settle(self.wet[k], r32[:, WET])
        self.rt60[k] = self._settle(self.rt60[k], r32[:, RT60])
        self.dir[k] = self._settle(self.dir[k], r32[:, [DIR_X, DIR_Y]])
        self.sdir[k] = self._settle(self.sdir[k], r32[:, [SDIR_X, SDIR_Y]])
        self.pos[k] = self._settle(self.pos[k], tpos)
        self.pattern[k] = epattern[k]
        return store(wet), store(dry)


def reverbs(x: np.ndarray, rt60s, rate: int, store=_keep) -> np.ndarray:
    """The reverbs over whole streams: ``x`` [R, N] float64, one row a
    reverb of decay ``rt60s[row]``, all at ``rate``. Returns [R, N].

    A comb's ring read d samples back is its delay line (the ring is at
    least d long and is read before it is written), as an allpass's is; so
    a chunk of the stream no longer than the shortest delay reads only what
    earlier chunks wrote."""
    rows, total = x.shape
    cd = [max(1, int(d * rate)) for d in COMB_DELAYS_S]
    ad = [max(1, int(d * rate)) for d in ALLPASS_DELAYS_S]
    fb = np.array([[10.0 ** (-3.0 * (d / rate) / max(rt, 1e-3)) for d in cd]
                   for rt in rt60s])[:, :, None]              # [R, 4, 1]
    lc = max(cd)
    ring = np.zeros((rows, 4, lc))
    lp = np.zeros((rows, 4, 1))
    delays = np.array(cd)[:, None]
    s = np.empty((rows, total))
    step = min(cd)
    for c0 in range(0, total, step):
        t = np.arange(c0, min(total, c0 + step))
        y = ring[:, np.arange(4)[:, None], (t - delays) % lc]   # [R, 4, L]
        damped, _ = lfilter([ONE_MINUS_DAMP], [1.0, -DAMP], y, axis=-1,
                            zi=DAMP * lp)
        damped = store(damped)
        lp = damped[..., -1:]
        ring[:, :, t % lc] = store(x[:, None, c0:t[-1] + 1] + damped * fb)
        s[:, c0:t[-1] + 1] = (((y[:, 0] + y[:, 1]) + y[:, 2]) + y[:, 3]) * 0.25
    for d in ad:
        # v[t] = s[t] + g v[t - d]; out[t] = v[t - d] - g s[t]
        v = np.empty_like(s)
        out = np.empty_like(s)
        for c0 in range(0, total, d):
            c1 = min(total, c0 + d)
            back = (v[:, c0 - d:c1 - d] if c0 >= d
                    else np.zeros((rows, c1 - c0)))
            v[:, c0:c1] = store(s[:, c0:c1] + back * ALLPASS_G)
            out[:, c0:c1] = back - ALLPASS_G * s[:, c0:c1]
        s = store(out)
    return s


def replay(stream: Stream, clips, gains, epos, efwd, epattern, rows, fed,
           listener, store=_keep) -> np.ndarray:
    """Every block from the DSP's creation: each voice looping its clip
    from the first block, the rows and listener each block was fed, the
    three reverbs on the wet buses. Returns the mix [B, frames, 2].

    clips: [V] float32 [L, 2] clips; gains [V] each voice's volume gain;
    epos / efwd [V, 2] the emitters' (x, z) position and forward, epattern
    [V] their patterns; rows [B, V, 8] float32 and fed [B, V]; listener
    [B, 6] float32.
    """
    blocks, voices = fed.shape
    n = stream.frames
    lengths = np.array([len(c) for c in clips])
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    mono = np.concatenate([
        store((store(c[:, 0] * np.float64(g)) + store(c[:, 1] * np.float64(g)))
              * 0.5) for c, g in zip(clips, gains)])
    epos = np.asarray(epos, f32)
    efwd = np.asarray(efwd, f32).astype(np.float64)
    epattern = np.asarray(epattern, np.int64)
    state = Voices(voices, stream, store)
    wet = np.empty((3, blocks * n))
    dry = np.empty((blocks, n, 2))
    ramp = np.arange(n)
    for b in range(blocks):
        idx = starts[:, None] + (b * n + ramp) % lengths[:, None]
        wet[:, b * n:(b + 1) * n], dry[b] = state.block(
            mono[idx], rows[b], fed[b], listener[b], epos, efwd, epattern)
    rev = reverbs(wet, stream.rt60s, stream.rate, store).sum(0)
    return store(dry + rev.reshape(blocks, n)[..., None])
