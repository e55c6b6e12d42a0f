"""Schroeder reverberators for the three canonical wet buses.

The reference *intends* in-engine reverb but never ships it: its Reverb.h is
a non-compiling sketch (4 parallel lowpass-comb filters at 29.7/37.1/41.1/
43.7 ms, 2 series allpass at 5.0/1.7 ms — reference PlaneverbDSP/src/
DSP/Reverb.h:4-25), and the shipped system routes the wet buses into Unity's
built-in reverbs with fixed 0.5 s / 1 s / 3 s decays (README.md:14,
PvDSPTypes.h:13-15). This module completes that design so the framework is
standalone: a classic Schroeder/Freeverb-topology reverb with comb feedback
derived from the target RT60 (g = 10^(-3 D / rt60)).

:func:`reverb_scan` runs the reverb over the sample axis of [B, N] blocks
(states are [B, ...], so many reverb lines run at once). On a CUDA tensor
it launches D2 (``csrc/dsp_scan.cu`` ``reverb_scan_kernel``: one launch over
a table of rows, a block a row holding its rings in shared memory), on a
CPU tensor it runs its plain version, :func:`reverb_scan_reference`.
:func:`reverb_scan_many` takes several reverbs of one sample rate in one
launch; :func:`mix_output` uses it for the three canonical decays.

:func:`mix_output` renders the final audible stereo mix the way the
reference's Unity mixer graph does: dry + sum of the three reverbed wet
buses (PlaneverbReverb.cs:45-101).

Calls are functional, as in the JAX package: a call returns a new state
and leaves the one it was given as it was.
"""

from __future__ import annotations

import ctypes
import math
import struct
import threading
from typing import NamedTuple

import numpy as np
import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.ops._common import counted, on_card

__all__ = ["COMB_DELAYS_S", "ALLPASS_DELAYS_S", "ALLPASS_G", "DAMPING",
           "comb_feedback", "ReverbParams", "reverb_params", "ReverbState",
           "init_reverb_state", "reverb_scan", "reverb_scan_many",
           "reverb_scan_reference", "mix_output", "MAX_ROWS"]

# Reverb.h:16-24 sketch constants (classic Schroeder numbers)
COMB_DELAYS_S = (0.0297, 0.0371, 0.0411, 0.0437)
ALLPASS_DELAYS_S = (0.005, 0.0017)
ALLPASS_G = 0.5
DAMPING = 0.2


def comb_feedback(delay_s: float, rt60: float) -> float:
    """Feedback gain so a D-second loop decays 60 dB in rt60 seconds."""
    return float(10.0 ** (-3.0 * delay_s / max(rt60, 1e-3)))


class ReverbParams(NamedTuple):
    comb_delays: tuple      # samples, per comb
    comb_feedback: tuple    # per comb
    allpass_delays: tuple   # samples
    sample_rate: int
    rt60: float


def reverb_params(rt60: float, sample_rate: int) -> ReverbParams:
    cd = tuple(max(1, int(d * sample_rate)) for d in COMB_DELAYS_S)
    ad = tuple(max(1, int(d * sample_rate)) for d in ALLPASS_DELAYS_S)
    fb = tuple(comb_feedback(d / sample_rate, rt60) for d in cd)
    return ReverbParams(comb_delays=cd, comb_feedback=fb, allpass_delays=ad,
                        sample_rate=sample_rate, rt60=rt60)


class ReverbState(NamedTuple):
    """Carried filter memories ([B, ...] batch leading axis).

    comb_buf:  [B, 4, Lc] circular comb delay lines
    comb_lp:   [B, 4] one-pole damping filter memories
    ap_buf:    [B, 2, La] allpass delay lines
    pos:       scalar int32 running sample counter (shared phase)
    """

    comb_buf: object
    comb_lp: object
    ap_buf: object
    pos: object


def init_reverb_state(params: ReverbParams, batch: int = 1,
                      device=None) -> ReverbState:
    """A silent state of ``batch`` rows on ``device`` (default "cuda");
    ``pos`` is a 0-dim int32 tensor there."""
    dev = torch.device("cuda" if device is None else device)
    lc = max(params.comb_delays)
    la = max(params.allpass_delays)
    return ReverbState(
        comb_buf=torch.zeros((batch, 4, lc), dtype=torch.float32, device=dev),
        comb_lp=torch.zeros((batch, 4), dtype=torch.float32, device=dev),
        ap_buf=torch.zeros((batch, 2, la), dtype=torch.float32, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev))


# the constants of a step as float32, as the JAX scan rounds them
_DAMP = float(np.float32(DAMPING))
_ONE_MINUS_DAMP = float(np.float32(1.0) - np.float32(DAMPING))
_G = float(np.float32(ALLPASS_G))
# rows a D2 launch takes (its table is a by-value kernel parameter)
MAX_ROWS = 32


def _check_state(where, x, state: ReverbState, params: ReverbParams):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{where}: x must be float32 [B, N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b = x.shape[0]
    lc = max(params.comb_delays)
    la = max(params.allpass_delays)
    for name, t, shape in (("comb_buf", state.comb_buf, (b, 4, lc)),
                           ("comb_lp", state.comb_lp, (b, 4)),
                           ("ap_buf", state.ap_buf, (b, 2, la))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{where}: {name} must be float32 {shape} for "
                             f"{params.sample_rate} Hz, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if state.pos.dtype != torch.int32 or state.pos.dim() != 0:
        raise ValueError(f"{where}: pos must be a 0-dim int32 tensor")


def reverb_scan_reference(x, state: ReverbState, params: ReverbParams):
    """D2's plain version: the reverb one sample at a time over [B] rows,
    every op rounded once in the kernel's order. Returns ([B, N] wet
    output, new state)."""
    b, n = x.shape
    lc = state.comb_buf.shape[-1]
    la = state.ap_buf.shape[-1]
    wrap = math.lcm(lc, la)
    dev = x.device
    cd = torch.tensor(params.comb_delays, dtype=torch.int64, device=dev)
    ad = list(params.allpass_delays)
    fb = torch.tensor(params.comb_feedback, dtype=torch.float32,
                      device=dev)
    comb_buf = state.comb_buf.clone()
    comb_lp = state.comb_lp
    ap_buf = state.ap_buf.clone()
    k4 = torch.arange(4, device=dev)
    pos0 = int(state.pos)
    out = torch.empty_like(x)
    for t in range(n):
        pos = (pos0 + t) % wrap if t else pos0
        # the parallel lowpass-comb bank (Reverb.h:27-141 design): every
        # comb reads (pos - d_k) mod lc of its ring before any write
        y = comb_buf[:, k4, torch.remainder(pos - cd, lc)]     # [B, 4]
        comb_lp = y * _ONE_MINUS_DAMP + comb_lp * _DAMP
        comb_buf[:, :, pos % lc] = x[:, t, None] + comb_lp * fb
        s = (((y[:, 0] + y[:, 1]) + y[:, 2]) + y[:, 3]) * 0.25
        # two series allpass
        for k in range(2):
            # a copy: the write below may hit the column just read
            buf_out = ap_buf[:, k, (pos - ad[k]) % la].clone()
            ap_buf[:, k, pos % la] = s + buf_out * _G
            s = buf_out - _G * s
        out[:, t] = s
    # wrap pos at lcm(lc, la): both index phases stay continuous while the
    # int32 counter never overflows
    pos = torch.full((), (pos0 + n) % wrap if n else pos0, dtype=torch.int32,
                     device=dev)
    return out, ReverbState(comb_buf=comb_buf, comb_lp=comb_lp.clone(),
                            ap_buf=ap_buf, pos=pos)


# one row of a D2 launch's table, packed as csrc/dsp_scan.cu ``ReverbRow``
# (kernels.ReverbRow): ten pointers, then the four comb feedbacks as float32
_ROW = struct.Struct("=10Q4f")
_TABLES = threading.local()


def _table():
    """This thread's D2 table: one ctypes array of MAX_ROWS rows, made once
    and refilled by every launch (the launcher copies it into the kernel's
    parameters before it returns)."""
    table = getattr(_TABLES, "table", None)
    if table is None:
        size = ctypes.sizeof(kernels.ReverbRow)
        if _ROW.size != size:
            raise RuntimeError(f"ReverbRow is {size} bytes, the packed row "
                               f"{_ROW.size}")
        table = _TABLES.table = (kernels.ReverbRow * MAX_ROWS)()
    return table


def _launch_rows(where, jobs, out, new):
    """One D2 launch over every job's rows (each job ``(x, state,
    params)``, contiguous), into one tensor a kind: ``out`` [rows, N] and
    ``new`` (a ReverbState of [rows, 4, lc], [rows, 4], [rows, 2, la] and
    a [jobs] counter), which the launch fills. A row's pointers are its
    tensor's plus the row's byte offset."""
    params = jobs[0][2]
    lc = max(params.comb_delays)
    la = max(params.allpass_delays)
    n = out.shape[1]
    xs, cs, ls, as_ = 4 * n, 16 * lc, 16, 8 * la     # bytes a row
    o, c, lo, a, q = (t.data_ptr() for t in (out, *new))
    table = _table()
    r = 0
    for j, (x, st, p) in enumerate(jobs):
        xp, cp, lp, ap, pp = (t.data_ptr() for t in (x, *st))
        for i in range(x.shape[0]):
            _ROW.pack_into(table, _ROW.size * r, xp + i * xs, o + r * xs,
                           cp + i * cs, c + r * cs, lp + i * ls, lo + r * ls,
                           ap + i * as_, a + r * as_, pp,
                           q + 4 * j if i == 0 else 0, *p.comb_feedback)
            r += 1
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.library().pv_reverb_scan(
            ctypes.addressof(table), r, n, *params.comb_delays,
            *params.allpass_delays, lc, la, math.lcm(lc, la), _DAMP,
            _ONE_MINUS_DAMP, _G, stream)
    kernels.check(err, where)


@counted
def reverb_scan_many(jobs):
    """Run several reverbs of one sample rate over their [B, N] blocks.

    ``jobs``: a list of ``(x, state, params)``, each as for
    :func:`reverb_scan`, all on one device, with one block length and one
    sample rate (so their rings have one length and their combs and
    allpasses one set of delays; the feedback may differ). Returns a list
    of ``(wet [B, N], new state)``, the same as one :func:`reverb_scan` a
    job. On a CUDA device one D2 launch takes every row of every job, at
    most :data:`MAX_ROWS` (more raise ValueError), on the current stream;
    the jobs' outputs are views of one tensor a kind (wet, each ring, the
    memories, the counters). On the CPU each job runs the plain version.
    """
    where = "reverb_scan_many"
    if not jobs:
        return []
    p0 = jobs[0][2]
    n = jobs[0][0].shape[-1]
    for x, state, p in jobs:
        _check_state(where, x, state, p)
        if (p.comb_delays, p.allpass_delays) != (p0.comb_delays,
                                                 p0.allpass_delays):
            raise ValueError(f"{where}: the jobs' delays differ ({p} vs "
                             f"{p0}): one launch takes one sample rate")
        if x.shape[-1] != n:
            raise ValueError(f"{where}: the jobs' blocks must have one "
                             f"length, got {x.shape[-1]} and {n}")
    tensors = [t for x, st, _ in jobs for t in (x, *st)]
    if not on_card(where, *tensors):
        return [reverb_scan_reference(x, st, p) for x, st, p in jobs]
    counts = [x.shape[0] for x, _, _ in jobs]
    rows = sum(counts)
    if rows > MAX_ROWS:
        raise ValueError(f"{where}: {rows} rows, one launch takes at most "
                         f"{MAX_ROWS}")
    jobs = [(x.contiguous(), ReverbState(*(t.contiguous() for t in st)), p)
            for x, st, p in jobs]
    lc = max(p0.comb_delays)
    la = max(p0.allpass_delays)
    dev = jobs[0][0].device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((rows, n), **f32)
    new = ReverbState(torch.empty((rows, 4, lc), **f32),
                      torch.empty((rows, 4), **f32),
                      torch.empty((rows, 2, la), **f32),
                      torch.empty((len(jobs),), dtype=torch.int32,
                                  device=dev))
    _launch_rows(where, jobs, out, new)
    reverb_scan_many.launches += 1
    return list(zip(out.split_with_sizes(counts),
                    map(ReverbState, *(t.split_with_sizes(counts)
                                       for t in new[:3]),
                        new.pos.unbind(0))))


def reverb_scan(x, state: ReverbState, params: ReverbParams):
    """Run the reverb over [B, N] mono blocks.

    Returns ([B, N] wet output, new state). Deterministic streaming:
    concatenating outputs of consecutive blocks equals one long block.
    """
    return reverb_scan_many([(x, state, params)])[0]


def mix_output(dry, wet_a, wet_b, wet_c, sample_rate: int,
               states=None, device=None):
    """Final audible stereo mix: dry + reverb(wetX) for the three canonical
    decays (the reference's Unity mixer graph, PlaneverbReverb.cs:45-101).

    Args: [N, 2] buses (arrays or tensors), moved to ``device`` (default:
    the device of a tensor ``dry``, else "cuda"). Returns ([N, 2] mix
    tensor, states) where states is a dict keyed by (rt60, sample_rate)
    carrying reverb state across calls (pass back in). At one rate the
    three reverbs share their delays, so on a card the three x two channels
    run as one D2 launch of six rows.
    """
    from planeverb_tpu_torch.dsp.gains import T_ER_1, T_ER_2, T_ER_3

    if device is None:
        device = dry.device if isinstance(dry, torch.Tensor) else "cuda"
    dev = torch.device(device)

    def bus(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    if states is None:
        states = {}
    jobs = []
    for rt60, wet in zip((T_ER_1, T_ER_2, T_ER_3), (wet_a, wet_b, wet_c)):
        params = reverb_params(rt60, sample_rate)
        # key by (rt60, sample_rate): the delay-line sizes depend on the
        # rate, and reusing a state across a rate change would read ring
        # buffers at silently wrong (aliased) delays
        st = states.get((rt60, sample_rate))
        if st is None:
            st = init_reverb_state(params, batch=2, device=dev)
        jobs.append((bus(wet).T, st, params))     # [2, N] L/R as batch
    mix = bus(dry)
    for (_, _, params), (wet, st) in zip(jobs, reverb_scan_many(jobs)):
        states[(params.rt60, sample_rate)] = st
        mix = mix + wet.T
    return mix, states
