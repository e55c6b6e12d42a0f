"""The port's DSP (planeverb_tpu_torch.dsp) against the JAX package's on the
CPU: D1's plain version (``lowpass.process_scan``) against JAX's
``lax.scan`` biquad, the torch gain helpers against the NumPy ``gains.py``,
and ``render_block`` against JAX's ``render_block`` and the streaming
``DSPContext`` block for block. Inputs are made from numpy seeds and given
to both packages.

Tolerances, each from the measured difference (ROADMAP C1, DSP row):
  - biquad: the coefficients equal JAX's; the filtered samples and the
    carried memories drift apart along a block where the poles sit near 1
    (low cutoffs: radius 0.998 at 20 Hz), up to 2.3e-4 of the row's peak
    (511 samples from carried memories; below 1e-6 from 1 kHz up). Held at
    5e-4 of each row's peak.
  - gain helpers: float32 powers and trigonometry of two libraries, rel
    2e-6.
  - render_block: the buses' sums over sources run in another order, and
    the biquad drift above: up to 2.0e-5 of a bus's peak, held at 5e-5;
    the carried filter memories within 1.3e-5, held at 5e-5 absolute; the
    smoothed parameters at rel 1e-5. Against the streaming renderer, the
    JAX test's 2e-4 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from planeverb_tpu.config import PlaneverbDSPConfig as JDSPConfig
from planeverb_tpu.dsp import SourceParams as JSourceParams
from planeverb_tpu.dsp import init_state as jinit_state
from planeverb_tpu.dsp import render_block as jrender_block
from planeverb_tpu.dsp.lowpass import coefficients as jcoefficients
from planeverb_tpu.dsp.lowpass import process_scan as jprocess_scan
from planeverb_tpu_torch.config import PlaneverbDSPConfig
from planeverb_tpu_torch.convert import dsp_state_from_numpy
from planeverb_tpu_torch.dsp import (DSPContext, SourceParams, gains,
                                     init_state, ops, render_block)
from planeverb_tpu_torch.dsp.lowpass import (LowpassState, _coefficients_torch,
                                             process, process_scan,
                                             process_scan_reference)
from planeverb_tpu_torch.types import PlaneverbOutput, vec2

f32 = np.float32
FS = 44100.0
BIQUAD_REL = 5e-4
BUS_REL = 5e-5


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel_rows(got, want):
    """max |got - want| / max |want| per row."""
    return (np.abs(got - want).max(-1)
            / np.maximum(np.abs(want).max(-1), 1e-30))


# ------------------------------------------------------------------ biquad
def test_coefficients_match_jax():
    cut = np.geomspace(5.0, 30000.0, 64).astype(f32)
    want = jcoefficients(jnp.asarray(cut), jnp.float32(FS), xp=jnp)
    got = _coefficients_torch(_t(cut), FS)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7)


@pytest.mark.parametrize("n", [1, 511, 4096])
def test_process_scan_matches_jax(n):
    """Cutoffs spread over 20 Hz - 20 kHz (the low end included), carried
    filter memories, one block of n samples."""
    rng = np.random.default_rng(n)
    s = 12
    x = rng.standard_normal((s, n)).astype(f32)
    cut = np.geomspace(20.0, 20000.0, s).astype(f32)
    y1 = (rng.standard_normal(s) * 0.1).astype(f32)
    y2 = (rng.standard_normal(s) * 0.1).astype(f32)
    jo, jy1, jy2 = jprocess_scan(jnp.asarray(x), jnp.asarray(y1),
                                 jnp.asarray(y2), jnp.asarray(cut), FS)
    to, ty1, ty2 = process_scan(_t(x), _t(y1), _t(y2), _t(cut), FS)
    assert to.shape == (s, n) and to.dtype == torch.float32
    # the carried memories beside each row's samples
    got = np.concatenate([to.numpy(), ty1.numpy()[:, None],
                          ty2.numpy()[:, None]], 1)
    want = np.concatenate([np.asarray(jo), np.asarray(jy1)[:, None],
                           np.asarray(jy2)[:, None]], 1)
    assert _rel_rows(got, want).max() <= BIQUAD_REL


def test_process_scan_chunked_equals_whole():
    """Streaming in chunks (carrying y1, y2) gives the whole block's bits."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((5, 1000)).astype(f32))
    cut = _t(np.array([20.0, 90.0, 700.0, 5000.0, 19000.0], f32))
    z = torch.zeros(5)
    whole, wy1, wy2 = process_scan(x, z, z, cut, FS)
    parts, y1, y2 = [], z, z
    for a, b in ((0, 1), (1, 300), (300, 512), (512, 1000)):
        p, y1, y2 = process_scan(x[:, a:b], y1, y2, cut, FS)
        parts.append(p)
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(y1, wy1) and torch.equal(y2, wy2)


def test_process_scan_matches_streaming():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 256)).astype(f32)
    cut = np.array([500.0, 2000.0, 15000.0], f32)
    want = np.stack([process(x[i], LowpassState(), float(cut[i]), FS)
                     for i in range(3)])
    got, _, _ = process_scan(_t(x), torch.zeros(3), torch.zeros(3),
                             _t(cut), FS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_process_scan_dispatch_and_checks():
    """A CPU tensor takes the plain version (counting no launch); another
    device or a wrong shape raises."""
    x = torch.zeros(2, 8)
    z = torch.zeros(2)
    before = process_scan.launches
    got = process_scan(x, z, z, torch.full((2,), 1000.0), FS)
    want = process_scan_reference(x, z, z, torch.full((2,), 1000.0), FS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert process_scan.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        process_scan(x.to("meta"), z.to("meta"), z.to("meta"),
                     z.to("meta"), FS)
    with pytest.raises(ValueError, match="y1"):
        process_scan(x, torch.zeros(3), z, z, FS)


# ------------------------------------------------------------ gain helpers
def test_gain_helpers_match_numpy():
    rng = np.random.default_rng(3)
    rt = np.concatenate([np.linspace(0.05, 4.0, 61),
                         [0.5, 1.0, 3.0, 0.0]]).astype(f32)
    wg = rng.uniform(0.0, 1.0, rt.size).astype(f32)
    for g, w in zip(ops.find_wet_gains(_t(rt), _t(wg)),
                    gains.find_wet_gains(rt, wg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-7)
    d = rng.standard_normal((2, 50)).astype(f32)
    lf = _t(np.array([0.6, 0.8], f32))
    for g, w in zip(ops.pan_gains(_t(d[0]), _t(d[1]), lf[0], lf[1]),
                    gains.pan_gains(d[0], d[1], f32(0.6), f32(0.8))):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-7)
    v = rng.standard_normal((4, 50)).astype(f32)
    np.testing.assert_allclose(ops.cardioid(*map(_t, v)).numpy(),
                               gains.cardioid(*v), rtol=2e-6)
    np.testing.assert_allclose(
        ops.distance_attenuation(_t(f32(1.0)), _t(f32(-2.0)),
                                 _t(v[0] * 5), _t(v[1] * 5)).numpy(),
        gains.distance_attenuation(f32(1.0), f32(-2.0), v[0] * 5, v[1] * 5),
        rtol=2e-6)
    cur, tgt = rng.uniform(0, 1, (2, 7)).astype(f32)
    for n in (1, 64, 512):
        factor = 1.0 / (n * 2.0)
        ramp, final = ops.lerp_ramp(_t(cur), _t(tgt), factor, n)
        wramp, wfinal = gains.lerp_ramp(cur, tgt, factor, n)
        np.testing.assert_allclose(ramp.numpy(), wramp, rtol=2e-6)
        np.testing.assert_allclose(final.numpy(), wfinal, rtol=2e-6)
        np.testing.assert_allclose(
            ops.lerp_final(_t(cur), _t(tgt), factor, n).numpy(),
            gains.lerp_final(cur, tgt, factor, n), rtol=2e-6)


# ------------------------------------------------------------ render_block
def _block_params(rng, s, mode):
    """One block's per-source targets; ``mode`` "bad" puts NaN,
    out-of-range and zero-direction sources in the batch."""
    dirs = rng.standard_normal((s, 2)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sdirs = rng.standard_normal((s, 2)).astype(f32)
    sdirs /= np.linalg.norm(sdirs, axis=1, keepdims=True)
    p = dict(occlusion=rng.uniform(0.1, 1.0, s).astype(f32),
             wet_gain=rng.uniform(0.1, 1.0, s).astype(f32),
             rt60=rng.uniform(0.2, 3.5, s).astype(f32),
             lowpass=np.geomspace(20.0, 20000.0, s).astype(f32),
             direction=dirs, directivity=sdirs)
    if mode == "bad":
        p["occlusion"][1] = np.nan           # NaN: rejected, not poisoning
        p["lowpass"][2] = 5.0                # out of range
        p["direction"][3] = 0.0              # zero direction
        p["wet_gain"][4] = np.inf
        p["occlusion"][5] = -1.0             # the invalid-dry-gain sentinel
    return p


def _render_both(cfg_kw, s, n, blocks, stereo, mode, seed=7):
    """render_block of both packages over ``blocks`` blocks from the same
    inputs; the port starts from JAX's state after its first block
    (converted with convert.dsp_state_from_numpy). Returns the per-block
    buses of both, from the second block on."""
    rng = np.random.default_rng(seed)
    jcfg = JDSPConfig(max_callback_length=n, **cfg_kw)
    tcfg = PlaneverbDSPConfig(max_callback_length=n, **cfg_kw)
    positions = rng.uniform(-5, 5, (s, 2)).astype(f32)
    forwards = rng.standard_normal((s, 2)).astype(f32)
    forwards /= np.linalg.norm(forwards, axis=1, keepdims=True)
    patterns = (np.arange(s) % 2).astype(np.int32)   # omni and cardioid
    lpos = np.array([1.0, 0.0, -2.0], f32)
    lfwd = np.array([0.6, 0.0, 0.8], f32)
    jstate = jinit_state(s)
    tstate = None
    out = []
    for blk in range(blocks):
        shape = (s, n, 2) if stereo else (s, n)
        audio = (rng.standard_normal(shape) * 0.5).astype(f32)
        p = _block_params(rng, s, mode)
        fields = dict(p, position=positions, forward=forwards,
                      pattern=patterns)
        jt = JSourceParams(**{k: jnp.asarray(v) for k, v in fields.items()})
        jbus, jstate_next = jrender_block(jcfg, jnp.asarray(audio), jt,
                                          jstate, jnp.asarray(lpos),
                                          jnp.asarray(lfwd))
        if tstate is not None:
            tt = SourceParams(**{k: _t(v, torch.int32 if k == "pattern"
                                       else torch.float32)
                                 for k, v in fields.items()})
            tbus, tstate = render_block(tcfg, _t(audio), tt, tstate,
                                        _t(lpos), _t(lfwd))
            out.append(([np.asarray(b) for b in jbus],
                        [b.numpy() for b in tbus], jstate_next, tstate))
        else:
            tstate = dsp_state_from_numpy(jstate_next, device="cpu")
        jstate = jstate_next
    return out


@pytest.mark.parametrize("stereo,spatial,mode", [
    (True, True, "good"), (False, True, "good"), (True, True, "bad"),
    (True, False, "bad")],
    ids=["stereo", "mono", "rejected", "no_spatialization"])
def test_render_block_matches_jax(stereo, spatial, mode):
    """Several blocks of 8 sources (omni and cardioid, cutoffs 20 Hz - 20
    kHz, NaN / out-of-range / zero-direction sources in "rejected"),
    buses within BUS_REL of each bus's peak, carried states within it."""
    out = _render_both(dict(use_spatialization=spatial), s=8, n=512,
                       blocks=4, stereo=stereo, mode=mode)
    for jbus, tbus, jst, tst in out:
        for name, w, g in zip(("dry", "a", "b", "c"), jbus, tbus):
            assert np.isfinite(g).all(), name
            peak = max(np.abs(w).max(), 1e-30)
            assert np.abs(g - w).max() <= BUS_REL * peak, name
        for f in JSourceParams._fields:
            w = np.asarray(getattr(jst.current, f))
            g = getattr(tst.current, f).numpy()
            if f == "pattern":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=f)
        for f in ("lpf_y1", "lpf_y2"):
            w = np.asarray(getattr(jst, f))
            np.testing.assert_allclose(getattr(tst, f).numpy(), w,
                                       atol=5e-5, err_msg=f)
    if mode == "bad":
        # rejected sources keep their carried filters and parameters
        jst, tst = out[-1][2], out[-1][3]
        assert tst.current.occlusion[1] == float(jst.current.occlusion[1])


def test_render_block_matches_streaming_block_for_block():
    """tests/test_dsp.py::TestBatchedRendererParity on the port: the
    batched renderer and the streaming DSPContext, block for block."""
    cfg = PlaneverbDSPConfig(max_callback_length=128)
    n, s, blocks = 128, 3, 4
    rng = np.random.default_rng(7)
    listener_pos = (1.0, 0.0, -2.0)
    listener_fwd = (0.6, 0.0, 0.8)
    positions = rng.uniform(-5, 5, (s, 2)).astype(f32)
    forwards = rng.standard_normal((s, 2)).astype(f32)
    forwards /= np.linalg.norm(forwards, axis=1, keepdims=True)
    patterns = np.array([0, 1, 1], np.int32)

    stream = DSPContext(cfg)
    stream.set_listener_transform(listener_pos, listener_fwd)
    for i in range(s):
        stream.update_emitter(i, (positions[i, 0], 0.0, positions[i, 1]),
                              (forwards[i, 0], 0.0, forwards[i, 1]))
        stream.set_emitter_directivity_pattern(i, int(patterns[i]))
    state = init_state(s, device="cpu")
    for blk in range(blocks):
        audio = rng.standard_normal((s, n, 2)).astype(f32) * 0.5
        params = dict(occlusion=rng.uniform(0.1, 1.0, s).astype(f32),
                      wet_gain=rng.uniform(0.1, 1.0, s).astype(f32),
                      rt60=rng.uniform(0.2, 3.5, s).astype(f32),
                      lowpass=rng.uniform(500, 18000, s).astype(f32))
        dirs = rng.standard_normal((s, 2)).astype(f32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        sdirs = rng.standard_normal((s, 2)).astype(f32)
        sdirs /= np.linalg.norm(sdirs, axis=1, keepdims=True)
        for i in range(s):
            stream.submit_source(i, PlaneverbOutput(
                occlusion=float(params["occlusion"][i]),
                wet_gain=float(params["wet_gain"][i]),
                rt60=float(params["rt60"][i]),
                lowpass=float(params["lowpass"][i]),
                direction=vec2(float(dirs[i, 0]), float(dirs[i, 1])),
                source_directivity=vec2(float(sdirs[i, 0]),
                                        float(sdirs[i, 1]))), audio[i])
        want = stream.get_output()
        target = SourceParams(
            occlusion=_t(params["occlusion"]), wet_gain=_t(params["wet_gain"]),
            rt60=_t(params["rt60"]), lowpass=_t(params["lowpass"]),
            direction=_t(dirs), position=_t(positions), forward=_t(forwards),
            directivity=_t(sdirs), pattern=_t(patterns, torch.int32))
        got, state = render_block(cfg, _t(audio), target, state,
                                  listener_pos, listener_fwd)
        for name, w, g in zip(("dry", "a", "b", "c"), want, got):
            np.testing.assert_allclose(g.numpy(), w[:n], atol=2e-4,
                                       err_msg=f"bus {name} block {blk}")


def test_render_block_rejected_source_is_silent_and_frozen():
    cfg = PlaneverbDSPConfig(max_callback_length=64)
    s, n = 2, 64
    state = init_state(s, device="cpu")
    target = SourceParams(
        occlusion=torch.tensor([0.8, np.nan]),
        wet_gain=torch.tensor([0.5, np.inf]),
        rt60=torch.tensor([0.9, np.nan]),
        lowpass=torch.tensor([8000.0, 1e30]),
        direction=torch.tensor([[1.0, 0.0]] * s),
        position=torch.zeros(s, 2), forward=torch.zeros(s, 2),
        directivity=torch.zeros(s, 2),
        pattern=torch.zeros(s, dtype=torch.int32))
    buses, new = render_block(cfg, torch.ones(s, n, 2), target, state,
                              torch.zeros(3), torch.tensor([1.0, 0.0, 0.0]))
    for bus in buses:
        assert torch.isfinite(bus).all()
    assert buses[0].abs().max() > 0
    assert float(new.current.occlusion[1]) == 1.0
    assert float(new.current.rt60[1]) == 0.0
    assert float(new.lpf_y1[1]) == 0.0


def test_init_state_defaults_to_cuda():
    """The port's entry points run on the card unless asked for the CPU."""
    with pytest.raises((RuntimeError, AssertionError)):
        init_state(2)
    st = init_state(3, device="cpu")
    want = jinit_state(3)
    for f in JSourceParams._fields:
        np.testing.assert_array_equal(getattr(st.current, f).numpy(),
                                      np.asarray(getattr(want.current, f)))


def test_launch_calls_match_the_launchers(monkeypatch):
    """The CUDA paths of D1 and D2 (``process_scan``, ``reverb_scan_many``)
    call their C launchers with the arguments ``kernels._SIGNATURES``
    declares: run here with a stub library and the tensors taken as on a
    card, each call is checked for its count and its ints and floats, and
    D2 takes one launch for mix_output's six rows and refuses more
    rows than one launch takes."""
    import contextlib
    import ctypes

    from planeverb_tpu_torch import kernels
    from planeverb_tpu_torch.dsp import lowpass, reverb

    calls = []

    class Library:
        def __getattr__(self, name):
            sig = kernels._SIGNATURES[name]

            def call(*args):
                assert len(args) == len(sig), (name, len(args), len(sig))
                for a, t in zip(args, sig):
                    if t is ctypes.c_int:
                        assert isinstance(a, int), (name, a)
                    elif t is ctypes.c_float:
                        assert isinstance(a, float), (name, a)
                calls.append((name, args))
                return 0
            return call

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(kernels, "library", Library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    for mod in (lowpass, reverb):
        monkeypatch.setattr(mod, "on_card", lambda where, *t: True)
    z = torch.zeros(3)
    before = process_scan.launches
    process_scan(torch.zeros(3, 16), z, z, z + 1000.0, FS)
    assert process_scan.launches == before + 1
    assert calls[-1][0] == "pv_biquad_scan" and calls[-1][1][7:9] == (3, 16)
    jobs = []
    for rt60 in (0.5, 1.0, 3.0):
        p = reverb.reverb_params(rt60, 44100)
        jobs.append((torch.zeros(2, 16),
                     reverb.init_reverb_state(p, 2, device="cpu"), p))
    before = reverb.reverb_scan_many.launches
    reverb.reverb_scan_many(jobs)
    assert reverb.reverb_scan_many.launches == before + 1
    name, args = calls[-1]
    assert name == "pv_reverb_scan" and args[1:3] == (6, 16)
    assert args[3:11] == (*jobs[0][2].comb_delays,
                          *jobs[0][2].allpass_delays, 1927, 220)
    # the table: each kind of output one tensor, a row's pointer its
    # tensor's plus the row's bytes; the counter written by each job's
    # first row; the feedbacks rounded to float32
    table = (kernels.ReverbRow * 6).from_address(args[0])
    for f, stride in (("out", 4 * 16), ("comb_out", 16 * 1927),
                      ("lp_out", 16), ("ap_out", 8 * 220)):
        ptrs = [getattr(r, f) for r in table]
        assert ptrs == [ptrs[0] + i * stride for i in range(6)], f
    pos = [r.pos_out for r in table]
    assert pos[1::2] == [None] * 3 and pos[2] == pos[0] + 4
    for r, (_, st, p) in zip(table, [j for j in jobs for _ in (0, 1)]):
        assert r.pos_in == st.pos.data_ptr()
        assert list(r.fb) == [float(np.float32(f)) for f in p.comb_feedback]
    # one launch takes at most MAX_ROWS rows: more raise, and launch nothing
    rows = reverb.MAX_ROWS + 1
    big = (torch.zeros(rows, 16),
           reverb.init_reverb_state(jobs[0][2], rows, device="cpu"),
           jobs[0][2])
    n = len(calls)
    with pytest.raises(ValueError, match="at most"):
        reverb.reverb_scan_many([big])
    assert len(calls) == n
    assert reverb.reverb_scan_many.launches == before + 1
