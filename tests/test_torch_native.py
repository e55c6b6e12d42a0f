"""The port's native C++ DSP (``planeverb_tpu_torch.native``: the g++ build
of its copy of ``pv_dsp.cpp``) on the CPU, and the audio loops that run it.

The cases of tests/test_native_dsp.py against the port's renderer (its
buses within atol 2e-4 of the Python streaming renderer, block for block);
the port's library against the JAX package's own build of the original
source: the same source and flags on the same host, so
``NativeDSPContext`` and ``NativeReverb`` render bit-equal blocks;
``NativeReverb`` against the port's reverb (D2's plain version) at the JAX
test's atol 2e-5; and ``RealtimePlayer(native=True)`` (the default) and
``AudioSourceManager`` with the three native reverbs against the JAX
package's on 275 Hz SmallRoom Contexts, at tests/test_torch_audio.py's
2e-6 of the output's peak (the two engines' parameters differ by ulps,
ROADMAP C1), and bit for bit against their chain driven by hand.
"""

import ctypes
import os
import time

import numpy as np
import pytest
import torch

import planeverb_tpu as jpv
import planeverb_tpu.native as jnative
import planeverb_tpu_torch as pv
from planeverb_tpu.sandbox.audio_manager import \
    AudioSourceManager as JAudioSourceManager
from planeverb_tpu.sandbox.realtime import RealtimePlayer as JRealtimePlayer
from planeverb_tpu.types import PlaneverbOutput as JOutput
from planeverb_tpu.types import vec2 as jvec2
from planeverb_tpu_torch import native
from planeverb_tpu_torch.config import PlaneverbDSPConfig
from planeverb_tpu_torch.dsp import DSPContext
from planeverb_tpu_torch.dsp.gains import T_ER_1, T_ER_2, T_ER_3
from planeverb_tpu_torch.dsp.reverb import (init_reverb_state,
                                            reverb_params,
                                            reverb_scan_reference)
from planeverb_tpu_torch.native import NativeDSPContext, NativeReverb
from planeverb_tpu_torch.sandbox.audio_manager import AudioSourceManager
from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer
from planeverb_tpu_torch.types import PlaneverbOutput, vec2

f32 = np.float32
RATE = 44100
AUDIO_REL = 2e-6
RT60S = (T_ER_1, T_ER_2, T_ER_3)


def _inputs(rng, s, out=PlaneverbOutput, v=vec2):
    """``s`` random engine outputs, as the ``out`` / ``v`` types."""
    dirs = rng.standard_normal((s, 2)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sdirs = rng.standard_normal((s, 2)).astype(f32)
    sdirs /= np.linalg.norm(sdirs, axis=1, keepdims=True)
    return [out(
        occlusion=float(rng.uniform(0.1, 1.0)),
        wet_gain=float(rng.uniform(0.1, 1.0)),
        rt60=float(rng.uniform(0.2, 3.5)),
        lowpass=float(rng.uniform(500, 18000)),
        direction=v(float(dirs[i, 0]), float(dirs[i, 1])),
        source_directivity=v(float(sdirs[i, 0]), float(sdirs[i, 1])))
        for i in range(s)]


def _drive(ctxs, seed, s=3, n=128, blocks=5):
    """The same listener, emitters and random blocks into every DSP context
    of ``ctxs`` (each given its package's output type); the buses of every
    block, per context."""
    outs = [[] for _ in ctxs]
    types = [(JOutput, jvec2) if isinstance(c, jnative.NativeDSPContext)
             else (PlaneverbOutput, vec2) for c in ctxs]
    rng = np.random.default_rng(seed)
    for c in ctxs:
        c.set_listener_transform((1.0, 0.0, -2.0), (0.6, 0.0, 0.8))
    for i in range(s):
        pos = tuple(rng.uniform(-5, 5, 3))
        fwd = tuple(rng.standard_normal(3))
        for c in ctxs:
            c.update_emitter(i, pos, fwd)
            c.set_emitter_directivity_pattern(i, i % 2)
    for _ in range(blocks):
        state = rng.bit_generator.state
        inputs = []
        for t in types:
            rng.bit_generator.state = state
            inputs.append(_inputs(rng, s, *t))
        audio = rng.standard_normal((s, n, 2)).astype(f32) * 0.5
        for c, ins, o in zip(ctxs, inputs, outs):
            for i in range(s):
                c.submit_source(i, ins[i], audio[i])
            # copies: the Python renderer hands out its back buffers
            o.append(tuple(np.array(bus) for bus in c.get_output()))
    return outs


# -------------------------------------------- tests/test_native_dsp.py cases
def test_native_matches_python_block_for_block():
    cfg = PlaneverbDSPConfig(max_callback_length=128)
    py, nat = _drive([DSPContext(cfg), NativeDSPContext(cfg)], seed=11)
    for blk, (p_buses, n_buses) in enumerate(zip(py, nat)):
        for name, pb, nb in zip("dry a b c".split(), p_buses, n_buses):
            np.testing.assert_allclose(
                nb, pb, atol=2e-4,
                err_msg=f"bus {name} mismatch at block {blk}")


def test_native_rejects_invalid_inputs():
    nat = NativeDSPContext(PlaneverbDSPConfig(max_callback_length=64))
    audio = np.ones((64, 2), f32)
    for i, (occ, lp, d) in enumerate(((-1.0, 8000.0, (1.0, 0.0)),
                                      (0.5, 5.0, (1.0, 0.0)),
                                      (0.5, 8000.0, (0.0, 0.0)))):
        nat.submit_source(i, PlaneverbOutput(
            occlusion=occ, wet_gain=0.5, rt60=1.0, lowpass=lp,
            direction=vec2(*d), source_directivity=vec2(1.0, 0.0)), audio)
    nat.submit_source(3, _inputs(np.random.default_rng(0), 1)[0],
                      np.ones((4096 * 2, 2), f32))        # oversized block
    for bus in nat.get_output():
        assert np.abs(bus).max() == 0.0


def test_native_mono_input_and_double_buffering():
    nat = NativeDSPContext(PlaneverbDSPConfig(max_callback_length=64,
                                              use_spatialization=False))
    nat.update_emitter(0, (0.5, 0.0, 0.0), (1.0, 0.0, 0.0))
    good = PlaneverbOutput(occlusion=0.8, wet_gain=0.5, rt60=0.9,
                           lowpass=8000.0, direction=vec2(1.0, 0.0),
                           source_directivity=vec2(1.0, 0.0))
    nat.submit_source(0, good, np.ones(64, f32))
    dry, a, b, c = nat.get_output()
    assert np.abs(dry).max() > 0
    assert np.abs(a).max() > 0 and np.abs(b).max() > 0
    assert np.abs(c).max() == 0
    dry2, *_ = nat.get_output()
    assert np.abs(dry2).max() == 0


def test_native_render_meets_audio_callback_budget():
    """One 512-frame callback of 8 sources and the three reverbs, on the
    host, well inside the 11.6 ms budget (the JAX test's 0.7 of it)."""
    cfg = PlaneverbDSPConfig(max_callback_length=512)
    nat = NativeDSPContext(cfg)
    nat.set_listener_transform((0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
    good = PlaneverbOutput(occlusion=0.8, wet_gain=0.5, rt60=0.9,
                           lowpass=8000.0, direction=vec2(1.0, 0.0),
                           source_directivity=vec2(1.0, 0.0))
    for eid in range(8):
        nat.update_emitter(eid, (1.0 + eid, 0.0, 0.0), (1.0, 0.0, 0.0))
    block = np.ones((512, 2), f32) * 0.25
    reverbs = [NativeReverb(rt, cfg.sampling_rate) for rt in RT60S]

    def one_callback():
        for eid in range(8):
            nat.submit_source(eid, good, block)
        dry, a, b, c = nat.get_output()
        out = dry[:512].copy()
        for rev, bus in zip(reverbs, (a, b, c)):
            rev.process_add(np.ascontiguousarray(bus[:512]), out)
        return out

    one_callback()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        one_callback()
        times.append(time.perf_counter() - t0)
    assert min(times) < 0.7 * 512 / cfg.sampling_rate


# ------------------------------------------ against the JAX package's build
def test_libraries_are_the_ports_own_builds():
    """Both libraries build from the port's copies into the port's build
    directory, never from or into planeverb_tpu/native/."""
    for build in (native.build_library, native.build_engine_client_library):
        path = build()
        assert os.path.dirname(path) == os.path.join(
            os.path.dirname(os.path.dirname(native.__file__)), "build",
            "native")
        assert os.path.basename(path).split("-")[0] in ("libpvdsp",
                                                        "libpvengine")
    assert os.path.dirname(native._SRC) == os.path.join(
        os.path.dirname(native.__file__), "src")


def test_dsp_calls_keep_the_interpreter_lock():
    """The DSP library's calls (microseconds each, ~100 an audio callback)
    keep the interpreter lock, so a callback beside a busy refresh loop
    does not queue for it after each; the engine client's calls, which wait
    on a socket, release it."""
    assert isinstance(native.load_library(), ctypes.PyDLL)
    assert not isinstance(native.load_engine_client_library(), ctypes.PyDLL)


@pytest.mark.parametrize("spatialize", [True, False])
def test_native_dsp_bit_equal_to_the_jax_build(spatialize):
    """NativeDSPContext of both packages on the same blocks: every bus of
    every block equal bit for bit."""
    cfg = PlaneverbDSPConfig(max_callback_length=256,
                             use_spatialization=spatialize)
    jcfg = jpv.PlaneverbDSPConfig(max_callback_length=256,
                                  use_spatialization=spatialize)
    ours, theirs = _drive([NativeDSPContext(cfg),
                           jnative.NativeDSPContext(jcfg)], seed=5, s=4,
                          n=256, blocks=6)
    assert np.abs(ours[-1][0]).max() > 0
    for blk, (a, b) in enumerate(zip(ours, theirs)):
        for name, x, y in zip("dry a b c".split(), a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"{name} {blk}")


@pytest.mark.parametrize("rt60", RT60S)
def test_native_reverb_bit_equal_to_the_jax_build(rt60):
    """NativeReverb of both packages over three carried blocks (stereo and
    mono) bit for bit, and within the JAX test's atol 2e-5 of the port's
    reverb plain version (the same rings, carried)."""
    rng = np.random.default_rng(int(rt60 * 10))
    for ch in (2, 1):
        x = (rng.standard_normal((3, 700, ch)) * 0.3).astype(f32)
        ours, theirs = NativeReverb(rt60, RATE, ch), \
            jnative.NativeReverb(rt60, RATE, ch)
        a, b = np.zeros_like(x), np.zeros_like(x)
        for i in range(3):
            ours.process_add(x[i], a[i])
            theirs.process_add(x[i], b[i])
        np.testing.assert_array_equal(a, b)
        params = reverb_params(rt60, RATE)
        state = init_reverb_state(params, batch=ch, device="cpu")
        for i in range(3):
            ref, state = reverb_scan_reference(torch.from_numpy(x[i].T.copy()),
                                               state, params)
            np.testing.assert_allclose(a[i], ref.numpy().T, atol=2e-5)


# ------------------------------------------------ the loops that run the DSP
@pytest.fixture(scope="module")
def ctxs():
    t = pv.Context(pv.PlaneverbConfig(10.0, 10.0, 275),
                   scene=pv.demo_scene("SmallRoom"), device="cpu")
    j = jpv.Context(jpv.PlaneverbConfig(10.0, 10.0, 275),
                    scene=jpv.demo_scene("SmallRoom"))
    for c in (t, j):
        c.set_listener_position(5.0, 0.0, 5.0)
        c.step()
    return t, j


def _tone(frames, freq=440.0):
    t = np.arange(frames) / RATE
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(f32)
    return np.stack([x, x], axis=-1)


def _assert_audio(got, want, what):
    peak = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= AUDIO_REL * peak, what


def test_realtime_player_native_is_the_default(ctxs):
    """RealtimePlayer's default (native=True): the C++ renderer and
    reverbs on the host, equal bit for bit to that chain driven by hand,
    within 2e-6 of the JAX player's output; close() frees the handles."""
    t, j = ctxs
    audio = _tone(1300)
    eid = t.emissions.emit(6.5, 0.0, 5.0, volume_db=-3.0)
    assert j.emissions.emit(6.5, 0.0, 5.0, volume_db=-3.0) == eid
    try:
        player = RealtimePlayer(t, eid, audio, RATE, frames=512)
        assert isinstance(player.dsp, NativeDSPContext)
        assert player.stream is None
        report = player.run(realtime=False)
        player.close()
        assert player.dsp._h is None
        assert all(r._h is None for r in player._reverbs)
        jplayer = JRealtimePlayer(j, eid, audio, RATE, frames=512)
        want = jplayer.run(realtime=False).output
        jplayer.close()

        dsp = NativeDSPContext(PlaneverbDSPConfig(max_callback_length=512,
                                                  sampling_rate=RATE))
        revs = [NativeReverb(r, RATE) for r in RT60S]
        chunks = []
        for start in range(0, len(audio), 512):
            block = audio[start:start + 512]
            out, gain = t.sync_dsp(dsp)[eid]
            dsp.submit_source(eid, out, block * f32(gain))
            dry, wa, wb, wc = dsp.get_output()
            mix = dry[:len(block)].copy()
            for rev, bus in zip(revs, (wa, wb, wc)):
                rev.process_add(np.ascontiguousarray(bus[:len(block)]), mix)
            chunks.append(mix)
    finally:
        t.emissions.end(eid)
        j.emissions.end(eid)
    got = report.output
    assert got.shape == audio.shape and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, np.concatenate(chunks))
    _assert_audio(got, want, "native player mix")


def test_audio_source_manager_with_native_reverbs_matches_jax(ctxs):
    """AudioSourceManager with the native renderer and the three native
    reverbs (process_add into the mix), against the JAX manager built the
    same way: two clips, the second ending in its second block, then the
    tails flushing after both end."""
    t, j = ctxs
    mgrs = []
    for ctx, mod, cfgm, mgr in (
            (t, native, pv, AudioSourceManager),
            (j, jnative, jpv, JAudioSourceManager)):
        cfg = cfgm.PlaneverbDSPConfig(max_callback_length=512,
                                      sampling_rate=RATE)
        mgrs.append(mgr(ctx, mod.NativeDSPContext(cfg),
                        reverbs=[mod.NativeReverb(r, RATE) for r in RT60S]))
    e1 = t.emissions.emit(6.5, 0.0, 5.0)
    e2 = t.emissions.emit(4.0, 0.0, 5.0, volume_db=-6.0)
    assert (j.emissions.emit(6.5, 0.0, 5.0),
            j.emissions.emit(4.0, 0.0, 5.0, volume_db=-6.0)) == (e1, e2)
    for m in mgrs:
        m.play(e1, _tone(1500, 440.0))
        m.play(e2, _tone(700, 880.0))
    outs = [np.concatenate([m.process_block(512) for _ in range(6)])
            for m in mgrs]
    for ctx, m in zip(ctxs, mgrs):
        assert m.active_sources() == []
        assert ctx.emissions.get(e1) is None and ctx.emissions.get(e2) is None
    got, want = outs
    tail = got[4 * 512:]          # both clips over: the reverbs' tails
    assert np.abs(tail).max() > 0
    _assert_audio(got, want, "native manager mix")
