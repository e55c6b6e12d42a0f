"""The port's audio path on the CPU against the JAX package's:
``Context.sync_dsp`` into the streaming ``DSPContext``, the audio-frame
loops (``sandbox.audio_manager.AudioSourceManager``,
``sandbox.realtime.RealtimePlayer(native=False)``), WAV I/O and the ``api``
facade, each on a 275 Hz SmallRoom Context of either package.

The two Contexts' emitter parameters agree within the golden tolerances,
not bit for bit (ROADMAP C1): the rendered audio of the two packages
differs by up to 2.0e-7 of the output's peak (the manager's dry mix and the
player's reverbed mix), held at 2e-6; the parameters sync_dsp returns at
the golden rel 1e-4.
"""

import numpy as np
import pytest

import planeverb_tpu as jpv
import planeverb_tpu_torch as pv
from planeverb_tpu.dsp import DSPContext as JDSPContext
from planeverb_tpu.sandbox.audio_manager import \
    AudioSourceManager as JAudioSourceManager
from planeverb_tpu.sandbox.realtime import RealtimePlayer as JRealtimePlayer
from planeverb_tpu_torch import api
from planeverb_tpu_torch.config import PlaneverbDSPConfig
from planeverb_tpu_torch.dsp import DirectivityPattern, DSPContext
from planeverb_tpu_torch.dsp.reverb import mix_output
from planeverb_tpu_torch.sandbox.audio_manager import AudioSourceManager
from planeverb_tpu_torch.sandbox.realtime import (AudioDeviceSink,
                                                  RealtimePlayer)
from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav
from planeverb_tpu_torch.types import INVALID_DRY_GAIN

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)
JCFG = jpv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                           grid_resolution=275)
RATE = 44100
AUDIO_REL = 2e-6


@pytest.fixture(scope="module")
def ctxs():
    """(port Context on the CPU, JAX Context), SmallRoom at 275 Hz, one
    step from the same listener."""
    t = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"), device="cpu")
    j = jpv.Context(JCFG, scene=jpv.demo_scene("SmallRoom"))
    for c in (t, j):
        c.set_listener_position(5.0, 0.0, 5.0)
        c.step()
    return t, j


def _tone(frames, freq=440.0):
    t = np.arange(frames) / RATE
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return np.stack([x, x], axis=-1)


def _emit_both(ctxs, *args, **kw):
    ids = [c.emissions.emit(*args, **kw) for c in ctxs]
    assert ids[0] == ids[1]
    return ids[0]


def _end_both(ctxs, eid):
    for c in ctxs:
        c.emissions.end(eid)


def _assert_audio(got, want, what):
    peak = max(np.abs(want).max(), 1e-30)
    diff = np.abs(got - want).max()
    assert diff <= AUDIO_REL * peak, f"{what}: {diff} > {AUDIO_REL} x {peak}"


def test_sync_dsp_matches_jax_including_id_reuse(ctxs):
    """sync_dsp returns the same emitters, volume gains and (within the
    golden tolerances) outputs as JAX's, pushes the same emitter state into
    the DSP context, and drops a dead emitter's DSP state when its id is
    reused."""
    dsps = (DSPContext(PlaneverbDSPConfig(max_callback_length=512)),
            JDSPContext(jpv.PlaneverbDSPConfig(max_callback_length=512)))
    e1 = _emit_both(ctxs, 6.5, 0.0, 5.0, forward=(0.0, 0.0, 1.0),
                    volume_db=-6.0, pattern=DirectivityPattern.CARDIOID)
    e2 = _emit_both(ctxs, 3.5, 0.0, 4.0)
    try:
        res = [c.sync_dsp(d) for c, d in zip(ctxs, dsps)]
        assert sorted(res[0]) == sorted(res[1]) == [e1, e2]
        for eid in (e1, e2):
            (a, ga), (b, gb) = res[0][eid], res[1][eid]
            assert ga == gb
            for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=1e-4, err_msg=f)
            for d in dsps:
                assert d._target[eid].pattern == \
                    dsps[1]._target[eid].pattern
                assert d._target[eid].position == \
                    dsps[1]._target[eid].position
        assert dsps[0]._pv_synced_ids == dsps[1]._pv_synced_ids
        for d, (c, r) in zip(dsps, zip(ctxs, res)):
            d.submit_source(e1, r[e1][0], _tone(512) * np.float32(r[e1][1]))
            d.get_output()
        assert e1 in dsps[0]._current
        _end_both(ctxs, e1)
        for c, d in zip(ctxs, dsps):
            c.sync_dsp(d)                  # the end is observed here
            assert e1 not in d._target and e1 not in d._current
        e3 = _emit_both(ctxs, 4.0, 0.0, 5.0)   # the free list reuses e1
        assert e3 == e1
        for c, d in zip(ctxs, dsps):
            c.sync_dsp(d)
            assert d._target[e3].pattern == DirectivityPattern.OMNI
        _end_both(ctxs, e3)
    finally:
        _end_both(ctxs, e2)
        for c, d in zip(ctxs, dsps):
            c.sync_dsp(d)


def test_audio_source_manager_matches_jax(ctxs):
    """Two clips through each package's manager (the second dies in its
    second block and ends its emission) over six blocks, dry mix."""
    mgrs = (AudioSourceManager(ctxs[0], DSPContext(PlaneverbDSPConfig(
                max_callback_length=512, sampling_rate=RATE))),
            JAudioSourceManager(ctxs[1], JDSPContext(jpv.PlaneverbDSPConfig(
                max_callback_length=512, sampling_rate=RATE))))
    e1 = _emit_both(ctxs, 6.5, 0.0, 5.0)
    e2 = _emit_both(ctxs, 4.0, 0.0, 5.0, volume_db=-6.0)
    for m in mgrs:
        m.play(e1, _tone(2048, 440.0))
        m.play(e2, _tone(700, 880.0))
    outs = [[m.process_block(512) for _ in range(6)] for m in mgrs]
    for ctx, m in zip(ctxs, mgrs):
        assert m.active_sources() == []
        assert ctx.emissions.get(e1) is None and ctx.emissions.get(e2) is None
    got, want = (np.concatenate(o, axis=0) for o in outs)
    assert np.abs(got).max() > 0
    _assert_audio(got, want, "manager mix")


def test_realtime_player_matches_jax(ctxs):
    """RealtimePlayer(native=False) of both packages, reverb on: the
    streaming DSP and then the three reverbs (the port's mix_output on the
    Context's device, here the CPU's plain version)."""
    audio = _tone(int(0.1 * RATE))
    eid = _emit_both(ctxs, 6.5, 0.0, 5.0, volume_db=-3.0)
    try:
        reports = [cls(c, eid, audio, RATE, frames=512,
                       native=False).run(realtime=False)
                   for cls, c in ((RealtimePlayer, ctxs[0]),
                                  (JRealtimePlayer, ctxs[1]))]
    finally:
        _end_both(ctxs, eid)
    got, want = (r.output for r in reports)
    assert got.shape == want.shape == audio.shape
    assert reports[0].blocks == -(-len(audio) // 512)
    assert np.abs(got).max() > 0
    _assert_audio(got, want, "player mix")
    s = reports[0].summary()
    assert "output" not in s and s["budget_ms"] == pytest.approx(
        512 / RATE * 1e3)


def test_realtime_player_is_its_own_chain(ctxs):
    """The pump equals the chain driven block by block by hand (sync_dsp ->
    DSPContext -> mix_output) bit for bit, and the bypass plays the source
    scaled by the emitter's volume."""
    ctx = ctxs[0]
    audio = _tone(1100)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0, volume_db=-6.0)
    try:
        report = RealtimePlayer(ctx, eid, audio, RATE, frames=512,
                                native=False).run(realtime=False)
        dsp = DSPContext(PlaneverbDSPConfig(max_callback_length=512,
                                            sampling_rate=RATE))
        states, chunks = {}, []
        for start in range(0, len(audio), 512):
            block = audio[start:start + 512]
            out, gain = ctx.sync_dsp(dsp)[eid]
            dsp.submit_source(eid, out, block * np.float32(gain))
            dry, wa, wb, wc = dsp.get_output()
            m = len(block)
            mix, states = mix_output(dry[:m], wa[:m], wb[:m], wc[:m], RATE,
                                     states, device="cpu")
            chunks.append(mix.numpy())
        bypass = RealtimePlayer(ctx, eid, audio, RATE, frames=512,
                                use_planeverb=False, native=False).run(
                                    realtime=False)
    finally:
        ctx.emissions.end(eid)
    np.testing.assert_array_equal(report.output, np.concatenate(chunks))
    np.testing.assert_allclose(bypass.output,
                               audio * np.float32(10 ** (-6.0 / 20.0)),
                               atol=1e-6)


def test_realtime_player_on_the_cpu_makes_no_stream(ctxs, monkeypatch):
    """On a CPU Context the player creates no CUDA stream, stages nothing
    in pinned memory and touches no torch.cuda API: each raises here."""
    import torch

    def refuse(*a, **kw):
        raise AssertionError("a CPU player touched torch.cuda")

    for name in ("Stream", "stream", "synchronize", "current_stream",
                 "device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    ctx = ctxs[0]
    eid = ctx.emissions.emit(6.5, 0.0, 5.0)
    try:
        player = RealtimePlayer(ctx, eid, _tone(1024), RATE, frames=512,
                                native=False)
        report = player.run(realtime=False)
    finally:
        ctx.emissions.end(eid)
    assert player.stream is None and player.copy_wait_ms == []
    assert report.blocks == 2 and np.abs(report.output).max() > 0


def test_realtime_player_native_and_sink_guarded(ctxs):
    """The default player is the native one (the C++ renderer and
    reverbs, tests/test_torch_native.py holds its output); the live sink
    needs the optional sounddevice package."""
    from planeverb_tpu_torch.native import NativeDSPContext

    player = RealtimePlayer(ctxs[0], 0, _tone(512), RATE)
    try:
        assert isinstance(player.dsp, NativeDSPContext)
        assert len(player._reverbs) == 3
    finally:
        player.close()
    import importlib.util

    if importlib.util.find_spec("sounddevice") is None:
        with pytest.raises(RuntimeError, match="sounddevice"):
            AudioDeviceSink(rate=RATE)


def test_wav_roundtrip_matches_jax(tmp_path):
    from planeverb_tpu.sandbox.wav import read_wav as jread_wav

    x = _tone(1000) * 0.9
    for f32 in (False, True):
        path = str(tmp_path / f"a{int(f32)}.wav")
        write_wav(path, x, RATE, float32=f32)
        got, rate = read_wav(path)
        want, jrate = jread_wav(path)
        assert rate == jrate == RATE
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, x, atol=1e-4 if not f32 else 0)


def test_api_facade():
    """tests/test_context.py::test_api_facade on the port, on the CPU."""
    api.init(CFG, scene=pv.demo_scene("SmallRoom"), background=False,
             device="cpu")
    try:
        assert api.get_context().device.type == "cpu"
        api.set_listener_position(5.0, 0.0, 5.0)
        api.get_context().step()
        eid = api.emit(6.0, 0.0, 5.0, volume_db=-3.0, pattern=1)
        assert api.get_emission(eid).pattern == 1
        assert api.get_output(eid).valid
        gid = api.add_geometry(pv.AABB(5.5, 5.0, 0.4, 3.0, 0.9))
        api.update_geometry(gid, pv.AABB(5.5, 5.0, 0.5, 3.0, 0.9))
        api.remove_geometry(gid)
        api.update_emission(eid, 6.5, 0.0, 5.0)
        api.end_emission(eid)
        assert api.get_impulse_response(6.0, 5.0).size > 0
    finally:
        api.exit()
    assert api.get_context() is None
    assert api.get_output(0).occlusion == INVALID_DRY_GAIN


def test_api_change_settings_keeps_device():
    """ChangeSettings = full teardown + re-init (PvContext.cpp:45-49), on the
    device the module was initialized on; init without device= asks for
    the card."""
    import dataclasses

    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(CFG, background=False)
    api.init(CFG, background=False, device="cpu")
    try:
        first = api.get_context()
        cfg2 = dataclasses.replace(CFG, grid_size_x=6.0, grid_size_y=6.0)
        ctx2 = api.change_settings(cfg2)
        assert ctx2 is not first and api.get_context() is ctx2
        assert ctx2.device.type == "cpu"
        assert ctx2.params.grid_size_x == 6.0
        ctx2.set_listener_position(3.0, 0.0, 3.0)
        ctx2.step()
        assert ctx2.result_at(4.0, 3.0).valid
    finally:
        api.exit()
