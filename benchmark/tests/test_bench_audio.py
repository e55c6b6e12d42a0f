"""The audio cell on the CPU at the 10 m, 275 Hz stand-in: the pump end to
end is correct, the faults an audio callback can have and its bf16 control
come out not correct, and the plain DSP agrees with the port's renderers.

The faults: a voice dropped before the DSP, half of the voices fed the rows
of a refresh long gone beside the others' current ones, the reverbs left
out of the mix. The control: the plain DSP computed in bf16 in the
callback's place.
"""

import json

import numpy as np
import pytest
import torch

import standin
from benchmark import drive, reference_dsp, run
from benchmark import traffic as traffic_mod

pv = pytest.importorskip("planeverb_tpu_torch")
from planeverb_tpu_torch import PlaneverbDSPConfig  # noqa: E402
from planeverb_tpu_torch.core import context as context_mod  # noqa: E402
from planeverb_tpu_torch.dsp import DSPContext  # noqa: E402
from planeverb_tpu_torch.dsp import reverb as reverb_mod  # noqa: E402
from planeverb_tpu_torch.native import (NativeDSPContext,  # noqa: E402
                                        NativeReverb)
from planeverb_tpu_torch.types import PlaneverbOutput, vec2  # noqa: E402

SEED = 4294967311          # more than 32 bits hold
AUDIO = ("audio_inputs_gap", "audio_gap")


def _line(capsys, extra=(), seconds=1.0):
    argv = ["--workload", "standin.audio", "--seed", str(SEED),
            "--seconds", str(seconds), "--trace", "0", *extra]
    assert run.main(argv, device="cpu", cell=standin.cell("audio")) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_pump_end_to_end(capsys):
    line, err = _line(capsys)
    assert line["correct"] is True and line["failed"] == 0
    checks = line["checks"]
    assert set(AUDIO) <= set(checks)
    assert checks["audio_inputs_gap"]["value"] == 0
    for k in AUDIO:
        assert checks[k]["value"] <= checks[k]["limit"]
    assert "audio_block_ms_p50" in line["metrics"]
    audio = line["run"]["audio"]
    # every block due in the window, each checked
    frames, rate = 512, 44100
    assert audio["blocks"] == int(np.ceil(1.0 * rate / frames))
    assert line["attempted"] == audio["blocks"] + sum(
        line["run"]["per_second"])
    assert audio["reference_s"] > 0 and audio["proxy_ms_per_block"] > 0
    assert err.strip().splitlines()[-1].startswith("check ")


def test_dropped_voice(capsys, monkeypatch):
    """The engine-to-DSP sync loses the first voice: the DSP never gets
    it."""
    real = context_mod.Context.sync_dsp

    def dropped(self, dsp, listener=0):
        out = real(self, dsp, listener)
        out.pop(min(out), None)
        return out

    monkeypatch.setattr(context_mod.Context, "sync_dsp", dropped)
    line, _ = _line(capsys)
    assert line["correct"] is False
    for k in AUDIO:
        assert line["checks"][k]["value"] > line["checks"][k]["limit"]


def test_rows_of_two_refreshes(capsys, monkeypatch):
    """Half of the voices keep the rows of the first block's sync, long
    stale, beside the others' current rows."""
    real = context_mod.Context.sync_dsp
    first = {}

    def stale(self, dsp, listener=0):
        out = real(self, dsp, listener)
        if not first:
            first.update(out)
        for eid in sorted(out)[:len(out) // 2]:
            out[eid] = first[eid]
        return out

    monkeypatch.setattr(context_mod.Context, "sync_dsp", stale)
    line, _ = _line(capsys)
    assert line["correct"] is False
    gap = line["checks"]["audio_inputs_gap"]
    assert gap["value"] > gap["limit"]


def test_reverbs_left_out(capsys, monkeypatch):
    monkeypatch.setattr(NativeReverb, "process_add", lambda *a, **k: None)
    line, _ = _line(capsys)
    assert line["correct"] is False
    gap = line["checks"]["audio_gap"]
    assert gap["value"] > gap["limit"]


def test_audio_control_fails(capsys):
    line, _ = _line(capsys, ("--control", "audio-bf16"))
    assert line["correct"] is False
    gap = line["checks"]["audio_gap"]
    assert gap["value"] > gap["limit"]


# ---------------------------------------------------------------- the plain
# DSP against the port's renderers, on seeded clips and rows

def _inputs(blocks=24, voices=6, seed=5):
    with open(f"{standin.cells.HERE}/traffic/audio.json") as f:
        audio = dict(json.load(f)["audio"])
    audio.update(voices=voices, clip_s=[0.05, 0.08])
    rng = np.random.default_rng(seed)
    rows = np.zeros((blocks, voices, 8), np.float32)
    rows[..., 0] = rng.uniform(0.05, 1.0, (blocks, voices))
    rows[..., 1] = rng.uniform(0.0, 0.8, (blocks, voices))
    # decays on both sides of the wet split's thresholds
    rows[..., 2] = rng.choice([0.3, 0.45, 0.6, 0.9, 1.2, 2.5, 3.4],
                              (blocks, voices)) * rng.uniform(
        0.95, 1.05, (blocks, voices))
    rows[..., 3] = np.exp(rng.uniform(np.log(30.0), np.log(19000.0),
                                      (blocks, voices)))
    a = rng.uniform(0.0, 2.0 * np.pi, (blocks, voices))
    rows[..., 4], rows[..., 5] = np.cos(a), np.sin(a)
    rows[..., 6:8] = rng.uniform(-1.0, 1.0, (blocks, voices, 2))
    # rejected rows: a cutoff out of band, an invalid emitter, no direction,
    # a NaN
    rows[3, 1, 3] = 10.0
    rows[4, 2, 0] = -1.0
    rows[5, 3, 4:6] = 0.0
    rows[6, 0, 2] = np.nan
    listener = np.zeros((blocks, 6), np.float32)
    turn = np.linspace(0.0, 3.0, blocks)
    listener[:, 0] = np.linspace(2.0, 6.0, blocks)
    listener[:, 1], listener[:, 2] = 1.7, 5.0
    listener[:, 3], listener[:, 5] = np.cos(turn), np.sin(turn)
    fed = np.ones((blocks, voices), bool)
    fed[7, 4] = False
    return dict(audio=audio, clips=traffic_mod.clips(audio, seed),
                rows=rows, fed=fed, listener=listener,
                epos=rng.uniform(0.0, 10.0, (voices, 2)).astype(np.float32),
                efwd=np.tile([1.0, 0.0], (voices, 1)),
                epattern=np.array([0, 1] * (voices // 2)))


def _replay(x, store=reference_dsp._keep):
    v = len(x["clips"])
    return reference_dsp.replay(
        reference_dsp.Stream.of(x["audio"]), x["clips"], [1.0] * v,
        x["epos"], x["efwd"], x["epattern"], x["rows"], x["fed"],
        x["listener"], store=store)


def _drive(dsp, x):
    """The DSP fed block by block as the audio manager feeds it; returns
    each block's four buses."""
    n = x["audio"]["frames"]
    out = []
    for b, rows in enumerate(x["rows"]):
        lis = x["listener"][b]
        dsp.set_listener_transform(tuple(map(float, lis[:3])),
                                   tuple(map(float, lis[3:])))
        for v, (px, pz) in enumerate(x["epos"]):
            dsp.update_emitter(v, (float(px), 1.7, float(pz)), (1.0, 0, 0))
            dsp.set_emitter_directivity_pattern(v, int(x["epattern"][v]))
        for v, r in enumerate(rows):
            if x["fed"][b, v]:
                clip = x["clips"][v]
                block = clip[(b * n + np.arange(n)) % len(clip)]
                dsp.submit_source(v, PlaneverbOutput(
                    *map(float, r[:4]), vec2(float(r[4]), float(r[5])),
                    vec2(float(r[6]), float(r[7]))), block)
        out.append([np.array(bus[:n], np.float32)
                    for bus in dsp.get_output()])
    return out


def _cfg(x):
    a = x["audio"]
    return PlaneverbDSPConfig(max_callback_length=a["frames"],
                              dsp_smoothing_factor=a["smoothing"],
                              sampling_rate=a["rate_hz"],
                              wet_gain_ratio=a["wet_gain_ratio"])


# float32 against float64: the ramps' and filters' rounding over a block,
# and the reverbs' feedback over the stream
TOLERANCE = 2e-4


def test_plain_dsp_against_the_native_renderer():
    x = _inputs()
    want = _replay(x)
    revs = [NativeReverb(rt, x["audio"]["rate_hz"])
            for rt in x["audio"]["reverb_rt60_s"]]
    mix = []
    for dry, *wet in _drive(NativeDSPContext(_cfg(x)), x):
        m = dry.copy()
        for rev, bus in zip(revs, wet):
            rev.process_add(bus, m)
        mix.append(m)
    gap = np.abs(np.stack(mix) - want).max() / np.abs(want).max()
    assert gap < TOLERANCE


def test_plain_dsp_against_the_plain_renderer_and_reverb():
    x = _inputs()
    want = _replay(x)
    buses = _drive(DSPContext(_cfg(x)), x)
    mix = np.stack([b[0] for b in buses]).astype(np.float64)
    rate = x["audio"]["rate_hz"]
    for k, rt in enumerate(x["audio"]["reverb_rt60_s"]):
        wet = np.concatenate([b[k + 1][:, 0] for b in buses])
        p = reverb_mod.reverb_params(rt, rate)
        y, _ = reverb_mod.reverb_scan_reference(
            torch.tensor(wet[None]), reverb_mod.init_reverb_state(
                p, 1, "cpu"), p)
        mix += y[0].double().numpy().reshape(mix.shape[:2])[..., None]
    gap = np.abs(mix - want).max() / np.abs(want).max()
    assert gap < TOLERANCE
    # the control is far outside that
    ctl = _replay(x, reference_dsp.bf16)
    assert np.abs(ctl - want).max() / np.abs(want).max() > 20 * TOLERANCE


def test_reverbs_equal_the_plain_version_at_every_chunking():
    """The chunked reverb against the port's per-sample plain version, at
    44.1 kHz and at a rate whose delays are a few samples."""
    rng = np.random.default_rng(3)
    for rate, n in ((44100, 5000), (1000, 300)):
        x = rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)
        got = reference_dsp.reverbs(x.astype(np.float64), (0.5, 1.0, 3.0),
                                    rate)
        for row, rt in enumerate((0.5, 1.0, 3.0)):
            p = reverb_mod.reverb_params(rt, rate)
            y, _ = reverb_mod.reverb_scan_reference(
                torch.tensor(x[row:row + 1]),
                reverb_mod.init_reverb_state(p, 1, "cpu"), p)
            want = y[0].double().numpy()
            assert np.abs(got[row] - want).max() < 1e-5 * np.abs(want).max()


def test_lowpass_closed_form_equals_the_recursion():
    rng = np.random.default_rng(4)
    cut = np.array([20.0, 95.0, 1000.0, 7000.0, 19999.0], np.float32)
    x = rng.uniform(-1.0, 1.0, (5, 512))
    y1, y2 = rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 5)
    got = reference_dsp.lowpass(x, y1, y2, cut, 44100)
    f = np.float32
    for i, c in enumerate(cut):
        t = f(2.0) * f(reference_dsp.PI) * c / f(44100)
        y = f(1.0) / (f(1.0) + f(reference_dsp.SQRT_2) * t + t * t)
        cx, c1, c2 = (float(v) for v in (t * t * y, (f(2.0) + f(
            reference_dsp.SQRT_2) * t) * y, -y))
        want, a, b = np.empty(512), y1[i], y2[i]
        for k in range(512):
            want[k] = cx * x[i, k] + c1 * a + c2 * b
            a, b = want[k], a
        assert np.abs(got[i] - want).max() < 1e-9 * np.abs(want).max()


def test_clips_from_their_own_stream():
    """The clips come from a stream no other draw uses: the same seed
    gives the same clips, and the walk of an audio mix is walk's."""
    cell = standin.cell("audio")
    walk = standin.cell("walk")
    from benchmark import reference, scenes
    p = cell.reference_params()
    g = reference.grid(p["world_x"], p["world_y"], p["resolution"])
    sc = scenes.load(cell.config["scene"])
    a = traffic_mod.make(g, sc, cell.traffic, 9)
    b = traffic_mod.make(g, sc, cell.traffic, 9)
    w = traffic_mod.make(g, sc, walk.traffic, 9)
    assert len(a.clips) == cell.traffic["audio"]["voices"]
    assert all(np.array_equal(c, d) for c, d in zip(a.clips, b.clips))
    lo, hi = cell.traffic["audio"]["clip_s"]
    assert all(lo * 44100 <= len(c) <= hi * 44100 for c in a.clips)
    peak = 10 ** (cell.traffic["audio"]["clip_dbfs"] / 20)
    assert max(float(np.abs(c).max()) for c in a.clips) <= peak
    assert a.emitters == w.emitters
    assert [a.listeners(i) for i in range(0, 500, 9)] == \
        [w.listeners(i) for i in range(0, 500, 9)]
    assert w.audio is None and w.clips is None


def test_proxy_passes_every_call_on():
    calls = []

    class Dsp:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a))

    out = PlaneverbOutput(0.5, 0.25, 1.0, 5000.0, vec2(1.0, 0.0),
                          vec2(0.0, 1.0))
    proxy = drive.RecordingDSP(Dsp(), {7: 0, 9: 1}, 3)
    proxy.block = 2
    proxy.set_listener_transform((1.0, 2.0, 3.0), (0.0, 0.0, 1.0))
    proxy.update_emitter(7, (0, 0, 0), (1, 0, 0))
    proxy.submit_source(9, out, None)
    proxy.submit_source(8, out, None)
    assert [c[0] for c in calls] == ["set_listener_transform",
                                     "update_emitter", "submit_source",
                                     "submit_source"]
    assert proxy.fed.tolist() == [[False, False]] * 2 + [[False, True]]
    assert proxy.rows[2, 1].tolist() == [0.5, 0.25, 1.0, 5000.0, 1.0, 0.0,
                                         0.0, 1.0]
    assert proxy.listener[2].tolist() == [1.0, 2.0, 3.0, 0.0, 0.0, 1.0]
    assert isinstance(drive.proxy_ms([7, 9], out, blocks=5), float)
