"""The port's sandbox front ends on the CPU: the CLI
(``python -m planeverb_tpu_torch``, ``sandbox/cli.py``), the browser viewer
(``sandbox/viewer.py``) and the door sweep (``sandbox/sweep.py``).

The cases of tests/test_sandbox.py (but ``scale``, which the port does not
have yet, and the explore demo, which drives the JAX package) and of
tests/test_viewer.py, each with ``--engine-device cpu`` / ``device="cpu"``;
then the port against the JAX package on the same inputs: the parameters
``analyze``, ``batch`` and ``ir`` print, the viewer's readouts and the door
sweep, at the golden tolerances of tests/test_golden_scenes.py (occlusion
and wet gain rtol 2e-4 atol 1e-5, lowpass rtol 2e-4 atol 1e-2, RT60 rtol
5e-3, source directivity rtol 1e-3 atol 1e-4, direction within 1e-4) plus
one unit of the last printed digit for printed values, and impulse
responses within C1's 1e-6 of their peak.
"""

import io
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import planeverb_tpu as jpv
from planeverb_tpu.sandbox.cli import main as jmain
from planeverb_tpu.sandbox.sweep import door_sweep as jdoor_sweep
from planeverb_tpu.sandbox.viewer import ViewerServer as JViewerServer
from planeverb_tpu_torch.config import PlaneverbConfig
from planeverb_tpu_torch.sandbox.cli import ascii_plot, main
from planeverb_tpu_torch.sandbox.sweep import door_sweep
from planeverb_tpu_torch.sandbox.viewer import ViewerServer
from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav
from planeverb_tpu_torch.scene import demo_scene, loads_pv

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--engine-device", "cpu"]
LOW = ["--resolution", "275"]
CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


def _run(argv, capsys, cli=main):
    assert cli(argv) == 0
    return capsys.readouterr().out


# ---------------------------------------------------- printed parameters
_NUM = r"([-+]?\d+(?:\.\d+)?)"
_FIELDS = {
    "occlusion": (rf"occlusion \(dry gain\):\s+{_NUM}", 1e-5),
    "wet_gain": (rf"wet gain:\s+{_NUM}", 1e-5),
    "rt60": (rf"rt60:\s+{_NUM}", 1e-5),
    "lowpass": (rf"lowpass cutoff:\s+{_NUM}", 1e-2),
    "direction": (rf"direction:\s+\({_NUM}, {_NUM}\)", 1e-4),
    "source_directivity": (rf"source directivity:\s+\({_NUM}, {_NUM}\)",
                           1e-4),
}


def _params(text):
    """Every readout block of the printed text, in order: {field: value}."""
    blocks = []
    for chunk in text.split("occlusion (dry gain)")[1:]:
        chunk = "occlusion (dry gain)" + chunk
        blocks.append({k: np.array(re.search(rx, chunk).groups(), float)
                       for k, (rx, _) in _FIELDS.items()})
    return blocks


def _assert_printed(got, want):
    """Printed readouts at the golden tolerances, plus one unit of the last
    printed digit (each side rounds on its own)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k, (rtol, atol) in {"occlusion": (2e-4, 1e-5),
                                "wet_gain": (2e-4, 1e-5),
                                "lowpass": (2e-4, 1e-2),
                                "rt60": (5e-3, 0.0),
                                "source_directivity": (1e-3, 1e-4),
                                "direction": (0.0, 1e-4)}.items():
            unit = _FIELDS[k][1]
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       atol=atol + unit, err_msg=k)


# --------------------------------------------------- tests/test_sandbox.py
class TestWav:
    def test_roundtrip_pcm16_stereo(self, tmp_path):
        rng = np.random.default_rng(0)
        x = rng.uniform(-0.9, 0.9, (1000, 2)).astype(np.float32)
        p = str(tmp_path / "t.wav")
        write_wav(p, x, 22050)
        y, rate = read_wav(p)
        assert rate == 22050 and y.shape == (1000, 2)
        np.testing.assert_allclose(y, x, atol=1e-4)

    def test_roundtrip_float32_mono(self, tmp_path):
        x = np.sin(np.linspace(0, 40, 500)).astype(np.float32)
        p = str(tmp_path / "t.wav")
        write_wav(p, x, 44100, float32=True)
        y, rate = read_wav(p)
        assert rate == 44100
        np.testing.assert_array_equal(y, x)

    def test_rejects_garbage(self, tmp_path):
        p = str(tmp_path / "bad.wav")
        with open(p, "wb") as f:
            f.write(b"not a wav file at all")
        with pytest.raises(ValueError):
            read_wav(p)


class TestCli:
    def test_scenes(self, capsys, tmp_path):
        out = _run(["scenes", "--export", str(tmp_path)], capsys)
        assert "SmallRoom" in out and "FloorPlanScene" in out
        assert len(os.listdir(tmp_path)) == 11

    def test_analyze(self, capsys):
        out = _run(["analyze", "SmallRoom", "--listener", "5,5",
                    "--source", "6.5,5"] + LOW + CPU, capsys)
        assert "occlusion" in out and "rt60" in out and "dB" in out

    def test_analyze_unknown_scene(self):
        with pytest.raises(SystemExit):
            main(["analyze", "NoSuchScene", "--source", "1,1"] + CPU)

    def test_batch_multi_listener(self, capsys):
        """batch = one batched simulation over B listeners; each listener's
        readout equals the single-listener analyze at that position."""
        out = _run(["batch", "SmallRoom", "--listener", "5,5",
                    "--listener", "3,3", "--source", "6.5,5"] + LOW + CPU,
                   capsys)
        assert out.count("listener (") == 2 and out.count("occlusion") == 2
        single = _run(["analyze", "SmallRoom", "--listener", "5,5",
                       "--source", "6.5,5"] + LOW + CPU, capsys)
        batch_first = out.split("listener (3, 3)")[0]
        for line in single.splitlines():
            if "occlusion" in line or "rt60" in line:
                assert line in batch_first, line

    def test_batch_requires_listener_in_grid(self):
        with pytest.raises(SystemExit, match="outside grid"):
            main(["batch", "SmallRoom", "--listener", "500,5",
                  "--source", "6,5"] + CPU)

    def test_grid(self, capsys):
        out = _run(["grid", "SmallRoom", "--source", "6.5,5"] + LOW, capsys)
        assert "#" in out and "." in out and "L" in out and "S" in out

    def test_ir_csv(self, tmp_path, capsys):
        out_path = str(tmp_path / "ir.csv")
        out = _run(["ir", "SmallRoom", "--listener", "5,5", "--source",
                    "6.5,5", "-o", out_path, "--plot"] + LOW + CPU, capsys)
        lines = open(out_path).read().strip().splitlines()
        assert lines[0] == "sample,pressure" and len(lines) > 100
        assert "linear" in out and "dB [-120, 0]" in out and "*" in out

    def test_ascii_plot_shape(self):
        s = ascii_plot(np.sin(np.linspace(0, 6.28, 1000)), -1.0, 1.0,
                       width=40, height=8)
        rows = s.splitlines()
        assert len(rows) == 8 and all(len(r) == 40 for r in rows)
        assert sum(r.count("*") for r in rows) == 40

    def test_render_native_and_python_agree(self, tmp_path, capsys):
        """render through the Python renderer and the native one (--native),
        with --mix: D2's plain version against the C++ reverbs."""
        t = np.arange(4410) / 44100.0
        tone = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
        src = str(tmp_path / "in.wav")
        write_wav(src, tone, 44100)
        outs = {}
        for flavor, extra in (("py", []), ("nat", ["--native"])):
            out_dir = str(tmp_path / flavor)
            out = _run(["render", "SmallRoom", "--listener", "5,5",
                        "--source", "6.5,5", "--in", src, "--out-dir",
                        out_dir, "--mix"] + LOW + CPU + extra, capsys)
            assert "mix" in out
            outs[flavor] = {
                n: read_wav(os.path.join(out_dir, f"{n}.wav"))[0]
                for n in ("dry", "wet_a_0.5s", "wet_b_1.0s", "wet_c_3.0s",
                          "mix")}
        for name in outs["py"]:
            assert np.abs(outs["py"][name]).max() > 0 or "c_3" in name
            np.testing.assert_allclose(
                outs["nat"][name], outs["py"][name], atol=5e-4,
                err_msg=f"native/python render mismatch on {name}")

    def test_convolve_and_play(self, tmp_path, capsys):
        """convolve (the simulated IR) and play (the native chain, unpaced)
        run on the CPU engine and write their outputs."""
        src = str(tmp_path / "in.wav")
        write_wav(src, np.sin(np.arange(2048) * 0.05).astype(np.float32)
                  * 0.5, 44100)
        conv = str(tmp_path / "conv.wav")
        out = _run(["convolve", "SmallRoom", "--source", "6.5,5", "--in",
                    src, "-o", conv] + LOW + CPU, capsys)
        assert "simulated IR" in out and read_wav(conv)[0].shape[0] > 2048
        played = str(tmp_path / "played.wav")
        rc = main(["play", "SmallRoom", "--source", "6.5,5", "--in", src,
                   "--no-pace", "-o", played] + LOW + CPU)
        out = capsys.readouterr().out
        assert rc in (0, 1) and "played 4 blocks" in out
        assert read_wav(played)[0].shape == (2048, 2)


class TestSweep:
    def test_cli_sweep_writes_the_csv(self, tmp_path, capsys):
        path = str(tmp_path / "sweep.csv")
        out = _run(["sweep", "--steps", "3", "-o", path] + LOW + CPU,
                   capsys)
        assert "3-step door sweep" in out
        lines = open(path).read().splitlines()
        assert lines[0] == "door_pos,dry_gain,wet_gain" and len(lines) == 4

    def test_door_sweep_smooth_and_monotonicish(self):
        res = door_sweep(CFG, steps=11, device="cpu")
        assert res.dry_gain.shape == (11,)
        assert res.dry_gain[-1] > res.dry_gain[0]
        steps = np.abs(np.diff(res.dry_gain))
        rng = res.dry_gain.max() - res.dry_gain.min()
        assert steps.max() <= 0.5 * rng + 1e-6
        buf = io.StringIO()
        res.to_csv(buf)
        assert buf.getvalue().startswith("door_pos,dry_gain,wet_gain")

    def test_ascii_plot_envelope_tracks_decay(self):
        t = np.arange(400, dtype=np.float64)
        db = -t * 0.25
        db[1::2] = -120.0
        rows = ascii_plot(db, -120.0, 0.0, width=40, height=10,
                          envelope=True).splitlines()
        col_height = [10 - next(r for r in range(10) if rows[r][c] == "*")
                      for c in range(40)]
        assert col_height[0] == 10 and col_height[-1] <= 3
        assert all(a >= b for a, b in zip(col_height, col_height[1:]))


def test_cli_play_device_flag_guarded(tmp_path):
    import importlib.util

    if importlib.util.find_spec("sounddevice") is not None:
        pytest.skip("sounddevice installed; no audio hardware here")
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros((512, 2), np.float32), 44100)
    with pytest.raises(RuntimeError, match="sounddevice"):
        main(["play", "SmallRoom", "--source", "6,5", "--in", str(wav),
              "--device", "--no-pace", "-o", ""] + LOW + CPU)


def test_cli_has_no_scale_command(capsys):
    """scale's projection model is ported with the H100's constants:
    ``scale --project`` prints one row per modelled card count, the one
    card at efficiency 1, without touching a card."""
    import json

    from planeverb_tpu_torch.sandbox.cli import PROJECT_COUNTS

    assert main(["scale", "HugeRoom", "--project", "--grid-size", "126",
                 "--resolution", "750"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == list(PROJECT_COUNTS)
    assert rows[0]["efficiency"] == 1.0
    assert all(0.0 < r["efficiency"] <= 1.0 for r in rows)


def test_engine_runs_on_the_card_unless_asked():
    """Without --engine-device / device= the CLI, the sweep and the viewer
    ask for the card; on a host without one they raise, never running on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["analyze", "SmallRoom", "--source", "6.5,5"] + LOW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["batch", "SmallRoom", "--listener", "5,5", "--source",
              "6.5,5"] + LOW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        door_sweep(CFG, steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewerServer(CFG, port=0, background=False)


def test_module_entry_point_serve_and_view():
    """python -m planeverb_tpu_torch runs; serve and view start on the CPU,
    answer, and stop."""
    env = dict(os.environ, PYTHONPATH=_ROOT)
    for argv, probe in ((["serve", "--port", "0"], "serve"),
                        (["view", "SmallRoom", "--port", "0"] + LOW, "view")):
        proc = subprocess.Popen(
            [sys.executable, "-m", "planeverb_tpu_torch", *argv] + CPU,
            cwd=_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            host, port = re.search(r"(\d+\.\d+\.\d+\.\d+):(\d+)",
                                   line).groups()
            if probe == "serve":
                from planeverb_tpu_torch.server import EngineClient

                c = EngineClient(host, int(port))
                r = c.call("init", grid_resolution=275, background=False)
                c.close()
                assert r["ok"] and r["fs"] > 0
            else:
                with urllib.request.urlopen(
                        f"http://{host}:{port}/api/state", timeout=120) as r:
                    assert json.loads(r.read())["scene"] == "SmallRoom"
        finally:
            proc.terminate()
            proc.wait(timeout=60)


# ------------------------------------------------ the port against the JAX
def test_analyze_matches_jax(capsys):
    argv = ["analyze", "SmallRoom", "--listener", "5,5", "--source", "6.5,5",
            "--source", "3.5,4", "--source", "6,6.5"] + LOW
    want = _params(_run(argv, capsys, jmain))
    got = _params(_run(argv + CPU, capsys))
    _assert_printed(got, want)


def test_batch_matches_jax(capsys):
    argv = ["batch", "SmallRoom", "--listener", "5,5", "--listener", "3,3",
            "--listener", "6.5,6", "--source", "6.5,5", "--source",
            "4,6"] + LOW
    want = _params(_run(argv, capsys, jmain))
    got = _params(_run(argv + CPU, capsys))
    assert len(got) == 6
    _assert_printed(got, want)


def test_ir_matches_jax(tmp_path, capsys):
    irs = []
    for cli, extra in ((jmain, []), (main, CPU)):
        path = str(tmp_path / f"ir{len(irs)}.csv")
        _run(["ir", "SmallRoom", "--listener", "5,5", "--source", "6.5,5",
              "-o", path] + LOW + extra, capsys, cli)
        irs.append(np.loadtxt(path, delimiter=",", skiprows=1)[:, 1])
    want, got = irs
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_door_sweep_matches_jax():
    cfg = jpv.PlaneverbConfig(10.0, 10.0, 275)
    want = jdoor_sweep(cfg, steps=5)
    got = door_sweep(CFG, steps=5, device="cpu")
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_allclose(got.dry_gain, want.dry_gain, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.wet_gain, want.wet_gain, rtol=2e-4,
                               atol=1e-5)
    a, b = io.StringIO(), io.StringIO()
    got.to_csv(a)
    want.to_csv(b)
    assert a.getvalue().splitlines()[0] == b.getvalue().splitlines()[0]


# --------------------------------------------------- tests/test_viewer.py
@pytest.fixture(scope="module")
def viewer():
    v = ViewerServer(CFG, scene=demo_scene("SmallRoom"), port=0,
                     background=False, device="cpu")
    v.start_background()
    yield v
    v.shutdown()


def _get(viewer, path):
    host, port = viewer.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=120) as r:
        body = r.read()
        if r.headers.get_content_type() == "application/json":
            return json.loads(body)
        return body.decode()


def _cmd(viewer, **req):
    host, port = viewer.address
    r = urllib.request.urlopen(
        urllib.request.Request(
            f"http://{host}:{port}/api/command",
            data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"}),
        timeout=600)
    return json.loads(r.read())


def test_page_serves(viewer):
    page = _get(viewer, "/")
    assert "<!doctype html>" in page and "/api/state" in page


def test_state_snapshot(viewer):
    s = _get(viewer, "/api/state")
    assert s["grid"]["nx"] > 0 and s["grid"]["fs"] > 0
    assert len(s["occupancy"]) == s["grid"]["nx"]
    assert len(s["occupancy"][0]) == s["grid"]["ny"]
    assert any("#" in row for row in s["occupancy"])
    assert len(s["geometry"]) == 4
    assert s["scene"] == "SmallRoom" and "SmallRoom" in s["scenes"]
    assert s["running"] is False


def test_full_editing_session(viewer):
    assert _cmd(viewer, cmd="listener", x=5.0, z=5.0)["ok"]
    eid = _cmd(viewer, cmd="emit", x=6.5, z=5.0)["id"]
    r = _cmd(viewer, cmd="step")
    assert r["ok"] and r["iteration"] >= 1
    out = _get(viewer, "/api/output?x=6.5&z=5.0")
    assert out["valid"] and out["occlusion"] > 0 and out["rt60"] > 0
    assert out["dry_db"] == pytest.approx(
        20 * np.log10(max(out["occlusion"], 1e-6)), abs=1e-6)
    ir = _get(viewer, "/api/ir?x=6.5&z=5.0")
    assert ir["fs"] == viewer.ctx.params.fs
    assert len(ir["samples"]) == viewer.ctx.params.response_length
    assert max(abs(v) for v in ir["samples"]) > 0
    gid = _cmd(viewer, cmd="add_geometry", cx=5.75, cy=5.0, w=0.8, h=3.0,
               absorption=0.98)["id"]
    _cmd(viewer, cmd="step")
    out2 = _get(viewer, "/api/output?x=6.5&z=5.0")
    assert out2["occlusion"] != out["occlusion"]
    assert _cmd(viewer, cmd="remove_geometry", id=gid)["ok"]
    s = _get(viewer, "/api/state")
    [em] = [e for e in s["emitters"] if e["id"] == eid]
    assert (em["x"], em["z"]) == (6.5, 5.0)
    assert em["volume_db"] == 0.0 and em["pattern"] == 0
    assert _cmd(viewer, cmd="update_emission", id=eid, x=6.0, z=5.0,
                volume_db=-6.0, pattern=1)["ok"]
    [em] = [e for e in _get(viewer, "/api/state")["emitters"]
            if e["id"] == eid]
    assert em["volume_db"] == -6.0 and em["pattern"] == 1 and em["x"] == 6.0
    assert _cmd(viewer, cmd="end_emission", id=eid)["ok"]
    assert _get(viewer, "/api/state")["emitters"] == []


def test_pv_roundtrip_and_scene_load(viewer):
    scene = loads_pv(_get(viewer, "/api/scene.pv"))
    assert len(scene.boxes) == len(_get(viewer, "/api/state")["geometry"])
    assert _cmd(viewer, cmd="load_scene", name="MiddleWallScene")["ok"]
    s = _get(viewer, "/api/state")
    assert s["scene"] == "MiddleWallScene" and len(s["geometry"]) == 1
    assert _cmd(viewer, cmd="load_scene", name="SmallRoom")["ok"]


def test_errors_do_not_kill_server(viewer):
    r = _cmd(viewer, cmd="no_such_command")
    assert r["ok"] is False and "unknown" in r["error"]
    r = _cmd(viewer, cmd="update_geometry", id=99999, cx=0, cy=0, w=1, h=1)
    assert r["ok"] is False
    with pytest.raises(urllib.error.HTTPError):
        _get(viewer, "/api/nope")
    assert _get(viewer, "/api/state")["grid"]["nx"] > 0


def test_viewer_matches_jax():
    """The port's viewer and the JAX package's on the same edits: equal
    state (grid, occupancy, geometry, emitters, listener, iteration), the
    readouts at the golden tolerances, the IR within 1e-6 of its peak; a
    CPU mesh (mesh_devices=4) publishes the single-device readouts."""
    views = [JViewerServer(jpv.PlaneverbConfig(10.0, 10.0, 275),
                           scene=jpv.demo_scene("SmallRoom"), port=0,
                           background=False),
             ViewerServer(CFG, scene=demo_scene("SmallRoom"), port=0,
                          background=False, device="cpu"),
             ViewerServer(CFG, scene=demo_scene("SmallRoom"), port=0,
                          background=False, mesh_devices=4, device="cpu")]
    for v in views:
        v.start_background()    # shutdown() waits for the serving loop
    try:
        for v in views:
            assert v.command({"cmd": "listener", "x": 4.5, "z": 5.5})["ok"]
            assert v.command({"cmd": "emit", "x": 6.5, "z": 5.0})["ok"]
            assert v.command({"cmd": "add_geometry", "cx": 5.5, "cy": 4.0,
                              "w": 0.5, "h": 2.0,
                              "absorption": "WOOD_PANEL"})["ok"]
            assert v.command({"cmd": "step"})["iteration"] == 1
        states = [{k: s[k] for k in s if k != "profile"}
                  for s in (v.state() for v in views)]
        assert states[1] == states[0] and states[2] == states[1]
        for x, z in ((6.5, 5.0), (4.0, 4.5), (5.5, 6.0)):
            want, got, mesh = (v.output_at(x, z) for v in views)
            assert mesh == got
            assert got["valid"] and want["valid"]
            for k, (rtol, atol) in (("occlusion", (2e-4, 1e-5)),
                                    ("wet_gain", (2e-4, 1e-5)),
                                    ("lowpass", (2e-4, 1e-2)),
                                    ("rt60", (5e-3, 0.0)),
                                    ("source_directivity", (1e-3, 1e-4))):
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           atol=atol, err_msg=k)
            assert np.abs(np.subtract(got["direction"],
                                      want["direction"])).max() <= 1e-4
            want_ir, got_ir = (np.array(v.ir_at(x, z)["samples"])
                               for v in views[:2])
            peak = np.abs(want_ir).max()
            assert peak > 0
            assert np.abs(got_ir - want_ir).max() <= 1e-6 * peak
    finally:
        for v in views:
            v.shutdown()
