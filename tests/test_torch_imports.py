"""The port imports without JAX, and its copied modules equal their originals.

planeverb_tpu_torch carries copies of the NumPy/stdlib modules it needs
(config, scene, objects, session, the DSP's NumPy modules, the sandbox's
WAV I/O and playback manager) because importing any planeverb_tpu
submodule imports jax (planeverb_tpu/__init__.py imports the Context
eagerly). These tests pin each copy to its original.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import planeverb_tpu.config as jcfg
import planeverb_tpu.scene as jscene
import planeverb_tpu_torch.config as tcfg
import planeverb_tpu_torch.scene as tscene

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_without_jax():
    """Every module of the port imports with jax and planeverb_tpu blocked
    (a None entry in sys.modules makes their import raise)."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["planeverb_tpu"] = None
        import importlib, pkgutil
        import planeverb_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      "planeverb_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in [k for k, v in sys.modules.items() if v]
        assert "planeverb_tpu_torch.ops.fdtd_tiled" in names
        assert "planeverb_tpu_torch.parallel.solver_fused" in names
        for name in ("dsp", "dsp.reverb", "api", "session",
                     "sandbox.realtime", "sandbox.audio_manager",
                     "core.objects", "server", "native", "sandbox.cli",
                     "sandbox.viewer", "sandbox.sweep", "__main__",
                     "parallel.multihost", "parallel.scaling", "entry"):
            assert "planeverb_tpu_torch." + name in names, name
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_scaling_holds_no_tpu_constant():
    """parallel/scaling.py's projection model carries the H100's own
    constants: none of the JAX module's TPU names (V5E_*, ICI_*, DCN_*)
    and no TPU lane padding (``_lanes``); each constant is set."""
    path = os.path.join(_ROOT, "planeverb_tpu_torch", "parallel",
                        "scaling.py")
    tree = ast.parse(open(path).read())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.name for n in ast.walk(tree)
              if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    bad = sorted(n for n in names
                 if n.startswith(("V5E_", "ICI_", "DCN_")) or n == "_lanes")
    assert not bad, bad
    from planeverb_tpu_torch.parallel import scaling

    assert scaling.__all__ == ["measure_scaling", "projected_efficiency",
                               "projected_weak_efficiency"]
    for name in ("ROUND_RATE_CUPS", "ROUND_OVERHEAD_S", "NVLINK_GBPS",
                 "NVLINK_LATENCY_S", "NIC_GBPS", "NIC_LATENCY_S"):
        assert getattr(scaling, name) > 0, name


def test_parallel_exports_the_ported_modules():
    from planeverb_tpu_torch import parallel

    for name in ("simulate_sharded", "simulate_sharded_wide",
                 "init_distributed", "layout_by_process",
                 "multihost_grid_mesh"):
        assert name in parallel.__all__ and callable(getattr(parallel, name))


def test_parallel_imports_without_jax():
    """The sharded engine (planeverb_tpu_torch.parallel) imports, builds a
    mesh of repeated cpu and steps it, with jax and planeverb_tpu
    blocked."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["planeverb_tpu"] = None
        import planeverb_tpu_torch as pv
        from planeverb_tpu_torch import parallel
        mesh = parallel.grid_mesh(["cpu"] * 2, (2, 1))
        ctx = pv.Context(pv.PlaneverbConfig(6.0, 6.0, 275), mesh=mesh)
        ctx.set_listener_position(3.0, 0.0, 3.0)
        ctx.step()
        assert ctx.result_at(4.0, 3.0).valid
        assert "jax" not in [k for k, v in sys.modules.items() if v]
        print(sorted(parallel.__all__))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "simulate_moments_sharded" in proc.stdout


@pytest.mark.parametrize("size", [10.0, 25.0])
@pytest.mark.parametrize("res", [275, 375, 750])
def test_grid_params_match(size, res):
    j = jcfg.compute_grid_params(jcfg.PlaneverbConfig(size, size, res))
    t = tcfg.compute_grid_params(tcfg.PlaneverbConfig(size, size, res))
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "constants":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    for prop in ("nx", "ny", "courant", "dry_gain_samples",
                 "source_dir_samples", "wet_gain_samples",
                 "schroeder_offset_samples", "covered_travel_m"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.world_to_cell(size / 2, size / 3) == t.world_to_cell(size / 2,
                                                                  size / 3)
    np.testing.assert_array_equal(jcfg.gaussian_pulse(j),
                                  tcfg.gaussian_pulse(t))


def test_demo_scenes_match():
    assert sorted(jscene.DEMO_SCENES) == sorted(tscene.DEMO_SCENES)
    assert len(tscene.DEMO_SCENES) == 11
    for name in jscene.DEMO_SCENES:
        a = [dataclasses.astuple(b) for b in jscene.demo_scene(name)]
        b = [dataclasses.astuple(b) for b in tscene.demo_scene(name)]
        assert a == b, name


def test_materials_match():
    assert dataclasses.asdict(jcfg.MATERIALS) == dataclasses.asdict(
        tcfg.MATERIALS)
    assert tcfg.material_r("grass") == jcfg.material_r("grass")


# ------------------------------------------------------- the copied modules
class _Strip(ast.NodeTransformer):
    """Drops import statements and docstrings: a copy may differ from its
    original in those alone."""

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def _body(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = body or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _body


def _defs(path, names=None):
    """{top-level name: ast dump} of a module's code, imports and
    docstrings dropped; ``names`` keeps only those definitions."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = _Strip().visit(ast.parse(f.read()))
    out = {}
    for i, node in enumerate(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            t = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            name = ast.unparse(t)
        else:
            name = f"<stmt {i}>"
        if names is None or name in names:
            out[name] = ast.dump(node)
    return out


# (original, copy, names pinned: None for the whole module)
_COPIES = [
    ("core/objects.py", "core/objects.py", None),
    ("session.py", "session.py", None),
    ("dsp/gains.py", "dsp/gains.py", None),
    ("dsp/context.py", "dsp/context.py", None),
    ("sandbox/wav.py", "sandbox/wav.py", None),
    ("sandbox/audio_manager.py", "sandbox/audio_manager.py", None),
    ("dsp/lowpass.py", "dsp/lowpass.py",
     {"SQRT_2", "PI", "coefficients", "LowpassState", "process"}),
    ("dsp/reverb.py", "dsp/reverb.py",
     {"COMB_DELAYS_S", "ALLPASS_DELAYS_S", "ALLPASS_G", "DAMPING",
      "comb_feedback", "ReverbParams", "reverb_params", "ReverbState"}),
    ("dsp/convolver.py", "dsp/convolver.py", {"synthetic_ir",
                                              "resample_ir"}),
    ("server.py", "server.py", {"_Handler", "_Server", "_HANDLERS",
                                "EngineClient"}),
    # all but the build directory and _compile, which renames each build
    # into place (test workers build the libraries concurrently)
    ("native/__init__.py", "native/__init__.py",
     {"__all__", "_DIR", "_SRC", "_ENGINE_SRC", "_LIB", "_ENGINE_LIB",
      "_src_tag", "build_library", "build_engine_client_library",
      "load_library", "_OutputC", "load_engine_client_library",
      "NativeEngineClient", "NativeReverb", "NativeDSPContext"}),
    ("sandbox/viewer.py", "sandbox/viewer.py", {"__all__", "_box", "_db",
                                                "_make_handler", "_PAGE"}),
    ("sandbox/sweep.py", "sandbox/sweep.py", {"__all__", "SweepResult"}),
    ("sandbox/cli.py", "sandbox/cli.py",
     {"__all__", "_load_scene", "_xy", "_config", "_db", "_print_params",
      "ascii_plot", "cmd_analyze", "cmd_grid", "cmd_scenes"}),
]


# the one deliberate difference inside a pinned definition, as (old, new)
# in its AST dump: the port loads the native DSP library with ctypes.PyDLL,
# whose calls keep the interpreter lock (an audio callback beside the
# refresh loop would otherwise queue for the lock after each of its calls)
_PORT_EDITS = {("native/__init__.py", "load_library"): ("attr='PyDLL'",
                                                       "attr='CDLL'")}


@pytest.mark.parametrize("orig,copy,names", _COPIES,
                         ids=[c[1] for c in _COPIES])
def test_copies_equal_their_originals(orig, copy, names):
    """Each copied module (or the copied part of a ported one) has its
    original's code, up to the import lines and docstrings and the edits
    of ``_PORT_EDITS``."""
    want = _defs(os.path.join("planeverb_tpu", orig), names)
    got = _defs(os.path.join("planeverb_tpu_torch", copy), names)
    if names is not None:
        assert set(want) == set(names), sorted(names - set(want))
    for (path, name), (new, old) in _PORT_EDITS.items():
        if path == copy:
            assert got[name].count(new) == 1, name
            got[name] = got[name].replace(new, old)
    assert got == want


def test_audio_path_imports_without_jax():
    """The DSP, the api facade, sessions and the audio-frame loops import
    and run a block on the CPU with jax and planeverb_tpu blocked."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["planeverb_tpu"] = None
        import numpy as np
        import torch
        import planeverb_tpu_torch as pv
        from planeverb_tpu_torch import api, dsp, session
        from planeverb_tpu_torch.dsp.reverb import mix_output
        from planeverb_tpu_torch.sandbox import audio_manager, realtime, wav
        state = dsp.init_state(2, device="cpu")
        target = state.current._replace(
            direction=torch.tensor([[1.0, 0.0], [0.0, 1.0]]))
        buses, _ = dsp.render_block(pv.PlaneverbDSPConfig(), torch.ones(
            2, 64, 2), target, state, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
        mix, states = mix_output(*buses, 44100, device="cpu")
        assert mix.shape == (64, 2) and len(states) == 3
        assert "jax" not in [k for k, v in sys.modules.items() if v]
        print(sorted(dsp.__all__))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "render_block" in proc.stdout


def _methods(path, cls, skip):
    """{method: ast dump} of class ``cls`` in a module, imports and
    docstrings dropped, the methods named in ``skip`` left out."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = _Strip().visit(ast.parse(f.read()))
    [node] = [n for n in tree.body
              if isinstance(n, ast.ClassDef) and n.name == cls]
    return {m.name: ast.dump(m) for m in node.body
            if isinstance(m, ast.FunctionDef) and m.name not in skip}


@pytest.mark.parametrize("path,cls,skip", [
    ("server.py", "EngineServer", {"__init__", "_init"}),
    ("sandbox/viewer.py", "ViewerServer", {"__init__"})])
def test_front_end_methods_equal_their_originals(path, cls, skip):
    """The server's and the viewer's methods are the JAX package's, but
    the constructors (a device) and the server's init (its Context on the
    server's device, ``parallel.mesh_for`` that device)."""
    want = _methods(os.path.join("planeverb_tpu", path), cls, skip)
    got = _methods(os.path.join("planeverb_tpu_torch", path), cls, skip)
    assert got == want


class _NoDevice(_Strip):
    """_Strip, and the ``device`` parameter and keyword dropped."""

    def visit_arguments(self, node):
        keep = [(a, d) for a, d in zip(node.args[-len(node.defaults):],
                                       node.defaults) if a.arg != "device"]
        node.args = node.args[:len(node.args) - len(node.defaults)] + \
            [a for a, _ in keep]
        node.defaults = [d for _, d in keep]
        return node

    def visit_keyword(self, node):
        return None if node.arg == "device" else node


def test_door_sweep_equals_its_original():
    """door_sweep is the JAX package's up to its device argument."""
    dumps = []
    for pkg in ("planeverb_tpu", "planeverb_tpu_torch"):
        with open(os.path.join(_ROOT, pkg, "sandbox", "sweep.py")) as f:
            tree = _NoDevice().visit(ast.parse(f.read()))
        [fn] = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "door_sweep"]
        dumps.append(ast.dump(fn))
    assert dumps[0] == dumps[1]


_CXX_TOKENS = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'|\w+|\S',
    re.S)


def _cxx_code(path):
    """A C++ source's tokens with the comments dropped (string and char
    literals kept whole)."""
    with open(os.path.join(_ROOT, path)) as f:
        src = f.read()
    return " ".join(t for t in _CXX_TOKENS.findall(src)
                    if not t.startswith(("//", "/*")))


@pytest.mark.parametrize("name", ["pv_dsp.cpp", "pv_engine_client.cpp"])
def test_native_sources_equal_their_originals(name):
    """The port's C++ sources are the JAX package's up to comments (and
    whitespace), so one compiler and one set of flags build the same
    code."""
    src = os.path.join("native", "src", name)
    want = _cxx_code(os.path.join("planeverb_tpu", src))
    got = _cxx_code(os.path.join("planeverb_tpu_torch", src))
    assert len(want) > 1000 and got == want


def test_front_ends_run_on_the_cpu_without_torch_cuda(tmp_path):
    """With jax and planeverb_tpu blocked and every torch.cuda entry point
    raising, the new modules run on device="cpu": a server session through
    the C ABI client, the CLI (analyze, batch, render --mix with and
    without --native), the door sweep, the viewer and the native player."""
    code = textwrap.dedent("""
        import sys, tempfile, os
        sys.modules["jax"] = None
        sys.modules["planeverb_tpu"] = None
        import numpy as np
        import torch

        def refuse(*a, **kw):
            raise AssertionError("a CPU path touched torch.cuda")

        for name in ("is_available", "device_count", "current_device",
                     "Stream", "stream", "synchronize", "current_stream",
                     "device", "Event", "set_device"):
            setattr(torch.cuda, name, refuse)
        import planeverb_tpu_torch as pv
        from planeverb_tpu_torch.native import NativeEngineClient
        from planeverb_tpu_torch.sandbox.cli import main
        from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer
        from planeverb_tpu_torch.sandbox.sweep import door_sweep
        from planeverb_tpu_torch.sandbox.viewer import ViewerServer
        from planeverb_tpu_torch.sandbox.wav import write_wav
        from planeverb_tpu_torch.server import EngineServer

        srv = EngineServer(port=0, device="cpu")
        srv.start_background()
        c = NativeEngineClient(*srv.address)
        assert c.init(8.0, 8.0, resolution=275, background=False) > 0
        c.set_listener_position(4.0, 0.0, 4.0)
        eid = c.emit(5.0, 0.0, 4.0)
        assert c.step() == 1 and c.get_outputs([eid])[0] is not None
        c.close()
        srv.shutdown()
        low = ["--resolution", "275", "--engine-device", "cpu"]
        assert main(["analyze", "SmallRoom", "--source", "6,5"] + low) == 0
        assert main(["batch", "SmallRoom", "--listener", "5,5",
                     "--source", "6,5"] + low) == 0
        d = tempfile.mkdtemp(dir=sys.argv[1])
        wav = os.path.join(d, "in.wav")
        write_wav(wav, np.ones((600, 2), np.float32) * 0.1, 44100)
        for extra in ([], ["--native"]):
            assert main(["render", "SmallRoom", "--source", "6,5", "--in",
                         wav, "--out-dir", d, "--mix"] + low + extra) == 0
        assert door_sweep(pv.PlaneverbConfig(10.0, 10.0, 275), steps=2,
                          device="cpu").dry_gain.shape == (2,)
        v = ViewerServer(pv.PlaneverbConfig(8.0, 8.0, 275), port=0,
                         background=False, device="cpu")
        v.command({"cmd": "step"})
        assert v.state()["iteration"] == 1
        ctx = v.ctx
        e = ctx.emissions.emit(5.0, 0.0, 4.0)
        p = RealtimePlayer(ctx, e, np.ones(1024, np.float32), 44100)
        assert p.run(realtime=False).blocks == 2
        p.close()
        assert "jax" not in [k for k, v in sys.modules.items() if v]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=_ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
