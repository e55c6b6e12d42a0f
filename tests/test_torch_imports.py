"""The port imports without JAX, and its copied modules equal their originals.

planeverb_tpu_torch carries copies of the NumPy/stdlib modules it needs
(config, scene) because importing any planeverb_tpu submodule imports jax
(planeverb_tpu/__init__.py imports the Context eagerly). These tests pin
each copy to its original.
"""

import dataclasses
import os
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
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 16


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
