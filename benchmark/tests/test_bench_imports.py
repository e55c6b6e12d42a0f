"""No module under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port. Names compare whole at their top
level, so ``planeverb_tpu_torch`` is not ``planeverb_tpu``."""

import ast
import os
import sys
import types

import pytest

from benchmark import cells, run

FORBIDDEN = {"jax", "jaxlib", "flax", "planeverb_tpu"}
# the yardstick: what decides correct, and the traffic and counts
YARDSTICK = ("reference.py", "check.py", "roofline.py", "traffic.py",
             "scenes.py")


def _sources():
    for d, _, files in os.walk(cells.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_port():
    for name in YARDSTICK:
        got = set(_imports(os.path.join(cells.HERE, name)))
        assert "planeverb_tpu_torch" not in got, name


def test_the_spans_name_only_the_port():
    for m in cells.load(os.path.dirname(cells.HERE))["per_layer"]:
        for targets in cells.metric_module(m["name"]).SPANS.values():
            for t in targets:
                assert t.split(".")[0] == "planeverb_tpu_torch"


@pytest.mark.parametrize("name,found", [("planeverb_tpu_torch.x", []),
                                        ("planeverb_tpu.config",
                                         ["planeverb_tpu"]),
                                        ("jax.numpy", ["jax"])])
def test_the_run_time_check_compares_whole_names(name, found, monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == found
