"""The plain reference agrees with the port's CPU path, bit for bit, and
its bf16 control does not."""

import numpy as np
import pytest
import torch

import standin
from benchmark import check, reference, scenes, traffic

pv = pytest.importorskip("planeverb_tpu_torch")


def _setup(traffic_name, seed=11):
    cfg = standin.config()
    cell = standin.cell(traffic_name)
    p = cell.reference_params()
    g = reference.grid(p["world_x"], p["world_y"], p["resolution"])
    t = traffic.make(g, scenes.load(cfg["scene"]), cell.traffic, seed)
    return cell, p, t


@pytest.mark.parametrize("traffic_name,publish", [
    ("walk", "grids"), ("walk", "cells"), ("split4", "grids"),
    ("split4", "cells"), ("door", "grids")])
def test_reference_equals_the_cpu_path(traffic_name, publish):
    from benchmark import drive

    cell, p, t = _setup(traffic_name)
    cfg = standin.config(publish)
    prog = drive.Program(cfg, t, "cpu")
    ref = reference.Reference(p, "cpu")
    assert ref.efree == prog.ctx.efree
    for i in (0, 7):
        outs = prog.refresh(t.listeners(i), t.door(i))
        sample = prog.sample(i, t.listeners(i), outs)
        want = ref.refresh(sample["boxes"], sample["listeners"], t.emitters,
                           keep_recording=True)
        n = check.compare(sample, want, len(t.walks))
        assert n == {"fields_gap": 0.0, "params_gap": 0.0,
                     "outputs_gap": 0.0}
        if len(t.walks) == 1:
            assert check.recording_gap(prog.ctx._published["pressure"],
                                       want["recording"][0]) == 0.0


def test_bf16_control_reads_apart():
    _, p, t = _setup("walk")
    ref = reference.Reference(p, "cpu")
    low = reference.Reference(p, "cpu", torch.bfloat16)
    boxes, lis = t.boxes_at(3), t.listeners(3)
    want = ref.refresh(boxes, lis, t.emitters, keep_recording=True)
    got = low.refresh(boxes, lis, t.emitters, keep_recording=True)
    assert got["recording"].dtype == torch.bfloat16
    assert check.recording_gap(got["recording"][0],
                               want["recording"][0]) > 1e-3
    assert check.gap(got["packed"], want["packed"]) > 1e-3


def test_gap_measure():
    a = np.array([[1.0, 2.0, 3.0, 4.0, 0.5, 0.5, 0.0, 1.0, 3e38]])
    assert check.gap(a, a) == 0.0
    b = a.copy()
    b[0, 0] = 1.001          # relative on the gains
    assert check.gap(b, a) == pytest.approx(1e-3)
    b = a.copy()
    b[0, 4] = 0.501          # absolute on the unit vectors
    assert check.gap(b, a) == pytest.approx(1e-3)
    b = a.copy()
    b[0, 2] = np.nan
    assert check.gap(b, a) == check.NONFINITE
    assert check.gap(a[:, :8], a) == check.NONFINITE
