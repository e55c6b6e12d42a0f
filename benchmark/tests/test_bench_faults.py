"""The comparison that decides ``correct`` fails the controls and every
fault a cell can have: a run of the stand-in cell with the timed path
broken underneath comes out not correct.

The faults: a step that returns its state unchanged (the published results
stay those of an earlier refresh), half of the views left out, and an
answer altered where the engine produces it. The cells run on one chip, so
no exchange between chips can be left out. The controls: the program's own
bf16 state mode, and the reference computed in bf16 in the program's
place.
"""

import json

import pytest
import torch

import standin
from benchmark import drive, reference, run

pv = pytest.importorskip("planeverb_tpu_torch")
from planeverb_tpu_torch.core import context as context_mod  # noqa: E402
from planeverb_tpu_torch.ops import analyzer  # noqa: E402

SEED = 2718281828459


def _line(capsys, traffic="walk", publish="grids", device="cpu",
          extra=()):
    argv = ["--workload", f"standin.{traffic}", "--seed", str(SEED),
            "--seconds", "1.0", "--trace", "0", *extra]
    assert run.main(argv, device=device,
                    cell=standin.cell(traffic, publish)) == 0
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("traffic,publish", [("walk", "grids"),
                                             ("door", "cells")])
def test_sound_run_is_correct(capsys, traffic, publish):
    assert _line(capsys, traffic, publish)["correct"] is True


@pytest.mark.parametrize("traffic,publish", [("walk", "grids"),
                                             ("door", "cells"),
                                             ("split4", "grids")])
def test_stale_step(capsys, monkeypatch, traffic, publish):
    """After the warm-up every step returns at once: the published results
    stay the last warm refresh's."""
    real = context_mod.Context.step
    calls = []

    def stale(self):
        calls.append(1)
        if len(calls) <= drive.WARM_REFRESHES:
            real(self)

    monkeypatch.setattr(context_mod.Context, "step", stale)
    line = _line(capsys, traffic, publish)
    assert line["correct"] is False
    assert line["checks"]["outputs_gap"]["value"] > \
        line["checks"]["outputs_gap"]["limit"]


def test_half_of_the_views_left_out(capsys, monkeypatch):
    """Four split-screen views, of which the engine steps two and publishes
    them twice."""
    real = context_mod.Context.set_listener_positions

    def half(self, positions):
        positions = list(positions)
        real(self, positions[:len(positions) // 2] * 2)

    monkeypatch.setattr(context_mod.Context, "set_listener_positions", half)
    line = _line(capsys, "split4")
    assert line["correct"] is False
    assert line["checks"]["params_gap"]["value"] > \
        line["checks"]["params_gap"]["limit"]


@pytest.mark.parametrize("publish", ["grids", "cells"])
def test_answer_altered_where_produced(capsys, monkeypatch, publish):
    """The assembly gets one cell's occlusion wrong: the first emitter's."""
    cell = standin.cell("walk", publish)
    p = cell.reference_params()
    g = reference.grid(p["world_x"], p["world_y"], p["resolution"])
    from benchmark import scenes, traffic
    t = traffic.make(g, scenes.load(cell.config["scene"]), cell.traffic,
                     SEED)
    i, j = g.cell(*t.emitters[0])
    real = analyzer.analyze_moments

    def altered(*a, **k):
        out = real(*a, **k)
        occ = out.occlusion.clone()
        occ[i, j] += 0.25
        return out._replace(occlusion=occ)

    monkeypatch.setattr(analyzer, "analyze_moments", altered)
    line = _line(capsys, "walk", publish)
    assert line["correct"] is False
    for k in ("params_gap", "outputs_gap"):
        assert line["checks"][k]["value"] > line["checks"][k]["limit"]


@pytest.mark.parametrize("control", ["program-bf16", "reference-bf16"])
def test_controls_fail(capsys, control):
    line = _line(capsys, "walk", "grids", extra=("--control", control))
    assert line["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("control", [None, "program-bf16", "reference-bf16"])
def test_on_the_card(capsys, card, control):
    """The stand-in on the card: the program is correct, each control
    fails."""
    extra = () if control is None else ("--control", control)
    line = _line(capsys, "walk", "grids", device=card, extra=extra)
    assert line["correct"] is (control is None)
    assert line["device"]["platform"] == "gpu"
    torch.cuda.empty_cache()
