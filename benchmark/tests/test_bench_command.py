"""The command end to end on the CPU at the 10 m, 275 Hz stand-in, and its
refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

import standin
from benchmark import run

SEED = 3141592653  # more than 32 signed bits hold


def _run(capsys, traffic="walk", publish="grids", trace=0, seconds=1.0,
         extra=()):
    argv = ["--workload", f"standin.{traffic}", "--seed", str(SEED),
            "--seconds", str(seconds), "--trace", str(trace), *extra]
    rc = run.main(argv, device="cpu", cell=standin.cell(traffic, publish))
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("traffic,publish", [("walk", "grids"),
                                             ("split4", "grids"),
                                             ("door", "cells")])
def test_prints_the_contract_line(capsys, traffic, publish):
    rc, out, err = _run(capsys, traffic, publish)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # split4's tail is per layer (refresh.ms_p95), not end to end
    wanted = {"refreshes_per_s", "device_mem_peak_gib", "setup_s"}
    if traffic != "split4":
        wanted.add("refresh_ms_p95")
    assert set(line["metrics"]) == wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {"fields_gap", "params_gap", "outputs_gap"}
    if traffic != "split4":
        names.add("recording_gap")
    assert set(line["checks"]) == names
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    # the numbers compared end standard error, each beside its limit
    tail = err.strip().splitlines()[-len(names):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_traced_line_has_the_host_metrics(capsys):
    rc, out, _ = _run(capsys, "door", "grids", trace=1)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    # the CPU has no device trace: only the host spans' metrics read
    assert set(line["metrics"]) == {"analysis.host_ms_per_refresh",
                                    "voxelize.host_ms_per_refresh",
                                    "query.host_ms_per_refresh"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


def test_traced_audio_line_reads_the_loop_and_the_callback(capsys):
    """With an audio thread beside the loop, the loop's readers read as on
    walk, the callback's reader reads, and no idle gap is the callback's."""
    lines = {}
    for traffic in ("walk", "audio"):
        rc, out, _ = _run(capsys, traffic, "grids", trace=1)
        assert rc == 0
        lines[traffic] = json.loads(out.strip().splitlines()[-1])
        assert lines[traffic]["correct"] is True
    walk, audio = (set(lines[t]["metrics"]) for t in ("walk", "audio"))
    assert walk == {"analysis.host_ms_per_refresh",
                    "query.host_ms_per_refresh"}
    assert audio == walk | {"audio.host_ms_per_block"}
    assert lines["audio"]["metrics"]["audio.host_ms_per_block"]["value"] > 0
    gaps = {n for n, _ in lines["audio"]["breakdown"]["idle_gaps"]}
    assert "host in audio" not in gaps
    assert gaps <= {f"host in {n}" for n in (
        "refresh", "inputs", "step", "query", "route", "solver",
        "analysis", "simulate+analyze", "pack", "fetch", "publish",
        "fields", "voxelize", "between refreshes")}


def test_refuses_without_a_card():
    """On a machine without a CUDA card the command prints no result and
    exits with another code than 0."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "hugeroom-25m.walk", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"],
                       cwd=standin.ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_refuses_an_unknown_workload():
    assert run.main(["--workload", "nowhere.walk", "--seed", "1",
                     "--seconds", "1", "--trace", "0"], device="cpu") == 2
