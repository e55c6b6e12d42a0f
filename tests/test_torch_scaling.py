"""The port's scaling harness, pass timing, traces and the CLI's ``scale``.

``parallel/scaling.py::measure_scaling`` on meshes of ``"cpu"`` repeated
(the counterpart of the JAX tests' 8 virtual devices) with the JAX
package's row, backend, overlap, weak-mode and error cases
(tests/test_parallel.py), ``"pallas"`` read as ``"fused"``; its rows
carry the JAX harness's keys (``ROW_KEYS``). Times from these runs are
the host's and say nothing of a card. Then ``utils/profiling.py``
(``time_passes_stats``' keys, a ``device_trace`` written on the CPU) and
``python -m planeverb_tpu_torch scale``. Last, the projection model
(``projected_efficiency`` / ``projected_weak_efficiency``) against the JAX
module's with its constants monkeypatched, inside the test only, to the
port's H100 values and its TPU lane padding (``_lanes``) to the port's
unpadded cell count: the rows must come out equal; and ``scale
--project``'s rows.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import oracle
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.ops import voxelize as tvox
from planeverb_tpu_torch.parallel import scaling
from planeverb_tpu_torch.parallel.scaling import measure_scaling
from planeverb_tpu_torch.sandbox.cli import PROJECT_COUNTS
from planeverb_tpu_torch.sandbox.cli import main as cli_main
from planeverb_tpu_torch.utils import profiling

CPUS = ["cpu"] * 8
ROW_KEYS = {"devices", "solver", "mode", "overlap", "mesh", "grid", "halo",
            "wall_s", "cell_updates_per_s", "efficiency_vs_1"}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def room6():
    """An empty 6 m world at 275 Hz, listener at its center."""
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(6.0, 6.0, 275))
    beta, refl = tvox.voxelize_np(p, [])
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(3.0, 3.0)
    return p, beta, refl, pulse, lix, liy


def test_scaling_harness_rows(room6):
    rows = measure_scaling(*room6, device_counts=[1, 2], halo=4, reps=1,
                           devices=CPUS)
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency_vs_1"] == 1.0
    assert all(r["wall_s"] > 0 and r["cell_updates_per_s"] > 0
               for r in rows)
    assert all(set(r) == ROW_KEYS for r in rows)
    assert [r["mesh"] for r in rows] == [[1, 1], [1, 2]]
    assert rows[0]["solver"] == "wide" and rows[0]["mode"] == "strong"


def test_scaling_harness_fused_backend(room6):
    rows = measure_scaling(*room6, device_counts=[2], halo=4, reps=1,
                           chain=2, solver="fused", devices=CPUS)
    assert rows[0]["solver"] == "fused" and rows[0]["wall_s"] > 0
    with pytest.raises(ValueError, match="solver"):
        measure_scaling(*room6, device_counts=[1], solver="pallas",
                        devices=CPUS)
    # overlap sweep: 1D (n, 1) meshes, halo clamped to bx >= 3k
    orows = measure_scaling(*room6, device_counts=[2], halo=4, reps=1,
                            chain=2, solver="fused", overlap=True,
                            devices=CPUS)
    assert orows[0]["overlap"] and orows[0]["mesh"] == [2, 1]
    assert orows[0]["halo"] * 3 <= 9   # bx of the (2, 1) mesh
    with pytest.raises(ValueError, match="fused"):
        measure_scaling(*room6, device_counts=[1], solver="wide",
                        overlap=True, devices=CPUS)


def test_measure_scaling_weak_mode(room6):
    """mode='weak' grows the world with the device count, holding the
    per-device block and T fixed."""
    p = room6[0]
    rows = measure_scaling(*room6, device_counts=[1, 4], halo=2, reps=1,
                           chain=2, solver="wide", mode="weak", devices=CPUS)
    assert rows[0]["mode"] == "weak"
    assert rows[0]["grid"] == [p.nx, p.ny]
    g1, m1 = rows[1]["grid"], rows[1]["mesh"]
    # the grid grew with the mesh (per-device block ~ the base grid)
    assert g1[0] >= p.nx * m1[0] - 2 and g1[1] >= p.ny * m1[1] - 2
    assert rows[1]["efficiency_vs_1"] > 0
    with pytest.raises(ValueError, match="mode"):
        measure_scaling(*room6, device_counts=[1], mode="nope", devices=CPUS)


def test_measure_scaling_without_a_card_raises(room6):
    """The default devices are the CUDA devices: without a card the sweep
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default sweep would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_scaling(*room6, device_counts=[1])


def test_time_passes_stats_keys():
    calls = []
    stats = profiling.time_passes_stats(lambda: calls.append(1), n=3,
                                        reps=2, devices=["cpu"])
    assert set(stats) == {"min_s", "median_s", "max_s", "reps", "chain"}
    assert (stats["reps"], stats["chain"]) == (2, 3) and len(calls) == 6
    assert 0 <= stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    assert profiling.time_passes(lambda: None, n=2, reps=1,
                                 devices=["cpu"]) >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.time_passes(lambda: None)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    path = tmp_path / "trace" / "trace.json"
    trace = json.loads(path.read_text())
    assert "traceEvents" in trace
    assert any("mm" in e.key for e in prof.key_averages())


def test_cli_scale_on_the_cpu(capsys):
    rc = cli_main(["scale", "SmallRoom", "--grid-size", "6", "--resolution",
                   "275", "--listener", "3,3", "--engine-device", "cpu",
                   "--reps", "1", "--chain", "1", "--halo", "4", "--solver",
                   "fused"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["solver"] == "fused" and set(r) == ROW_KEYS for r in rows)


def test_cli_scale_rejects_overlap_without_fused(capsys):
    rc = cli_main(["scale", "SmallRoom", "--overlap", "--engine-device",
                   "cpu"])
    assert rc == 2
    assert "--overlap needs --solver fused" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--project"], ["--rate-ext", "50"],
                                  ["--round-overhead-us", "2"]])
def test_cli_scale_rejects_the_projection_flags(flag):
    """The JAX CLI's projection flags are ported with the H100's
    defaults: ``scale --project`` with each flag, as a subprocess sees it,
    prints the model's rows for those constants (no card needed)."""
    proc = subprocess.run(
        [sys.executable, "-m", "planeverb_tpu_torch", "scale", "SmallRoom",
         "--grid-size", "10", "--resolution", "500", "--project", *flag],
        cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(10.0, 10.0, 500))
    rate = 50e9 if "--rate-ext" in flag else scaling.ROUND_RATE_CUPS
    c = 2e-6 if "--round-overhead-us" in flag else scaling.ROUND_OVERHEAD_S
    assert rows == json.loads(json.dumps(scaling.projected_efficiency(
        p.nx, p.ny, PROJECT_COUNTS, rate_ext_cups=rate,
        round_overhead_s=c)))


# ------------------------------------------------------ the projection model
# the JAX module's constants and the port's that take their place
_PORT_CONSTANTS = {"V5E_ICI_GBPS": "NVLINK_GBPS", "V5E_DCN_GBPS": "NIC_GBPS",
                   "ICI_LATENCY_S": "NVLINK_LATENCY_S",
                   "DCN_LATENCY_S": "NIC_LATENCY_S"}
# (function, grid or block, device counts, keyword arguments)
PROJECTIONS = [
    ("projected_efficiency", (192, 192), [1, 2, 4, 8], {}),
    ("projected_efficiency", (964, 964), [1, 2, 4, 8, 16, 32, 64], {}),
    ("projected_efficiency", (1920, 1920), [1, 8, 16, 64], {}),
    ("projected_efficiency", (964, 964), [2, 4, 8, 16, 64],
     {"overlap": True}),
    ("projected_efficiency", (459, 301), [4, 8, 12, 16],
     {"chips_per_host": 4, "halos": (2, 6, 16)}),
    ("projected_weak_efficiency", (480, 512), [1, 16, 32, 64],
     {"overlap": True}),
    ("projected_weak_efficiency", (192, 192), [1, 2, 4, 8, 16], {}),
]


@pytest.fixture
def jax_model(monkeypatch):
    """The JAX projection model with the port's constants and cell count,
    patched for this test only."""
    from planeverb_tpu.parallel import scaling as jscaling

    for jname, pname in _PORT_CONSTANTS.items():
        monkeypatch.setattr(jscaling, jname, getattr(scaling, pname))
    monkeypatch.setattr(jscaling, "_lanes", lambda n: n)
    return jscaling


@pytest.mark.parametrize("fn,grid,counts,kw", PROJECTIONS,
                         ids=[f"{c[0][10:]}-{c[1][0]}x{c[1][1]}-{i}"
                              for i, c in enumerate(PROJECTIONS)])
def test_projection_rows_equal_the_jax_model(jax_model, fn, grid, counts,
                                             kw):
    kw = dict(kw, round_overhead_s=scaling.ROUND_OVERHEAD_S)
    port = getattr(scaling, fn)(*grid, counts, scaling.ROUND_RATE_CUPS, **kw)
    want = getattr(jax_model, fn)(*grid, counts, scaling.ROUND_RATE_CUPS,
                                  **kw)
    assert port == want and port
    # the defaults are the H100 fit
    assert getattr(scaling, fn)(*grid, counts, **kw) == port


def test_projection_model_shape():
    """The JAX model's structural checks on the port's constants: one card
    is the reference, strong efficiency decays with N, rows inside a host
    pay NVLink and cross-host rows the NIC, the split's rows carry its
    derivation, weak rows grow the world."""
    rows = scaling.projected_efficiency(964, 964, [1, 2, 4, 8, 16, 64])
    by_n = {r["devices"]: r for r in rows}
    assert by_n[1]["efficiency"] == 1.0 and by_n[1]["mesh"] == [1, 1]
    assert by_n[1]["t_comm_round_us"] == 0.0
    effs = [by_n[n]["efficiency"] for n in sorted(by_n)]
    assert effs == sorted(effs, reverse=True)
    assert [by_n[n]["hosts"] for n in (8, 16, 64)] == [1, 2, 8]
    tx, _ = scaling._axis_comm(2, 1, 16, 482, 964, 8)
    slab = 3 * 16 * 964 * 4
    assert tx == slab / (scaling.NVLINK_GBPS * 1e9) + scaling.NVLINK_LATENCY_S
    tx, _ = scaling._axis_comm(16, 1, 16, 61, 964, 8)
    assert tx == slab / (scaling.NIC_GBPS * 1e9) + scaling.NIC_LATENCY_S
    split = scaling.projected_efficiency(964, 964, [4, 8], overlap=True)
    for r in split:
        assert r["mesh"][1] == 1 and "comm_hidden" in r
        if r["comm_hidden"]:
            assert r["t_comm_round_us"] == 0.0
    weak = scaling.projected_weak_efficiency(192, 192, [1, 4])
    assert weak[0]["efficiency"] == 1.0
    assert weak[1]["global_grid"][0] * weak[1]["global_grid"][1] \
        == 4 * 192 * 192


def test_cli_scale_project_rows(capsys):
    """``scale --project`` (and ``--weak --overlap``) print the model's
    rows for PROJECT_COUNTS with the H100's constants."""
    p = tcfg.compute_grid_params(tcfg.PlaneverbConfig(25.0, 25.0, 750))
    for flags, fn in (([], scaling.projected_efficiency),
                      (["--weak", "--overlap"],
                       scaling.projected_weak_efficiency)):
        assert cli_main(["scale", "HugeRoom", "--project", "--grid-size",
                         "25", "--resolution", "750", *flags]) == 0
        rows = [json.loads(line)
                for line in capsys.readouterr().out.splitlines()]
        want = fn(p.nx, p.ny, PROJECT_COUNTS, overlap=bool(flags))
        assert rows == json.loads(json.dumps(want))
        assert [r["devices"] for r in rows] == list(PROJECT_COUNTS)
