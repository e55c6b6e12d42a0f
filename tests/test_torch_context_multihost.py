"""The port's Context on a mesh of two processes (core/context.py with a
``multihost_grid_mesh``).

Two OS processes join a gloo process group on 127.0.0.1 and each names two
``"cpu"`` positions of a (2, 2) and a (4, 1) process-grouped mesh. Each
builds the same Contexts (HugeRoom at 25 m and 275 Hz, 71 x 71 x 435) and
steps them in turn: grids publish with three emitters, impulse responses
on both processes' shards (a collective), two views, cells publish with
50 emitters (one view and two), and the overlap split on (4, 1) at halo 4;
then a listener that only rank 1 moves (both ranks must raise the same
``ValueError``, and the next agreed step runs), an error reading rank 1's
inputs (the same ``ValueError`` on both ranks) and the background loop
stopped on rank 0 alone (both loops end on the same iteration). Each
worker prints SHA-256 digests of what it published; the parent requires
them bit-equal to the same Contexts on single-process ``["cpu"] * 4``
meshes, and those within the golden tolerances of the JAX Context on a
mesh of the conftest's virtual CPU devices. This file is its own worker:
``python tests/test_torch_context_multihost.py <port> <rank>``.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import planeverb_tpu_torch as tpv
from planeverb_tpu_torch.parallel import (grid_mesh, init_distributed,
                                          multihost, multihost_grid_mesh)

WORKER_TIMEOUT_S = 120
CFG = (25.0, 25.0, 275)
SCENE = "HugeRoom"
LISTENER = (12.5, 0.0, 12.5)
EMITTERS = [(15.0, 12.5), (10.0, 9.0), (12.5, 20.0)]
# a game's per-frame poll of 50 emitters
CELL_EMITTERS = EMITTERS + [(2.0 + 2.5 * (i % 9), 3.0 + 4.0 * (i // 9))
                            for i in range(47)]
VIEWS = [LISTENER, (10.0, 0.0, 9.0)]
# impulse responses: a cell on rank 0's shard rows, one on rank 1's, and
# a probe outside the grid
IR_PROBES = [(5.0, 6.0), (20.0, 18.0), (500.0, 5.0)]
SPLIT_HALO = 4
# the background loop: steps rank 0 waits for before it calls stop()
LOOP_STEPS = 2


def _ctx(mesh, publish="grids", emitters=EMITTERS, halo=None):
    ctx = tpv.Context(tpv.PlaneverbConfig(*CFG),
                      scene=tpv.demo_scene(SCENE), mesh=mesh,
                      publish=publish, halo=halo)
    ctx.set_listener_position(*LISTENER)
    for x, z in emitters:
        ctx.emissions.emit(x, 0.0, z)
    return ctx


def _digest(ctx) -> str:
    """SHA-256 of a Context's published snapshot: every grid, or every
    cells row and the device grid."""
    pub = ctx._published
    h = hashlib.sha256()
    if "cells" in pub:
        for cell in sorted(pub["cells"]):
            h.update(repr(cell).encode())
            h.update(np.ascontiguousarray(pub["cells"][cell]).tobytes())
        h.update(pub["packed_device"].cpu().numpy().tobytes())
    for key in sorted(pub.keys() - {"listener", "listeners", "pressure",
                                    "cells", "packed_device"}):
        h.update(key.encode())
        h.update(np.ascontiguousarray(pub[key]).tobytes())
    return h.hexdigest()


def _irs(ctx) -> list:
    return [hashlib.sha256(ctx.get_impulse_response(x, z).tobytes())
            .hexdigest() for x, z in IR_PROBES]


def _scenarios(mesh22, mesh41) -> dict:
    """Every published digest of the scenarios on a (2, 2) and a (4, 1)
    mesh: {name: digest or list of digests}."""
    out = {}
    ctx = _ctx(mesh22)
    ctx.step()
    out["grids"] = _digest(ctx)
    out["ir"] = _irs(ctx)
    ctx.set_listener_positions(VIEWS)
    ctx.step()
    out["views"] = _digest(ctx)
    out["views ir"] = _irs(ctx)
    cells = _ctx(mesh22, publish="cells", emitters=CELL_EMITTERS)
    cells.step()
    out["cells"] = _digest(cells)
    cells.set_listener_positions(VIEWS)
    cells.step()
    out["cells views"] = _digest(cells)
    split = _ctx(mesh41, halo=SPLIT_HALO)
    out["split taken"] = split._overlap
    split.step()
    out["split"] = _digest(split)
    out["split ir"] = _irs(split)
    return out


def _worker(port: str, rank: int) -> int:
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                     backend="gloo")
    mesh22 = multihost_grid_mesh(local_devices=["cpu", "cpu"])
    mesh41 = multihost_grid_mesh((4, 1), local_devices=["cpu", "cpu"])
    assert mesh22.ranks == [[0, 0], [1, 1]], mesh22.ranks
    assert mesh41.ranks == [[0], [0], [1], [1]], mesh41.ranks
    out = {"rank": rank, "scenarios": _scenarios(mesh22, mesh41)}

    # a listener only rank 1 moves: both ranks refuse the step, and the
    # next agreed step runs
    ctx = _ctx(mesh22)
    if rank == 1:
        ctx.set_listener_position(13.0, 0.0, 12.5)
    try:
        ctx.step()
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["refused iteration"] = ctx.iteration
    ctx.set_listener_position(*LISTENER)
    ctx.step()
    out["after refusal"] = _digest(ctx)

    # an error reading rank 1's inputs (an emitter at NaN: its cell has no
    # index) rides the agreement: both ranks raise the same ValueError
    cells = _ctx(mesh22, publish="cells")
    if rank == 1:
        cells.emissions.emit(float("nan"), 0.0, 5.0)
    try:
        cells.step()
        out["error rides"] = None
    except ValueError as e:
        out["error rides"] = [str(e), repr(e.__cause__)]

    # the background loop, stopped on rank 0 alone
    start = ctx.iteration
    ctx.start()
    if rank == 0:
        out["loop reached"] = ctx.wait_for_iteration(start + LOOP_STEPS,
                                                     timeout=60)
        ctx.stop()
    else:
        deadline = time.monotonic() + 60
        while ctx.background_running and time.monotonic() < deadline:
            time.sleep(0.01)
        out["loop ended alone"] = not ctx.background_running
        ctx.stop()
    out["stopped at"] = ctx.iteration - start
    out["loop error"] = repr(ctx.error)
    out["after loop"] = _digest(ctx)
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _start_workers():
    with socket.socket() as s:   # a free port on 127.0.0.1 for the store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]


def _results(procs) -> list:
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert len(outs) == len(procs), "the workers timed out"
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out
    return [json.loads(next(line for line in out.splitlines()
                            if line.startswith("RESULT "))[7:])
            for out in outs]


@pytest.fixture(scope="module")
def runs():
    """(the two workers' results, the single-process meshes' digests and
    Contexts): the workers run while this process steps the references."""
    procs = _start_workers()
    try:
        mesh22 = grid_mesh(["cpu"] * 4, (2, 2))
        mesh41 = grid_mesh(["cpu"] * 4, (4, 1))
        want = _scenarios(mesh22, mesh41)
        ctx = _ctx(mesh22)
        ctx.step()
        want["after refusal"] = want["after loop"] = _digest(ctx)
        split = _ctx(mesh41, halo=SPLIT_HALO)
        split.step()
    finally:
        got = _results(procs)
    return got, want, {"grids": ctx, "split": split}


@pytest.mark.parametrize("name", ["grids", "views", "cells", "cells views",
                                  "split"])
def test_published_bit_equal_to_one_process(runs, name):
    got, want, _ = runs
    for res in got:
        assert res["scenarios"][name] == want[name], (res["rank"], name)


@pytest.mark.parametrize("name", ["ir", "views ir", "split ir"])
def test_impulse_responses_on_every_rank(runs, name):
    """Every rank returns the owner's column (a collective), equal to one
    process's; the out-of-grid probe and a snapshot of two views return
    what one process returns, with no collective."""
    got, want, _ = runs
    for res in got:
        assert res["scenarios"][name] == want[name], (res["rank"], name)
    assert len(set(want[name])) == len(IR_PROBES) or name == "views ir"


def test_split_taken_across_processes(runs):
    got, want, _ = runs
    assert want["split taken"] and all(r["scenarios"]["split taken"]
                                       for r in got)


def test_disagreeing_rank_refused_on_every_rank(runs):
    got, want, _ = runs
    refused = [r["refused"] for r in got]
    assert refused[0] is not None and refused[0] == refused[1], refused
    assert "[1]" in refused[0] and "'listeners'" in refused[0], refused[0]
    assert all(r["refused iteration"] == 0 for r in got)
    assert all(r["after refusal"] == want["after refusal"] for r in got)


def test_error_reading_inputs_rides_the_agreement(runs):
    """An error in one rank's inputs becomes the same ValueError on every
    rank, chained on the failing rank to its own error."""
    got, _, _ = runs
    (m0, cause0), (m1, cause1) = (r["error rides"] for r in got)
    assert m0 == m1 and "[1]" in m0 and "'error'" in m0, m0
    assert cause0 == "None" and "NaN" in cause1, (cause0, cause1)


def test_stop_on_one_rank_ends_every_loop(runs):
    got, want, _ = runs
    r0, r1 = got
    assert r0["loop reached"] and r1["loop ended alone"]
    assert r0["stopped at"] == r1["stopped at"] >= LOOP_STEPS + 1
    assert r0["loop error"] == r1["loop error"] == "None"
    assert r0["after loop"] == r1["after loop"] == want["after loop"]


@pytest.mark.parametrize("what", ["grids", "split"])
def test_within_golden_of_the_jax_mesh_context(runs, what):
    """The single-process Contexts the workers equal bit for bit, held to
    the JAX Context on a mesh of four virtual CPU devices."""
    import jax

    import planeverb_tpu as jpv
    from planeverb_tpu.parallel import grid_mesh as jax_grid_mesh
    from test_torch_context import _assert_golden

    shape, halo = ((2, 2), None) if what == "grids" else ((4, 1),
                                                          SPLIT_HALO)
    j = jpv.Context(jpv.PlaneverbConfig(*CFG), scene=jpv.demo_scene(SCENE),
                    mesh=jax_grid_mesh(jax.devices()[:4], shape), halo=halo)
    j.set_listener_position(*LISTENER)
    for x, z in EMITTERS:
        j.emissions.emit(x, 0.0, z)
    j.step()
    _assert_golden(runs[2][what], j)


def test_agree_outside_a_process_group():
    assert not torch.distributed.is_initialized()
    assert multihost.agree({"a": 1}) is False
    assert multihost.agree({"a": 1}, flag=True) is True
    with pytest.raises(ValueError, match="at most"):
        multihost.agree({str(i): i for i in range(multihost.AGREE_ITEMS
                                                  + 1)})


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
