"""Multi-process meshes of the port (planeverb_tpu_torch.parallel.multihost).

The JAX package's four layout tests and its single-process no-op, on
``(process, device)`` pairs; then a real two-process run: two OS processes
join a gloo process group on 127.0.0.1, each names two ``"cpu"`` positions
of a 2x2 ``multihost_grid_mesh`` (rows grouped by process, so x crosses
the process boundary and so do the diagonal neighbours the round kernel's
3 x 3 source table reads), and runs on the whole padded fields it holds:

  - ``simulate_sharded_wide`` (halo 2) and ``simulate_sharded``;
  - ``simulate_sharded_fused`` through B5's plain rounds (halo 2) and B6's
    (``band_rows=4``), moments included;
  - the overlap split on a (4, 1) mesh of the two processes;
  - a ``Context`` on the 2x2 mesh, stepped once.

Each worker assembles every result (each block broadcast from its owner)
and prints SHA-256 digests of its bytes and three fingerprints (the JAX
worker's, tests/multihost_worker.py), and a digest of the Context's
published grids. The parent requires the digests to equal those of the
same passes and Context on a single-process ``["cpu"] * 4`` mesh (bit for
bit) and the fingerprints to lie within 1e-5 (scale-relative) of the JAX
package's single-device ``fdtd.simulate``. This file is its own
worker: ``python tests/test_torch_multihost.py <port> <rank>``.
"""

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import planeverb_tpu_torch as tpv
from planeverb_tpu_torch import config as tcfg
from planeverb_tpu_torch.ops import voxelize as tvox
from planeverb_tpu_torch.parallel import (grid_mesh, init_distributed,
                                          layout_by_process,
                                          multihost_grid_mesh, pad_to_mesh,
                                          simulate_moments_sharded,
                                          simulate_sharded,
                                          simulate_sharded_fused,
                                          simulate_sharded_wide)
from planeverb_tpu_torch.parallel.mesh import factor_mesh

WORKER_TIMEOUT_S = 120
LISTENER = (3.0, 3.0)


def _case():
    """SmallRoom at 6 m and 275 Hz, 48 steps (the JAX worker's case)."""
    p = dataclasses.replace(
        tcfg.compute_grid_params(tcfg.PlaneverbConfig(6.0, 6.0, 275)),
        response_length=48)
    beta, refl = tvox.voxelize_np(p, tpv.demo_scene("SmallRoom").boxes)
    pulse = tcfg.gaussian_pulse(p)[:p.response_length]
    return p, beta, refl, pulse, p.world_to_cell(*LISTENER)


def _fingerprint(pr):
    """The JAX worker's three fingerprints of a [T, nx, ny] recording."""
    pr = np.asarray(pr, np.float32)
    t, nx, ny = pr.shape
    wt = np.cos(np.arange(t, dtype=np.float32) * 0.37)[:, None, None]
    wx = np.sin(1.0 + np.arange(nx, dtype=np.float32) * 0.11)[None, :, None]
    wy = np.cos(np.arange(ny, dtype=np.float32) * 0.23)[None, None, :]
    return [float(np.sum(pr * wt * wx * wy, dtype=np.float64)),
            float(np.abs(pr).sum(dtype=np.float64)), float(np.abs(pr).max())]


def _digest(fields, p) -> str:
    h = hashlib.sha256()
    for name in fields._fields:
        h.update(getattr(fields, name)[..., :p.nx, :p.ny].contiguous()
                 .numpy().tobytes())
    return h.hexdigest()


def _context_digest(mesh) -> str:
    """SHA-256 of the grids a Context on ``mesh`` publishes after a step
    (SmallRoom at 6 m and 275 Hz, the listener of the passes)."""
    ctx = tpv.Context(tpv.PlaneverbConfig(6.0, 6.0, 275),
                      scene=tpv.demo_scene("SmallRoom"), mesh=mesh)
    ctx.set_listener_position(LISTENER[0], 0.0, LISTENER[1])
    ctx.step()
    h = hashlib.sha256()
    for key in sorted(ctx._published.keys() - {"listener", "pressure"}):
        h.update(np.ascontiguousarray(ctx._published[key]).tobytes())
    return h.hexdigest()


def _passes(mesh, mesh41) -> dict:
    """Every pass of the two-process run on ``mesh`` (2x2) and ``mesh41``
    (4x1): {name: (digest, fingerprints)}."""
    p, beta, refl, pulse, (lix, liy) = _case()
    out = {}

    def padded(m, multiple=1):
        nxp, nyp = pad_to_mesh(p.nx, p.ny, m, multiple)
        pad = (0, nyp - p.ny, 0, nxp - p.nx)
        return (torch.nn.functional.pad(torch.from_numpy(beta), pad),
                torch.nn.functional.pad(torch.from_numpy(refl), pad),
                torch.from_numpy(pulse), lix, liy, m, nxp, nyp)

    def record(name, sharded, extra=None):
        res = sharded.assemble("cpu")
        digest = _digest(res, p)
        if extra is not None:
            digest += _digest(extra.assemble("cpu"), p)
        out[name] = (digest, _fingerprint(res.pressure[:, :p.nx, :p.ny]))

    args = padded(mesh)
    record("wide", simulate_sharded_wide(p, *args, halo=2))
    record("step", simulate_sharded(p, *args))
    record("B5", *simulate_moments_sharded(p, *args, halo=2))
    record("B6", *simulate_moments_sharded(p, *args, halo=2, band_rows=4))
    args41 = padded(mesh41, 2)      # 6-row shards: the split's 3 * halo
    record("B5 split", simulate_sharded_fused(p, *args41, halo=2,
                                              overlap=True))
    record("B6 split", simulate_sharded_fused(p, *args41, halo=2,
                                              band_rows=4, overlap=True))
    return out


def _worker(port: str, rank: int) -> int:
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                     backend="gloo")
    mesh = multihost_grid_mesh(local_devices=["cpu", "cpu"])
    mesh41 = multihost_grid_mesh((4, 1), local_devices=["cpu", "cpu"])
    assert mesh.ranks == [[0, 0], [1, 1]], mesh.ranks
    assert mesh41.ranks == [[0], [0], [1], [1]], mesh41.ranks
    assert mesh.multi_process and mesh.is_local(rank, 0)
    res = _passes(mesh, mesh41)
    # a block of the other process cannot be read in place
    p, beta, refl, pulse, (lix, liy) = _case()
    nxp, nyp = pad_to_mesh(p.nx, p.ny, mesh)
    pad = (0, nyp - p.ny, 0, nxp - p.nx)
    sh = simulate_sharded_fused(
        p, torch.nn.functional.pad(torch.from_numpy(beta), pad),
        torch.nn.functional.pad(torch.from_numpy(refl), pad),
        torch.from_numpy(pulse), lix, liy, mesh, nxp, nyp, halo=2)
    bx = nxp // 2
    sh.at("onset", rank * bx, 0)
    try:
        sh.at("onset", (1 - rank) * bx, 0)
        raise AssertionError("Sharded.at read another process's block")
    except ValueError:
        pass
    # a Context steps on the multi-process mesh
    context = _context_digest(mesh)
    print("RESULT " + json.dumps({"rank": rank, "passes": res,
                                  "context": context}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


# ------------------------------------------------------------------ layout
def test_layout_single_process_matches_factorization():
    mesh = layout_by_process([(0, "cpu")] * 8)
    assert (mesh.shape["x"], mesh.shape["y"]) == factor_mesh(8)
    assert not mesh.multi_process


def test_layout_groups_process_rows_contiguously():
    # 4 processes x 4 devices: y-neighbours must be of one process
    devs = [(p, "cpu") for p in range(4) for _ in range(4)]
    mesh = layout_by_process(devs)
    assert (mesh.shape["x"], mesh.shape["y"]) == (8, 2)
    for row in mesh.ranks:
        assert len(set(row)) == 1
    # x rows grouped: the process changes at most once between adjacent rows
    pids = [row[0] for row in mesh.ranks]
    assert pids == sorted(pids)


def test_layout_rejects_dcn_crossing_y():
    devs = [(p, "cpu") for p in range(2) for _ in range(2)]
    with pytest.raises(ValueError, match="DCN"):
        layout_by_process(devs, shape=(1, 4))


def test_layout_rejects_uneven_processes():
    devs = [(0, "cpu"), (0, "cpu"), (1, "cpu")]
    with pytest.raises(ValueError, match="uneven"):
        layout_by_process(devs)


def test_init_distributed_single_process_noop():
    init_distributed(num_processes=1)   # must not raise or init anything
    assert not torch.distributed.is_initialized()
    # outside a group the multihost mesh is the calling process's own
    mesh = multihost_grid_mesh(local_devices=["cpu"] * 4)
    assert mesh.shape == {"x": 2, "y": 2} and not mesh.multi_process


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: NCCL would initialise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("127.0.0.1:1", num_processes=2, process_id=0,
                         backend="nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_grid_mesh()


@pytest.mark.parametrize("kx,ky", [(0, 2), (2, 0), (3, 3)])
def test_extended_blocks_equal_the_exchange(kx, ky):
    """The extended blocks a process cuts from the whole field equal the
    exchange's, corners and zero edges included."""
    from planeverb_tpu_torch.parallel import shard_fields, solver

    mesh = grid_mesh(["cpu"] * 4, (2, 2))
    field = torch.arange(20 * 12, dtype=torch.float32).reshape(20, 12) + 1
    want = solver._exchange_axes(shard_fields(mesh, field)[0], kx, ky)
    got = solver.extended_blocks(mesh, field, kx, ky)
    assert all(torch.equal(g, w) for grow, wrow in zip(got, want)
               for g, w in zip(grow, wrow))


def test_mesh_positions_of_another_process():
    """A mesh with positions of another process (no group needed to build
    one): the calling rank 0 holds blocks of its own positions only, and
    the static fields must come whole."""
    from planeverb_tpu_torch.parallel import Mesh, shard_fields, solver

    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ranks=[[0, 0], [1, 1]])
    assert mesh.multi_process and mesh.is_local(0, 1)
    assert not mesh.is_local(1, 0) and mesh.local_device.type == "cpu"
    field = torch.ones(4, 4)
    (blocks,) = shard_fields(mesh, field)
    assert blocks[1] == [None, None] and blocks[0][0].shape == (2, 2)
    ext = solver.extended_blocks(mesh, field, 1, 1)
    assert ext[1] == [None, None] and ext[0][1].shape == (4, 4)
    p, beta, refl, pulse, (lix, liy) = _case()
    grid = [[torch.zeros(9, 9)] * 2] * 2
    with pytest.raises(ValueError, match="whole padded field"):
        simulate_sharded(p, grid, grid, torch.from_numpy(pulse), lix, liy,
                         mesh, 18, 18)
    with pytest.raises(ValueError, match="ranks"):
        Mesh([["cpu", "cpu"]], ranks=[[0]])


# -------------------------------------------------------- two processes
def test_two_processes_bit_equal_to_single_process():
    import jax.numpy as jnp
    from planeverb_tpu.ops import fdtd as jfdtd

    with socket.socket() as s:   # a free port on 127.0.0.1 for the store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out
    got = [json.loads(next(line for line in out.splitlines()
                           if line.startswith("RESULT "))[7:])
           for out in outs]

    # the same passes on a single-process mesh of four CPU positions
    want = _passes(grid_mesh(["cpu"] * 4, (2, 2)),
                   grid_mesh(["cpu"] * 4, (4, 1)))
    p, beta, refl, pulse, (lix, liy) = _case()
    ref = jfdtd.simulate(p, jnp.asarray(beta), jnp.asarray(refl),
                         jnp.asarray(pulse), lix, liy)
    jax_fp = _fingerprint(np.asarray(ref.pressure))
    context = _context_digest(grid_mesh(["cpu"] * 4, (2, 2)))
    for g in got:
        assert g["context"] == context, g["rank"]
        assert set(g["passes"]) == set(want)
        for name, (digest, fp) in g["passes"].items():
            assert digest == want[name][0], (g["rank"], name)
            for a, b in zip(fp, jax_fp):
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (name, fp,
                                                               jax_fp)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
