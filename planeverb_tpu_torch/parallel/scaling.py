"""Halo-exchange scaling harness of the sharded engine.

Counterpart of ``measure_scaling`` in ``planeverb_tpu/parallel/scaling.py``.
It measures the time of one simulation pass of the sharded solver on
growing device counts, in two modes:

  strong: the global grid is fixed, shards shrink —
          efficiency(n) = t(1) / (n * t(n));
  weak:   the per-device block is fixed, the world grows with the mesh —
          efficiency(n) = t(1) / t(n), ideal = a flat wall.

The mesh's devices may repeat: ``devices=["cuda:0"] * 4`` sweeps meshes of
one card (the shards share its SMs, so the rows measure the exchange's and
the rounds' overheads, not more compute), ``["cpu"] * n`` runs the plain
versions on the host (plumbing checks, not performance), and distinct cards
measure the engine across cards.

The JAX module's projection model (``projected_efficiency``,
``projected_weak_efficiency`` and its constants) is not ported: its rates,
latencies and launch overheads are figures of a TPU and its interconnect.

Usage:  python -m planeverb_tpu_torch scale HugeRoom --solver fused [--weak]
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from planeverb_tpu_torch.utils.profiling import time_passes

__all__ = ["measure_scaling"]


def measure_scaling(params, beta, refl, pulse, lix, liy,
                    device_counts=None, halo: int = 8, reps: int = 3,
                    chain: int = 5, solver: str = "wide",
                    mode: str = "strong", overlap: bool = False,
                    devices=None):
    """Scaling sweep of the sharded solver over sub-meshes of ``devices``.

    ``mode="strong"`` (default): the GLOBAL grid is fixed and shards
    shrink with the device count; efficiency(n) = t(1) / (n * t(n)).
    ``mode="weak"``: the PER-DEVICE block is fixed at the given params'
    grid and the world grows with the mesh; efficiency(n) = t(1) / t(n).
    Weak rows run an empty world at the base response length (geometry
    never changes the solver's per-cell cost, and a fixed T keeps
    per-device work identical across sizes).

    ``solver`` picks the backend: "wide" = the per-step solver with k-step
    halo widening (``parallel/solver.py::simulate_sharded_wide``, plain
    torch), "fused" = the rounds of B5/B6 between ghost exchanges
    (``simulate_sharded_fused``, the JAX module's "pallas"). ``overlap=True``
    (fused only) runs the overlap split of the rounds on 1D ("x", N) meshes:
    the sweep then uses (n, 1) meshes and clamps the halo so shards satisfy
    the split's bx >= 3 * halo. The JAX module's clamp of the halo to a
    multiple of 16 above 16 is not carried: the port's round kernel runs any
    halo as sub-rounds of ``ops/fdtd_tiled.HALO`` steps.

    ``devices``: the devices the sweep's meshes take, in order (default:
    every CUDA device; raises where there is none). ``device_counts``
    defaults to the powers of two up to their number.

    Each row's pass is run once to warm up (kernel builds, launch tables),
    then timed with ``utils.profiling.time_passes`` over ``reps`` reps of
    ``chain`` passes (CUDA events on one card, ``synchronize`` and the host
    clock across cards, the host clock on the CPU).

    Returns a list of row dicts: {devices, solver, mode, overlap, mesh,
    grid, halo, wall_s, cell_updates_per_s, efficiency_vs_1}.
    """
    from planeverb_tpu_torch.config import (PlaneverbConfig,
                                            compute_grid_params)
    from planeverb_tpu_torch.ops import voxelize
    from planeverb_tpu_torch.parallel.mesh import (factor_mesh, grid_mesh,
                                                   pad_to_mesh)
    from planeverb_tpu_torch.parallel.solver import simulate_sharded_wide
    from planeverb_tpu_torch.parallel.solver_fused import (
        simulate_sharded_fused)

    if solver not in ("wide", "fused"):
        raise ValueError(f"unknown solver {solver!r}")
    if mode not in ("strong", "weak"):
        raise ValueError(f"unknown mode {mode!r}")
    if overlap and solver != "fused":
        raise ValueError("overlap=True needs solver='fused' (the round "
                         "split lives in the fused rounds)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("measure_scaling: no CUDA device is "
                               "available; pass devices=['cpu'] * n for a "
                               "CPU sweep")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    all_devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = []
        n = 1
        while n <= len(all_devices):
            device_counts.append(n)
            n *= 2

    rows = []
    t1 = None
    for n in device_counts:
        mesh = grid_mesh(all_devices[:n],
                         (n, 1) if overlap else factor_mesh(n))
        dev = mesh.first_device
        if mode == "weak":
            # grow the world with the mesh: per-device block ~= the base grid
            mx_, my_ = mesh.shape["x"], mesh.shape["y"]
            cfg_n = PlaneverbConfig(
                grid_size_x=params.grid_size_x * mx_,
                grid_size_y=params.grid_size_y * my_,
                grid_resolution=params.resolution,
                grid_boundary_type=params.boundary_type)
            p_n = dataclasses.replace(compute_grid_params(cfg_n),
                                      response_length=params.response_length)
            b_n, r_n = (torch.from_numpy(a) for a in voxelize.base_fields(p_n))
            cix, ciy = p_n.nx // 2, p_n.ny // 2
        else:
            p_n, b_n, r_n = params, torch.as_tensor(beta), \
                torch.as_tensor(refl)
            cix, ciy = int(lix), int(liy)
        nx_pad, ny_pad = pad_to_mesh(p_n.nx, p_n.ny, mesh)
        pad = (0, ny_pad - p_n.ny, 0, nx_pad - p_n.nx)
        bp = F.pad(b_n.to(dev, torch.float32), pad)
        rp = F.pad(r_n.to(dev, torch.float32), pad)
        pu = torch.as_tensor(pulse, dtype=torch.float32).to(dev)
        k = min(halo, nx_pad // mesh.shape["x"], ny_pad // mesh.shape["y"])
        if overlap and mesh.shape["x"] > 1:
            # the split needs bx >= 3*halo (frame + fringe + frame)
            k = max(1, min(k, (nx_pad // mesh.shape["x"]) // 3))
        updates = p_n.nx * p_n.ny * p_n.response_length

        if solver == "fused":
            def one_pass(p_n=p_n, mesh=mesh, bp=bp, rp=rp, pu=pu, k=k,
                         nx_pad=nx_pad, ny_pad=ny_pad, cix=cix, ciy=ciy):
                return simulate_sharded_fused(
                    p_n, bp, rp, pu, cix, ciy, mesh, nx_pad, ny_pad, halo=k,
                    overlap=overlap)
        else:
            def one_pass(p_n=p_n, mesh=mesh, bp=bp, rp=rp, pu=pu, k=k,
                         nx_pad=nx_pad, ny_pad=ny_pad, cix=cix, ciy=ciy):
                return simulate_sharded_wide(
                    p_n, bp, rp, pu, cix, ciy, mesh, nx_pad, ny_pad, halo=k)

        mesh_devices = [d for row in mesh.devices for d in row]
        one_pass()   # warm: kernel builds, launch tables
        t = time_passes(one_pass, n=chain, reps=reps, devices=mesh_devices)
        if t1 is None:
            # normalize in case the sweep starts above 1 device
            t1 = t * (n if mode == "strong" else 1)
        eff = (t1 / (n * t)) if mode == "strong" else (t1 / t)
        rows.append({
            "devices": n,
            "solver": solver,
            "mode": mode,
            "overlap": overlap,
            "mesh": [mesh.shape["x"], mesh.shape["y"]],
            "grid": [p_n.nx, p_n.ny],
            "halo": k,
            "wall_s": round(t, 5),
            "cell_updates_per_s": round(updates / t),
            "efficiency_vs_1": round(eff, 4),
        })
    return rows
