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

The projected_* functions are the JAX module's projection model, which
models device counts no run has from the one-card round structure and the
links' rates, with the H100's own constants (below): none of the TPU's.

Usage:  python -m planeverb_tpu_torch scale HugeRoom --solver fused [--weak]
        python -m planeverb_tpu_torch scale HugeRoom --project [--weak]
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from planeverb_tpu_torch.utils.profiling import time_passes

__all__ = ["measure_scaling", "projected_efficiency",
           "projected_weak_efficiency"]

# ---------------------------------------------------------------------------
# The projection model (the JAX module's, structure and row keys unchanged).
#
# One card cannot measure many, but every input of the round structure is
# measurable on one card and one host (``chip_smoke.py``, phase 23):
#   - compute: a round's wall on one card, B5 advancing the extended block
#     (ghost rows included) at an asymptotic cell rate plus a fixed cost a
#     round (its launch and the host's work around it);
#   - communication: per round and mesh axis each shard sends its state's
#     three fields (p, vx, vy: the ghost buffers of solver_fused.py are
#     [3, h, w]) as slabs of halo x edge x 4 B, over NVLink inside a host
#     and the host's NIC across hosts. The diagonal neighbours' k x k
#     corners the port also sends are left out, as the JAX model's
#     per-axis slabs leave them out.
# Cells are counted unpadded: (bx + 2k) x (by + 2k), with no TPU lane
# padding; the fit below counts them the same way, so it absorbs the round
# kernel's own tile borders (csrc/windows.cuh) into its rate.
#
# ROUND_RATE_CUPS and ROUND_OVERHEAD_S: a least-squares fit of
# t_round = cells * k / rate + C to a 1x1 halo sweep of B5 at the headline
# (HugeRoom, 25 m at 750 Hz: 192 x 192 x 1187), k in {2, 4, 6, 8, 12, 16},
# each pass's CUDA-event time over its rounds (a round 17.8 us at k = 2 to
# 36.5 us at k = 16, the fit's largest residual 12 % of a round);
# chip_smoke.py phase 23 on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit.
ROUND_RATE_CUPS = 3.057084e10
ROUND_OVERHEAD_S = 17.6023e-6
# NVLINK_GBPS and NVLINK_LATENCY_S: a least-squares fit of
# t = bytes / rate + latency to the exchange of two NCCL processes, one a
# card (multihost.transfer, both ways at once, 50 back to back), over slabs
# of 3 x k x edge x 4 B at the headline's 96-cell and the 126 m world's
# 482-cell shard edges, k in {2, 4, 6, 8, 12, 16} (2.3 to 92.5 kB);
# chip_smoke.py --cards on 4 x NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit. An exchange took 89 to 125 us whatever its size, so the latency
# (the exchange's software path) is what the fit pins; its rate, far
# below the link's, only says that these slabs never reach it (the fit's
# largest residual is 22 %).
NVLINK_GBPS = 4.7236
NVLINK_LATENCY_S = 106.4011e-6
# NIC_GBPS and NIC_LATENCY_S (across hosts): not measured, one host cannot.
# An assumption from the public spec of a DGX H100 (NVIDIA's DGX H100 data
# sheet): one ConnectX-7 400 Gb/s NIC per GPU, 50 GB/s a direction. Its
# latency is assumed equal to the measured in-host one: the exchange's own
# software path, which dominates slabs this small; the network's is left
# out. With the in-host rate above, a host-crossing exchange models no
# dearer than one inside a host, so rows of more than one host say nothing
# of the NIC.
NIC_GBPS = 50.0
NIC_LATENCY_S = NVLINK_LATENCY_S
# an HGX / DGX H100 host holds eight cards
CHIPS_PER_HOST = 8
_EXCHANGED_FIELDS = 3  # p, vx, vy


def _factorizations(n):
    out = []
    f = 1
    while f * f <= n:
        if n % f == 0:
            out += [(f, n // f), (n // f, f)]
        f += 1
    return sorted(set(out))


def _axis_comm(mx, my, k, bx, by, chips_per_host):
    """Per-round exchange cost per axis.

    Device order is x-major (device = x*my + y), hosts own contiguous
    device ranges: y-neighbour pairs straddle a host boundary once my
    exceeds a host, x-neighbour pairs once the x rows per host run out.
    Only boundary cards pay the NIC, but the rounds are synchronous, so a
    crossing axis charges the whole round the NIC's cost (max over cards).
    Returns (t_comm_x, t_comm_y)."""
    y_cross = my > chips_per_host
    x_cross = mx > max(1, chips_per_host // min(my, chips_per_host))
    out = []
    for axis_n, edge, cross in ((mx, by, x_cross), (my, bx, y_cross)):
        if axis_n == 1:
            out.append(0.0)
            continue
        slab = _EXCHANGED_FIELDS * k * edge * 4
        bw = (NIC_GBPS if cross else NVLINK_GBPS) * 1e9
        lat = NIC_LATENCY_S if cross else NVLINK_LATENCY_S
        out.append(slab / bw + lat)
    return out[0], out[1]


def _t_round(mx, my, k, bx, by, rate, chips_per_host, overlap,
             c_round=ROUND_OVERHEAD_S):
    """One round's modelled wall for a (bx, by)-cell shard on an (mx, my)
    mesh. Returns (t_comp, t_comm, extras) or (None, None, None) when the
    configuration is invalid.

    Compute: the round's cells, counted unpadded, advance k steps at
    ``rate`` plus a fixed ``c_round`` a launch (the two parameters of the
    halo sweep's fit, ROUND_RATE_CUPS / ROUND_OVERHEAD_S).

    Plain rounds: B5 advances the (bx + 2k·[mx>1]) x (by + 2k·[my>1])
    extended block, then the round waits out the whole exchange:
    t = t_comp + t_comm.

    Overlap rounds (1D x-meshes only, solver_fused._overlap_rounds): the two
    3k-row frame windows advance first (one launch), the frames' exchange
    then runs beside the bx-row interior launch:
    t = t_frame + max(t_comm, t_interior). The exchange leaves the round
    whenever it is shorter than the interior's advance; the price is the
    split's extra fringe compute (6k rows a round against the plain 1D
    rounds' 2k ghost rows) and one more launch."""
    if k > bx or k > by:
        return None, None, None
    tx, ty = _axis_comm(mx, my, k, bx, by, chips_per_host)
    if not overlap or (mx == 1 and my == 1):
        # (the split takes the plain rounds on a single shard: nothing to
        # exchange)
        kx = k if mx > 1 else 0
        ky = k if my > 1 else 0
        ext = (bx + 2 * kx) * (by + 2 * ky)
        return ext * k / rate + c_round, tx + ty, {}
    if my != 1 or bx < 3 * k:
        # the split exists on 1D ("x", N) meshes only; the model mirrors
        # the solver, which raises on other shapes
        return None, None, None
    t_frame = 2 * (3 * k * by) * k / rate + c_round
    t_int = bx * by * k / rate + c_round
    t_comp = t_frame + max(tx, t_int)
    return t_comp, 0.0, {
        "t_frame_round_us": round(t_frame * 1e6, 1),
        "t_interior_round_us": round(t_int * 1e6, 1),
        "t_exchange_round_us": round(tx * 1e6, 1),
        "comm_hidden": tx <= t_int,
    }


def projected_efficiency(grid_x: int, grid_y: int, device_counts,
                         rate_ext_cups: float = ROUND_RATE_CUPS,
                         halos=(8, 16, 32),
                         chips_per_host: int = CHIPS_PER_HOST,
                         overlap: bool = False,
                         round_overhead_s: float = ROUND_OVERHEAD_S
                         ) -> list[dict]:
    """Model the sharded engine's strong-scaling efficiency on N cards.

    ``rate_ext_cups`` and ``round_overhead_s``: the round's asymptotic
    cell rate (unpadded cells a second) and fixed cost, by default the
    H100 fit above. Per device count the model searches mesh
    factorizations and halos and reports the best:

      t_round(N, mx, my, k) = ext_cells/card * k / rate + C  (+ comm; see
                              _t_round: overlap=True hides the exchange
                              behind the interior launch on 1D meshes)
      efficiency(N) = t_round(1) / (N * t_round(N))   [same k as N's best]

    Communication charges the NIC (bandwidth + latency) on host-crossing
    axes, NVLink otherwise. ``overlap=True`` models the overlap split and
    restricts the search to its shape (1D x-meshes). Returns one row per N:
    {devices, mesh, halo, hosts, t_comp_round_us, t_comm_round_us,
    efficiency, and the split's extras}.
    """
    rows = []
    for n in device_counts:
        best = None
        for mx, my in _factorizations(n):
            for k in halos:
                bx = -(-grid_x // mx)
                by = -(-grid_y // my)
                tc, tx, extras = _t_round(mx, my, k, bx, by, rate_ext_cups,
                                          chips_per_host, overlap,
                                          round_overhead_s)
                if tc is None:
                    continue
                t1c, _, _ = _t_round(1, 1, k, grid_x, grid_y,
                                     rate_ext_cups, chips_per_host, overlap,
                                     round_overhead_s)
                eff = t1c / (n * (tc + tx))
                if best is None or eff > best["efficiency"]:
                    best = {
                        "devices": n, "mesh": [mx, my], "halo": k,
                        "hosts": max(1, n // chips_per_host),
                        "t_comp_round_us": round(tc * 1e6, 1),
                        "t_comm_round_us": round(tx * 1e6, 1),
                        "efficiency": round(eff, 3),
                        **extras,
                    }
        if best is not None:
            rows.append(best)
    return rows


def projected_weak_efficiency(block_x: int, block_y: int, device_counts,
                              rate_ext_cups: float = ROUND_RATE_CUPS,
                              halos=(8, 16, 32),
                              chips_per_host: int = CHIPS_PER_HOST,
                              overlap: bool = False,
                              round_overhead_s: float = ROUND_OVERHEAD_S
                              ) -> list[dict]:
    """Weak-scaling companion of :func:`projected_efficiency`: the
    per-card block stays (block_x, block_y) cells, the world grows with
    the machine, and

      efficiency(N) = t_round(1 card) / t_round(N cards)

    (no 1/N: per-card work is constant, so ideal scaling is a flat wall).
    Ghost compute no longer grows with N, so the model isolates the
    exchange's cost, which ``overlap=True`` hides behind the interior
    launch whenever it is shorter. Returns one row per N with the best
    (mesh, halo), and ``global_grid``."""
    rows = []
    for n in device_counts:
        best = None
        for mx, my in _factorizations(n):
            for k in halos:
                tc, tx, extras = _t_round(mx, my, k, block_x, block_y,
                                          rate_ext_cups, chips_per_host,
                                          overlap, round_overhead_s)
                if tc is None:
                    continue
                t1c, _, _ = _t_round(1, 1, k, block_x, block_y,
                                     rate_ext_cups, chips_per_host, overlap,
                                     round_overhead_s)
                eff = t1c / (tc + tx)
                if best is None or eff > best["efficiency"]:
                    best = {
                        "devices": n, "mesh": [mx, my], "halo": k,
                        "hosts": max(1, n // chips_per_host),
                        "global_grid": [mx * block_x, my * block_y],
                        "t_comp_round_us": round(tc * 1e6, 1),
                        "t_comm_round_us": round(tx * 1e6, 1),
                        "efficiency": round(eff, 3),
                        **extras,
                    }
        if best is not None:
            rows.append(best)
    return rows


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
    halo as sub-rounds of ``solver_fused.SUB_ROUND`` steps.

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
