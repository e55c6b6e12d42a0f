#!/usr/bin/env python3
"""Bring-up smoke run of planeverb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``planeverb_tpu_torch/csrc`` and runs, one
line per phase:

  1. device: the card's name and power limit, torch, CUDA and nvcc versions;
  2. build: nvcc build of the kernels (seconds, ptxas register counts);
  3. B1 ``fdtd_sim`` against its plain PyTorch version on the card, at the
     headline workload (HugeRoom, 25 m at 750 Hz: 192 x 192 cells x 1187
     steps), with CUDA-event medians of both;
  4. B2 ``rt60_moments`` against its plain version on that recording;
  5. the engine's main path: ``Context(device="cuda")`` at the headline
     size, three emitters, five ``step()`` calls, with the kernels' launch
     counts and the step times;
  6. the same engine step on the CPU (the plain versions), its published
     grids held to the card's at the golden-scene tolerances;
  7. B3 ``fdtd_sim_tiled`` (the large world's simulation: k steps per
     launch over tiles) against its plain version and against B1 (kernel
     against kernel) at 459^2 (60 m at 750 Hz, HugeRoom, listener at the
     center) and 964^2 (126 m), with CUDA-event medians (the plain version
     timed at 459^2 only);
  8. B4 ``rt60_moments_tiled`` against its plain version and against B2 on
     B3's recordings at 459^2 and 964^2, with times and GB/s;
  9. the large-world engine: ``Context`` at 126 m with ``publish="cells"``,
     three emitters, three ``step()`` calls, with the launch counts (B1
     once for calibration, B3 and B4 once a step, B2 never), the emitter
     rows held to the grids publish on the same fields, step times and
     peak device memory;
 10. the route's crossover: B1 + B2 against B3 + B4 at 192^2, 261^2,
     459^2 and 964^2, the measurement ``fdtd_fused.TILED_MIN_CELLS`` rests
     on;
 11. B5 ``sharded_round`` (the sharded engine's rounds):
     ``simulate_moments_sharded`` at the headline on 2x2, 4x1 and 1x1 meshes
     of the one card (halo 16: 96^2 shards and 75 rounds on 2x2), all nine
     outputs held to B1 + B2 and to the plain sharded path on the card, the
     pass timed against B1 + B2 and the 2x2 simulation against its plain
     version;
 12. B6 ``banded_round``: the 126 m world on a 2x2 mesh (482^2 shards, routed
     to B6), held to B3 + B4 and to the plain sharded path, timed against
     its plain version; then B6 forced (``band_rows=16``) against B5 on the
     headline's 96^2 shards, the crossover the B5/B6 routing rests on;
 13. the sharded engine's main path: ``Context(mesh=grid_mesh(["cuda:0"] *
     4, (2, 2)))`` at the headline, grids publish, five ``step()`` calls,
     its grids equal to the single-device Context's; then the 126 m world
     on the same mesh, cells publish, three steps, its emitter rows equal to
     phase 9's; launch counts (set to 0 just before each part), step times
     and peak device memory.

Then a JSON line with each kernel's error and times, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. It needs a CUDA card and the repository
beside it; it imports neither jax nor planeverb_tpu.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HEADLINE = dict(size=25.0, resolution=750, scene="HugeRoom",
                listener=(12.5, 12.5))
EMITTERS = [(15.0, 12.5), (10.0, 9.0), (12.5, 20.0)]
STEPS = 5
# the large worlds (the JAX bench's tiled_large and tiled_xl rows): HugeRoom
# at 750 Hz, listener at the center; 459^2 x 1470 and 964^2 x 2006 cells
LARGE = 60.0
XL = 126.0
XL_EMITTERS = [(66.0, 63.0), (58.0, 59.0), (63.0, 72.0)]
XL_STEPS = 3
# the route's crossover: 25 m (the headline, 192^2), 34 m (261^2), 60 m and
# 126 m, HugeRoom at 750 Hz
CROSSOVER = (25.0, 34.0, 60.0, 126.0)
CROSSOVER_REPS = 5
# the sharded engine (phases 11-13): meshes of the one card at the headline,
# the round length (the Context's default on 96^2 shards), B6's forced tile
SHARDED_MESHES = ((2, 2), (4, 1), (1, 1))
SHARD_HALO = 16
FORCED_BAND = 16
# kernel vs its plain version on the card: both round every op once (the
# kernels build with -fmad=false), so they are expected bit-equal; the bound
# checked is the C1 bound the port holds against JAX (1e-6 of the peak)
REL_TOL = 1e-6
# RT60 moments: logf inside the kernel vs torch.log; same bound as the JAX
# package's own kernel test (scale-relative 1e-5)
MOMENTS_REL_TOL = 1e-5


def _require(cond, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _rel(a, b):
    """max |a - b| / max |b| over finite entries, and max |a - b|; a
    recording is walked in chunks of steps, so no copy of it is made."""
    import torch

    diff = scale = 0.0
    for x, y in (zip(a.split(64), b.split(64)) if a.dim() == 3
                 else [(a, b)]):
        fin = torch.isfinite(y)
        if fin.any():
            diff = max(diff, (x[fin] - y[fin]).abs().max().item())
            scale = max(scale, y[fin].abs().max().item())
    return (diff / scale if scale > 0 else diff), diff


def _once(fn):
    """(CUDA-event ms, host wall ms) of one call of fn, from an idle
    device to its end."""
    import torch

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1), (time.perf_counter() - t0) * 1e3


def _time_pair(kernel_fn, plain_fn, reps):
    """CUDA-event medians (ms) of kernel_fn and plain_fn, taken in turns
    (plain, kernel, kernel, plain, ...) after one warm-up call each."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    ks, ps = [], []
    for r in range(reps):
        order = (plain_fn, kernel_fn) if r % 2 == 0 else (kernel_fn, plain_fn)
        for fn in order:
            (ks if fn is kernel_fn else ps).append(_once(fn)[0])
    return statistics.median(ks), statistics.median(ps)


def _compare(kres, kacc, rres, racc, what):
    """Hold a sim's outputs (FdtdResult, energies) to another's: onset
    equal, the rest within REL_TOL of the peak. Returns ({name: (rel, abs)},
    bit-equal on every output)."""
    import torch

    _require(torch.equal(kres.onset, rres.onset),
             f"{what}: onset differs")
    out = {}
    for name, a, b in (("rec", kres.pressure, rres.pressure),
                       ("fx", kres.flux_x, rres.flux_x),
                       ("fy", kres.flux_y, rres.flux_y),
                       ("e_dry", kacc[0], racc[0]),
                       ("e_wet", kacc[1], racc[1]),
                       ("e_total", kacc[2], racc[2])):
        out[name] = _rel(a, b)
        _require(out[name][0] <= REL_TOL,
                 f"{what} {name}: rel {out[name][0]} > {REL_TOL}")
    bits = all(torch.equal(a, b) for a, b in zip((*kres, *kacc),
                                                 (*rres, *racc)))
    return out, bits


def _cuda_ms(fn, reps):
    """CUDA-event median (ms) of fn over reps calls, after one warm-up."""
    fn()
    return statistics.median(_once(fn)[0] for _ in range(reps))


def _large_inputs(pv, voxelize, gaussian_pulse, size, dev):
    import torch

    p = pv.compute_grid_params(pv.PlaneverbConfig(size, size, 750))
    beta, refl = voxelize.voxelize(p, torch.from_numpy(
        voxelize.boxes_to_array(pv.demo_scene("HugeRoom").boxes)).to(dev))
    pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
    lix, liy = p.world_to_cell(size / 2, size / 2)
    return p, beta, refl, pulse, lix, liy


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "planeverb_tpu_torch")):
        print("chip_smoke: planeverb_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    import planeverb_tpu_torch as pv
    from planeverb_tpu_torch import kernels
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled, voxelize

    # -- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"card: {card}")
    print(f"phase 1 device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc[-1]}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 2. build
    t0 = time.perf_counter()
    lib_path, log = kernels.build(force=True)
    kernels.library()
    build_s = time.perf_counter() - t0
    regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {build_s:.2f} s -> "
          f"{os.path.relpath(lib_path, root)}; ptxas: {' | '.join(regs)}")

    # -- headline inputs, made on the card
    dev = torch.device("cuda")
    size, res = HEADLINE["size"], HEADLINE["resolution"]
    cfg = pv.PlaneverbConfig(size, size, res)
    p = pv.compute_grid_params(cfg)
    scene = pv.demo_scene(HEADLINE["scene"])
    beta, refl = voxelize.voxelize(p, torch.from_numpy(
        voxelize.boxes_to_array(scene.boxes)).to(dev))
    pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
    lix, liy = p.world_to_cell(*HEADLINE["listener"])
    shape = f"{p.nx}x{p.ny}x{p.response_length}"
    label = f"CUDA-event medians on {card}"

    # -- 3. B1 vs its plain version
    kres, kacc = fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy)
    rres, racc = fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse,
                                               lix, liy)
    torch.cuda.synchronize()
    b1, b1_bits = _compare(kres, kacc, rres, racc, "B1 vs plain")
    _require(torch.isfinite(kres.pressure).all(), "B1 recording not finite")
    b1_ms, b1_plain_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy),
        lambda: fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, lix,
                                              liy), reps=4)
    print(f"phase 3 B1 fdtd_sim {shape}: max rel diff "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b1.items())
          + f" (bound {REL_TOL:g}); onset equal True; bit-equal "
          f"{b1_bits}; kernel "
          f"{b1_ms:.3f} ms vs plain {b1_plain_ms:.3f} ms ({label})")

    # -- 4. B2 vs its plain version, on the kernel's recording
    s0, s1 = fdtd_fused.rt60_moments(p, kres.pressure, kres.onset)
    r0, r1 = fdtd_fused.rt60_moments_reference(p, kres.pressure, kres.onset)
    torch.cuda.synchronize()
    b2 = {"s0": _rel(s0, r0), "s1": _rel(s1, r1)}
    b2_bits = torch.equal(s0, r0) and torch.equal(s1, r1)
    for name, (rel, _) in b2.items():
        _require(rel <= MOMENTS_REL_TOL, f"B2 {name}: rel {rel}")
    b2_ms, b2_plain_ms = _time_pair(
        lambda: fdtd_fused.rt60_moments(p, kres.pressure, kres.onset),
        lambda: fdtd_fused.rt60_moments_reference(p, kres.pressure,
                                                  kres.onset), reps=4)
    print(f"phase 4 B2 rt60_moments {shape}: max rel diff "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b2.items())
          + f" (bound {MOMENTS_REL_TOL:g}); bit-equal {b2_bits}; kernel "
          f"{b2_ms:.3f} ms vs plain "
          f"{b2_plain_ms:.3f} ms ({label})")

    # -- 5. the main path: Context on the card
    fdtd_fused.reset_launch_counts()
    lx, lz = HEADLINE["listener"]
    ctx = pv.Context(cfg, scene=scene, device="cuda")
    _require(fdtd_fused.fdtd_sim.launches == 1, "calibration must run B1 once")
    _require(fdtd_fused.rt60_moments.launches == 0, "B2 ran at init")
    ctx.set_listener_position(lx, 0.0, lz)
    eids = [ctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    ev_ms, wall_ms = zip(*(_once(ctx.step) for _ in range(STEPS)))
    launches = {"fdtd_sim": fdtd_fused.fdtd_sim.launches,
                "rt60_moments": fdtd_fused.rt60_moments.launches}
    _require(launches == {"fdtd_sim": 1 + STEPS, "rt60_moments": STEPS},
             launches)
    _require(fdtd_tiled.fdtd_sim_tiled.launches == 0
             and fdtd_tiled.rt60_moments_tiled.launches == 0,
             "the headline must stay on B1 + B2")
    outs = [ctx.get_output(e) for e in eids]
    _require(all(o.valid for o in outs), outs)
    grids = {k: v for k, v in ctx._published.items()
             if k not in ("listener", "pressure")}
    for k, v in grids.items():
        _require(v.shape[:2] == (p.grid_x, p.grid_y), k)
        if k != "delay_samples":
            _require(np.isfinite(v).all(), k)
    found = grids["delay_samples"] < np.finfo(np.float32).max
    _require(found.sum() > 0 and (grids["rt60"][found] > 0).any(),
             "no cell found, or no RT60 > 0")
    ir = ctx.get_impulse_response(lx + 2 * p.dx, lz)
    _require(ir.shape == (p.response_length,) and np.abs(ir).max() > 0,
             "impulse response near the listener is silent")
    tput = p.nx * p.ny * p.response_length / (statistics.median(ev_ms) / 1e3)
    print(f"phase 5 main path Context(device='cuda') {shape}: EFree "
          f"{ctx.efree:.6g}; launches {launches} (calibration + {STEPS} "
          f"steps); step median {statistics.median(ev_ms):.3f} ms "
          f"(CUDA events), {statistics.median(wall_ms):.3f} ms (wall) on "
          f"{card}; {tput / 1e9:.3f} G cell-updates/s; emitters "
          + "; ".join(f"occ {o.occlusion:.4f} rt60 {o.rt60:.3f}"
                      for o in outs))

    # -- 6. the same step on the CPU (plain versions), held to the card's
    cpu = pv.Context(cfg, scene=scene, device="cpu")
    cpu.set_listener_position(lx, 0.0, lz)
    cpu.step()
    c = cpu._published
    _require(abs(cpu.efree - ctx.efree) <= 1e-5 * abs(ctx.efree),
             f"EFree card {ctx.efree} vs CPU {cpu.efree}")
    np.testing.assert_array_equal(grids["delay_samples"], c["delay_samples"])
    for k, rtol, atol in (("occlusion", 2e-4, 1e-5), ("wet_gain", 2e-4, 1e-5),
                          ("lowpass", 2e-4, 1e-2),
                          ("source_directivity", 1e-3, 1e-4)):
        np.testing.assert_allclose(grids[k], c[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    valid = (c["rt60"] > 0.01) & (c["rt60"] < 100.0)
    np.testing.assert_allclose(grids["rt60"][valid], c["rt60"][valid],
                               rtol=5e-3)
    n_dir = int((np.abs(grids["direction"] - c["direction"]).max(-1)
                 > 1e-4).sum())
    _require(n_dir == 0, n_dir)
    same = {k: bool(np.array_equal(grids[k], c[k])) for k in grids}
    print(f"phase 6 card vs CPU plain path {shape}: golden tolerances hold "
          f"({int(valid.sum())} valid RT60 cells); bit-equal per grid {same}")

    del ctx, cpu, kres, rres, kacc, racc
    torch.cuda.empty_cache()

    # -- 7. B3 vs its plain version (459^2) and vs B1 (459^2, 964^2)
    t_phase = time.perf_counter()
    b3 = {}
    recs = {}
    for size in (LARGE, XL):
        q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse,
                                              size, dev)
        qshape = f"{q.nx}x{q.ny}x{q.response_length}"
        k3res, k3acc = fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy)
        k1res, k1acc = fdtd_fused.fdtd_sim(q, qb, qr, qp, qx, qy)
        torch.cuda.synchronize()
        vs_b1, b1_bits3 = _compare(k3res, k3acc, k1res, k1acc,
                                   f"B3 vs B1 {qshape}")
        del k1res, k1acc
        row = {"vs_b1": vs_b1, "b1_bits": b1_bits3}
        # the plain version at both sizes (the main path runs B3 at 964^2);
        # it is timed at 459^2 only
        r3res, r3acc = fdtd_tiled.fdtd_sim_tiled_reference(
            q, qb, qr, qp, qx, qy)
        torch.cuda.synchronize()
        row["vs_plain"], row["plain_bits"] = _compare(
            k3res, k3acc, r3res, r3acc, f"B3 vs plain {qshape}")
        del r3res, r3acc
        if size == LARGE:
            row["ms"], row["plain_ms"] = _time_pair(
                lambda: fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy),
                lambda: fdtd_tiled.fdtd_sim_tiled_reference(
                    q, qb, qr, qp, qx, qy), reps=2)
        else:
            row["ms"] = _cuda_ms(
                lambda: fdtd_tiled.fdtd_sim_tiled(q, qb, qr, qp, qx, qy), 3)
        row["b1_ms"] = _cuda_ms(
            lambda: fdtd_fused.fdtd_sim(q, qb, qr, qp, qx, qy), 3)
        torch.cuda.synchronize()
        _require(torch.isfinite(k3res.pressure).all(),
                 f"B3 recording not finite at {qshape}")
        rounds = -(-q.response_length // fdtd_tiled.HALO)
        tile = fdtd_tiled.pick_tile(
            q.nx, q.ny, fdtd_tiled.HALO,
            torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"phase 7 B3 fdtd_sim_tiled {qshape} (tile {tile}, halo "
              f"{fdtd_tiled.HALO}: {rounds} launches a pass): vs B1 max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in vs_b1.items())
              + f", bit-equal {b1_bits3}; vs plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_plain"].items())
              + f", bit-equal {row['plain_bits']}"
              + f" (bound {REL_TOL:g}, onset equal); B3 {row['ms']:.3f} ms, "
              f"B1 {row['b1_ms']:.3f} ms"
              + (f", plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                 else "")
              + f" ({label}); wrapper calls so far "
              f"{fdtd_tiled.fdtd_sim_tiled.launches}", flush=True)
        b3[qshape] = row
        recs[qshape] = (q, k3res)
    print(f"phase 7 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 8. B4 vs its plain version and vs B2, on B3's recordings
    t_phase = time.perf_counter()
    b4 = {}
    for qshape, (q, k3res) in recs.items():
        rec, onset = k3res.pressure, k3res.onset
        s4 = fdtd_tiled.rt60_moments_tiled(q, rec, onset)
        r4 = fdtd_tiled.rt60_moments_tiled_reference(q, rec, onset)
        s2 = fdtd_fused.rt60_moments(q, rec, onset)
        torch.cuda.synchronize()
        row = {"vs_plain": {"s0": _rel(s4[0], r4[0]),
                            "s1": _rel(s4[1], r4[1])},
               "vs_b2": {"s0": _rel(s4[0], s2[0]), "s1": _rel(s4[1], s2[1])},
               "plain_bits": all(map(torch.equal, s4, r4)),
               "b2_bits": all(map(torch.equal, s4, s2))}
        for what in ("vs_plain", "vs_b2"):
            for name, (rel, _) in row[what].items():
                _require(rel <= MOMENTS_REL_TOL,
                         f"B4 {what} {name} {qshape}: rel {rel}")
        _require(all(torch.isfinite(x).all() for x in s4),
                 f"B4 moments not finite at {qshape}")
        row["ms"], row["plain_ms"] = _time_pair(
            lambda: fdtd_tiled.rt60_moments_tiled(q, rec, onset),
            lambda: fdtd_tiled.rt60_moments_tiled_reference(q, rec, onset),
            reps=2)
        row["b2_ms"] = _cuda_ms(lambda: fdtd_fused.rt60_moments(q, rec,
                                                                onset), 3)
        gb = rec.numel() * 4 / 1e9
        print(f"phase 8 B4 rt60_moments_tiled {qshape} (chunk "
              f"{fdtd_tiled.CHUNK}): vs plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_plain"].items())
              + f", bit-equal {row['plain_bits']}; vs B2 max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in row["vs_b2"].items())
              + f", bit-equal {row['b2_bits']} (bound {MOMENTS_REL_TOL:g}); "
              f"B4 {row['ms']:.3f} ms ({gb / row['ms'] * 1e3:.1f} GB/s over "
              f"the {gb:.2f} GB recording), B2 {row['b2_ms']:.3f} ms "
              f"({gb / row['b2_ms'] * 1e3:.1f} GB/s), plain "
              f"{row['plain_ms']:.3f} ms ({label})", flush=True)
        b4[qshape] = row
        del s4, r4, s2
    del recs, k3res, k3acc, rec, onset
    torch.cuda.empty_cache()
    print(f"phase 8 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 9. the large world's main path: Context at 126 m, cells publish
    t_phase = time.perf_counter()
    from planeverb_tpu_torch.core.context import _pack

    torch.cuda.reset_peak_memory_stats()
    xcfg = pv.PlaneverbConfig(XL, XL, 750)
    fdtd_fused.reset_launch_counts()
    xctx = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"),
                      publish="cells", device="cuda")
    xl_lx = xl_lz = XL / 2
    xctx.set_listener_position(xl_lx, 0.0, xl_lz)
    xeids = [xctx.emissions.emit(x, 0.0, z) for x, z in XL_EMITTERS]
    xev, xwall = zip(*(_once(xctx.step) for _ in range(XL_STEPS)))
    xl_launches = {
        "fdtd_sim": fdtd_fused.fdtd_sim.launches,
        "rt60_moments": fdtd_fused.rt60_moments.launches,
        "fdtd_sim_tiled": fdtd_tiled.fdtd_sim_tiled.launches,
        "rt60_moments_tiled": fdtd_tiled.rt60_moments_tiled.launches}
    _require(xl_launches == {"fdtd_sim": 1, "rt60_moments": 0,
                             "fdtd_sim_tiled": XL_STEPS,
                             "rt60_moments_tiled": XL_STEPS}, xl_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    xp = xctx.params
    xouts = [xctx.get_output(e) for e in xeids]
    _require(all(o.valid for o in xouts), xouts)
    cells = xctx._published["cells"]
    _require(len(cells) == len(XL_EMITTERS), sorted(cells))
    xl_rows = dict(cells)     # phase 13 holds the sharded engine to these
    # the same pass with the grids publish's pipeline on the same fields
    xres, xout = fdtd_fused.pipeline_auto(
        xp, xctx._beta, xctx._refl, xctx._pulse,
        *xp.world_to_cell(xl_lx, xl_lz), xctx.efree,
        float(np.float32(xl_lx)), float(np.float32(xl_lz)))
    grid_rows = _pack(xout).cpu().numpy()
    for (cx, cy), row in cells.items():
        np.testing.assert_array_equal(row, grid_rows[cx, cy],
                                      err_msg=f"cell ({cx}, {cy})")
        _require(np.isfinite(row[:8]).all(), (cx, cy, row))
    probe = xctx.result_at(xl_lx + 10.0, xl_lz - 7.0)
    pcx, pcy = xp.world_to_cell(xl_lx + 10.0, xl_lz - 7.0)
    _require(probe.valid and probe.occlusion == float(grid_rows[pcx, pcy, 0]),
             probe)
    xir = xctx.get_impulse_response(*XL_EMITTERS[0])
    _require(xir.shape == (xp.response_length,) and np.abs(xir).max() > 0,
             "large-world impulse response is silent")
    del xres, xout
    xshape = f"{xp.nx}x{xp.ny}x{xp.response_length}"
    xtput = xp.nx * xp.ny * xp.response_length / (statistics.median(xev)
                                                   / 1e3)
    print(f"phase 9 large world Context({XL:g} m, publish='cells', "
          f"device='cuda') {xshape}: EFree {xctx.efree:.6g}; launches "
          f"{xl_launches} (calibration + {XL_STEPS} steps); step median "
          f"{statistics.median(xev):.3f} ms (CUDA events), "
          f"{statistics.median(xwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in xev)
          + f" ms on {card}; {xtput / 1e9:.3f} G cell-updates/s; peak "
          f"device memory {peak_gb:.2f} GB; emitter rows equal the grids "
          f"publish; emitters "
          + "; ".join(f"occ {o.occlusion:.4f} rt60 {o.rt60:.3f}"
                      for o in xouts), flush=True)
    del xctx
    torch.cuda.empty_cache()
    print(f"phase 9 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 10. the route's crossover: B1 + B2 against B3 + B4 by grid size
    t_phase = time.perf_counter()
    for size in CROSSOVER:
        q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse,
                                              size, dev)
        qshape = f"{q.nx}x{q.ny}x{q.response_length}"
        tiled_ms, fused_ms = _time_pair(
            lambda: fdtd_tiled.simulate_moments_tiled(q, qb, qr, qp, qx, qy),
            lambda: fdtd_fused.simulate_moments_fused(q, qb, qr, qp, qx, qy),
            reps=CROSSOVER_REPS)
        routed = ("B3 + B4" if q.nx * q.ny > fdtd_fused.TILED_MIN_CELLS
                  else "B1 + B2")
        print(f"phase 10 crossover {qshape} ({q.nx * q.ny} cells, routed "
              f"to {routed} by TILED_MIN_CELLS = "
              f"{fdtd_fused.TILED_MIN_CELLS}): B1 + B2 "
              f"{fused_ms:.3f} ms, B3 + B4 {tiled_ms:.3f} ms, ratio "
              f"{tiled_ms / fused_ms:.3f} ({label}, medians of "
              f"{CROSSOVER_REPS} in turns)", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 10 seconds: {time.perf_counter() - t_phase:.1f}")

    from planeverb_tpu_torch import parallel
    from planeverb_tpu_torch.parallel import solver_fused

    def nine(res, mom, q):
        """The nine outputs of a sharded pass, assembled on the card and
        cropped to the field."""
        out = {k: v[..., :q.nx, :q.ny]
               for k, v in res.assemble(dev)._asdict().items()}
        out.update({k: v[:q.nx, :q.ny]
                    for k, v in mom.assemble(dev)._asdict().items()})
        return out

    def hold(got, ref, what):
        """onset equal, the sim outputs within REL_TOL and the moments
        within MOMENTS_REL_TOL of the peak; returns ({name: (rel, abs)},
        bit-equal on all nine)."""
        _require(torch.equal(got["onset"], ref["onset"]),
                 f"{what}: onset differs")
        errs = {}
        for name in got:
            if name == "onset":
                continue
            errs[name] = _rel(got[name], ref[name])
            bound = MOMENTS_REL_TOL if name in ("s0", "s1") else REL_TOL
            _require(errs[name][0] <= bound,
                     f"{what} {name}: rel {errs[name][0]} > {bound}")
        return errs, all(torch.equal(got[k], ref[k]) for k in got)

    def sharded_args(q, qb, qr, qp, mesh_shape):
        mesh = parallel.grid_mesh(["cuda:0"] * (mesh_shape[0] * mesh_shape[1]),
                                  mesh_shape)
        nx_pad, ny_pad = parallel.pad_to_mesh(q.nx, q.ny, mesh)
        pad = (0, ny_pad - q.ny, 0, nx_pad - q.nx)
        return (q, torch.nn.functional.pad(qb, pad),
                torch.nn.functional.pad(qr, pad), qp), (mesh, nx_pad, ny_pad)

    # -- 11. B5: the headline on 2x2, 4x1 and 1x1 meshes of the card
    t_phase = time.perf_counter()
    fres, fmom = fdtd_fused.simulate_moments_fused(p, beta, refl, pulse,
                                                   lix, liy)
    single = {**fres._asdict(), **fmom._asdict()}
    del fres, fmom
    b5 = {}
    for mshape in SHARDED_MESHES:
        fields, (mesh, nx_pad, ny_pad) = sharded_args(p, beta, refl, pulse,
                                                      mshape)
        margs = (*fields, lix, liy, mesh, nx_pad, ny_pad)
        fdtd_fused.reset_launch_counts()
        got = nine(*parallel.simulate_moments_sharded(
            *margs, halo=SHARD_HALO), p)
        torch.cuda.synchronize()
        counts = {"sharded_round": solver_fused.sharded_round.launches,
                  "banded_round": solver_fused.banded_round.launches,
                  "rt60_moments": fdtd_fused.rt60_moments.launches}
        n_shards = mshape[0] * mshape[1]
        rounds = -(-p.response_length // SHARD_HALO)
        _require(counts == {"sharded_round": rounds * n_shards,
                            "banded_round": 0, "rt60_moments": n_shards},
                 f"B5 {mshape} launches {counts}")
        _require(all(torch.isfinite(v).all() for k, v in got.items()
                     if k != "onset"), f"B5 {mshape}: not finite")
        vs_b1, b1_bits5 = hold(got, single, f"B5 {mshape} vs B1 + B2")
        plain = nine(*parallel.simulate_moments_sharded_reference(
            *margs, halo=SHARD_HALO), p)
        torch.cuda.synchronize()
        vs_plain, plain_bits5 = hold(got, plain, f"B5 {mshape} vs plain")
        del got, plain
        row = {"launches": counts["sharded_round"], "vs_plain": vs_plain,
               "plain_bits": plain_bits5, "b1_bits": b1_bits5}
        row["pass_ms"], row["b1b2_ms"] = _time_pair(
            lambda: parallel.simulate_moments_sharded(*margs,
                                                      halo=SHARD_HALO),
            lambda: fdtd_fused.simulate_moments_fused(p, beta, refl, pulse,
                                                      lix, liy), reps=3)
        if mshape == SHARDED_MESHES[0]:
            row["ms"], row["plain_ms"] = _time_pair(
                lambda: parallel.simulate_sharded_fused(*margs,
                                                        halo=SHARD_HALO),
                lambda: parallel.simulate_sharded_reference(
                    *margs, halo=SHARD_HALO), reps=2)
        tile = solver_fused.pick_round_tile(
            nx_pad // mshape[0], ny_pad // mshape[1], SHARD_HALO,
            torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"phase 11 B5 sharded_round {mshape[0]}x{mshape[1]} mesh of "
              f"cuda:0 {shape} (shards {nx_pad // mshape[0]}x"
              f"{ny_pad // mshape[1]}, halo {SHARD_HALO}, tile {tile}): "
              f"launches {counts}; vs B1 + B2 bit-equal {b1_bits5}; vs "
              f"plain max rel "
              + ", ".join(f"{k} {v[0]:.3g}" for k, v in vs_plain.items())
              + f", bit-equal {plain_bits5} (onset equal); sharded pass "
              f"(rounds + exchanges + B2) {row['pass_ms']:.3f} ms vs B1 + B2 "
              f"{row['b1b2_ms']:.3f} ms"
              + (f"; simulation {row['ms']:.3f} ms vs plain rounds "
                 f"{row['plain_ms']:.3f} ms" if "ms" in row else "")
              + f" ({label})", flush=True)
        b5[mshape] = row
    torch.cuda.empty_cache()
    print(f"phase 11 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 12. B6: the 126 m world on a 2x2 mesh; B6 vs B5 at 96^2 shards
    t_phase = time.perf_counter()
    q, qb, qr, qp, qx, qy = _large_inputs(pv, voxelize, gaussian_pulse, XL,
                                          dev)
    qshape = f"{q.nx}x{q.ny}x{q.response_length}"
    fields, (mesh, nx_pad, ny_pad) = sharded_args(q, qb, qr, qp, (2, 2))
    margs = (*fields, qx, qy, mesh, nx_pad, ny_pad)
    fdtd_fused.reset_launch_counts()
    got = nine(*parallel.simulate_moments_sharded(*margs, halo=SHARD_HALO),
               q)
    torch.cuda.synchronize()
    counts = {"sharded_round": solver_fused.sharded_round.launches,
              "banded_round": solver_fused.banded_round.launches,
              "rt60_moments_tiled": fdtd_tiled.rt60_moments_tiled.launches}
    rounds = -(-q.response_length // SHARD_HALO)
    _require(counts == {"sharded_round": 0, "banded_round": 4 * rounds,
                        "rt60_moments_tiled": 4}, f"B6 launches {counts}")
    _require(all(torch.isfinite(v).all() for k, v in got.items()
                 if k != "onset"), "B6: not finite")
    tres, tmom = fdtd_tiled.simulate_moments_tiled(q, qb, qr, qp, qx, qy)
    b6_vs_b3, b6_b3_bits = hold(got, {**tres._asdict(), **tmom._asdict()},
                                "B6 vs B3 + B4")
    del tres, tmom
    torch.cuda.empty_cache()
    plain = nine(*parallel.simulate_moments_sharded_reference(
        *margs, halo=SHARD_HALO), q)
    torch.cuda.synchronize()
    b6_vs_plain, b6_plain_bits = hold(got, plain, "B6 vs plain")
    del got, plain
    torch.cuda.empty_cache()
    b6 = {"launches": counts["banded_round"]}
    b6["ms"] = _cuda_ms(lambda: parallel.simulate_sharded_fused(
        *margs, halo=SHARD_HALO), 3)
    b6["plain_ms"] = _once(lambda: parallel.simulate_sharded_reference(
        *margs, halo=SHARD_HALO))[0]
    b6["b3_ms"] = _cuda_ms(lambda: fdtd_tiled.fdtd_sim_tiled(
        q, qb, qr, qp, qx, qy), 3)
    torch.cuda.empty_cache()
    tile = solver_fused.pick_round_tile(
        nx_pad // 2, ny_pad // 2, SHARD_HALO,
        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"phase 12 B6 banded_round {qshape} on a 2x2 mesh of cuda:0 "
          f"(shards {nx_pad // 2}x{ny_pad // 2}, halo {SHARD_HALO}, tile "
          f"{tile}): launches {counts}; vs B3 + B4 bit-equal {b6_b3_bits}; "
          f"vs plain max rel "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b6_vs_plain.items())
          + f", bit-equal {b6_plain_bits} (onset equal); simulation "
          f"{b6['ms']:.3f} ms vs plain rounds {b6['plain_ms']:.3f} ms (one "
          f"pass) and B3 {b6['b3_ms']:.3f} ms ({label})", flush=True)
    # B6 forced against B5 on the headline's 96^2 shards
    fields, (mesh, nx_pad, ny_pad) = sharded_args(p, beta, refl, pulse,
                                                  (2, 2))
    margs = (*fields, lix, liy, mesh, nx_pad, ny_pad)
    forced = parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                             band_rows=FORCED_BAND)
    rounds5 = parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO)
    same = all(torch.equal(a, b) for a, b in zip(
        forced.assemble(dev), rounds5.assemble(dev)))
    _require(same, "B6 forced differs from B5 at the headline")
    del forced, rounds5
    b6_96, b5_96 = _time_pair(
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO,
                                                band_rows=FORCED_BAND),
        lambda: parallel.simulate_sharded_fused(*margs, halo=SHARD_HALO),
        reps=5)
    print(f"phase 12 B5/B6 crossover at the headline's {nx_pad // 2}x"
          f"{ny_pad // 2} shards (2x2, halo {SHARD_HALO}): B6 forced (band_rows={FORCED_BAND}: "
          f"{FORCED_BAND}x{FORCED_BAND} tiles) {b6_96:.3f} ms, B5 "
          f"{b5_96:.3f} ms, ratio {b6_96 / b5_96:.3f}, bit-equal {same} "
          f"({label}, medians of 5 in turns)", flush=True)
    print(f"phase 12 seconds: {time.perf_counter() - t_phase:.1f}")

    # -- 13. the sharded engine's main path: Context on a 2x2 mesh
    t_phase = time.perf_counter()
    mesh4 = parallel.grid_mesh(["cuda:0"] * 4, (2, 2))
    fdtd_fused.reset_launch_counts()
    mctx = pv.Context(cfg, scene=scene, mesh=mesh4)
    mctx.set_listener_position(lx, 0.0, lz)
    meids = [mctx.emissions.emit(x, 0.0, z) for x, z in EMITTERS]
    mev, mwall = zip(*(_once(mctx.step) for _ in range(STEPS)))
    m_launches = {k: f.launches for k, f in (
        ("fdtd_sim", fdtd_fused.fdtd_sim),
        ("rt60_moments", fdtd_fused.rt60_moments),
        ("sharded_round", solver_fused.sharded_round),
        ("banded_round", solver_fused.banded_round),
        ("fdtd_sim_tiled", fdtd_tiled.fdtd_sim_tiled),
        ("rt60_moments_tiled", fdtd_tiled.rt60_moments_tiled))}
    rounds = -(-p.response_length // mctx._halo)
    _require(m_launches == {"fdtd_sim": 1, "rt60_moments": 4 * STEPS,
                            "sharded_round": 4 * rounds * STEPS,
                            "banded_round": 0, "fdtd_sim_tiled": 0,
                            "rt60_moments_tiled": 0}, m_launches)
    one = pv.Context(cfg, scene=scene, device="cuda")
    one.set_listener_position(lx, 0.0, lz)
    for x, z in EMITTERS:
        one.emissions.emit(x, 0.0, z)
    one_ev, _ = _once(one.step)
    mg, og = mctx._published, one._published
    for k in mg.keys() - {"listener", "pressure"}:
        np.testing.assert_array_equal(mg[k], og[k], err_msg=k)
    _require(all(mctx.get_output(e).valid for e in meids), "mesh outputs")
    mir = mctx.get_impulse_response(lx + 2 * p.dx, lz)
    np.testing.assert_array_equal(
        mir, one.get_impulse_response(lx + 2 * p.dx, lz))
    del one
    print(f"phase 13 main path Context(mesh=2x2 of cuda:0, halo "
          f"{mctx._halo}) {shape}: launches {m_launches} (calibration + "
          f"{STEPS} steps); step median {statistics.median(mev):.3f} ms "
          f"(CUDA events), {statistics.median(mwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in mev)
          + f" ms; single-device step {one_ev:.3f} ms; published grids and "
          f"impulse response equal the single-device Context's ({label})",
          flush=True)
    b5_launches = m_launches["sharded_round"]
    del mctx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fdtd_fused.reset_launch_counts()
    xm = pv.Context(xcfg, scene=pv.demo_scene("HugeRoom"), publish="cells",
                    mesh=mesh4)
    xm.set_listener_position(xl_lx, 0.0, xl_lz)
    xmeids = [xm.emissions.emit(x, 0.0, z) for x, z in XL_EMITTERS]
    xmev, xmwall = zip(*(_once(xm.step) for _ in range(XL_STEPS)))
    xm_launches = {k: f.launches for k, f in (
        ("fdtd_sim", fdtd_fused.fdtd_sim),
        ("rt60_moments", fdtd_fused.rt60_moments),
        ("sharded_round", solver_fused.sharded_round),
        ("banded_round", solver_fused.banded_round),
        ("fdtd_sim_tiled", fdtd_tiled.fdtd_sim_tiled),
        ("rt60_moments_tiled", fdtd_tiled.rt60_moments_tiled))}
    xrounds = -(-xp.response_length // xm._halo)
    _require(xm_launches == {"fdtd_sim": 1, "rt60_moments": 0,
                             "sharded_round": 0,
                             "banded_round": 4 * xrounds * XL_STEPS,
                             "fdtd_sim_tiled": 0,
                             "rt60_moments_tiled": 4 * XL_STEPS},
             xm_launches)
    xm_peak = torch.cuda.max_memory_allocated() / 1e9
    xm_cells = xm._published["cells"]
    _require(xm_cells.keys() == xl_rows.keys(), sorted(xm_cells))
    for cell, row in xm_cells.items():
        np.testing.assert_array_equal(row, xl_rows[cell],
                                      err_msg=f"cell {cell}")
    _require(all(xm.get_output(e).valid for e in xmeids), "126 m outputs")
    print(f"phase 13 large world Context({XL:g} m, publish='cells', mesh="
          f"2x2 of cuda:0, halo {xm._halo}) {xshape}: launches "
          f"{xm_launches} (calibration + {XL_STEPS} steps); step median "
          f"{statistics.median(xmev):.3f} ms (CUDA events), "
          f"{statistics.median(xmwall):.3f} ms (wall), steps "
          + ", ".join(f"{v:.3f}" for v in xmev)
          + f" ms; peak device memory {xm_peak:.2f} GB; emitter rows equal "
          f"phase 9's ({label})", flush=True)
    b6_launches = xm_launches["banded_round"]
    del xm
    torch.cuda.empty_cache()
    print(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")

    b3_err = max(v[1] for r in b3.values() for v in r["vs_plain"].values())
    b4_xl = b4[xshape]
    b3_large = next(r for r in b3.values() if "plain_ms" in r)
    print(json.dumps({"kernels": [
        {"name": "fdtd_sim", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/fdtd_fused.cu",
         "replaces": "planeverb_tpu/ops/fdtd_pallas.py:104",
         "launches": launches["fdtd_sim"],
         "max_abs_err": max(v[1] for v in b1.values()),
         "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "rt60_moments", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/fdtd_fused.cu",
         "replaces": "planeverb_tpu/ops/fdtd_pallas.py:246",
         "launches": launches["rt60_moments"],
         "max_abs_err": max(v[1] for v in b2.values()),
         "ms": b2_ms, "plain_ms": b2_plain_ms},
        {"name": "fdtd_sim_tiled", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/fdtd_tiled.cu",
         "replaces": "planeverb_tpu/ops/fdtd_tiled.py:54",
         "launches": xl_launches["fdtd_sim_tiled"],
         "max_abs_err": b3_err,
         "ms": b3_large["ms"], "plain_ms": b3_large["plain_ms"]},
        {"name": "rt60_moments_tiled", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/fdtd_tiled.cu",
         "replaces": "planeverb_tpu/ops/fdtd_tiled.py:382",
         "launches": xl_launches["rt60_moments_tiled"],
         "max_abs_err": max(v[1] for v in b4_xl["vs_plain"].values()),
         "ms": b4_xl["ms"], "plain_ms": b4_xl["plain_ms"]},
        {"name": "sharded_round", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/solver_rounds.cu",
         "replaces": "planeverb_tpu/parallel/solver_pallas.py:76",
         "launches": b5_launches,
         "max_abs_err": max(v[1] for r in b5.values()
                            for v in r["vs_plain"].values()),
         "ms": b5[SHARDED_MESHES[0]]["ms"],
         "plain_ms": b5[SHARDED_MESHES[0]]["plain_ms"]},
        {"name": "banded_round", "route": "cuda",
         "source": "planeverb_tpu_torch/csrc/solver_rounds.cu",
         "replaces": "planeverb_tpu/parallel/solver_pallas.py:221",
         "launches": b6_launches,
         "max_abs_err": max(v[1] for v in b6_vs_plain.values()),
         "ms": b6["ms"], "plain_ms": b6["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
