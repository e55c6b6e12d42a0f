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
     on.

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
    """max |a - b| / max |b| over finite entries, and max |a - b|."""
    import torch

    fin = torch.isfinite(b)
    diff = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
    scale = b[fin].abs().max().item() if fin.any() else 0.0
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
