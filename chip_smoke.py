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
     grids held to the card's at the golden-scene tolerances.

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


def _time_pair(kernel_fn, plain_fn, reps):
    """CUDA-event medians (ms) of kernel_fn and plain_fn, taken in turns
    (plain, kernel, kernel, plain, ...) after one warm-up call each."""
    import torch

    def once(fn):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1)

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    ks, ps = [], []
    for r in range(reps):
        order = (plain_fn, kernel_fn) if r % 2 == 0 else (kernel_fn, plain_fn)
        for fn in order:
            (ks if fn is kernel_fn else ps).append(once(fn))
    return statistics.median(ks), statistics.median(ps)


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
    from planeverb_tpu_torch.ops import fdtd_fused, voxelize

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
    onset_equal = torch.equal(kres.onset, rres.onset)
    b1 = {}
    for name, a, b in (("rec", kres.pressure, rres.pressure),
                       ("fx", kres.flux_x, rres.flux_x),
                       ("fy", kres.flux_y, rres.flux_y),
                       ("e_dry", kacc[0], racc[0]),
                       ("e_wet", kacc[1], racc[1]),
                       ("e_total", kacc[2], racc[2])):
        b1[name] = _rel(a, b)
    b1_bits = all(torch.equal(a, b) for a, b in (
        (kres.pressure, rres.pressure), (kres.flux_x, rres.flux_x),
        (kres.flux_y, rres.flux_y), *zip(kacc, racc)))
    _require(onset_equal, "B1 onset differs from the plain version")
    for name, (rel, _) in b1.items():
        _require(rel <= REL_TOL, f"B1 {name}: rel {rel} > {REL_TOL}")
    _require(torch.isfinite(kres.pressure).all(), "B1 recording not finite")
    b1_ms, b1_plain_ms = _time_pair(
        lambda: fdtd_fused.fdtd_sim(p, beta, refl, pulse, lix, liy),
        lambda: fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, lix,
                                              liy), reps=4)
    print(f"phase 3 B1 fdtd_sim {shape}: max rel diff "
          + ", ".join(f"{k} {v[0]:.3g}" for k, v in b1.items())
          + f" (bound {REL_TOL:g}); onset equal {onset_equal}; bit-equal "
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
    ev_ms, wall_ms = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        ctx.step()
        ev1.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(ev0.elapsed_time(ev1))
    launches = {"fdtd_sim": fdtd_fused.fdtd_sim.launches,
                "rt60_moments": fdtd_fused.rt60_moments.launches}
    _require(launches == {"fdtd_sim": 1 + STEPS, "rt60_moments": STEPS},
             launches)
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
