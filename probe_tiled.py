#!/usr/bin/env python3
"""Sweeps behind the large-world route's constants, on one CUDA card.

    python3 probe_tiled.py [--reps N] [--sizes 25,60,126] [--b3-only]
                           [--out build/probe_tiled.json]

For HugeRoom at 750 Hz, listener at the center, at 25, 60 and 126 m (192^2,
459^2 and 964^2 solver cells) it prints, as CUDA-event medians beside the
card's ``nvidia-smi`` name and power limit:

  - B3 ``fdtd_sim_tiled`` at every round plan of ``fdtd_tiled.PLANS``
    (tile, k), its one cooperative launch with the accumulators where the
    kernel puts them (``fdtd_tiled.fdtd_sim_tiled_probe``), each held
    bit-equal to B1's plain version, with the time of the same pass with
    0-step rounds (the windows' loads, fold and write-back alone); for the
    fastest plan and 20 x 52 at k = 6 also with the accumulators forced to
    global memory. Then the fit of ``fdtd_tiled.C_ROUND`` (a round's fixed
    cost in window cells, from the 0-step rounds) and ``C_STEP`` (a
    window's step, from the rest of the full passes), and at each size the
    plan ``fdtd_tiled.plan_tiled`` picks beside the fastest measured: the
    measurement behind ``PLANS``, ``C_ROUND``, ``C_STEP`` and
    ``plan_tiled``;
  - B4 ``rt60_moments_tiled`` for each chunk of CHUNKS against B2
    ``rt60_moments`` on B3's recording, timed in turns, each bit-equal to
    B2, with GB/s over the recording: the measurement behind
    ``fdtd_tiled.CHUNK`` (left out with ``--b3-only``).

``chip_smoke.py`` phase 10 measures the route's crossover (B1 + B2 against
B3 + B4) behind ``fdtd_fused.TILED_MIN_CELLS``. The results also go to the
JSON file named by ``--out``. It imports neither jax nor planeverb_tpu.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SIZES = (25.0, 60.0, 126.0)
# B4's reverse chunks; 4096 > T is one chunk, B2's walk
CHUNKS = (8, 32, 128, 4096)
# the plan B3 kept before plans were chosen by field shape
OLD_PLAN = (20, 52, 6)


def _ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1)


def _in_turns(fns: dict, reps: int) -> dict:
    """CUDA-event median (ms) of each named call, after one warm-up call
    each, the order rotated every rep."""
    names = list(fns)
    for name in names:
        fns[name]()
    times = {name: [] for name in names}
    for r in range(reps):
        for i in range(len(names)):
            name = names[(r + i) % len(names)]
            times[name].append(_ms(fns[name]))
    return {name: statistics.median(v) for name, v in times.items()}


def fit_plan_model(rows) -> dict:
    """``fdtd_tiled.C_ROUND`` and ``C_STEP`` from the sweep's rows (each
    with ``rounds``, ``busiest``, ``cells``, ``T``, ``full_ms`` and
    ``dry_ms``). A pass of 0-step rounds takes rounds x (a x busiest x
    cells + c) ms: a and c by least squares over every row, each row
    weighed by its time (relative errors). The rest of a full pass is its
    steps, busiest x T x g ms: g the same way, through the origin. In
    window cells (a): C_ROUND = c / a, C_STEP = g / a."""
    def lstsq(xs, ys):
        # weighted normal equations of ys ~ xs @ coef, weights 1 / ys
        n = len(xs[0])
        m = [[sum(x[i] * x[j] / y ** 2 for x, y in zip(xs, ys))
              for j in range(n)] for i in range(n)]
        v = [sum(x[i] / y for x, y in zip(xs, ys)) for i in range(n)]
        if n == 1:
            return [v[0] / m[0][0]]
        det = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        return [(v[0] * m[1][1] - v[1] * m[0][1]) / det,
                (m[0][0] * v[1] - m[1][0] * v[0]) / det]

    a, c = lstsq([(r["rounds"] * r["busiest"] * r["cells"], r["rounds"])
                  for r in rows], [r["dry_ms"] for r in rows])
    (g,) = lstsq([(r["busiest"] * r["T"],) for r in rows],
                 [r["full_ms"] - r["dry_ms"] for r in rows])
    return {"rows": len(rows), "cell_ms": a, "round_ms": c, "step_ms": g,
            "c_round": c / a, "c_step": g / a}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sizes", default=",".join(f"{s:g}" for s in SIZES))
    ap.add_argument("--b3-only", action="store_true")
    ap.add_argument("--out", default="build/probe_tiled.json")
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("probe_tiled: no CUDA device", file=sys.stderr)
        return 1

    import planeverb_tpu_torch as pv
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import fdtd_fused, fdtd_tiled, voxelize

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    props = torch.cuda.get_device_properties(0)
    n_sm, optin = props.multi_processor_count, \
        props.shared_memory_per_block_optin
    print(f"SMs {n_sm}, shared memory a block may opt into {optin} B, "
          f"{len(fdtd_tiled.PLANS)} plans", flush=True)
    dev = torch.device("cuda")
    boxes = torch.from_numpy(voxelize.boxes_to_array(
        pv.demo_scene("HugeRoom").boxes)).to(dev)
    results = {"card": card, "reps": args.reps, "n_sm": n_sm,
               "smem_optin": optin, "sizes": []}
    for size in map(float, args.sizes.split(",")):
        p = pv.compute_grid_params(pv.PlaneverbConfig(size, size, 750))
        beta, refl = voxelize.voxelize(p, boxes)
        pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
        lix, liy = p.world_to_cell(size / 2, size / 2)
        nx, ny, T = p.nx, p.ny, p.response_length
        shape = f"{nx}x{ny}x{T}"
        row = {"shape": shape, "nx": nx, "ny": ny, "T": T, "b3": [],
               "b4_ms": {}}

        # -- B3 at every plan, each bit-equal to B1's plain version; full
        # passes and passes of 0-step rounds timed in turns
        ref = fdtd_fused.fdtd_sim_reference(p, beta, refl, pulse, lix, liy)
        first = (*ref[0], *ref[1])
        del ref

        def b3(plan, dry=False, global_acc=False):
            return fdtd_tiled.fdtd_sim_tiled_probe(
                p, beta, refl, pulse, lix, liy, plan[:2], plan[2], dry=dry,
                global_acc=global_acc)

        def equal(plan, global_acc=False):
            res, acc = b3(plan, global_acc=global_acc)
            torch.cuda.synchronize()
            if not all(map(torch.equal, (*res, *acc), first)):
                raise RuntimeError(f"B3 {plan} global_acc={global_acc} "
                                   f"differs from B1's plain version at "
                                   f"{shape}")

        for plan in fdtd_tiled.PLANS:
            equal(plan)
            ms = _in_turns({"full": lambda: b3(plan),
                            "dry": lambda: b3(plan, dry=True)}, args.reps)
            lanes, runs = fdtd_tiled.block_shape(*plan)
            windows = -(-nx // plan[0]) * -(-ny // plan[1])
            entry = {"plan": list(plan), "lanes": lanes, "runs": runs,
                     "cells": lanes * runs * fdtd_tiled.RUN,
                     "windows": windows, "busiest": -(-windows // n_sm),
                     "rounds": -(-T // plan[2]),
                     "shared_acc": fdtd_tiled.acc_fits(nx, ny, plan, n_sm,
                                                       optin),
                     "full_ms": ms["full"], "dry_ms": ms["dry"]}
            row["b3"].append(entry)
            print(f"{shape} B3 {plan[0]}x{plan[1]} k={plan[2]} "
                  f"({runs * fdtd_tiled.RUN} x {lanes} window, busiest SM "
                  f"{entry['busiest']} of {windows}, accumulators "
                  f"{'shared' if entry['shared_acc'] else 'global'}): "
                  f"{ms['full']:.3f} ms, 0-step rounds {ms['dry']:.3f} ms, "
                  f"bit-equal", flush=True)
        fastest = min(row["b3"], key=lambda e: e["full_ms"])
        for plan in {tuple(fastest["plan"]), OLD_PLAN}:
            equal(plan, global_acc=True)
            ms = _in_turns({"auto": lambda: b3(plan),
                            "global": lambda: b3(plan, global_acc=True)},
                           args.reps)
            row.setdefault("global_acc_ms", {})[str(plan)] = ms
            print(f"{shape} B3 {plan} accumulators where the kernel puts "
                  f"them {ms['auto']:.3f} ms, in global memory "
                  f"{ms['global']:.3f} ms, bit-equal", flush=True)
        rec, onset = first[0], first[1]
        del first

        # -- B4 chunks against B2, in turns, each bit-equal to B2
        if not args.b3_only:
            s2 = fdtd_fused.rt60_moments(p, rec, onset)
            fns = {"b2": lambda: fdtd_fused.rt60_moments(p, rec, onset)}
            for chunk in CHUNKS:
                s4 = fdtd_tiled.rt60_moments_tiled(p, rec, onset, chunk)
                if not all(map(torch.equal, s4, s2)):
                    raise RuntimeError(f"B4 chunk {chunk} differs from B2 "
                                       f"at {shape}")
                fns[f"b4 chunk {chunk}"] = (
                    lambda chunk=chunk: fdtd_tiled.rt60_moments_tiled(
                        p, rec, onset, chunk))
            gb = rec.numel() * 4 / 1e9
            for name, ms in _in_turns(fns, args.reps).items():
                row["b4_ms"][name] = ms
                print(f"{shape} {name}: {ms:.3f} ms ({gb / ms * 1e3:.1f} "
                      f"GB/s over the {gb:.2f} GB recording)", flush=True)
            del s2, fns
        results["sizes"].append(row)
        del rec, onset
        torch.cuda.empty_cache()

    # -- the plan model's fit, and each size's pick beside the fastest
    # measured
    fit = fit_plan_model([dict(e, T=row["T"]) for row in results["sizes"]
                          for e in row["b3"]])
    results["plan_model_fit"] = fit
    print(f"plan model fit over {fit['rows']} passes: a window cell's "
          f"round {fit['cell_ms'] * 1e9:.3f} ps and a round "
          f"{fit['round_ms'] * 1e3:.3f} us (0-step rounds), a window's step "
          f"{fit['step_ms'] * 1e3:.4f} us: C_ROUND = {fit['c_round']:.1f}, "
          f"C_STEP = {fit['c_step']:.1f} window cells (committed "
          f"{fdtd_tiled.C_ROUND}, {fdtd_tiled.C_STEP})", flush=True)
    for row in results["sizes"]:
        nx, ny, T = row["nx"], row["ny"], row["T"]
        pick = fdtd_tiled.plan_tiled(nx, ny, T, n_sm, optin)
        times = {tuple(e["plan"]): e["full_ms"] for e in row["b3"]}
        best = min(times, key=times.get)
        row["pick"], row["fastest"] = list(pick), list(best)
        print(f"{row['shape']} plan_tiled picks {pick}: {times[pick]:.3f} "
              f"ms; fastest measured {best}: {times[best]:.3f} ms "
              f"({times[pick] / times[best] - 1:+.1%}); {OLD_PLAN}: "
              f"{times[OLD_PLAN]:.3f} ms", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
