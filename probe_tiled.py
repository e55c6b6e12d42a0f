#!/usr/bin/env python3
"""Sweeps behind the large-world route's constants, on one CUDA card.

    python3 probe_tiled.py [--reps N] [--out build/probe_tiled.json]

For HugeRoom at 750 Hz, listener at the center, at 25, 34, 60 and 126 m
(192^2, 261^2, 459^2 and 964^2 solver cells) it prints, as CUDA-event
medians beside the card's ``nvidia-smi`` name and power limit:

  - B3 ``fdtd_sim_tiled`` for each tiling of TILINGS (interior tile, halo),
    each held bit-equal to the first, and the tile ``pick_tile`` chooses:
    the measurement behind ``fdtd_tiled.TILES``, ``HALO`` and
    ``pick_tile``;
  - B4 ``rt60_moments_tiled`` for each chunk of CHUNKS against B2
    ``rt60_moments`` on B3's recording, timed in turns, each bit-equal to
    B2, with GB/s over the recording: the measurement behind
    ``fdtd_tiled.CHUNK``.

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

SIZES = (25.0, 34.0, 60.0, 126.0)
# (interior tile, halo = steps per launch)
TILINGS = (((32, 64), 8), ((32, 32), 8), ((48, 48), 8), ((64, 32), 8),
           ((32, 32), 6), ((32, 32), 4), ((32, 32), 16), ((24, 24), 4))
# B4's reverse chunks; 4096 > T is one chunk, B2's walk
CHUNKS = (8, 32, 128, 4096)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
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
    print(f"card: {card}", flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    boxes = torch.from_numpy(voxelize.boxes_to_array(
        pv.demo_scene("HugeRoom").boxes)).to(dev)
    results = {"card": card, "reps": args.reps, "sizes": []}
    for size in SIZES:
        p = pv.compute_grid_params(pv.PlaneverbConfig(size, size, 750))
        beta, refl = voxelize.voxelize(p, boxes)
        pulse = torch.from_numpy(gaussian_pulse(p)).to(dev)
        lix, liy = p.world_to_cell(size / 2, size / 2)
        shape = f"{p.nx}x{p.ny}x{p.response_length}"
        row = {"shape": shape, "pick_tile": fdtd_tiled.pick_tile(
            p.nx, p.ny, fdtd_tiled.HALO, n_sm), "b3_ms": {}, "b4_ms": {}}

        # -- B3 tilings, each bit-equal to the first
        first = None
        for tile, halo in TILINGS:
            def b3(tile=tile, halo=halo):
                return fdtd_tiled.fdtd_sim_tiled(p, beta, refl, pulse, lix,
                                                 liy, tile=tile, halo=halo)
            res, acc = b3()
            torch.cuda.synchronize()
            flat = (*res, *acc)
            if first is None:
                first = flat
            elif not all(map(torch.equal, flat, first)):
                raise RuntimeError(f"B3 {tile} k={halo} differs at {shape}")
            del res, acc, flat
            ms = _in_turns({"b3": b3}, args.reps)["b3"]
            key = f"{tile[0]}x{tile[1]} k={halo}"
            row["b3_ms"][key] = ms
            print(f"{shape} B3 {key}: {ms:.3f} ms", flush=True)
        rec, onset = first[0], first[1]
        del first

        # -- B4 chunks against B2, in turns, each bit-equal to B2
        s2 = fdtd_fused.rt60_moments(p, rec, onset)
        fns = {"b2": lambda: fdtd_fused.rt60_moments(p, rec, onset)}
        for chunk in CHUNKS:
            s4 = fdtd_tiled.rt60_moments_tiled(p, rec, onset, chunk)
            if not all(map(torch.equal, s4, s2)):
                raise RuntimeError(f"B4 chunk {chunk} differs from B2 at "
                                   f"{shape}")
            fns[f"b4 chunk {chunk}"] = (
                lambda chunk=chunk: fdtd_tiled.rt60_moments_tiled(
                    p, rec, onset, chunk))
        gb = rec.numel() * 4 / 1e9
        for name, ms in _in_turns(fns, args.reps).items():
            row["b4_ms"][name] = ms
            print(f"{shape} {name}: {ms:.3f} ms ({gb / ms * 1e3:.1f} GB/s "
                  f"over the {gb:.2f} GB recording)", flush=True)
        print(f"{shape} pick_tile: {row['pick_tile']}", flush=True)
        results["sizes"].append(row)
        del rec, onset, s2, fns
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
