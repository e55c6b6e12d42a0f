#!/usr/bin/env python3
"""The DSP's kernels and the audio callback, timed through their wrappers
on one CUDA card, for comparing two trees of the port in turns.

    python3 probe_dsp.py [--root DIR] [--reps N] [--player] [--profile]

Imports ``planeverb_tpu_torch`` from DIR (default: the directory of this
script), so the same script times another commit unpacked with ``git
archive`` into DIR; run the trees in turns in one call (A, B, B, A) to
compare them on one card. Prints one JSON line: the card's name and power
limit (``nvidia-smi``), the root, and, from inputs made from a fixed seed:

  - D1 ``lowpass.process_scan`` at 256 sources x 512 samples and D2
    ``reverb.reverb_scan_many`` over ``mix_output``'s six rows x 512 at
    44.1 kHz: device ms (CUDA-event medians, each call queued behind a
    sleep kernel so its host enqueue is hidden) and ms a call (from an idle
    device to the call's end), with a SHA-256 of each output, which two
    trees whose kernels are bit-equal share; with ``--profile``, D2's
    host time a call by function (cProfile);
  - with ``--player``: ``RealtimePlayer(native=False)`` over 2 s of a tone
    at 44.1 kHz in 512-frame blocks on the 25 m HugeRoom Context at 750 Hz
    (``chip_smoke.py``'s headline), unpaced, with the engine idle and then
    stepping in the background: mean, median and max block ms, the median
    ms of a block's device part (from the DSP's buses to the mix on the
    host: the copies, ``mix_output`` with D2, the wait), the blocks over
    the 11.61 ms budget, and the max of the player's per-block wait on its
    DSP stream where the tree's player records it.

It imports neither jax nor planeverb_tpu, and needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

RATE = 44100
FRAMES = 512
SOURCES = 256
SECONDS = 2.0
SLEEP_CYCLES = 5_000_000


def _device_ms(fn, reps):
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times)


def _call_ms(fn, reps):
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times)


def _sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _kernels(reps, profile=False):
    import numpy as np
    import torch

    from planeverb_tpu_torch.dsp import lowpass, reverb

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((SOURCES, FRAMES))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.standard_normal((2, SOURCES)) * 0.1)
                         .astype(np.float32)).to(dev)
    cut = torch.from_numpy(np.geomspace(20.0, 20000.0, SOURCES)
                           .astype(np.float32)).to(dev)

    def d1():
        return lowpass.process_scan(x, y[0], y[1], cut, RATE)

    jobs = []
    for i, rt60 in enumerate((0.5, 1.0, 3.0)):
        p = reverb.reverb_params(rt60, RATE)
        lc, la = max(p.comb_delays), max(p.allpass_delays)
        st = reverb.ReverbState(*(
            torch.from_numpy((rng.standard_normal(shape) * 0.1)
                             .astype(np.float32)).to(dev)
            for shape in ((2, 4, lc), (2, 4), (2, 2, la))),
            torch.tensor(1000 * i, dtype=torch.int32, device=dev))
        xb = torch.from_numpy((rng.standard_normal((2, FRAMES)) * 0.3)
                              .astype(np.float32)).to(dev)
        jobs.append((xb, st, p))

    def d2():
        return reverb.reverb_scan_many(jobs)

    d1_out = d1()
    d2_out = d2()
    torch.cuda.synchronize()
    res = {
        "d1_device_ms": _device_ms(d1, reps), "d1_call_ms": _call_ms(d1, reps),
        "d1_sha": _sha(*d1_out),
        "d2_device_ms": _device_ms(d2, reps), "d2_call_ms": _call_ms(d2, reps),
        "d2_sha": _sha(*(t for wet, st in d2_out for t in (wet, *st))),
    }
    if profile:
        res["d2_host_profile"] = _profile(d2, reps)
    return res


def _profile(fn, reps):
    """[function, its own host us a call, calls a call] of fn's ten
    costliest functions under cProfile over 10 x reps calls."""
    import cProfile
    import pstats

    calls = 10 * reps
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{os.path.basename(k[0])}:{k[1]}({k[2]})", v[2], v[1])
                   for k, v in stats.items()), key=lambda r: -r[1])
    return [[name, tt / calls * 1e6, n / calls] for name, tt, n in rows[:10]]


def _player():
    import numpy as np
    import torch

    import planeverb_tpu_torch as pv
    from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer

    ctx = pv.Context(pv.PlaneverbConfig(25.0, 25.0, 750),
                     scene=pv.demo_scene("HugeRoom"), device="cuda")
    ctx.set_listener_position(12.5, 0.0, 12.5)
    eid = ctx.emissions.emit(15.0, 0.0, 12.5)
    ctx.step()
    t = np.arange(int(SECONDS * RATE)) / RATE
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    RealtimePlayer(ctx, eid, tone[:FRAMES], RATE, frames=FRAMES,
                   native=False).run(realtime=False)
    budget = FRAMES / RATE * 1e3
    out = {}
    for mode in ("idle", "stepping"):
        if mode == "stepping":
            ctx.start()
        player = RealtimePlayer(ctx, eid, tone, RATE, frames=FRAMES,
                                native=False)
        block_ms, mix_ms, marks = [], [], []

        def get_output(get=player.dsp.get_output, marks=marks):
            out = get()
            marks.append(time.perf_counter())
            return out

        def timed(block, process=player.process_block, block_ms=block_ms,
                  mix_ms=mix_ms, marks=marks):
            t0 = time.perf_counter()
            res = process(block)
            t1 = time.perf_counter()
            block_ms.append((t1 - t0) * 1e3)
            mix_ms.append((t1 - marks[-1]) * 1e3)
            return res

        player.dsp.get_output = get_output
        player.process_block = timed
        it0 = ctx.iteration
        rep = player.run(realtime=False)
        if mode == "stepping":
            ctx.stop()
            if ctx.error is not None:
                raise RuntimeError(f"background loop: {ctx.error}")
        torch.cuda.synchronize()
        waits = getattr(player, "copy_wait_ms", None)
        out[mode] = {"mean_ms": rep.mean_process_ms,
                     "median_ms": statistics.median(block_ms),
                     "mix_median_ms": statistics.median(mix_ms),
                     "max_ms": rep.max_process_ms,
                     "over": sum(ms > budget for ms in block_ms),
                     "blocks": rep.blocks, "steps": ctx.iteration - it0,
                     "max_wait_ms": max(waits) if waits else None}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--player", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="add D2's host profile (cProfile) to the line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "planeverb_tpu_torch")):
        print(f"probe_dsp: no planeverb_tpu_torch in {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("probe_dsp: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from planeverb_tpu_torch import kernels

    kernels.library()          # the build, before any timing
    res = {"card": card, "root": root,
           **_kernels(args.reps, args.profile)}
    if args.player:
        res["player"] = _player()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
