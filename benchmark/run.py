"""Run one benchmark cell of ``planeverb_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The cell's
configuration, traffic, per-layer metrics and limits are found by the names
in ``BENCHMARK.json`` (``cells.py``). The run builds the cell's Context (set-up:
imports, kernel build on a checkout's first run, calibration, warm-up),
refreshes for ``--seconds`` (``drive.py``), then checks the refreshes drawn
from the seed against the plain reference (``reference.py``, ``check.py``)
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics; with ``--trace 1`` the per-layer ones,
read from a profiler trace of the window's first refreshes), ``device``
and, last, ``checks``: each number compared with its limit. The same
numbers end standard error.

A cell whose traffic has ``audio`` also runs the audio callback beside the
refreshes (``drive.AudioPump``), replays every block of it with the plain
DSP after the window (``reference_dsp.py``), and reports the blocks'
lateness and the replay under ``run.audio``.

``--control program-bf16`` runs the program's own bf16 state mode,
``--control reference-bf16`` puts the reference computed in bf16 in the
program's place, and ``--control audio-bf16`` puts the plain DSP computed in
bf16 in the audio callback's place: the controls the check has to fail
(``PERF.md``). The driver never passes them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "planeverb_tpu")
# refreshes the traced run profiles at most, from the window's start
TRACE_REFRESHES = 200


def _cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program's own kernels build into ``planeverb_tpu_torch/build/``."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("program-bf16", "reference-bf16",
                                         "audio-bf16"))
    return p.parse_args(argv)


def _power_limit() -> str | None:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def measure(args, cell, device: str, t_start: float) -> dict:
    """One run of ``cell``: set-up, window, check. Returns the result."""
    import torch

    from benchmark import check, drive, reference, scenes, tracing
    from benchmark import traffic as traffic_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    marks = {"imports": time.perf_counter() - t_start}
    config = cell.config
    params = cell.reference_params()
    grid = reference.grid(params["world_x"], params["world_y"],
                          params["resolution"], params["offset_x"],
                          params["offset_y"], params["absorbing"])
    scene = scenes.load(config["scene"])
    traffic = traffic_mod.make(grid, scene, cell.traffic, args.seed)
    marks["traffic"] = time.perf_counter() - t_start
    metrics = cell.metric_modules() if args.trace else {}
    wrapped = []
    if args.trace:
        spans: dict = {}
        for mod in metrics.values():
            for span, targets in mod.SPANS.items():
                spans.setdefault(span, [])
                spans[span] += [t for t in targets if t not in spans[span]]
        wrapped = tracing.wrap(spans)
    precision = ("bf16" if args.control == "program-bf16"
                 else config.get("precision", "f32"))
    audio = traffic.audio is not None
    program = drive.AudioProgram if audio else drive.Program
    prog = program(config, traffic, dev, precision, spans=bool(args.trace))
    marks["context"] = time.perf_counter() - t_start
    drive.warm(prog)
    marks["warm"] = time.perf_counter() - t_start
    pump = None
    if audio:
        pump = drive.AudioPump(prog, args.seconds)
        marks["audio"] = time.perf_counter() - t_start
    profiler = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # the profiler's own first start (CUPTI) belongs to set-up
        with profile(activities=acts):
            prog.refresh(traffic.listeners(0), traffic.door(0))
        profiler = profile(activities=acts)
    drive.prepare(traffic, args.seconds)
    # the set-up's objects leave the collector's generations: a full
    # collection in the window then walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if profiler is not None:
        profiler.start()
    win = drive.run_window(prog, args.seconds, args.seed,
                           profile_first=TRACE_REFRESHES, profiler=profiler,
                           pump=pump)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {', '.join(found)}; "
                         f"nothing it runs may import JAX or the JAX package")
    views = prog.views
    t_ref = time.perf_counter()
    worst, failed, n_failed = _check(args, cell, dev, win, traffic, views,
                                     prog.ctx._published.get("pressure"))
    ref_s = time.perf_counter() - t_ref
    attempted = len(win.latencies)
    if pump is not None:
        numbers, bad, report = _audio_check(args, prog, pump, cell.limits)
        worst.update(numbers)
        failed = check.judge([worst], cell.limits)[1]
        attempted += pump.blocks
        n_failed += bad
    result = {"correct": not failed, "attempted": attempted,
              "failed": n_failed}
    lat_ms = sorted(x * 1e3 for x in win.latencies)
    device_extra = {}
    if args.trace:
        info = {"cells": grid.nx * grid.ny, "steps": grid.steps,
                "views": views,
                "state_bytes": 2 if precision == "bf16" else 4,
                "refresh_ms_untraced": [x * 1e3 for x in
                                        win.latencies[TRACE_REFRESHES:]]}
        if pump is not None:
            # the blocks that started and ended inside the traced window
            rec = pump.rec
            inside = rec.end <= win.traced_until
            info["audio_block_ms"] = (
                (rec.end - rec.start)[inside] * 1e3).tolist()
        result["metrics"], device_extra, result["breakdown"] = _per_layer(
            profiler, info, metrics)
    else:
        result["metrics"] = _end_to_end(cell, win, lat_ms, setup_s, pump)
    result["device"] = _device(dev, cell.chips, win.memory_peak)
    result["device"].update(device_extra)
    result["card"] = {"power_limit": _power_limit() if dev.type == "cuda"
                      else None, "torch": torch.__version__,
                      "cuda": torch.version.cuda}
    result["run"] = {"setup_s": setup_s, "setup_marks_s": marks,
                     "window_s": win.seconds,
                     "reference_s": ref_s,
                     "checked": [s["index"] for s in win.samples],
                     "refresh_ms_median": statistics.median(lat_ms),
                     "refresh_ms_p95": _p95(lat_ms),
                     "per_second": _per_second(win.ends),
                     "host_cpu_ms_per_refresh":
                         win.main_thread_cpu_s * 1e3 / len(win.latencies)}
    if pump is not None:
        result["run"]["audio"] = report
    result["checks"] = {k: {"value": worst[k], "limit": cell.limits.get(k)}
                        for k in sorted(worst)}
    tracing.unwrap(wrapped)
    return result


def _check(args, cell, dev, win, traffic, views: int, last_rec):
    """The comparison after the window: each refresh kept, worked out again
    by the reference on the same device, then judged against the cell's
    limits. Returns (the widest of each number, the numbers over their
    limits, the refreshes found wrong)."""
    import torch

    from benchmark import check, reference

    params = cell.reference_params()
    ref = reference.Reference(params, dev)
    control = (reference.Reference(params, dev, torch.bfloat16)
               if args.control == "reference-bf16" else None)
    numbers = []
    last_index = win.samples[-1]["index"]
    for s in win.samples:
        keep = s["index"] == last_index and views == 1
        want = ref.refresh(s["boxes"], s["listeners"], traffic.emitters,
                           keep_recording=keep)
        if control is not None:
            got = control.refresh(s["boxes"], s["listeners"],
                                  traffic.emitters, keep_recording=keep)
            s = _as_program(got, s)
            if keep:
                last_rec = got["recording"][0]
        n = check.compare(s, want, views)
        if keep and last_rec is not None:
            n["recording_gap"] = check.recording_gap(last_rec,
                                                     want["recording"][0])
        numbers.append(n)
        del want
    worst, failed = check.judge(numbers, cell.limits)
    n_failed = sum(1 for n in numbers if check.judge([n], cell.limits)[1])
    return worst, failed, n_failed


def _audio_check(args, prog, pump, limits: dict):
    """Every block of the audio callback, after the window: its inputs
    against the refresh loop's rows, its mix against the plain DSP's replay
    (``--control audio-bf16``: the replay in bf16 in the program's place).
    Returns (the two numbers, the blocks found wrong, ``run.audio``)."""
    import numpy as np

    from benchmark import check, drive, reference_dsp

    t0 = time.perf_counter()
    rec, fed, traffic = pump.rec, pump.dsp, prog.traffic
    n, voices = pump.blocks, prog.voices
    inputs = check.audio_inputs(
        fed.rows, fed.fed, rec.offsets, rec.start, rec.end, prog.starts,
        prog.ends, np.stack(prog.rows), [len(c) for c in traffic.clips],
        pump.frames)
    fx, _, fz = drive.VOICE_FORWARD
    replay = (reference_dsp.Stream.of(traffic.audio), traffic.clips,
              [float(np.float32(10.0 ** (drive.VOICE_DB / 20.0)))] * voices,
              traffic.emitters[:voices], [(fx, fz)] * voices,
              [drive.VOICE_PATTERN] * voices, inputs["rows"],
              np.ones((n, voices), bool), fed.listener)
    want = reference_dsp.replay(*replay)
    got = (reference_dsp.replay(*replay, store=reference_dsp.bf16)
           if args.control == "audio-bf16" else rec.mix)
    gaps = check.audio_gap(got, want)
    ref_s = time.perf_counter() - t0
    numbers = {"audio_inputs_gap": float(inputs["gap"].sum()),
               "audio_gap": float(gaps.max())}
    bad = int((inputs["gap"] | ~(gaps <= limits.get("audio_gap", -1.0)))
              .sum())
    ms = (rec.end - rec.due) * 1e3
    late = ms > pump.period * 1e3
    cuts = statistics.quantiles(ms.tolist(), n=100, method="inclusive")
    report = {"blocks": n,
              "late_blocks": int(late.sum()),
              "late_per_second": np.bincount(
                  ((rec.due - rec.due[0])[late]).astype(int),
                  minlength=int(n * pump.period) + 1).tolist(),
              "block_ms_quantiles": {str(q): cuts[q - 1]
                                     for q in (75, 90, 95, 99)},
              "block_ms_max": float(ms.max()),
              "host_ms_per_block":
                  float((rec.end - rec.start).mean() * 1e3),
              "torn_blocks": int(inputs["torn"].sum()),
              "proxy_ms_per_block": pump.proxy_ms,
              "reference_s": ref_s}
    return numbers, bad, report


def _per_layer(profiler, info: dict, metrics: dict):
    """The per-layer metrics, the device's busy and window seconds, and the
    breakdown, from the profiler's trace of the window's first refreshes
    (written to a temporary file and read back)."""
    from benchmark import tracing

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.export_chrome_trace(path)
        trace = tracing.load(path)
    finally:
        os.remove(path)
    out = {}
    for name, mod in metrics.items():
        value = mod.read(trace, info)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    device = {"busy_s": trace.busy_us() * 1e-6,
              "window_s": trace.window_us * 1e-6}
    return out, device, tracing.breakdown(trace)


def _as_program(got: dict, sample: dict) -> dict:
    """The control: the bf16 reference's results in the program's place,
    published as the program publishes them."""
    from benchmark import check

    views = got["packed"].shape[0]
    packed = got["packed"]
    pub = dict(sample["published"])
    if "cells" in pub:
        pub["cells"] = {c: packed[:, c[0], c[1]].reshape(
            pub["cells"][c].shape) for c in pub["cells"]}
    else:
        g = packed if "listeners" in pub else packed[0]
        pub.update(occlusion=g[..., 0], wet_gain=g[..., 1], rt60=g[..., 2],
                   lowpass=g[..., 3], direction=g[..., 4:6],
                   source_directivity=g[..., 6:8], delay_samples=g[..., 8])
    outs = [[_output(r, v, check) for r in got["outputs"]]
            for v in range(views)]
    return {**sample, "published": pub, "outputs": outs,
            "beta": got["beta"], "refl": got["refl"]}


def _output(row, v, check):
    import types

    r = check.INVALID_ROW if row is None else row[v]
    vec = types.SimpleNamespace
    return vec(occlusion=r[0], wet_gain=r[1], rt60=r[2], lowpass=r[3],
               direction=vec(x=r[4], y=r[5]),
               source_directivity=vec(x=r[6], y=r[7]))


def _per_second(ends: list) -> list:
    """Refreshes that ended in each whole second of the window."""
    out = [0] * (int(max(ends)) + 1 if ends else 0)
    for e in ends:
        out[int(e)] += 1
    return out


def _p95(lat_ms: list) -> float:
    """The 95th percentile of every refresh's latency in the window."""
    return (statistics.quantiles(lat_ms, n=100, method="inclusive")[94]
            if len(lat_ms) > 1 else lat_ms[0])


def _end_to_end(cell, win, lat_ms, setup_s, pump=None) -> dict:
    values = {
        "refreshes_per_s": len(win.latencies) / win.seconds,
        "refresh_ms_p95": _p95(lat_ms),
        "device_mem_peak_gib": win.memory_peak / 2 ** 30,
        "setup_s": setup_s,
    }
    if pump is not None:
        rec = pump.rec
        values["audio_block_ms_p50"] = statistics.median(
            ((rec.end - rec.due) * 1e3).tolist())
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def _device(dev, chips: int, peak: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def main(argv=None, device: str = "cuda", root: str = ROOT,
         t_start: float = T_START, cell=None) -> int:
    """The command. ``device`` is ``"cuda"`` for every run of the benchmark;
    the CPU tests pass ``"cpu"`` (and a stand-in ``cell``) to drive the rest
    of a run on the plain versions."""
    args = parse(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import cells

    if cell is None:
        try:
            cell = cells.resolve(cells.load(root), args.workload, root)
        except (OSError, KeyError, ValueError) as e:
            print(f"benchmark: {args.workload}: {e}", file=sys.stderr)
            return 2
    if device == "cuda":
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    _cache_dirs(root)
    result = measure(args, cell, device, t_start)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
