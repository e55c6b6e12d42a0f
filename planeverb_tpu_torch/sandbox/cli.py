"""Sandbox CLI — the reference's GLFW/ImGui editor as a batch tool.

Counterpart of ``planeverb_tpu/sandbox/cli.py``: the same subcommands,
arguments and output (``scale --project`` models the H100's constants).
The reference sandbox (PlaneverbSandbox/src/Editor/Editor.cpp) loads .pv
scenes, shows live acoustic parameters in dB, plots impulse responses, and
plays processed audio. This CLI exposes the same workflows headlessly:

  python -m planeverb_tpu_torch analyze SmallRoom --listener 5,5 --source 6.5,5
  python -m planeverb_tpu_torch ir     SmallRoom --listener 5,5 --source 6.5,5 -o ir.wav
  python -m planeverb_tpu_torch render SmallRoom --listener 5,5 --source 6.5,5 \
      --in voice.wav --out-dir out/
  python -m planeverb_tpu_torch sweep  -o sweep.csv
  python -m planeverb_tpu_torch grid   SmallRoom
  python -m planeverb_tpu_torch scale  HugeRoom --grid-size 25 --resolution 750 --solver fused
  python -m planeverb_tpu_torch scale  HugeRoom --grid-size 25 --resolution 750 --project
  python -m planeverb_tpu_torch scenes

Scene arguments accept either a .pv file path or a built-in demo scene name.
Every command that runs the engine runs it on ``--engine-device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). ``play --device`` keeps
its meaning: a live audio output device.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from planeverb_tpu_torch.config import (PlaneverbConfig, PlaneverbDSPConfig,
                                        Resolution)
from planeverb_tpu_torch.core.context import Context
from planeverb_tpu_torch.parallel.scaling import (
    ROUND_OVERHEAD_S, ROUND_RATE_CUPS, projected_efficiency,
    projected_weak_efficiency)
from planeverb_tpu_torch.scene import DEMO_SCENES, Scene, demo_scene, load_pv
from planeverb_tpu_torch.types import PlaneverbOutput

__all__ = ["main"]


def _load_scene(name: str | None) -> Scene | None:
    if not name or name == "empty":
        return None
    if os.path.exists(name):
        return load_pv(name)
    if name in DEMO_SCENES:
        return demo_scene(name)
    raise SystemExit(f"error: scene '{name}' is neither a .pv file nor one of "
                     f"{sorted(DEMO_SCENES)}")


def _xy(text: str) -> tuple[float, float]:
    try:
        a, b = text.split(",")
        return float(a), float(b)
    except ValueError:
        raise SystemExit(f"error: expected 'x,z' pair, got {text!r}")


def _config(args) -> PlaneverbConfig:
    return PlaneverbConfig(
        grid_size_x=args.grid_size, grid_size_y=args.grid_size,
        grid_resolution=args.resolution)


def _db(x: float) -> float:
    return 20.0 * math.log10(max(abs(x), 1e-10))


def _print_params(out: PlaneverbOutput) -> None:
    # dB readout like the editor's parameter window (Editor.cpp:396-434)
    if not out.valid:
        print("  <invalid: source outside grid or no simulation yet>")
        return
    print(f"  occlusion (dry gain): {out.occlusion:10.5f}  "
          f"({_db(out.occlusion):7.2f} dB)")
    print(f"  wet gain:             {out.wet_gain:10.5f}  "
          f"({_db(out.wet_gain):7.2f} dB)")
    print(f"  rt60:                 {out.rt60:10.5f}  s")
    print(f"  lowpass cutoff:       {out.lowpass:10.2f}  Hz")
    print(f"  direction:            ({out.direction.x:+.4f}, "
          f"{out.direction.y:+.4f})")
    print(f"  source directivity:   ({out.source_directivity.x:+.4f}, "
          f"{out.source_directivity.y:+.4f})")


def _run_context(args):
    ctx = Context(_config(args), scene=_load_scene(args.scene),
                  device=args.engine_device)
    lx, lz = _xy(args.listener)
    ctx.set_listener_position(lx, 0.0, lz)
    ctx.step()
    return ctx


def cmd_analyze(args) -> int:
    sources = [_xy(s) for s in args.source]  # fail fast, before the sim
    ctx = _run_context(args)
    for sx, sz in sources:
        print(f"source ({sx:g}, {sz:g}):")
        _print_params(ctx.result_at(sx, sz))
    return 0


def ascii_plot(y: np.ndarray, lo: float, hi: float, width: int = 72,
               height: int = 12, envelope: bool = False) -> str:
    """Render samples as an ASCII line plot (the editor's IR plot,
    Editor.cpp:449-477, without ImGui). Buckets columns by the sample of
    largest magnitude; with ``envelope`` by the maximum value instead —
    right for all-negative dB traces, where max-|value| would pick the
    noise floor and hide the decay envelope."""
    y = np.asarray(y, np.float64)
    n = len(y)
    cols = np.zeros(width)
    for c in range(width):
        seg = y[c * n // width:max(c * n // width + 1, (c + 1) * n // width)]
        if not len(seg):
            continue
        cols[c] = seg.max() if envelope else seg[np.argmax(np.abs(seg))]
    span = hi - lo or 1.0
    rows = np.clip(((cols - lo) / span * (height - 1)).round().astype(int),
                   0, height - 1)
    canvas = [[" "] * width for _ in range(height)]
    for c, r in enumerate(rows):
        canvas[height - 1 - r][c] = "*"
    return "\n".join("".join(row) for row in canvas)


def cmd_ir(args) -> int:
    from planeverb_tpu_torch.sandbox.wav import write_wav

    sx, sz = _xy(args.source[0])  # fail fast, before the sim
    ctx = _run_context(args)
    ir = ctx.get_impulse_response(sx, sz)
    if ir.size == 0:
        raise SystemExit(f"error: source ({sx}, {sz}) is outside the grid")
    if args.plot:
        peak = float(np.abs(ir).max()) or 1.0
        print(f"impulse response, linear [{-peak:.3g}, {peak:.3g}]:")
        print(ascii_plot(ir, -peak, peak))
        db = 20.0 * np.log10(np.maximum(np.abs(ir) / peak, 1e-6))
        print("impulse response, dB [-120, 0]:")
        print(ascii_plot(db, -120.0, 0.0, envelope=True))
    if args.output.endswith(".csv"):
        with open(args.output, "w") as f:
            f.write("sample,pressure\n")
            for i, v in enumerate(ir):
                f.write(f"{i},{v:.8g}\n")
    else:
        peak = float(np.abs(ir).max()) or 1.0
        write_wav(args.output, ir / peak, ctx.params.fs, float32=True)
    print(f"wrote {len(ir)}-sample IR (fs={ctx.params.fs} Hz) to {args.output}")
    return 0


def cmd_render(args) -> int:
    from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav

    if args.native:
        from planeverb_tpu_torch.native import NativeDSPContext as DSP
    else:
        from planeverb_tpu_torch.dsp import DSPContext as DSP

    sx, sz = _xy(args.source[0])  # fail fast, before the sim
    lx, lz = _xy(args.listener)
    ctx = _run_context(args)
    out = ctx.result_at(sx, sz)
    if not out.valid:
        raise SystemExit("error: source position has no valid parameters")

    audio, rate = read_wav(args.infile)
    if audio.ndim == 1:
        audio = np.stack([audio, audio], axis=-1)
    block = args.block
    dsp_cfg = PlaneverbDSPConfig(max_callback_length=block, sampling_rate=rate)
    dsp = DSP(dsp_cfg)
    dsp.set_listener_transform((lx, 0.0, lz), (1.0, 0.0, 0.0))
    fwd = (lx - sx, lz - sz)
    norm = math.hypot(*fwd) or 1.0
    dsp.update_emitter(0, (sx, 0.0, sz), (fwd[0] / norm, 0.0, fwd[1] / norm))

    n = len(audio)
    buses = [np.zeros((n, 2), np.float32) for _ in range(4)]
    for start in range(0, n, block):
        chunk = audio[start:start + block]
        dsp.submit_source(0, out, chunk)
        rendered = dsp.get_output()
        m = len(chunk)
        for bus, ren in zip(buses, rendered):
            bus[start:start + m] = ren[:m]

    os.makedirs(args.out_dir, exist_ok=True)
    names = ["dry", "wet_a_0.5s", "wet_b_1.0s", "wet_c_3.0s"]
    for name, bus in zip(names, buses):
        path = os.path.join(args.out_dir, f"{name}.wav")
        write_wav(path, bus, rate)
    written = list(names)
    if args.mix:
        # final audible mix: dry + the three canonical reverbs applied to
        # the wet buses (the reference delegates this to Unity's reverbs;
        # here dsp/reverb.py completes the design in-engine): the C++
        # reverbs with --native, else D2 on the engine's device
        mix = buses[0].copy()
        if args.native:
            from planeverb_tpu_torch.native import NativeReverb
            for rt60, bus in zip((0.5, 1.0, 3.0), buses[1:]):
                NativeReverb(rt60, rate).process_add(bus, mix)
        else:
            from planeverb_tpu_torch.dsp.reverb import mix_output
            mix = mix_output(buses[0], *buses[1:], rate,
                             device=args.engine_device)[0].cpu().numpy()
        write_wav(os.path.join(args.out_dir, "mix.wav"), mix, rate)
        written.append("mix")
    print(f"rendered {n} frames into {args.out_dir}/ "
          f"({', '.join(written)}; engine={'native' if args.native else 'python'})")
    return 0


def cmd_convolve(args) -> int:
    """Auralize audio through the *actual simulated* impulse response."""
    from planeverb_tpu_torch.dsp.convolver import convolve_offline, resample_ir
    from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav

    sx, sz = _xy(args.source[0])  # fail fast, before the sim
    ctx = _run_context(args)
    ir = ctx.get_impulse_response(sx, sz)
    if ir.size == 0:
        raise SystemExit(f"error: source ({sx}, {sz}) is outside the grid")
    if float(np.abs(ir).max()) == 0.0:
        raise SystemExit("error: simulated IR is silent at that position")

    audio, rate = read_wav(args.infile)
    ir_up = resample_ir(ir, ctx.params.fs, rate)
    peak_in = float(np.abs(audio).max()) or 1.0
    y = convolve_offline(audio, ir_up)
    if args.normalize:
        peak = float(np.abs(y).max()) or 1.0
        y = y * (peak_in / peak)
    write_wav(args.output, y, rate)
    print(f"convolved {len(audio)} frames with the {len(ir)}-sample "
          f"simulated IR (fs {ctx.params.fs} -> {rate} Hz) -> {args.output}")
    return 0


def cmd_play(args) -> int:
    """Real-time-paced playout through the full chain (AudioCore analog).

    Streams the input WAV block-by-block against real-time deadlines
    through engine output -> DSP -> reverb mix, reporting callback-budget
    compliance; --bypass is the reference's "Use Planeverb" A/B toggle
    (AudioCore.cpp:98-143)."""
    from planeverb_tpu_torch.sandbox.realtime import RealtimePlayer
    from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav

    sx, sz = _xy(args.source[0])  # fail fast, before the sim
    ctx = _run_context(args)
    eid = ctx.emissions.emit(sx, 0.0, sz, volume_db=args.volume_db)
    if not ctx.get_output(eid).valid:
        raise SystemExit("error: source position has no valid parameters")

    audio, rate = read_wav(args.infile)
    sink = None
    if args.device:
        # live audio output through the optional sounddevice/PortAudio
        # stack (the reference sandbox's own audio path, AudioCore.cpp:28)
        from planeverb_tpu_torch.sandbox.realtime import AudioDeviceSink

        sink = AudioDeviceSink(rate=rate, frames=args.block)
    player = RealtimePlayer(ctx, eid, audio, rate, frames=args.block,
                            use_planeverb=not args.bypass,
                            native=not args.python_dsp, sink=sink)
    try:
        report = player.run(realtime=not args.no_pace)
    finally:
        player.close()
        if sink is not None:
            sink.close()
    if args.output:
        write_wav(args.output, report.output, rate)
    s = report.summary()
    mode = "bypass" if args.bypass else "planeverb"
    print(f"played {s['blocks']} blocks x {s['frames']} frames @ {rate} Hz "
          f"({s['duration_s']:.2f} s, {mode})")
    print(f"callback budget {s['budget_ms']:.2f} ms; processing mean "
          f"{s['mean_process_ms']:.3f} ms, max {s['max_process_ms']:.3f} ms; "
          f"underruns {s['underruns']}")
    if args.output:
        print(f"mix -> {args.output}")
    return 1 if s["underruns"] else 0


def cmd_sweep(args) -> int:
    from planeverb_tpu_torch.sandbox.sweep import door_sweep

    result = door_sweep(_config(args), steps=args.steps,
                        device=args.engine_device)
    result.to_csv(args.output)
    print(f"wrote {args.steps}-step door sweep to {args.output}")
    return 0


def cmd_batch(args) -> int:
    """Batched multi-listener analysis in ONE device call (ops/batch.py).

    The reference runs exactly one listener per context (PvContext.cpp:63-94);
    here B listeners (split-screen / multiplayer, SURVEY.md §2 DP row) batch
    over the leading axis and each source is read out of every listener's
    parameter field. On a card the listeners share one batched B1 pass;
    their parameters come from ``analyze_listeners``, as in the JAX CLI."""
    import torch

    from planeverb_tpu_torch.config import (compute_grid_params,
                                            gaussian_pulse)
    from planeverb_tpu_torch.core.free_grid import calibrate_free_field
    from planeverb_tpu_torch.ops import voxelize
    from planeverb_tpu_torch.ops.batch import (analyze_listeners,
                                               simulate_listeners_auto)
    from planeverb_tpu_torch.types import PlaneverbOutput, vec2

    # argparse enforces required=True on --listener/--source
    listeners = [_xy(s) for s in args.listener]
    sources = [_xy(s) for s in args.source]
    params = compute_grid_params(_config(args))
    scene = _load_scene(args.scene)
    beta, refl = voxelize.voxelize_np(params, scene.boxes if scene else [])
    dev = torch.device(args.engine_device)
    efree = calibrate_free_field(params, dev)
    pulse = torch.from_numpy(gaussian_pulse(params)).to(dev)

    cells = [params.world_to_cell(lx, lz) for lx, lz in listeners]
    for (cx, cy), (lx, lz) in zip(cells, listeners):
        if not (0 <= cx < params.grid_x and 0 <= cy < params.grid_y):
            raise SystemExit(f"error: listener ({lx:g}, {lz:g}) outside grid")
    res = simulate_listeners_auto(
        params, torch.from_numpy(beta).to(dev),
        torch.from_numpy(refl).to(dev), pulse,
        [c[0] for c in cells], [c[1] for c in cells])
    # float32 listener positions, as the JAX CLI passes them
    out = analyze_listeners(
        params, res, efree,
        [float(np.float32(lx)) for lx, _ in listeners],
        [float(np.float32(lz)) for _, lz in listeners])
    occ = out.occlusion.cpu().numpy()
    wet = out.wet_gain.cpu().numpy()
    rt60 = out.rt60.cpu().numpy()
    lp = out.lowpass.cpu().numpy()
    dirs = out.direction.cpu().numpy()
    sdir = out.source_directivity.cpu().numpy()
    for b, (lx, lz) in enumerate(listeners):
        print(f"listener ({lx:g}, {lz:g}):")
        for sx, sz in sources:
            cx, cy = params.world_to_cell(sx, sz)
            print(f"  source ({sx:g}, {sz:g}):")
            if not (0 <= cx < params.grid_x and 0 <= cy < params.grid_y):
                print("    outside grid")
                continue
            _print_params(PlaneverbOutput(
                occlusion=float(occ[b, cx, cy]),
                wet_gain=float(wet[b, cx, cy]),
                rt60=float(rt60[b, cx, cy]),
                lowpass=float(lp[b, cx, cy]),
                direction=vec2(float(dirs[b, cx, cy, 0]),
                               float(dirs[b, cx, cy, 1])),
                source_directivity=vec2(float(sdir[b, cx, cy, 0]),
                                        float(sdir[b, cx, cy, 1]))))
    return 0


def cmd_grid(args) -> int:
    # ASCII voxelization dump with listener/source markers
    # (Grid::PrintGrid analog, Grid.cpp:306-357)
    from planeverb_tpu_torch.config import compute_grid_params
    from planeverb_tpu_torch.ops import voxelize

    params = compute_grid_params(_config(args))
    scene = _load_scene(args.scene)
    beta, _ = voxelize.voxelize_np(params, scene.boxes if scene else [])
    marks = {}
    lx, lz = _xy(args.listener)
    marks[params.world_to_cell(lx, lz)] = "L"
    for spec in (args.source or []):
        marks[params.world_to_cell(*_xy(spec))] = "S"
    for i in range(params.nx):
        print("".join(marks.get((i, j), "." if beta[i, j] > 0 else "#")
                      for j in range(params.ny)))
    return 0


def cmd_serve(args) -> int:
    from planeverb_tpu_torch.server import EngineServer

    srv = EngineServer(args.host, args.port, mesh_devices=args.mesh,
                       device=args.engine_device)
    host, port = srv.address
    print(f"planeverb engine server listening on {host}:{port} "
          f"(newline-delimited JSON; send {{\"cmd\": \"init\", ...}} first)",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
    return 0


def cmd_view(args) -> int:
    # interactive browser sandbox (the reference's ImGui editor analog,
    # Editor.cpp:563-651 grid view / 396-434 readouts / 449-477 IR plots)
    from planeverb_tpu_torch.sandbox.viewer import ViewerServer

    try:
        viewer = ViewerServer(_config(args), scene=_load_scene(args.scene),
                              host=args.host, port=args.port,
                              mesh_devices=args.mesh,
                              device=args.engine_device)
    except ValueError as e:  # e.g. --mesh N beyond the device count
        print(f"error: {e}", file=sys.stderr)
        return 2
    lx, lz = _xy(args.listener)
    viewer.ctx.set_listener_position(lx, 0.0, lz)
    host, port = viewer.address
    print(f"planeverb sandbox viewer at http://{host}:{port}/", flush=True)
    try:
        viewer.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.shutdown()
    return 0


# the CPU positions ``scale --engine-device cpu`` sweeps (the JAX tests'
# eight virtual devices)
CPU_SCALE_POSITIONS = 8
# the card counts ``scale --project`` models: the JAX CLI's, and 2 (a host
# of two cards)
PROJECT_COUNTS = (1, 2, 4, 8, 16, 32, 64)


def cmd_scale(args) -> int:
    # strong- (or weak-) scaling sweep of the sharded solver: every CUDA
    # device on a card, CPU_SCALE_POSITIONS positions of the CPU there
    import json

    import torch

    from planeverb_tpu_torch.config import compute_grid_params, gaussian_pulse
    from planeverb_tpu_torch.ops import voxelize
    from planeverb_tpu_torch.parallel.scaling import measure_scaling

    params = compute_grid_params(_config(args))
    if args.project:
        # the projected efficiency from the one-card model
        # (parallel/scaling.py::projected_efficiency /
        # projected_weak_efficiency), with the H100's fitted rate and
        # overhead unless overridden: --weak holds the per-card block at
        # this grid and grows the world with N; --overlap models the
        # overlap split (1D meshes, the exchange beside the interior launch)
        fn = projected_weak_efficiency if args.weak else projected_efficiency
        rows = fn(params.nx, params.ny, PROJECT_COUNTS,
                  rate_ext_cups=args.rate_ext * 1e9, overlap=args.overlap,
                  round_overhead_s=args.round_overhead_us * 1e-6)
        for row in rows:
            print(json.dumps(row))
        return 0
    if args.overlap and args.solver != "fused":
        # fail like the other subcommands do: a clean message, not a
        # traceback from deep inside the harness
        print("error: --overlap needs --solver fused (the round split "
              "lives in the fused rounds)", file=sys.stderr)
        return 2
    scene = _load_scene(args.scene)
    beta, refl = voxelize.voxelize_np(params, scene.boxes if scene else [])
    lix, liy = params.world_to_cell(*_xy(args.listener))
    devices = (["cpu"] * CPU_SCALE_POSITIONS
               if torch.device(args.engine_device).type == "cpu" else None)
    rows = measure_scaling(params, beta, refl, gaussian_pulse(params),
                           lix, liy, halo=args.halo, reps=args.reps,
                           chain=args.chain, solver=args.solver,
                           mode="weak" if args.weak else "strong",
                           overlap=args.overlap, devices=devices)
    for row in rows:
        print(json.dumps(row))
    return 0


def cmd_scenes(args) -> int:
    from planeverb_tpu_torch.scene import save_pv

    for name, scene in DEMO_SCENES.items():
        print(f"{name:20s} {len(scene.boxes):3d} boxes")
    if args.export:
        os.makedirs(args.export, exist_ok=True)
        for name, scene in DEMO_SCENES.items():
            save_pv(scene, os.path.join(args.export, f"{name}.pv"))
        print(f"exported {len(DEMO_SCENES)} .pv files to {args.export}/")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="planeverb_tpu_torch",
        description="Wave acoustics sandbox on PyTorch and CUDA (Planeverb "
                    "analog)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def engine_device(p):
        p.add_argument("--engine-device", default="cuda",
                       help="torch device the engine runs on (cuda, or cpu "
                            "for the kernels' plain versions)")

    def common(p, scene=True):
        if scene:
            p.add_argument("scene", help=".pv file or demo scene name")
        p.add_argument("--listener", default="5,5", help="listener x,z (m)")
        p.add_argument("--resolution", type=int,
                       default=int(Resolution.DEFAULT),
                       help="max simulated frequency Hz (275/375/500/750)")
        p.add_argument("--grid-size", type=float, default=10.0,
                       help="square grid edge length (m)")
        engine_device(p)

    p = sub.add_parser("analyze", help="print acoustic params at source positions")
    common(p)
    p.add_argument("--source", action="append", required=True,
                   help="source x,z (repeatable)")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("batch", help="batched multi-listener analysis in "
                                     "one device call (split-screen / "
                                     "multiplayer)")
    p.add_argument("scene", nargs="?", default=None,
                   help=".pv file or demo scene name (default: empty grid)")
    p.add_argument("--listener", action="append", default=[], required=True,
                   help="listener x,z (repeatable — one sim per listener)")
    p.add_argument("--source", action="append", default=[], required=True,
                   help="source x,z (repeatable)")
    p.add_argument("--resolution", type=int, default=int(Resolution.DEFAULT),
                   help="max simulated frequency Hz (275/375/500/750)")
    p.add_argument("--grid-size", type=float, default=10.0,
                   help="square grid edge length (m)")
    engine_device(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("ir", help="dump an impulse response to .wav/.csv")
    common(p)
    p.add_argument("--source", action="append", required=True)
    p.add_argument("-o", "--output", default="ir.wav")
    p.add_argument("--plot", action="store_true",
                   help="print ASCII linear+dB IR plots (editor analog)")
    p.set_defaults(fn=cmd_ir)

    p = sub.add_parser("render", help="render a wav through the DSP pipeline")
    common(p)
    p.add_argument("--source", action="append", required=True)
    p.add_argument("--in", dest="infile", required=True, help="input wav")
    p.add_argument("--out-dir", default="rendered")
    p.add_argument("--block", type=int, default=512,
                   help="callback block size (frames)")
    p.add_argument("--native", action="store_true",
                   help="use the C++ renderer instead of the Python one")
    p.add_argument("--mix", action="store_true",
                   help="also write mix.wav = dry + reverbed wet buses")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("convolve",
                       help="convolve a wav with the simulated IR")
    common(p)
    p.add_argument("--source", action="append", required=True)
    p.add_argument("--in", dest="infile", required=True, help="input wav")
    p.add_argument("-o", "--output", default="convolved.wav")
    p.add_argument("--normalize", action="store_true", default=True,
                   help="match output peak to input peak (default on)")
    p.set_defaults(fn=cmd_convolve)

    p = sub.add_parser("play", help="real-time-paced playout through the "
                                    "full chain (AudioCore analog)")
    common(p)
    p.add_argument("--source", action="append", required=True)
    p.add_argument("--in", dest="infile", required=True, help="input wav")
    p.add_argument("-o", "--output", default="played.wav",
                   help="write the delivered mix here ('' to skip)")
    p.add_argument("--block", type=int, default=512,
                   help="frames per callback block (reference: 512)")
    p.add_argument("--volume-db", type=float, default=0.0,
                   help="emitter volume in dB (PlaneverbEmitter.Volume)")
    p.add_argument("--bypass", action="store_true",
                   help='A/B toggle: play WITHOUT Planeverb processing')
    p.add_argument("--python-dsp", action="store_true",
                   help="use the Python DSP renderer instead of C++")
    p.add_argument("--no-pace", action="store_true",
                   help="skip deadline sleeps (budget measurement mode)")
    p.add_argument("--device", action="store_true",
                   help="play live through an audio device (needs the "
                        "optional sounddevice package / PortAudio)")
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("sweep", help="WetDryDoorPlot-style door sweep to CSV")
    common(p, scene=False)
    p.add_argument("--steps", type=int, default=101)
    p.add_argument("-o", "--output", default="sweep.csv")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("grid", help="ASCII dump of the voxelized grid")
    common(p)
    p.add_argument("--source", action="append", default=[],
                   help="mark source positions with S")
    p.set_defaults(fn=cmd_grid)

    p = sub.add_parser("serve", help="run the TCP JSON engine server "
                                     "(game-engine binding layer)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run engine contexts sharded over an N-device mesh "
                        "(0 = single device)")
    engine_device(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("view", help="interactive browser sandbox "
                                    "(grid editor, live params, IR plots)")
    p.add_argument("scene", nargs="?", default=None,
                   help=".pv file or demo scene name (default: empty grid)")
    common(p, scene=False)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8470)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run the engine sharded over an N-device mesh "
                        "(0 = single device)")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("scale", help="strong-scaling sweep of the sharded "
                                     "solver over growing device counts")
    common(p)
    p.add_argument("--halo", type=int, default=8,
                   help="multi-step halo width (exchange every k steps)")
    p.add_argument("--reps", type=int, default=3,
                   help="timing reps per device count (median taken)")
    p.add_argument("--chain", type=int, default=5,
                   help="back-to-back passes per timing rep")
    p.add_argument("--solver", choices=("wide", "fused"), default="wide",
                   help="sharded backend: the per-step wide-halo solver "
                        "(plain torch) or the fused rounds (B5/B6 kernels)")
    p.add_argument("--project", action="store_true",
                   help="print the projected efficiency table from the "
                        "one-card model instead of measuring")
    p.add_argument("--rate-ext", type=float,
                   default=ROUND_RATE_CUPS / 1e9, dest="rate_ext",
                   help="the round's asymptotic cell rate in G cells/s "
                        "for --project (cells unpadded; default: "
                        "scaling.ROUND_RATE_CUPS, fitted on an H100)")
    p.add_argument("--round-overhead-us", type=float,
                   default=ROUND_OVERHEAD_S * 1e6,
                   dest="round_overhead_us",
                   help="the round's fixed cost in us for --project (the "
                        "fit's second parameter; default: "
                        "scaling.ROUND_OVERHEAD_S)")
    p.add_argument("--weak", action="store_true",
                   help="weak scaling: hold the per-device block at this "
                        "grid and grow the world with the device count "
                        "(the measured sweep and --project both honor it)")
    p.add_argument("--overlap", action="store_true",
                   help="the overlap round split (1D meshes): modelled "
                        "with --project, else run in the measured sweep "
                        "(needs --solver fused)")
    p.set_defaults(fn=cmd_scale)

    p = sub.add_parser("scenes", help="list built-in demo scenes")
    p.add_argument("--export", metavar="DIR", default=None,
                   help="also write each demo scene as DIR/<name>.pv")
    p.set_defaults(fn=cmd_scenes)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
