"""Entry hooks of the port: the flagship step and a multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry()`` returns the flagship step, one full acoustics pipeline
iteration (FDTD simulation + parameter analysis) on a SmallRoom scene,
with its example arguments on the device.

``dryrun_multichip(n)`` runs the JAX dry run's sequence once on an
n-position mesh at tiny shapes: the per-step sharded solver, the analysis
and a DSP block with its sources split over the mesh's x rows; the
wide-halo solver; the fused rounds (B5, and B6 forced
with ``band_rows``, bit-equal); the overlap split on a 1D mesh (bit-equal to
the plain rounds, plain and banded); a Context on the mesh against a
single-device one; and two listeners on the mesh.

On ``device="cuda"`` (the default) the mesh's n positions cycle over the
cards present (``cuda:0`` repeated on a one-card host); on ``"cpu"`` they
are ``["cpu"] * n`` and every kernel runs its plain version. Without a card
a CUDA request raises: nothing falls back to the CPU.

    python -m planeverb_tpu_torch.entry      # both, on the card
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

# the source-split render against one render_block call: the split changes
# the order of the sum over sources (ROADMAP C1's bound for render_block,
# relative to each bus's peak)
DSP_SPLIT_REL_TOL = 5e-5


def _params(grid_m: float = 10.0, resolution: int = 275):
    from planeverb_tpu_torch.config import (PlaneverbConfig,
                                            compute_grid_params)

    return compute_grid_params(PlaneverbConfig(
        grid_size_x=grid_m, grid_size_y=grid_m, grid_resolution=resolution))


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: no CUDA device is "
                           f"available; pass device='cpu' to run the plain "
                           f"versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def entry(device=None):
    """(fn, example_args): the flagship forward step, ``ops/fdtd.simulate``
    + ``ops/analyzer.analyze`` on SmallRoom (10 m at 275 Hz, listener at
    (5, 5)), its arguments on ``device`` (default ``"cuda"``)."""
    from planeverb_tpu_torch.config import gaussian_pulse
    from planeverb_tpu_torch.ops import analyzer, fdtd, voxelize
    from planeverb_tpu_torch.scene import demo_scene

    dev = _device(device)
    params = _params()
    beta, refl = voxelize.voxelize_np(params, demo_scene("SmallRoom").boxes)
    pulse = gaussian_pulse(params)
    lix, liy = params.world_to_cell(5.0, 5.0)

    def step_fn(beta, refl, pulse, lix, liy, efree, lx, ly):
        res = fdtd.simulate(params, beta, refl, pulse, lix, liy)
        return analyzer.analyze(params, res.pressure, res.onset,
                                res.flux_x, res.flux_y, efree, lx, ly)

    example_args = (torch.from_numpy(beta).to(dev),
                    torch.from_numpy(refl).to(dev),
                    torch.from_numpy(pulse).to(dev), lix, liy,
                    0.0288, 5.0, 5.0)
    return step_fn, example_args


def _mesh_devices(n: int, dev: torch.device) -> list[str]:
    if dev.type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def _render_by_rows(config, audio, target, state, listener_pos,
                    listener_fwd, mesh):
    """``dsp.render_block`` with the S sources split over the mesh's x rows,
    as the JAX dry run shards them (``P("x")``): the first device of row i
    renders sources [i * S / mx, (i + 1) * S / mx) in one call (one D1
    launch), and the four buses are summed on the mesh's first device in
    row order. The split changes the order of the sum over sources, so the
    buses equal one call on one device only to within rounding
    (:data:`DSP_SPLIT_REL_TOL`). Returns the buses; the rows' new states
    are dropped, as the dry run drops its state."""
    from planeverb_tpu_torch.dsp import DSPState, SourceParams, render_block

    mx = mesh.shape["x"]
    s = audio.shape[0]
    if s % mx:
        raise ValueError(f"{s} sources do not split over {mx} mesh rows")
    per = s // mx
    dev0 = mesh.first_device
    total = None
    for i in range(mx):
        dev = mesh.devices[i][0]
        rows = slice(i * per, (i + 1) * per)

        def cut(t, rows=rows, dev=dev):
            return t[rows].to(dev)

        part = DSPState(SourceParams(*map(cut, state.current)),
                        cut(state.lpf_y1), cut(state.lpf_y2))
        buses, _ = render_block(config, cut(audio),
                                SourceParams(*map(cut, target)), part,
                                listener_pos, listener_fwd)
        buses = [b.to(dev0) for b in buses]
        total = buses if total is None else [a + b for a, b in
                                             zip(total, buses)]
    return tuple(total)


def _bus_rel(got, want) -> float:
    """The largest difference of two renders' buses, relative to each
    bus's peak."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                1e-30)
               for g, w in zip(got, want))


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One sharded pipeline step and its variants on an ``n_devices``-
    position mesh (tiny shapes: SmallRoom at 4 m and 275 Hz, 32 steps),
    each checked as the JAX dry run checks it. Returns its summary line
    (also printed). The DSP block's sources are split over the mesh's x
    rows (:func:`_render_by_rows`) and held to one render on the mesh's
    first device."""
    from planeverb_tpu_torch.config import (PlaneverbConfig,
                                            PlaneverbDSPConfig,
                                            gaussian_pulse)
    from planeverb_tpu_torch.core.context import Context
    from planeverb_tpu_torch.dsp import SourceParams, init_state, render_block
    from planeverb_tpu_torch.ops import analyzer, voxelize
    from planeverb_tpu_torch.parallel import (grid_mesh, pad_to_mesh,
                                              simulate_sharded,
                                              simulate_sharded_fused,
                                              simulate_sharded_wide)
    from planeverb_tpu_torch.scene import demo_scene

    dev = _device(device)
    devices = _mesh_devices(n_devices, dev)

    # tiny workload: short IR, small grid
    params = dataclasses.replace(_params(4.0), response_length=32)
    mesh = grid_mesh(devices)
    dev0 = mesh.first_device
    nx, ny = params.nx, params.ny
    nx_pad, ny_pad = pad_to_mesh(nx, ny, mesh)

    beta, refl = voxelize.voxelize_np(params, demo_scene("SmallRoom").boxes)

    def padded(a, shape):
        out = np.zeros(shape, np.float32)
        out[:nx, :ny] = a
        return torch.from_numpy(out).to(dev0)

    bpad = padded(beta, (nx_pad, ny_pad))
    rpad = padded(refl, (nx_pad, ny_pad))
    pulse = torch.from_numpy(gaussian_pulse(params)).to(dev0)
    lix, liy = params.world_to_cell(2.0, 2.0)
    args = (params, bpad, rpad, pulse, lix, liy, mesh, nx_pad, ny_pad)

    # DSP: 2 * mx sources, split over the mesh's x rows
    s, frames = 2 * mesh.shape["x"], 64
    dsp_cfg = PlaneverbDSPConfig(max_callback_length=frames)
    audio = torch.full((s, frames, 2), 0.1, dtype=torch.float32, device=dev0)
    state = init_state(s, dev0)

    res = simulate_sharded(*args).assemble(dev0)
    out = analyzer.analyze(
        params, res.pressure[:, :nx, :ny], res.onset[:nx, :ny],
        res.flux_x[:nx, :ny], res.flux_y[:nx, :ny], 0.0288, 2.0, 2.0)
    # feed one cell's params to every DSP source (shape plumbing only)
    cx, cy = params.grid_x // 2, params.grid_y // 2

    def full(v):
        return v.expand(s).contiguous()

    ones2 = torch.ones((s, 2), dtype=torch.float32, device=dev0)
    target = SourceParams(
        occlusion=full(out.occlusion[cx, cy]),
        wet_gain=full(out.wet_gain[cx, cy]),
        rt60=full(out.rt60[cx, cy]),
        lowpass=full(out.lowpass[cx, cy].clamp(20.0, 20000.0)),
        direction=out.direction[cx, cy].expand(s, 2).contiguous(),
        position=ones2, forward=ones2,
        directivity=out.source_directivity[cx, cy].expand(s, 2).contiguous(),
        pattern=torch.ones(s, dtype=torch.int32, device=dev0))
    listener = ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0])
    buses = _render_by_rows(dsp_cfg, audio, target, state, *listener, mesh)
    if not all(torch.isfinite(b).all() for b in buses):
        raise AssertionError("dryrun: the DSP buses are not finite")
    one, _ = render_block(dsp_cfg, audio, target, state, *listener)
    dsp_rel = _bus_rel(buses, one)
    if not dsp_rel <= DSP_SPLIT_REL_TOL:
        raise AssertionError(f"dryrun: the source-split buses differ from "
                             f"one render by {dsp_rel:.3e} of the peak")

    # the wide-halo variant (k-step ghost exchange)
    k = max(1, min(2, nx_pad // mesh.shape["x"], ny_pad // mesh.shape["y"]))
    res_w = simulate_sharded_wide(*args, halo=k).assemble(dev0)

    # the fused rounds (B5), held to the wide solver
    res_p = simulate_sharded_fused(*args, halo=k).assemble(dev0)
    torch.testing.assert_close(res_p.pressure, res_w.pressure, rtol=0,
                               atol=1e-6)
    # ... and B6 forced with band_rows: bit-equal to the fused rounds
    res_b = simulate_sharded_fused(*args, halo=k, band_rows=8).assemble(dev0)
    if not torch.equal(res_b.pressure, res_p.pressure):
        raise AssertionError("dryrun: B6 rounds differ from B5's")

    # the overlap split on a 1D ("x", N) mesh: bit-equal to the plain
    # rounds, plain (B5) and banded (B6)
    mesh1d = grid_mesh(devices, (len(devices), 1))
    nx1, ny1 = pad_to_mesh(nx, ny, mesh1d, multiple=8)
    k1 = max(1, min(2, nx1 // (3 * len(devices))))
    args1 = (params, padded(beta, (nx1, ny1)), padded(refl, (nx1, ny1)),
             pulse, lix, liy, mesh1d, nx1, ny1)
    for band in (None, 8):
        plain = simulate_sharded_fused(*args1, halo=k1, band_rows=band)
        split = simulate_sharded_fused(*args1, halo=k1, band_rows=band,
                                       overlap=True)
        for name in ("pressure", "onset"):
            if not torch.equal(split.field(name, dev0),
                               plain.field(name, dev0)):
                raise AssertionError(f"dryrun: the overlap split's {name} "
                                     f"differs (band_rows={band})")

    # the product surface: a Context on the mesh publishes the grids of a
    # single-device one
    cfg = PlaneverbConfig(grid_size_x=4.0, grid_size_y=4.0,
                          grid_resolution=275)
    ctx_mesh = Context(cfg, scene=demo_scene("SmallRoom"), mesh=mesh)
    ctx_mesh.set_listener_position(2.0, 0.0, 2.0)
    ctx_mesh.step()
    ctx_one = Context(cfg, scene=demo_scene("SmallRoom"), device=dev0)
    ctx_one.set_listener_position(2.0, 0.0, 2.0)
    ctx_one.step()
    pm, po = ctx_mesh._published, ctx_one._published
    for key in ("occlusion", "wet_gain", "rt60", "lowpass", "direction",
                "source_directivity"):
        np.testing.assert_allclose(pm[key], po[key], rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    if not ctx_mesh.result_at(2.5, 2.0).valid:
        raise AssertionError("dryrun: the mesh Context's result is invalid")

    # split-screen on the mesh: two listeners
    ctx_mesh.set_listener_positions([(2.0, 0.0, 2.0), (1.0, 0.0, 3.0)])
    ctx_mesh.step()
    for listener in (0, 1):
        if not ctx_mesh.result_at(2.5, 2.0, listener=listener).valid:
            raise AssertionError(f"dryrun: listener {listener} invalid")
    line = (f"dryrun_multichip: mesh={dict(mesh.shape)} on {devices} "
            f"grid={nx_pad}x{ny_pad} T={params.response_length} "
            f"sources={s} dsp_rows={mesh.shape['x']}(rel {dsp_rel:.1e}) "
            f"wide_halo=k{k} fused_sharded=ok banded=ok "
            f"overlap_1d=ok(mesh={len(devices)}x1, halo={k1}, bit-equal) "
            f"context_sharded=ok(halo={ctx_mesh._halo}, "
            f"pad={ctx_mesh._nx_pad}x{ctx_mesh._ny_pad}, "
            f"publish-parity vs single-device) multi_listener_mesh=ok ok")
    print(line)
    return line


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: ok ({torch.cuda.get_device_name(0)}; occlusion "
          f"{tuple(out.occlusion.shape)})")
    dryrun_multichip(4)
