"""Batched simulation: many listeners, scenes or slices in one call.

Counterpart of ``planeverb_tpu/ops/batch.py``. The reference is one
listener, one scene (PvContext.cpp:63-94); acoustic reciprocity already
makes *sources* free (one sim yields every source cell's IR,
FDTD.cpp:233-234). This module adds the other axes:

  - **listeners**: split-screen / multiplayer. :func:`simulate_listeners`
    is the plain per-listener loop; :func:`simulate_listeners_auto` runs
    the batched B1 kernel (``fdtd_fused.fdtd_sim_batch``: one launch for
    all listeners) or one B3 pass per listener, as
    ``fdtd_fused.route_tiled`` routes the batch.
  - **scenes**: level precomputation / dataset generation, one pass per
    (beta, reflection) field set; **slices**: one pass per horizontal
    slice of a 3D scene.

Every function returns its results stacked on a leading axis, on the
device of its inputs. Memory scales as B x [T, nx, ny] float32 recordings
(25 m at 275 Hz: ~9 MB a listener).
"""

from __future__ import annotations

import torch

from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops import (analyzer, fdtd, fdtd_fused, fdtd_tiled,
                                     voxelize)
from planeverb_tpu_torch.ops.fdtd import FdtdResult
from planeverb_tpu_torch.scene import project_to_slice

__all__ = ["simulate_listeners", "simulate_listeners_auto",
           "analyze_listeners", "simulate_scenes", "simulate_slices"]


def _stack(results) -> FdtdResult:
    return FdtdResult(*(torch.stack(f) for f in zip(*results)))


def _cells(listener_ix, listener_iy) -> list[tuple[int, int]]:
    return [(int(i), int(j)) for i, j in zip(listener_ix, listener_iy)]


def simulate_listeners(params: GridParams, beta, refl, pulse,
                       listener_ix, listener_iy) -> FdtdResult:
    """One plain simulation (``ops/fdtd.py::simulate``) per listener cell.

    Args:
      beta, refl: [nx, ny] shared fields.
      listener_ix, listener_iy: [B] integer listener cells (host values).
    Returns FdtdResult with a leading [B] axis on every field.
    """
    return _stack(fdtd.simulate(params, beta, refl, pulse, i, j)
                  for i, j in _cells(listener_ix, listener_iy))


def simulate_listeners_auto(params: GridParams, beta, refl, pulse,
                            listener_ix, listener_iy) -> FdtdResult:
    """Batched listeners on the fields' device, float32, routed by
    ``fdtd_fused.route_tiled`` for their number: the batched B1 pass, or
    one B3 pass per listener. Equal to :func:`simulate_listeners`."""
    cells = _cells(listener_ix, listener_iy)
    if not fdtd_fused.route_tiled(params.nx * params.ny, len(cells),
                                  torch.float32, beta.device.type == "cuda"):
        res, _ = fdtd_fused.fdtd_sim_batch(params, beta, refl, pulse, cells)
        return res
    return _stack(fdtd_tiled.fdtd_sim_tiled(params, beta, refl, pulse, i, j)[0]
                  for i, j in cells)


def analyze_listeners(params: GridParams, batched_result: FdtdResult,
                      efree: float, listener_x,
                      listener_y) -> analyzer.AnalyzerResults:
    """Analysis of :func:`simulate_listeners` output, one listener at a
    time. ``listener_x``, ``listener_y``: [B] world positions (offset not
    yet applied). Returns AnalyzerResults with a leading [B] axis."""
    outs = [analyzer.analyze(params, pr, onset, fx, fy, efree, float(lx),
                             float(ly))
            for pr, onset, fx, fy, lx, ly in zip(*batched_result, listener_x,
                                                  listener_y)]
    return analyzer.AnalyzerResults(*(torch.stack(g) for g in zip(*outs)))


def simulate_scenes(params: GridParams, beta, refl, pulse,
                    listener_ix: int, listener_iy: int) -> FdtdResult:
    """One ``simulate_auto`` pass per scene: ``beta``/``refl`` are [S, nx,
    ny] with a single shared listener cell. Returns FdtdResult with a
    leading [S] axis."""
    return _stack(fdtd_fused.simulate_auto(params, b, r, pulse,
                                           int(listener_ix),
                                           int(listener_iy))
                  for b, r in zip(beta, refl))


def simulate_slices(params: GridParams, boxes3d, heights, pulse,
                    listener_ix: int, listener_iy: int,
                    head_slice: float = 0.5) -> FdtdResult:
    """2.5D slice stack: one 2D pass per horizontal slice of a 3D scene, on
    the pulse's device.

    The reference simulates the single slice at the listener's head height
    (head-slice culling, PlaneverbObject.cs:194-200); a stack gives e.g.
    per-floor acoustics of a building.

    Args:
      boxes3d: iterable of scene.AABB3D.
      heights: [H] listener ear heights (one slice each).
    Returns FdtdResult with a leading [H] axis.
    """
    boxes3d = list(boxes3d)
    betas, refls = [], []
    for h in heights:
        scene = project_to_slice(boxes3d, float(h), head_slice)
        b, r = voxelize.voxelize_np(params, scene.boxes)
        betas.append(torch.from_numpy(b))
        refls.append(torch.from_numpy(r))
    return simulate_scenes(params, torch.stack(betas).to(pulse.device),
                           torch.stack(refls).to(pulse.device), pulse,
                           listener_ix, listener_iy)
