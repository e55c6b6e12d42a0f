"""Free-field calibration (FreeGrid analog).

Counterpart of ``planeverb_tpu/core/free_grid.py``. At engine init the
reference runs one full FDTD pass on an *empty* grid, measures the energy of
the response 1 m from the listener over the dry window, and normalizes it to
exactly 1 m via the 2D 1/r energy falloff
(ProjectPlaneverb/src/FDTD/FreeGrid.cpp:71-110). The result ``EFree`` is the
denominator for the analyzer's obstruction and wet-gain normalization.

Grids larger than :data:`CAL_SIZE_M` calibrate on a fixed CAL_SIZE_M-square
empty domain: EFree does not depend on grid extent once the boundary is
beyond the echo horizon of the 1 m probe (see the JAX module's docstring).
Grids at or below CAL_SIZE_M keep the reference's full-grid behavior.

The result is cached per calibration configuration and device, as the JAX
module caches it per configuration: the server makes a Context on every
``init``, the CLI one per command, ``api.change_settings`` one per call.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch.config import (GridParams, PlaneverbConfig,
                                        compute_grid_params, gaussian_pulse)
from planeverb_tpu_torch.ops import voxelize
from planeverb_tpu_torch.ops.fdtd_fused import simulate_auto

__all__ = ["calibrate_free_field", "clear_cache", "CAL_SIZE_M"]

CAL_SIZE_M = 25.0

_CACHE: dict[tuple, float] = {}


def _key(params: GridParams, device: torch.device) -> tuple:
    """The JAX module's key plus the device: the card's ``log``/``pow``
    differ from the CPU's by ulps, so a value computed on one never
    answers the other."""
    return (params.resolution, params.grid_x, params.grid_y,
            params.response_length, params.boundary_type,
            params.grid_offset_x, params.grid_offset_y,
            device.type, device.index)


def _cal_params(params: GridParams) -> GridParams:
    """Calibration domain: each dimension clamps to CAL_SIZE_M (same
    resolution/boundary/constants, zero offset); dimensions at or under
    CAL_SIZE_M stay exact."""
    if (params.grid_size_x <= CAL_SIZE_M
            and params.grid_size_y <= CAL_SIZE_M):
        return params
    cfg = PlaneverbConfig(
        grid_size_x=min(params.grid_size_x, CAL_SIZE_M),
        grid_size_y=min(params.grid_size_y, CAL_SIZE_M),
        grid_resolution=params.resolution,
        grid_boundary_type=params.boundary_type,
        constants=params.constants)
    return compute_grid_params(cfg)


def _efree_on(params: GridParams, device: torch.device) -> float:
    """One empty-grid sim on ``params`` -> EFree (FreeGrid.cpp:71-110)."""
    beta, refl = voxelize.base_fields(params)
    pulse = gaussian_pulse(params)

    lx = params.grid_x // 2
    ly = params.grid_y // 2
    emitter_x = lx + int(np.float32(1.0) / np.float32(params.dx))
    emitter_y = ly

    # listener world position is round-tripped through world_to_cell exactly
    # as the reference re-derives the cell from a world pos (FreeGrid.cpp:84)
    wx = float(np.float32(lx) * np.float32(params.dx))
    wy = float(np.float32(ly) * np.float32(params.dx))
    cix, ciy = params.world_to_cell(wx, wy)

    res = simulate_auto(params, torch.from_numpy(beta).to(device),
                        torch.from_numpy(refl).to(device),
                        torch.from_numpy(pulse).to(device), cix, ciy)
    sig = res.pressure[:, emitter_x, emitter_y].cpu().numpy()

    k = params.constants
    num_samples = (int(np.float32(k.dry_gain_analysis_length) * np.float32(params.fs))
                   + int(np.float32(1.0) / np.float32(k.c) * np.float32(params.fs)))
    efree = float(np.sum(sig[:num_samples].astype(np.float32) ** 2,
                         dtype=np.float32))

    r = np.float32(emitter_x - lx) * np.float32(params.dx)
    return float(np.float32(efree) * r)


def calibrate_free_field(params: GridParams, device="cuda") -> float:
    """EFree for this grid configuration on ``device`` (default the card;
    ``device="cpu"`` runs the plain version): one simulation the first time
    (on a CUDA device one B1 or B3 launch, as ``simulate_auto`` routes
    it), the cached value after that. A CUDA device without a card raises:
    there is no silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"calibrate_free_field(device={str(device)!r}): no CUDA device is "
            f"available; pass device='cpu' to run the plain version")
    cal = _cal_params(params)
    key = _key(cal, device)
    if key not in _CACHE:
        _CACHE[key] = _efree_on(cal, device)
    return _CACHE[key]


def clear_cache() -> None:
    """Forget every cached EFree: the next calibration simulates again."""
    _CACHE.clear()
