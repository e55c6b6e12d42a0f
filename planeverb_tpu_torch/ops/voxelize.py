"""AABB voxelization: scene geometry -> (beta, reflection) fields.

Counterpart of ``planeverb_tpu/ops/voxelize.py``. Instead of imperatively
painting and un-painting boxes (Grid.cpp:136-296), the fields are rebuilt
from the full box set in one vectorized pass: boolean masks from box corner
indices, resolved in paint order so overlapping boxes last-wins exactly
like sequential AddAABB calls.

Cell flag semantics (Grid.cpp:88-113): interior cells are air (beta=1); the
last row (x == grid_x) and last column (y == grid_y) of the extended
staggered grid are non-air (beta=0); boxes force beta=0 and set the
reflection coefficient R.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.utils.profiling import spanned

__all__ = ["base_fields", "voxelize", "voxelize_np", "boxes_to_array"]


def base_fields(params: GridParams) -> tuple[np.ndarray, np.ndarray]:
    """Empty-scene (beta, reflection) as numpy [nx, ny] float32."""
    nx, ny = params.nx, params.ny
    beta = np.ones((nx, ny), np.float32)
    beta[params.grid_x, :] = 0.0
    beta[:, params.grid_y] = 0.0
    reflection = np.zeros((nx, ny), np.float32)  # free space R = 0
    return beta, reflection


def boxes_to_array(boxes, max_boxes: int | None = None) -> np.ndarray:
    """Pack AABBs into a [B, 5] float32 array (x, y, w, h, R).

    Padded rows use zero width/height, which rasterize to an empty cell range.
    """
    n = len(boxes)
    b = max_boxes if max_boxes is not None else max(n, 1)
    out = np.zeros((b, 5), np.float32)
    for i, box in enumerate(boxes):
        out[i] = (box.x, box.y, box.width, box.height, box.absorption)
    return out


@spanned("voxelize")
def voxelize(params: GridParams, boxes: torch.Tensor):
    """Rasterize a [B, 5] float32 box tensor into (beta, reflection)
    [nx, ny] fields on the boxes' device.

    Corner truncation per AddAABB (Grid.cpp:229-246): cells [start, end) per
    axis, int-truncated f32 corners. Overlaps resolve last-wins: each cell
    takes the reflection of the highest-index box covering it.
    """
    nx, ny = params.nx, params.ny
    dev = boxes.device
    inv_dx = np.float32(1.0) / np.float32(params.dx)
    offx = float(np.float32(params.grid_offset_x))
    offy = float(np.float32(params.grid_offset_y))
    x, y, w, h, r = boxes.unbind(1)
    start_x = ((x - w * 0.5 + offx) * float(inv_dx)).to(torch.int32)
    end_x = ((x + w * 0.5 + offx) * float(inv_dx)).to(torch.int32)
    start_y = ((y - h * 0.5 + offy) * float(inv_dx)).to(torch.int32)
    end_y = ((y + h * 0.5 + offy) * float(inv_dx)).to(torch.int32)

    ix = torch.arange(nx, dtype=torch.int32, device=dev).view(1, nx, 1)
    iy = torch.arange(ny, dtype=torch.int32, device=dev).view(1, 1, ny)
    m = ((ix >= start_x.view(-1, 1, 1)) & (ix < end_x.view(-1, 1, 1))
         & (iy >= start_y.view(-1, 1, 1)) & (iy < end_y.view(-1, 1, 1)))

    # last-wins: 1 + index of the last box covering each cell, 0 for none
    order = torch.arange(1, boxes.shape[0] + 1, dtype=torch.int64,
                         device=dev).view(-1, 1, 1)
    last = (m * order).amax(dim=0)
    covered = last > 0

    b0, r0 = base_fields(params)
    beta = torch.where(covered, 0.0, torch.from_numpy(b0).to(dev))
    refl = torch.where(covered, r[(last - 1).clamp(min=0)],
                       torch.from_numpy(r0).to(dev))
    return beta, refl


def voxelize_np(params: GridParams, boxes) -> tuple[np.ndarray, np.ndarray]:
    """Host-side numpy rasterization (same semantics), for tests/tools."""
    beta, refl = base_fields(params)
    inv_dx = np.float32(1.0) / np.float32(params.dx)
    for box in boxes:
        sx = int(np.float32(box.x - box.width * 0.5 + params.grid_offset_x) * inv_dx)
        ex = int(np.float32(box.x + box.width * 0.5 + params.grid_offset_x) * inv_dx)
        sy = int(np.float32(box.y - box.height * 0.5 + params.grid_offset_y) * inv_dx)
        ey = int(np.float32(box.y + box.height * 0.5 + params.grid_offset_y) * inv_dx)
        sx_c, ex_c = max(sx, 0), min(ex, params.grid_x + 1)
        sy_c, ey_c = max(sy, 0), min(ey, params.grid_y + 1)
        if sx_c < ex_c and sy_c < ey_c:
            beta[sx_c:ex_c, sy_c:ey_c] = 0.0
            refl[sx_c:ex_c, sy_c:ey_c] = np.float32(box.absorption)
    return beta, refl
