"""Scenes: a configuration's boxes and doorways, from the data files under
``benchmark/scenes/``, optionally tiled into a larger world.

A scene file holds ``boxes`` as (x, y, width, height, R) rows in paint order
(x along the grid's first axis, y along its second, which is the world's z)
and ``doorways``: openings a door can slide across, each a span ``x`` of the
first axis at the line ``y``, the side it slides to (``slide``: +1 or -1),
and the door's reflection. A configuration's ``scene`` names the file and,
for a tiled world, ``tile`` (copies along each axis), ``pitch_m`` (the
distance between copies) and ``origin_m`` (the first copy's corner).
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(spec: dict, base: str = HERE) -> dict:
    """A configuration's ``scene`` entry -> {"boxes": [[x, y, w, h, R]],
    "doorways": [...]} with the tiling applied."""
    path = spec["file"]
    if not os.path.isabs(path):
        path = os.path.join(base, path)
    with open(path) as f:
        scene = json.load(f)
    boxes = [list(map(float, b)) for b in scene["boxes"]]
    doorways = [dict(d) for d in scene.get("doorways", [])]
    tx, ty = spec.get("tile", (1, 1))
    ox, oy = spec.get("origin_m", (0.0, 0.0))
    pitch = float(spec.get("pitch_m", 0.0))
    out_boxes, out_doors = [], []
    for i in range(int(tx)):
        for j in range(int(ty)):
            sx, sy = ox + i * pitch, oy + j * pitch
            out_boxes += [[x + sx, y + sy, w, h, r] for x, y, w, h, r in boxes]
            out_doors += [{**d, "x": [d["x"][0] + sx, d["x"][1] + sx],
                           "y": d["y"] + sy} for d in doorways]
    return {"name": scene["name"], "boxes": out_boxes, "doorways": out_doors}


def paint(boxes, nx: int, ny: int, dx: float, grid_x: int, grid_y: int,
          offset=(0.0, 0.0)) -> np.ndarray:
    """Boolean [nx, ny] mask of the cells no box covers and that are not the
    grid's last row or column, painted box by box on the host (the traffic
    generator's view of free space; the reference's ``fields`` is the one
    compared with the engine)."""
    free = np.ones((nx, ny), bool)
    free[grid_x, :] = False
    free[:, grid_y] = False
    inv = np.float32(1.0) / np.float32(dx)
    for x, y, w, h, _ in boxes:
        sx = max(int(np.float32(x - w * 0.5 + offset[0]) * inv), 0)
        ex = min(int(np.float32(x + w * 0.5 + offset[0]) * inv), nx)
        sy = max(int(np.float32(y - h * 0.5 + offset[1]) * inv), 0)
        ey = min(int(np.float32(y + h * 0.5 + offset[1]) * inv), ny)
        if sx < ex and sy < ey:
            free[sx:ex, sy:ey] = False
    return free


def erode(mask: np.ndarray, cells: int) -> np.ndarray:
    """``mask`` shrunk by ``cells`` cells in every direction (outside the
    grid counts as taken)."""
    out = mask.copy()
    for _ in range(cells):
        p = np.pad(out, 1, constant_values=False)
        n = out.copy()
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                n &= p[di:di + out.shape[0], dj:dj + out.shape[1]]
        out = n
    return out
