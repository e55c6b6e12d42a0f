"""Direction-of-arrival via parallel delay-field descent.

Counterpart of ``planeverb_tpu/ops/doa.py``. The reference encodes
listener direction with a per-cell greedy walk across the onset-delay field
(ProjectPlaneverb/src/DSP/Analyzer.cpp:340-431): from each source cell,
repeatedly hop to the 8-neighbor with the smallest onset delay until
reaching line-of-sight with the listener (or a loudness/delay threshold),
then emit the unit vector from the final cell to the listener.

The hop choice from a cell depends only on that cell, so the walk is
iteration of a *fixed* per-cell successor function ``g``:

    g(c) = c               if terminal(c)
         = best_neighbor(c) otherwise

The walk's end from every cell at once is ``g`` composed with itself until
it stops changing. On a GPU a gather is cheap, so this module uses pointer
jumping: ``g <- g[g]`` squares the map, and a fixed ceil(log2(path_bound))
squarings reach the fixpoint of every path, with no data-dependent exit and
so no host sync (the JAX package instead propagates labels by 8 shifts per
hop and tests for convergence every 4 hops, because TPU gathers are slow).
The fixpoint labels are the same either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from planeverb_tpu_torch.config import GridParams

__all__ = ["encode_directions", "walk_ends", "walk_direction", "walk_end"]

# neighbor order matters for tie-breaking: strict < keeps the earliest
# minimal neighbor, matching the reference's iteration order
_NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1),
                     (0, -1), (0, 1),
                     (1, -1), (1, 0), (1, 1))

_F32MAX = float(np.finfo(np.float32).max)


def _shift(arr, dr: int, dc: int, fill: float):
    """arr value at (i+dr, j+dc), out-of-bounds filled."""
    gx, gy = arr.shape
    padded = F.pad(arr, (max(-dc, 0), max(dc, 0), max(-dr, 0), max(dr, 0)),
                   value=fill)
    r0 = max(dr, 0)
    c0 = max(dc, 0)
    return padded[r0:r0 + gx, c0:c0 + gy]


def _offset(idx, dx: float, lw: float):
    """f32 ``idx * dx - lw`` rounded once, as the fused multiply-add the
    JAX engine's compiler emits for it: near the listener the subtraction
    cancels, and a separately rounded product leaves ~1e-6 errors in the
    unit vectors there. The product and difference are exact in f64."""
    return (idx.to(torch.float64) * dx - lw).to(torch.float32)


def walk_ends(params: GridParams, occlusion, delay,
              listener_wx: float, listener_wy: float) -> torch.Tensor:
    """[gx * gy] flat index of the cell where each cell's walk ends.

    Args as :func:`encode_directions`.
    """
    gx, gy = params.grid_x, params.grid_y
    n = gx * gy
    k = params.constants
    dev = delay.device
    dx = float(np.float32(params.dx))
    c_sound = np.float32(k.c)
    fs = np.float32(params.fs)
    thr_dist = float(np.float32(0.3) * (c_sound / np.float32(params.resolution)))

    rr = torch.arange(gx, dtype=torch.int64, device=dev).view(gx, 1)
    cc = torch.arange(gy, dtype=torch.int64, device=dev).view(1, gy)
    self_idx = (rr * gy + cc).expand(gx, gy)

    # best (strictly smallest-delay, occlusion>0) neighbor per cell
    best_delay = torch.full((gx, gy), _F32MAX, dtype=torch.float32,
                            device=dev)
    best_idx = self_idx
    for dr, dc in _NEIGHBOR_OFFSETS:
        n_delay = _shift(delay, dr, dc, _F32MAX)
        n_occ = _shift(occlusion, dr, dc, 0.0)
        cand_ok = (n_occ > 0.0) & (n_delay < best_delay)
        best_delay = torch.where(cand_ok, n_delay, best_delay)
        best_idx = torch.where(cand_ok, (rr + dr) * gy + (cc + dc), best_idx)

    nxt = best_idx.reshape(n)
    nxt_delay = best_delay.reshape(n)
    has_next = nxt_delay < _F32MAX
    occ = occlusion.reshape(n)
    dly = delay.reshape(n)

    # per-cell geometry for the line-of-sight test
    dxv = _offset(rr, dx, listener_wx).expand(gx, gy).reshape(n)
    dyv = _offset(cc, dx, listener_wy).expand(gx, gy).reshape(n)
    euclid = torch.sqrt(dxv * dxv + dyv * dyv)
    # divisor as a tensor: true division on CUDA too (see analyzer._div)
    geodesic = float(c_sound) * dly / torch.full_like(dly, float(fs))
    los = (geodesic - euclid).abs() < thr_dist

    # stop-at-this-cell predicate (arrival LOS + loop-top checks, which the
    # reference evaluates BEFORE the neighbor scan — Analyzer.cpp:354,406)
    loud = occ >= float(np.float32(k.distance_gain_threshold))
    stop_here = (los | (dly <= float(np.float32(k.delay_close_threshold)))
                 | loud | ~has_next)
    # the reference commits nextIndex inside the scan, so a non-improving
    # best neighbor means one final hop TO that neighbor, then stop
    # (Analyzer.cpp:375-385): the walk-end label of such cells is nxt
    hop_stop = ~stop_here & has_next & (nxt_delay >= dly)
    advance = ~stop_here & (nxt_delay < dly)

    idx = self_idx.reshape(n)
    label0 = torch.where(hop_stop, nxt, idx)
    g = torch.where(advance, nxt, idx)

    # delay strictly decreases >= 1 sample per advancing hop (integer-valued
    # onsets), so no path is longer than path_bound; 2^squarings >= that
    path_bound = min(max(n, 2), params.response_length + 2)
    for _ in range(math.ceil(math.log2(path_bound))):
        g = g[g]
    lab = label0[g]

    # first step from the start cell: delay register is +inf, LOS unchecked
    # — resolve each start through its first-hop neighbor's converged label
    start_terminal = loud | ~has_next
    return torch.where(start_terminal, lab, lab[nxt])


def encode_directions(params: GridParams, occlusion, delay,
                      listener_wx: float, listener_wy: float) -> torch.Tensor:
    """Compute [gx, gy, 2] DOA unit vectors (EncodeListenerDirection analog).

    Args:
      occlusion: [gx, gy] obstruction gains (pass-1 output).
      delay: [gx, gy] onset delays in samples (f32; FLT_MAX where none).
      listener_wx, listener_wy: listener world position incl. grid offset
        (f32 values).
    """
    gx, gy = params.grid_x, params.grid_y
    dx = float(np.float32(params.dx))
    final = walk_ends(params, occlusion, delay, listener_wx, listener_wy)

    # unit vector from final cell to listener (Analyzer.cpp:409-430)
    ox = _offset(final // gy, dx, listener_wx)
    oy = _offset(final % gy, dx, listener_wy)
    length_sq = ox * ox + oy * oy
    inv_len = torch.where(length_sq != 0.0, 1.0 / torch.sqrt(length_sq),
                          torch.ones_like(length_sq))
    out = torch.stack([ox * inv_len, oy * inv_len], dim=-1)
    return out.reshape(gx, gy, 2)


def walk_end(params: GridParams, occlusion, delay, sx: int, sy: int,
             listener_wx: float, listener_wy: float) -> tuple[int, int]:
    """Single-cell greedy walk on the host (numpy): the (i, j) cell where
    the walk from (sx, sy) ends.

    Semantics identical to :func:`walk_ends` (same neighbor order,
    tie-breaking, and terminal predicate), evaluated for one source cell.

    Args:
      occlusion, delay: [gx, gy] numpy arrays (pass-1 outputs).
      sx, sy: source cell indices.
      listener_wx, listener_wy: listener world position incl. grid offset.
    """
    gx, gy = params.grid_x, params.grid_y
    k = params.constants
    dx = np.float32(params.dx)
    fs = np.float32(params.fs)
    c_sound = np.float32(k.c)
    wavelength = c_sound / np.float32(params.resolution)
    thr_dist = np.float32(0.3) * wavelength
    f32max = np.float32(np.finfo(np.float32).max)

    def best_neighbor(i, j):
        best_d = f32max
        best = (i, j)
        for dr, dc in _NEIGHBOR_OFFSETS:
            ni, nj = i + dr, j + dc
            if not (0 <= ni < gx and 0 <= nj < gy):
                continue
            if occlusion[ni, nj] > 0.0 and delay[ni, nj] < best_d:
                best_d = delay[ni, nj]
                best = (ni, nj)
        return best, best_d

    def los(i, j):
        ex = np.float32(i) * dx
        ey = np.float32(j) * dx
        euclid = np.sqrt((ex - listener_wx) ** 2 + (ey - listener_wy) ** 2)
        geodesic = c_sound * delay[i, j] / fs
        return abs(geodesic - euclid) < thr_dist

    def terminal(i, j, nxt_d):
        return (los(i, j)
                or delay[i, j] <= np.float32(k.delay_close_threshold)
                or occlusion[i, j] >= np.float32(k.distance_gain_threshold)
                or nxt_d >= delay[i, j])

    # first step from the start cell: delay register is +inf, LOS unchecked
    cur = (sx, sy)
    nxt, nxt_d = best_neighbor(*cur)
    if not (occlusion[sx, sy] >= np.float32(k.distance_gain_threshold)
            or nxt_d == f32max):
        cur = nxt
        for _ in range(params.response_length + 2):
            nxt, nxt_d = best_neighbor(*cur)
            if nxt_d == f32max or terminal(*cur, nxt_d):
                # literal reference semantics: the C++ commits nextIndex to
                # the best neighbor inside the scan, so the non-improving
                # break (nxt_d >= delay[cur], no LOS/close/loud stop first)
                # still leaves the walk at that neighbor (Analyzer.cpp:
                # 375-385)
                if (nxt_d != f32max and nxt_d >= delay[cur]
                        and not los(*cur)
                        and delay[cur] > np.float32(k.delay_close_threshold)
                        and occlusion[cur] < np.float32(
                            k.distance_gain_threshold)):
                    cur = nxt
                break
            cur = nxt
    return cur


def walk_direction(params: GridParams, occlusion, delay, sx: int, sy: int,
                   listener_wx: float, listener_wy: float):
    """Single-cell DOA by the greedy walk (:func:`walk_end`), on the host.
    Returns (dir_x, dir_y)."""
    cur = walk_end(params, occlusion, delay, sx, sy, listener_wx,
                   listener_wy)
    dx = np.float32(params.dx)
    ex = np.float32(cur[0]) * dx
    ey = np.float32(cur[1]) * dx
    ox = np.float32(ex - listener_wx)
    oy = np.float32(ey - listener_wy)
    length_sq = ox * ox + oy * oy
    if length_sq != 0.0:
        inv = np.float32(1.0) / np.sqrt(length_sq, dtype=np.float32)
        ox, oy = ox * inv, oy * inv
    return float(ox), float(oy)
