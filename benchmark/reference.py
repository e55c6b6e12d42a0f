"""The plain reference of one refresh: what the engine publishes for a
listener (or several) in a scene of boxes, in plain PyTorch.

A frozen copy of the port's plain versions, written against the engine's
published semantics (the reference C++ engine's FDTD.cpp, Analyzer.cpp and
FreeGrid.cpp, as the port's docstrings cite them) and importing nothing of
the port. From a configuration's sizes, the boxes, the listeners and the
emitters it works out again everything the engine derives: the grid law,
the pulse, the fields, the free-field calibration, the simulation with its
streamed onset, flux and energies, the RT60 moments, the parameter assembly,
the directions of arrival, the packed publish layout and each emitter's
output. It runs on any torch device; on a CUDA device it launches plain
torch operations only.

``state_dtype=torch.bfloat16`` computes the wave state and the recording in
bf16 (every operation in float, rounded once), the accumulators in float32:
the control that the comparison in ``check.py`` has to fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

F32 = np.float32
F32_MAX = float(np.finfo(np.float32).max)
INVALID_OCCLUSION = -1.0
# 10/ln(10) rounded to float32: y_db = 10 log10(EDC) from ln
LOG10_SCALE = F32(10.0 / np.log(10.0))
# the calibration domain's side in metres: larger worlds calibrate on a
# CAL_SIZE_M square (the free field's energy 1 m out does not see the walls)
CAL_SIZE_M = 25.0
# the engine's physical constants (PvTypes.h:83-102)
C_SOUND = 343.21
AUDIBLE_THRESHOLD = 0.00000316
DRY_DIRECTION_S = 0.005
DRY_GAIN_S = 0.01
WET_GAIN_S = 0.080
POINTS_PER_WAVELENGTH = 3.5
SCHROEDER_OFFSET_S = 0.01
DISTANCE_GAIN_THRESHOLD = 0.891251
DELAY_CLOSE_THRESHOLD = 5.0
# boxes rasterized at once (a [chunk, nx, ny] mask)
BOX_CHUNK = 16
# the packed publish layout: a [9] row per cell
COLUMNS = ("occlusion", "wet_gain", "rt60", "lowpass", "direction_x",
           "direction_y", "directivity_x", "directivity_y", "delay_samples")


@dataclasses.dataclass(frozen=True)
class Grid:
    """The grid law of a world (Grid.cpp:46-116, 390-396), in float32."""
    dx: float
    fs: int
    grid_x: int
    grid_y: int
    steps: int
    resolution: int
    offset_x: float = 0.0
    offset_y: float = 0.0
    absorbing: bool = True

    @property
    def nx(self) -> int:
        return self.grid_x + 1

    @property
    def ny(self) -> int:
        return self.grid_y + 1

    def cell(self, x: float, z: float) -> tuple[int, int]:
        """World position -> cell (FDTD.cpp:96-97)."""
        return (int(F32(x + self.offset_x) / F32(self.dx)),
                int(F32(z + self.offset_y) / F32(self.dx)))

    def samples(self, seconds: float) -> int:
        return int(F32(seconds) * F32(self.fs))


def grid(size_x: float, size_y: float, resolution: int,
         offset_x: float = 0.0, offset_y: float = 0.0,
         absorbing: bool = True) -> Grid:
    c = F32(C_SOUND)
    dx = c / F32(resolution) / F32(POINTS_PER_WAVELENGTH)
    fs = int(F32(1.0) / (dx / (c * F32(1.5))))
    gx = int((F32(1.0) / dx) * F32(size_x))
    gy = int((F32(1.0) / dx) * F32(size_y))
    # the IR law: sqrt(2) * 12.5 / c + 0.25 s, extended by the travel beyond
    # the 25 m world's half-diagonal
    ir_s = F32(math.sqrt(2.0)) * F32(12.5) / c + F32(0.25)
    half = F32(0.5) * np.hypot(F32(size_x), F32(size_y))
    extra = np.maximum(F32(0.0), half - F32(math.sqrt(2.0)) * F32(12.5)) / c
    steps = int(F32(fs) * (F32(float(ir_s)) + extra))
    return Grid(float(dx), fs, gx, gy, steps, int(resolution),
                float(offset_x), float(offset_y), bool(absorbing))


def pulse(g: Grid, device) -> torch.Tensor:
    """The Gaussian source pulse (Grid.cpp:12-27), float32 [T]."""
    sigma = F32(1.0) / (F32(0.5) * F32(math.acos(-1.0)) * F32(g.resolution))
    delay = F32(2.0) * sigma
    t = np.arange(g.steps, dtype=np.float32) * (F32(1.0) / F32(g.fs))
    p = np.exp(-(t - delay) * (t - delay) / (sigma * sigma)).astype(np.float32)
    return torch.from_numpy(p).to(device)


# ------------------------------------------------------------------ fields
def base_fields(g: Grid) -> tuple[np.ndarray, np.ndarray]:
    beta = np.ones((g.nx, g.ny), np.float32)
    beta[g.grid_x, :] = 0.0
    beta[:, g.grid_y] = 0.0
    return beta, np.zeros((g.nx, g.ny), np.float32)


def fields(g: Grid, boxes, device):
    """(beta, reflection) [nx, ny] from boxes (x, y, w, h, R) in paint order:
    cells [start, end) from float32 corners truncated to int (Grid.cpp:
    229-246); a cell takes the reflection of the last box covering it.
    The boxes are rasterized :data:`BOX_CHUNK` at a time."""
    b0, r0 = base_fields(g)
    b0 = torch.from_numpy(b0).to(device)
    r0 = torch.from_numpy(r0).to(device)
    if len(boxes) == 0:
        return b0, r0
    arr = torch.tensor(np.asarray(boxes, np.float32).reshape(-1, 5),
                       device=device)
    inv = float(F32(1.0) / F32(g.dx))
    ox, oy = float(F32(g.offset_x)), float(F32(g.offset_y))
    x, y, w, h, r = arr.unbind(1)
    sx = ((x - w * 0.5 + ox) * inv).to(torch.int32).view(-1, 1, 1)
    ex = ((x + w * 0.5 + ox) * inv).to(torch.int32).view(-1, 1, 1)
    sy = ((y - h * 0.5 + oy) * inv).to(torch.int32).view(-1, 1, 1)
    ey = ((y + h * 0.5 + oy) * inv).to(torch.int32).view(-1, 1, 1)
    ix = torch.arange(g.nx, dtype=torch.int32, device=device).view(1, -1, 1)
    iy = torch.arange(g.ny, dtype=torch.int32, device=device).view(1, 1, -1)
    last = torch.zeros((g.nx, g.ny), dtype=torch.int64, device=device)
    for k in range(0, arr.shape[0], BOX_CHUNK):
        inside = ((ix >= sx[k:k + BOX_CHUNK]) & (ix < ex[k:k + BOX_CHUNK])
                  & (iy >= sy[k:k + BOX_CHUNK]) & (iy < ey[k:k + BOX_CHUNK]))
        order = torch.arange(k + 1, k + 1 + inside.shape[0],
                             dtype=torch.int64, device=device).view(-1, 1, 1)
        last = torch.maximum(last, (inside * order).amax(dim=0))
    covered = last > 0
    beta = torch.where(covered, 0.0, b0)
    refl = torch.where(covered, r[(last - 1).clamp(min=0)], r0)
    return beta, refl


def coefficients(g: Grid, beta, refl):
    """The six folded velocity-update planes: wall admittance and the edge
    impedance ABC (FDTD.cpp:143-223) as v' = A (v - C (p - p_m)) + B p +
    D p_m, each gate an exact 0/1."""
    Y = (1.0 - refl) / (1.0 + refl)
    nx, ny = beta.shape
    b_xm = F.pad(beta[:-1], (0, 0, 1, 0))
    y_xm = F.pad(Y[:-1], (0, 0, 1, 0))
    b_ym = F.pad(beta[:, :-1], (1, 0))
    y_ym = F.pad(Y[:, :-1], (1, 0))
    gi = torch.arange(nx, device=beta.device).view(nx, 1)
    gj = torch.arange(ny, device=beta.device).view(1, ny)
    w_x = (b_xm - beta) * (beta * y_xm + b_xm * Y)
    a_x, bc_x, d_x = beta * b_xm, w_x * beta, w_x * b_xm
    w_y = (b_ym - beta) * (beta * y_ym + b_ym * Y)
    a_y, bc_y, d_y = beta * b_ym, w_y * beta, w_y * b_ym
    row0, rowg = gi == 0, gi == g.grid_x
    col0, colg = gj == 0, gj == g.grid_y
    zero = torch.zeros_like(beta)
    if g.absorbing:
        in_gy = (gj < g.grid_y).to(beta.dtype).expand_as(beta)
        in_gx = (gi < g.grid_x).to(beta.dtype).expand_as(beta)
        eb_x, ed_x, eb_y, ed_y = -in_gy, in_gy, -in_gx, in_gx
    else:
        eb_x = ed_x = eb_y = ed_y = zero
    a_x = torch.where(row0 | rowg, zero, a_x)
    b_x = torch.where(row0, eb_x, torch.where(rowg, zero, bc_x))
    d_x = torch.where(rowg, ed_x, torch.where(row0, zero, d_x))
    a_y = torch.where(col0 | colg, zero, a_y)
    b_y = torch.where(col0, eb_y, torch.where(colg, zero, bc_y))
    d_y = torch.where(colg, ed_y, torch.where(col0, zero, d_y))
    return a_x, b_x, d_x, a_y, b_y, d_y


# -------------------------------------------------------------- simulation
def _step(p, vx, vy, beta, coefs, courant):
    """One FDTD step (FDTD.cpp:124-223); p is this step's pressure before
    the source is injected."""
    a_x, b_x, d_x, a_y, b_y, d_y = coefs
    div = ((F.pad(vx[..., 1:, :], (0, 0, 0, 1)) - vx)
           + (F.pad(vy[..., 1:], (0, 1)) - vy))
    p = beta * (p - courant * div)
    p_xm = F.pad(p[..., :-1, :], (0, 0, 1, 0))
    vx = a_x * (vx - courant * (p - p_xm)) + b_x * p + d_x * p_xm
    p_ym = F.pad(p[..., :-1], (1, 0))
    vy = a_y * (vy - courant * (p - p_ym)) + b_y * p + d_y * p_ym
    return p, vx, vy


def simulate(g: Grid, beta, refl, src, cells, state_dtype=torch.float32,
             keep=True):
    """The whole pass for B listener cells at once: the pre-injection
    recording [B, T, nx, ny] (None unless ``keep``), and the streamed
    accumulators (onset, flux x, flux y, e_dry, e_wet, e_total), each
    [B, nx, ny] float32; onset is +inf where |p| never crossed the
    audible threshold."""
    B, dev = len(cells), beta.device
    shape = (B, g.nx, g.ny)
    courant = float(torch.tensor(_courant(g)).to(state_dtype))
    thr = float(F32(AUDIBLE_THRESHOLD))
    flux_n = float(g.samples(DRY_DIRECTION_S))
    dry_n = float(g.samples(DRY_GAIN_S))
    wet_n = float(g.samples(WET_GAIN_S))
    beta_s, *coefs = (c.to(state_dtype)
                      for c in (beta, *coefficients(g, beta, refl)))
    src = src.to(state_dtype)
    p = vx = vy = torch.zeros(shape, dtype=state_dtype, device=dev)
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    onset = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
    fx = fy = ed = ew = et = zeros
    rec = (torch.empty((B, g.steps, g.nx, g.ny), dtype=state_dtype,
                       device=dev) if keep else None)
    live = [(b, i, j) for b, (i, j) in enumerate(cells)
            if 0 <= i < g.nx and 0 <= j < g.ny]
    at = tuple(torch.tensor(v, device=dev) for v in zip(*live))
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(g.steps):
        p, vx, vy = _step(p, vx, vy, beta_s, coefs, courant)
        pf, vxf, vyf = p.float(), vx.float(), vy.float()
        tf = float(t)
        onset = torch.minimum(onset, torch.where(pf.abs() > thr,
                                                 torch.full_like(pf, tf), inf))
        mp = torch.where(onset > tf - flux_n, pf, zero)
        fx = fx + mp * vxf
        fy = fy + mp * vyf
        sq = pf * pf
        ed = torch.where(onset > tf - dry_n, ed + sq, ed)
        ew = torch.where((onset <= tf - dry_n - 1.0)
                         & (onset > tf - dry_n - 1.0 - wet_n), ew + sq, ew)
        et = et + sq
        if keep:
            rec[:, t] = p
        if live:
            p[at] = p[at] + src[t]
    return rec, (onset, fx, fy, ed, ew, et)


def _courant(g: Grid) -> float:
    """c dt / dx in float32 (FDTD.cpp:90), dt = dx / (1.5 c)."""
    dx = F32(g.dx)
    dt = dx / (F32(C_SOUND) * F32(1.5))
    return float(F32(C_SOUND) * dt / dx)


def moments(g: Grid, rec_step, onset):
    """The RT60 regression moments (s0, s1) in one backward pass over the
    recording, ``rec_step(t)`` giving step t's [B, nx, ny] samples: the
    energy decay curve's y_db = 10 log10(max(EDC, 1e-37)) summed, and
    weighted by (t - start), over [onset + dry + 1, T - Schroeder offset)."""
    start = onset + float(g.samples(DRY_GAIN_S) + 1)
    end = float(g.steps - g.samples(SCHROEDER_OFFSET_S))
    scale = float(LOG10_SCALE)
    edc = s0 = s1 = torch.zeros_like(onset)
    for t in reversed(range(g.steps)):
        p = rec_step(t).float()
        edc = edc + p * p
        y = torch.log(torch.clamp(edc, min=1e-37)) * scale
        tf = float(t)
        m = (tf >= start) & (tf < end)
        s0 = torch.where(m, s0 + y, s0)
        s1 = torch.where(m, s1 + (tf - start) * y, s1)
    return s0, s1


def efree(params: dict, device) -> float:
    """The free-field calibration (FreeGrid.cpp:71-110): one pass on an
    empty grid (at most CAL_SIZE_M a side), the energy 1 m from the
    listener over the dry window and the direct path, times r."""
    g = grid(min(params["world_x"], CAL_SIZE_M),
             min(params["world_y"], CAL_SIZE_M), params["resolution"],
             absorbing=params["absorbing"])
    if (params["world_x"] <= CAL_SIZE_M and params["world_y"] <= CAL_SIZE_M):
        g = dataclasses.replace(g, offset_x=params["offset_x"],
                                offset_y=params["offset_y"])
    beta, refl = (torch.from_numpy(a).to(device) for a in base_fields(g))
    lx, ly = g.grid_x // 2, g.grid_y // 2
    ex = lx + int(F32(1.0) / F32(g.dx))
    cell = g.cell(float(F32(lx) * F32(g.dx)), float(F32(ly) * F32(g.dx)))
    rec, _ = simulate(g, beta, refl, pulse(g, device), [cell])
    sig = rec[0, :, ex, ly].cpu().numpy()
    n = g.samples(DRY_GAIN_S) + int(F32(1.0) / F32(C_SOUND) * F32(g.fs))
    e = float(np.sum(sig[:n].astype(np.float32) ** 2, dtype=np.float32))
    return float(F32(e) * (F32(ex - lx) * F32(g.dx)))


# ---------------------------------------------------------------- analysis
def _div(a, b):
    """a / b as one float32 division where either side is a scalar."""
    like = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return a / b


def _shift(arr, dr: int, dc: int, fill: float):
    gx, gy = arr.shape
    padded = F.pad(arr, (max(-dc, 0), max(dc, 0), max(-dr, 0), max(dr, 0)),
                   value=fill)
    return padded[max(dr, 0):max(dr, 0) + gx, max(dc, 0):max(dc, 0) + gy]


def _offset(idx, dx: float, lw: float):
    """float32 idx * dx - lw rounded once (exact in float64 first)."""
    return (idx.to(torch.float64) * dx - lw).to(torch.float32)


# the walk's neighbour order (ties keep the earliest, Analyzer.cpp:340-431)
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
               (1, 1))


def directions(g: Grid, occlusion, delay, lwx: float, lwy: float):
    """[gx, gy, 2] directions of arrival: from each cell the greedy walk
    over the onset-delay field to the neighbour of least delay, until line
    of sight, a near or loud cell, or no better neighbour (Analyzer.cpp:
    340-431), then the unit vector from the walk's end to the listener. The
    walk's end is found for every cell at once by squaring the successor
    map."""
    gx, gy = g.grid_x, g.grid_y
    n, dev = gx * gy, delay.device
    dx = float(F32(g.dx))
    c_sound, fs = F32(C_SOUND), F32(g.fs)
    thr_dist = float(F32(0.3) * (c_sound / F32(g.resolution)))
    rr = torch.arange(gx, dtype=torch.int64, device=dev).view(gx, 1)
    cc = torch.arange(gy, dtype=torch.int64, device=dev).view(1, gy)
    self_idx = (rr * gy + cc).expand(gx, gy)
    best_delay = torch.full((gx, gy), F32_MAX, dtype=torch.float32,
                            device=dev)
    best_idx = self_idx
    for dr, dc in _NEIGHBOURS:
        n_delay = _shift(delay, dr, dc, F32_MAX)
        ok = (_shift(occlusion, dr, dc, 0.0) > 0.0) & (n_delay < best_delay)
        best_delay = torch.where(ok, n_delay, best_delay)
        best_idx = torch.where(ok, (rr + dr) * gy + (cc + dc), best_idx)
    nxt = best_idx.reshape(n)
    nxt_delay = best_delay.reshape(n)
    has_next = nxt_delay < F32_MAX
    occ = occlusion.reshape(n)
    dly = delay.reshape(n)
    dxv = _offset(rr, dx, lwx).expand(gx, gy).reshape(n)
    dyv = _offset(cc, dx, lwy).expand(gx, gy).reshape(n)
    euclid = torch.sqrt(dxv * dxv + dyv * dyv)
    geodesic = float(c_sound) * dly / torch.full_like(dly, float(fs))
    los = (geodesic - euclid).abs() < thr_dist
    loud = occ >= float(F32(DISTANCE_GAIN_THRESHOLD))
    stop = los | (dly <= float(F32(DELAY_CLOSE_THRESHOLD))) | loud | ~has_next
    hop_stop = ~stop & has_next & (nxt_delay >= dly)
    advance = ~stop & (nxt_delay < dly)
    idx = self_idx.reshape(n)
    label0 = torch.where(hop_stop, nxt, idx)
    succ = torch.where(advance, nxt, idx)
    bound = min(max(n, 2), g.steps + 2)
    for _ in range(math.ceil(math.log2(bound))):
        succ = succ[succ]
    lab = label0[succ]
    final = torch.where(loud | ~has_next, lab, lab[nxt])
    ox = _offset(final // gy, dx, lwx)
    oy = _offset(final % gy, dx, lwy)
    lsq = ox * ox + oy * oy
    inv = torch.where(lsq != 0.0, 1.0 / torch.sqrt(lsq), torch.ones_like(lsq))
    return torch.stack([ox * inv, oy * inv], dim=-1).reshape(gx, gy, 2)


def assemble(g: Grid, acc, s0, s1, e_free: float, lx: float, lz: float):
    """One view's [gx, gy, 9] packed parameters (Analyzer.cpp:139-328):
    occlusion, wet gain, RT60, lowpass, direction, source directivity and
    the onset delay (FLT_MAX where never found)."""
    gx, gy, dev = g.grid_x, g.grid_y, s0.device
    onset, fx, fy, e_dry, e_wet, _ = (a[:gx, :gy] for a in acc)
    s0, s1 = s0[:gx, :gy], s1[:gx, :gy]
    fs = float(F32(g.fs))
    e_free = float(F32(e_free))
    lwx = F32(lx) + F32(g.offset_x)
    lwy = F32(lz) + F32(g.offset_y)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    found = torch.isfinite(onset)
    direct_end = torch.where(found, onset, zero) + float(g.samples(DRY_GAIN_S))
    # obstruction against the free field's 1/r energy (FreeGrid.cpp:41-59)
    inv_dx = F32(1.0) / F32(g.dx)
    lix, liy = int(lwx * inv_dx), int(lwy * inv_dx)
    dxf = float(F32(g.dx))
    ri = torch.arange(gx, dtype=torch.int32, device=dev).view(gx, 1)
    ci = torch.arange(gy, dtype=torch.int32, device=dev).view(1, gy)
    di = (ri - lix).to(torch.float32)
    dj = (ci - liy).to(torch.float32)
    r = torch.sqrt(di * di + dj * dj) * dxf
    here = (ri == lix) & (ci == liy)
    one = torch.ones((), dtype=torch.float32, device=dev)
    inv_r = torch.where(here, one, 1.0 / torch.where(here, one, r))
    occlusion = torch.where(found, torch.sqrt(e_dry / (e_free * inv_r)), zero)
    norm = torch.sqrt(fx * fx + fy * fy)
    inv_norm = -1.0 / torch.where(norm > 0.0, norm, torch.ones_like(norm))
    sdir = torch.where(found[..., None],
                       torch.stack([fx * inv_norm, fy * inv_norm], dim=-1),
                       zero)
    r_occ = 1.0 / torch.clamp(occlusion, min=0.001)
    lowpass = -147.0 + _div(18390.0, 1.0 + torch.pow(_div(r_occ, 12.0), 0.8))
    lowpass = torch.where(found, lowpass, zero)
    wet = torch.where(found, torch.sqrt(_div(e_wet, e_free)), zero)
    start = direct_end + 1.0
    rn = float(g.steps - g.samples(SCHROEDER_OFFSET_S)) - start
    ok = rn > 1.0
    rn = torch.where(ok, rn, torch.full_like(rn, 2.0))
    xmean = (rn - 1.0) * 0.5
    xsum = rn * xmean
    denom = (1.0 / 12.0) * rn * (rn * rn - 1.0)
    ymean = s0 / rn
    numer = s1 - ymean * xsum - xmean * s0 + rn * xmean * ymean
    rt60 = torch.where(found & ok, _div(-60.0, numer / denom * fs), zero)
    delay = torch.where(found, onset, torch.full_like(onset, F32_MAX))
    doa = directions(g, occlusion, delay, float(lwx), float(lwy))
    return torch.cat([occlusion[..., None], wet[..., None], rt60[..., None],
                      lowpass[..., None], doa, sdir, delay[..., None]],
                     dim=-1)


# ----------------------------------------------------------------- refresh
class Reference:
    """The reference engine for one configuration on one device: the grid,
    the pulse and the calibration, made once; :meth:`refresh` per input."""

    def __init__(self, params: dict, device, state_dtype=torch.float32):
        self.params = params
        self.device = torch.device(device)
        self.state_dtype = state_dtype
        self.grid = grid(params["world_x"], params["world_y"],
                         params["resolution"], params["offset_x"],
                         params["offset_y"], params["absorbing"])
        self.pulse = pulse(self.grid, self.device)
        self.efree = efree(params, self.device)

    def refresh(self, boxes, listeners, emitters, keep_recording=False):
        """One refresh: the fields, every view's [gx, gy, 9] packed grid,
        each emitter's output row per view (``None`` where the emitter is
        outside the grid), the emitters' cells in the grid (sorted, each
        once: the rows cells publish copies), and the recording
        [B, T, nx, ny] when asked.
        ``listeners`` are (x, z) world positions, ``emitters`` (x, z)."""
        g, dev = self.grid, self.device
        beta, refl = fields(g, boxes, dev)
        cells = [g.cell(x, z) for x, z in listeners]
        rec, acc = simulate(g, beta, refl, self.pulse, cells,
                            self.state_dtype, keep=True)
        s0, s1 = moments(g, lambda t: rec[:, t], acc[0])
        packed = torch.stack([
            assemble(g, [a[b] for a in acc], s0[b], s1[b], self.efree,
                     float(F32(x)), float(F32(z)))
            for b, (x, z) in enumerate(listeners)])
        packed_h = packed.cpu().numpy()
        rows, wanted = [], set()
        for x, z in emitters:
            cx, cy = g.cell(x, z)
            inside = 0 <= cx < g.grid_x and 0 <= cy < g.grid_y
            rows.append(packed_h[:, cx, cy, :8] if inside else None)
            if inside:
                wanted.add((cx, cy))
        return {"beta": beta, "refl": refl, "packed": packed_h,
                "outputs": rows, "cells": sorted(wanted),
                "recording": rec if keep_recording else None}
