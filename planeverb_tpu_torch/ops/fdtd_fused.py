"""Fused FDTD simulation + RT60 moments: the two kernels of an engine step.

Counterpart of ``planeverb_tpu/ops/fdtd_pallas.py``. Two kernels, each
hand-written in CUDA with a plain PyTorch version of the same function, and
wrappers for one listener and for B:

  - B1 (replaces ``fdtd_pallas.py::_kernel``): all T FDTD steps, recording
    the pre-injection pressure, streaming the onset, the source-directivity
    flux and the windowed energies, in ``csrc/fdtd_fused.cu``.
    :func:`fdtd_sim` for one listener,
    :func:`fdtd_sim_batch` for B listeners in one pass (its ``batched``
    mode: the B listeners share the field planes). A pass is one launch,
    a thread-block cluster a listener holding the field on chip for all T
    steps, for fields of at most :data:`CLUSTER_CELLS` cells
    (:func:`b1_fits`); the card refuses a larger one, which the route
    sends to the tiled kernels.
  - B2 (replaces ``fdtd_pallas.py::_moments_kernel``): one backward pass
    over the recording for the RT60 regression moments, in
    ``csrc/moments.cu``. :func:`rt60_moments` for one recording,
    :func:`rt60_moments_batch` for B listeners', :func:`rt60_moments_many`
    for any list of recordings on one device (a sharded pass's shards).
    Each is one launch over a table of its recordings
    (:func:`moments_table`): a warp streams a tile of
    :data:`MOMENTS_TILE` cells through its ring in shared memory, a lane a
    cell, and takes a chunk's logarithms as independent chains.

``state_dtype=torch.bfloat16`` is the half-precision wave-state mode of
the TPU kernel: p/vx/vy, beta and the coefficient planes and the recording
are bf16, each operation computed in float and rounded once; onset, flux
and the energies stay float32, and B2 reads the bf16 recording.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version, any other device raises.
There is no fallback from the kernel to the plain version. Each wrapper
counts its kernel launches in its ``launches`` attribute;
:func:`reset_launch_counts` zeroes every kernel's counter.

:func:`simulate_auto`, :func:`pipeline_auto` and :func:`pipeline_auto_batch`
take the route :func:`route_tiled` gives their pass: the tiled kernels of
``ops/fdtd_tiled.py`` (B3, B4; float32 state, one listener a pass) or B1 +
B2.

Fields are exactly [nx, ny] and a recording exactly [T, nx, ny]: no
padding, no chunking, and no element limit (offsets are 64-bit); a batch
too large for the card fails in ``torch.empty`` with its out-of-memory
error.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from planeverb_tpu_torch import kernels
from planeverb_tpu_torch.config import GridParams
from planeverb_tpu_torch.ops import analyzer, fdtd_tiled
from planeverb_tpu_torch.ops._common import (check_field, coefficients,
                                             counted, fresh_acc,
                                             moment_scalars, moment_step,
                                             moments_shape, on_card,
                                             reset_launch_counts,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.analyzer import AnalyzerResults, Moments
from planeverb_tpu_torch.ops.fdtd import FdtdResult, fdtd_step_folded
from planeverb_tpu_torch.utils.profiling import count, span, spanned

__all__ = ["STATE_DTYPES", "CLUSTER_CELLS", "b1_fits", "fdtd_sim",
           "fdtd_sim_reference", "fdtd_sim_batch",
           "fdtd_sim_batch_reference", "MOMENTS_TILE", "MOMENTS_CHUNK",
           "MOMENTS_MAX_ENTRIES", "MOMENTS_PROBE_MODES", "MomentsRow",
           "moments_table", "rt60_moments", "rt60_moments_reference",
           "rt60_moments_batch", "rt60_moments_batch_reference",
           "rt60_moments_many", "rt60_moments_many_reference",
           "rt60_moments_probe", "simulate_moments_fused",
           "simulate_moments_fused_reference", "simulate_moments_fused_batch",
           "simulate_auto", "pipeline_auto", "pipeline_auto_batch",
           "reset_launch_counts", "TILED_MIN_CELLS", "TILED_SINGLE_MIN_CELLS",
           "route_tiled"]

# the wave-state types of B1 (and recording types of B2)
STATE_DTYPES = (torch.float32, torch.bfloat16)
# the most cells B1's cluster holds: 16 blocks of 768 threads, three cells
# a thread (csrc/fdtd_fused.cu kCluster, kClusterThreads, kClusterRun)
CLUSTER_CELLS = 16 * 768 * 3


def _listener_cells(where: str, lcells) -> list[tuple[int, int]]:
    """A host [B, 2] integer array-like (list, numpy, CPU tensor) ->
    B (ix, iy) pairs."""
    cells = [tuple(int(v) for v in c) for c in lcells]
    if not cells or any(len(c) != 2 for c in cells):
        raise ValueError(f"{where}: listener cells must be [B, 2] with "
                         f"B >= 1, got {cells}")
    return cells


def _check_sim(where: str, params: GridParams, beta, refl, pulse,
               state_dtype) -> None:
    nx, ny = params.nx, params.ny
    check_field(where, "beta", beta, (nx, ny))
    check_field(where, "refl", refl, (nx, ny))
    check_field(where, "pulse", pulse, (params.response_length,))
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"{where}: state_dtype must be one of "
                         f"{STATE_DTYPES}, got {state_dtype}")


# ----------------------------------------------------------------- B1 sim
def fdtd_sim_batch_reference(params: GridParams, beta, refl, pulse, lcells,
                             state_dtype=torch.float32):
    """Plain version of B1 for B listeners: a Python loop over T of
    ``fdtd_step_folded`` on [B, nx, ny] state plus the kernel's streaming
    predicates, on any device. In bf16 the state, the fields and the pulse
    are bf16 and the accumulators read the state as float32.

    Returns (FdtdResult, (e_dry, e_wet, e_total)), every field with a
    leading [B] axis; the recording is [B, T, nx, ny] of ``state_dtype``.
    """
    cells = _listener_cells("fdtd_sim_batch_reference", lcells)
    B = len(cells)
    nx, ny, T = params.nx, params.ny, params.response_length
    scalars = window_scalars(params, state_dtype)
    beta_s, *coefs = (c.to(state_dtype) for c in
                      (beta, *coefficients(params, beta, refl)))
    pulse_s = pulse.to(state_dtype)
    dev = beta.device

    p = vx = vy = torch.zeros((B, nx, ny), dtype=state_dtype, device=dev)
    acc = fresh_acc((B, nx, ny), dev)
    rec = torch.empty((B, T, nx, ny), dtype=state_dtype, device=dev)
    # a listener outside the field injects nothing (the kernel compares
    # cell indices)
    inside = [(b, i, j) for b, (i, j) in enumerate(cells)
              if 0 <= i < nx and 0 <= j < ny]
    src = tuple(torch.tensor(v, device=dev) for v in zip(*inside))

    for t in range(T):
        p, vx, vy = fdtd_step_folded(p, vx, vy, beta_s, coefs, scalars[0])
        acc = stream_step(t, p.float(), vx.float(), vy.float(), acc,
                          scalars)
        rec[:, t] = p  # record pre-injection, then inject at the listener
        if inside:
            p[src] = p[src] + pulse_s[t]
    onset, fx, fy, ed, ew, et = acc
    res = FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy)
    return res, (ed, ew, et)


def fdtd_sim_reference(params: GridParams, beta, refl, pulse,
                       lix: int, liy: int, state_dtype=torch.float32):
    """Plain version of B1 for one listener (the batched plain version with
    B = 1), on any device. Returns (FdtdResult, (e_dry, e_wet, e_total))."""
    res, acc = fdtd_sim_batch_reference(params, beta, refl, pulse,
                                        [(lix, liy)], state_dtype)
    return FdtdResult(*(x[0] for x in res)), tuple(x[0] for x in acc)


def b1_fits(nx: int, ny: int) -> bool:
    """Whether B1's kernel holds an nx x ny field: at most
    :data:`CLUSTER_CELLS` cells, in float32 and bf16 and for any number of
    listeners. :func:`route_tiled` sends B1 no larger grid."""
    return nx * ny <= CLUSTER_CELLS


def _launch_fdtd_sim(where: str, params: GridParams, beta, refl, pulse,
                     cells, state_dtype):
    nx, ny, T = params.nx, params.ny, params.response_length
    if not b1_fits(nx, ny):
        raise ValueError(f"{where}: a {nx}x{ny} field is above the "
                         f"{CLUSTER_CELLS} cells B1 holds on the card; the "
                         f"tiled kernels (fdtd_tiled.fdtd_sim_tiled, "
                         f"rt60_moments_tiled) step it")
    B = len(cells)
    courant, thr, src_dir_n, dry_n, wet_n = window_scalars(params,
                                                           state_dtype)
    coefs = coefficients(params, beta, refl)
    fields = [c.to(state_dtype).contiguous() for c in (beta, *coefs)]
    pulse = pulse.contiguous()
    dev = beta.device
    rec = torch.empty((B, T, nx, ny), dtype=state_dtype, device=dev)
    acc = torch.empty((6, B, nx, ny), dtype=torch.float32, device=dev)
    # the [B, 2] listener table, copied without a host sync
    lc = torch.tensor(cells, dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pv_fdtd_sim(
            *(f.data_ptr() for f in fields), pulse.data_ptr(),
            rec.data_ptr(), acc.data_ptr(), lc.data_ptr(), nx, ny, T, B,
            int(state_dtype == torch.bfloat16), courant, thr, src_dir_n,
            dry_n, wet_n, stream)
    return err, rec, acc


@counted
@spanned("solver")
def fdtd_sim(params: GridParams, beta, refl, pulse, lix: int, liy: int,
             state_dtype=torch.float32):
    """One full simulation pass with streaming onset/flux/energies (B1).

    Args:
      beta, refl: [nx, ny] float32 air flags and reflection coefficients.
      pulse: [T] float32 source pulse.
      lix, liy: listener cell (a cell outside the field injects nothing).
      state_dtype: torch.float32 or torch.bfloat16 wave state.
    Returns (FdtdResult, (e_dry, e_wet, e_total)): the [T, nx, ny]
    pre-injection recording (of ``state_dtype``), onset (+inf where never
    crossed), flux, and the windowed energies of :class:`analyzer.Moments`.
    """
    where = "fdtd_sim"
    _check_sim(where, params, beta, refl, pulse, state_dtype)
    lix, liy = int(lix), int(liy)
    if not on_card(where, beta, refl, pulse):
        return fdtd_sim_reference(params, beta, refl, pulse, lix, liy,
                                  state_dtype)
    err, rec, acc = _launch_fdtd_sim(where, params, beta, refl, pulse,
                                     [(lix, liy)], state_dtype)
    kernels.check(err, where)
    fdtd_sim.launches += 1
    onset, fx, fy, ed, ew, et = (a[0] for a in acc)
    return (FdtdResult(pressure=rec[0], onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


@counted
@spanned("solver")
def fdtd_sim_batch(params: GridParams, beta, refl, pulse, lcells,
                   state_dtype=torch.float32):
    """B1 for B listeners in one pass (the TPU kernel's batched mode): one
    launch of B clusters advances every listener, all reading one copy of
    the field planes. Bit-equal to B :func:`fdtd_sim` passes.

    ``lcells`` is a host [B, 2] integer array-like of listener cells; the
    other arguments as :func:`fdtd_sim`. Returns (FdtdResult,
    (e_dry, e_wet, e_total)) with a leading [B] axis on every field (the
    recording [B, T, nx, ny])."""
    where = "fdtd_sim_batch"
    _check_sim(where, params, beta, refl, pulse, state_dtype)
    cells = _listener_cells(where, lcells)
    if not on_card(where, beta, refl, pulse):
        return fdtd_sim_batch_reference(params, beta, refl, pulse, cells,
                                        state_dtype)
    err, rec, acc = _launch_fdtd_sim(where, params, beta, refl, pulse,
                                     cells, state_dtype)
    kernels.check(err, where)
    fdtd_sim_batch.launches += 1
    onset, fx, fy, ed, ew, et = acc
    return (FdtdResult(pressure=rec, onset=onset, flux_x=fx, flux_y=fy),
            (ed, ew, et))


# ------------------------------------------------------------- B2 moments
# The card's B2 (csrc/moments.cu): a launch covers up to
# MOMENTS_MAX_ENTRIES recordings; a one-warp block owns a tile of
# MOMENTS_TILE consecutive cells of one of them.
MOMENTS_TILE = 32
# rows (time steps) of a chunk of the kernel's walk (csrc/moments.cu kChunk)
MOMENTS_CHUNK = 16
MOMENTS_MAX_ENTRIES = 64
# the probe's modes (everything, no logarithms: the loads and sums, no
# loads: the logarithms and sums on samples made in registers)
MOMENTS_PROBE_MODES = ("full", "no_log", "no_load")


class MomentsRow(NamedTuple):
    """One recording's place in a B2 launch: its first block, its blocks,
    and whether every row of it starts 16-byte aligned."""
    tile0: int
    tiles: int
    aligned: bool


def moments_table(entries):
    """The tiling of one B2 launch over recordings given as (cells,
    element bytes, address of the first sample): the launch's blocks in
    entry order, :data:`MOMENTS_TILE` cells each, an entry's last block
    holding what is left. Block b belongs to the last entry whose ``tile0``
    is at or below b (the kernel's lookup) and covers its cells
    [(b - tile0) * MOMENTS_TILE, min(cells, (b - tile0 + 1) *
    MOMENTS_TILE)). An entry is aligned when its first sample and its rows
    (cells x element bytes) are 16-byte aligned; the kernel reads a row
    that is not from the 16-byte words covering it. Returns ([MomentsRow],
    total blocks). Plain integers, no device."""
    rows, tile0 = [], 0
    for cells, elem, addr in entries:
        cells, elem, addr = int(cells), int(elem), int(addr)
        if cells < 1 or elem < 1:
            raise ValueError(f"moments_table: an entry of {cells} cells of "
                             f"{elem} bytes")
        tiles = -(-cells // MOMENTS_TILE)
        rows.append(MomentsRow(tile0, tiles,
                               addr % 16 == 0 and cells * elem % 16 == 0))
        tile0 += tiles
    return rows, tile0


def rt60_moments_reference(params: GridParams, rec, onset):
    """Plain version of B2: a backward Python loop over the recording
    ([T, X, Y], or [B, T, X, Y] for B listeners; each sample read as
    float32) against the [X, Y] (or [B, X, Y]) onset, in the kernel's
    summation order, on any device. Returns (s0, s1)."""
    dry_n1, end, log10_scale = moment_scalars(params)
    start = onset + dry_n1
    carry = (torch.zeros_like(onset),) * 3
    for t in reversed(range(rec.shape[-3])):
        carry = moment_step(t, rec.select(-3, t).float(), start, end,
                            log10_scale, carry)
    return carry[1], carry[2]


# the plain version takes a leading listener axis as it is
rt60_moments_batch_reference = rt60_moments_reference


def rt60_moments_many_reference(params: GridParams, recs, onsets):
    """Plain version of :func:`rt60_moments_many`: the plain B2 on each
    recording in turn, on any device. Returns a list of (s0, s1)."""
    return [rt60_moments_reference(params, r, o)
            for r, o in zip(recs, onsets)]


def _check_many(where: str, params: GridParams, recs, onsets):
    recs, onsets = list(recs), list(onsets)
    if not recs or len(recs) != len(onsets):
        raise ValueError(f"{where}: need as many onsets as recordings (at "
                         f"least one), got {len(recs)} and {len(onsets)}")
    for r, o in zip(recs, onsets):
        moments_shape(where, params, r, o, rec_dtypes=STATE_DTYPES)
    if len({r.dtype for r in recs}) != 1:
        raise ValueError(f"{where}: the recordings must share one type, got "
                         f"{sorted({str(r.dtype) for r in recs})}")
    return recs, onsets


def _launch_moments(where: str, params: GridParams, recs, onsets,
                    probe=None):
    """B2 on the card over [T, X_i, Y_i] recordings of one type and their
    [X_i, Y_i] onsets, one launch per :data:`MOMENTS_MAX_ENTRIES` of them.
    ``probe``: a mode of :func:`rt60_moments_probe`. Returns
    (s, launches): s [2, sum of X_i * Y_i], each recording's s0 and s1 in
    turn along the second axis."""
    recs = [r.contiguous() for r in recs]
    onsets = [o.contiguous() for o in onsets]
    dev = recs[0].device
    cells = [o.numel() for o in onsets]
    s = torch.empty((2, sum(cells)), dtype=torch.float32, device=dev)
    T = params.response_length
    dry_n1, end, log10_scale = moment_scalars(params)
    bf16 = int(recs[0].dtype == torch.bfloat16)
    outs = _split(s, onsets)
    lib = kernels.library()
    launches = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g in range(0, len(recs), MOMENTS_MAX_ENTRIES):
            part = range(g, min(g + MOMENTS_MAX_ENTRIES, len(recs)))
            rows, tiles = moments_table(
                [(cells[i], recs[i].element_size(), recs[i].data_ptr())
                 for i in part])
            table = (kernels.MomentsEntry * len(rows))()
            for e, (i, row) in enumerate(zip(part, rows)):
                table[e] = kernels.MomentsEntry(
                    recs[i].data_ptr(), onsets[i].data_ptr(),
                    outs[i][0].data_ptr(), outs[i][1].data_ptr(), cells[i],
                    row.tile0, int(row.aligned))
            args = (ctypes.addressof(table), len(rows), tiles, T, bf16,
                    dry_n1, end, log10_scale)
            if probe is None:
                err = lib.pv_rt60_moments(*args, stream)
            else:
                err = lib.pv_rt60_moments_probe(
                    *args, MOMENTS_PROBE_MODES.index(probe), stream)
            kernels.check(err, where)
            launches += 1
    return s, launches


def _split(s, onsets):
    """Each recording's (s0, s1) views of a launch's outputs."""
    out, off = [], 0
    for o in onsets:
        c = o.numel()
        out.append((s[0, off:off + c].view(o.shape),
                    s[1, off:off + c].view(o.shape)))
        off += c
    return out


@counted
@spanned("solver")
def rt60_moments(params: GridParams, rec, onset):
    """RT60 regression moments (s0, s1) of :class:`analyzer.Moments` from
    the [T, X, Y] recording (float32 or bf16) and the [X, Y] onset: the
    whole field, or one shard of it (B2). One launch on a card."""
    where = "rt60_moments"
    nx, ny = moments_shape(where, params, rec, onset,
                           rec_dtypes=STATE_DTYPES)
    if not on_card(where, rec, onset):
        return rt60_moments_reference(params, rec, onset)
    s, n = _launch_moments(where, params, [rec], [onset])
    rt60_moments.launches += n
    return s[0].view(nx, ny), s[1].view(nx, ny)


@counted
@spanned("solver")
def rt60_moments_batch(params: GridParams, rec, onset):
    """B2 for B listeners in one launch: the [B, T, X, Y] recordings
    (float32 or bf16) and [B, X, Y] onsets -> (s0, s1), each [B, X, Y].
    Bit-equal to B :func:`rt60_moments` calls."""
    where = "rt60_moments_batch"
    nx, ny = moments_shape(where, params, rec, onset, batched=True,
                           rec_dtypes=STATE_DTYPES)
    if not on_card(where, rec, onset):
        return rt60_moments_batch_reference(params, rec, onset)
    s, n = _launch_moments(where, params, list(rec.unbind(0)),
                           list(onset.unbind(0)))
    rt60_moments_batch.launches += n
    B = rec.shape[0]
    return s[0].view(B, nx, ny), s[1].view(B, nx, ny)


@counted
def rt60_moments_many(params: GridParams, recs, onsets):
    """B2 over several recordings of one device at once (the shards a
    device holds in a sharded pass): ``recs`` [T, X_i, Y_i] recordings of
    one type (float32 or bf16), ``onsets`` their [X_i, Y_i] onsets.
    Returns a list of (s0, s1), each [X_i, Y_i], bit-equal to
    :func:`rt60_moments` on each. One launch on a card (one per
    :data:`MOMENTS_MAX_ENTRIES` recordings)."""
    where = "rt60_moments_many"
    recs, onsets = _check_many(where, params, recs, onsets)
    if not on_card(where, *recs, *onsets):
        return rt60_moments_many_reference(params, recs, onsets)
    s, n = _launch_moments(where, params, recs, onsets)
    rt60_moments_many.launches += n
    return _split(s, onsets)


def rt60_moments_probe(params: GridParams, recs, onsets,
                       mode: str = "full"):
    """B2's card kernel in a probe's mode, for ``chip_smoke.py``; the
    engine never calls it, and it counts in no wrapper's ``launches``.
    ``mode``: one of :data:`MOMENTS_PROBE_MODES` (the outputs are the
    moments in ``"full"`` only). Arguments and return as
    :func:`rt60_moments_many`; CUDA tensors only."""
    where = "rt60_moments_probe"
    recs, onsets = _check_many(where, params, recs, onsets)
    if mode not in MOMENTS_PROBE_MODES:
        raise ValueError(f"{where}: no mode {mode!r}")
    if not on_card(where, *recs, *onsets):
        raise ValueError(f"{where}: needs CUDA tensors (a probe of the "
                         f"card's kernel), got {recs[0].device}")
    s, _ = _launch_moments(where, params, recs, onsets, probe=mode)
    return _split(s, onsets)


# ------------------------------------------------------------ compositions
def simulate_moments_fused(params: GridParams, beta, refl, pulse,
                           lix: int, liy: int, state_dtype=torch.float32):
    """Sim + analyzer moments: B1 then B2. Returns (FdtdResult, Moments)."""
    res, (ed, ew, et) = fdtd_sim(params, beta, refl, pulse, lix, liy,
                                 state_dtype)
    s0, s1 = rt60_moments(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_fused_reference(params: GridParams, beta, refl, pulse,
                                     lix: int, liy: int):
    """Plain versions of B1 then B2 on any device."""
    res, (ed, ew, et) = fdtd_sim_reference(params, beta, refl, pulse,
                                           lix, liy)
    s0, s1 = rt60_moments_reference(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


def simulate_moments_fused_batch(params: GridParams, beta, refl, pulse,
                                 lcells, state_dtype=torch.float32):
    """Batched sim + moments for B listeners: one B1 pass and one B2 launch
    (the counterpart of ``simulate_moments_pallas_batch``). Returns
    (FdtdResult, Moments), every field with a leading [B] axis; the caller
    may drop the [B, T, nx, ny] recordings."""
    res, (ed, ew, et) = fdtd_sim_batch(params, beta, refl, pulse, lcells,
                                       state_dtype)
    s0, s1 = rt60_moments_batch(params, res.pressure, res.onset)
    return res, Moments(e_dry=ed, e_wet=ew, e_total=et, s0=s0, s1=s1)


# Grids of more than this many solver cells (nx * ny) take the tiled route
# (B3 + B4, ops/fdtd_tiled.py) whatever else holds, and a mesh's shards B6
# (parallel/solver_fused.py). It is the most B1's cluster holds
# (CLUSTER_CELLS), and one batched B1 pass of four views at 192^2 beats four
# B3 passes.
TILED_MIN_CELLS = 192 * 192
# One float32 listener on the card takes the tiled route from this many
# cells, the smallest size swept: B3 + B4 spread the pass over every SM and
# fold the coefficients in the kernel, where B1's cluster holds a listener
# on 16 SMs after a fold of ~50 launches on the host. chip_smoke.py phase 10
# on an H100 80GB HBM3 at 700 W (CUDA events from idle, the host enqueue
# and B1's fold included, medians of 5 in turns), B3 + B4 over B1 + B2 in
# two runs: 0.598 / 0.585 at 65^2, 0.702 / 0.690 at 96^2, 0.572 / 0.566 at
# 128^2, 0.494 / 0.510 at 160^2, 0.471 / 0.456 at 192^2. Nothing smaller
# was measured, so smaller grids keep B1.
TILED_SINGLE_MIN_CELLS = 65 * 65


def route_tiled(cells: int, listeners: int, state_dtype,
                card: bool) -> bool:
    """Whether a pass of ``listeners`` listeners over ``cells`` solver cells
    with ``state_dtype`` wave state, on the card or not, takes the tiled
    route (B3 + B4) rather than B1 + B2: above :data:`TILED_MIN_CELLS`
    always; one float32 listener on the card from
    :data:`TILED_SINGLE_MIN_CELLS`. The tiled route runs float32 whatever
    it is given, so a bf16 pass stays on B1 under TILED_MIN_CELLS; on the
    CPU the plain B1 is the cheaper of two bit-equal versions."""
    if cells > TILED_MIN_CELLS:
        return True
    return (card and listeners == 1 and state_dtype == torch.float32
            and cells >= TILED_SINGLE_MIN_CELLS)


def simulate_auto(params: GridParams, beta, refl, pulse,
                  lix: int, liy: int) -> FdtdResult:
    """One float32 simulation pass on the fields' device, B3 or B1 as
    :func:`route_tiled` routes one listener."""
    if route_tiled(params.nx * params.ny, 1, torch.float32,
                   beta.device.type == "cuda"):
        res, _ = fdtd_tiled.fdtd_sim_tiled(params, beta, refl, pulse, lix, liy)
    else:
        res, _ = fdtd_sim(params, beta, refl, pulse, lix, liy)
    return res


@spanned("route")
def pipeline_auto(params: GridParams, beta, refl, pulse, lix: int, liy: int,
                  efree: float, listener_x: float, listener_z: float,
                  compute_directions: bool = True,
                  state_dtype=torch.float32
                  ) -> tuple[FdtdResult, AnalyzerResults]:
    """Full pass on the fields' device, B3 + B4 or B1 + B2 as
    :func:`route_tiled` routes one listener, then parameter assembly and,
    unless ``compute_directions`` is False, DOA. Returns (FdtdResult,
    AnalyzerResults); the recording is the exact [T, nx, ny] buffer the sim
    kernel wrote. ``state_dtype`` picks B1's wave state; the tiled route
    runs float32 whatever it is, as the JAX package's does.

    Counts one solver pass and one view in the step's ``route.passes`` and
    ``route.views`` counters, and a pass on B3 + B4 in
    ``route.tiled_passes``."""
    if route_tiled(params.nx * params.ny, 1, state_dtype,
                   beta.device.type == "cuda"):
        res, moments = fdtd_tiled.simulate_moments_tiled(
            params, beta, refl, pulse, lix, liy)
        count("route.tiled_passes")
    else:
        res, moments = simulate_moments_fused(params, beta, refl, pulse,
                                              lix, liy, state_dtype)
    count("route.passes")
    count("route.views")
    out = analyzer.analyze_moments(params, moments, res.onset, res.flux_x,
                                   res.flux_y, efree, listener_x, listener_z,
                                   compute_directions=compute_directions)
    return res, out


@spanned("route")
def pipeline_auto_batch(params: GridParams, beta, refl, pulse, lcells,
                        efree: float, lpos, compute_directions: bool = True,
                        state_dtype=torch.float32) -> AnalyzerResults:
    """Full pass for B listeners: AnalyzerResults with a leading [B] axis
    on every grid; the recordings are dropped.

    On B1 + B2 (as :func:`route_tiled` routes B listeners) the listeners
    run together in the batched kernels (:func:`simulate_moments_fused_batch`:
    one B1 pass, one B2 launch). On the tiled route each listener runs its
    own B3 + B4 pass (float32), as the JAX package's ``lax.map`` does, and
    its recording is freed before the next pass starts, so the route holds
    one recording at a time. On either route one ``analyze_moments`` call
    then assembles every view (on a card two launches for all of them).

    The step's ``route.passes`` counter counts the solver passes (1 on the
    batched route, B on the tiled one, also counted in
    ``route.tiled_passes``) and ``route.views`` the B views; on the tiled
    route each view's pass runs inside a ``view`` span.

    ``lcells``: host [B, 2] listener cells; ``lpos``: B listener world
    positions (x, z), float32 values.
    """
    cells = _listener_cells("pipeline_auto_batch", lcells)
    lpos = [(float(x), float(z)) for x, z in lpos]
    if len(lpos) != len(cells):
        raise ValueError(f"pipeline_auto_batch: {len(cells)} listener cells "
                         f"but {len(lpos)} positions")
    if not route_tiled(params.nx * params.ny, len(cells), state_dtype,
                       beta.device.type == "cuda"):
        res, mom = simulate_moments_fused_batch(params, beta, refl, pulse,
                                                cells, state_dtype)
        count("route.passes")
        onset, fx, fy = res.onset, res.flux_x, res.flux_y
        del res   # the recordings go before the assembly
    else:
        planes = []
        for cix, ciy in cells:
            with span("view"):
                res, mom = fdtd_tiled.simulate_moments_tiled(
                    params, beta, refl, pulse, cix, ciy)
                count("route.passes")
                count("route.tiled_passes")
                planes.append((*mom, res.onset, res.flux_x, res.flux_y))
                del res   # this listener's recording goes before the next pass
        planes = [torch.stack(g) for g in zip(*planes)]
        mom, (onset, fx, fy) = Moments(*planes[:5]), planes[5:]
    count("route.views", len(cells))
    xs, zs = zip(*lpos)
    return analyzer.analyze_moments(params, mom, onset, fx, fy, efree, xs, zs,
                                    compute_directions=compute_directions)
