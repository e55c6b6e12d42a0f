"""The comparison that decides ``correct``: what the timed path produced in
the refreshes checked, against the plain reference (``reference.py``) on the
same inputs.

Numbers compared, each the widest over the refreshes checked, every view and
every cell or emitter compared:

- ``fields_gap``: the largest |difference| of the voxelized beta and
  reflection fields the refresh stepped on (exact: the limit is 0);
- ``params_gap``: the published parameters, every cell of the grids on grids
  publish and every emitter's row on cells publish;
- ``outputs_gap``: the values ``Context.get_output`` returned for every
  emitter and view;
- ``recording_gap`` (one view only): the last refresh's published recording,
  the largest |difference| over the reference's largest |sample|.

In a cell with an audio callback (``drive.AudioPump``), over every block of
the window:

- ``audio_inputs_gap``: the blocks in which the DSP was not fed what it was
  due: a voice without a row, a voice's row equal to that emitter's row in
  none of the refreshes that could be current while the block read them
  (from the last refresh that had ended when the block started to the last
  that had started when it ended), or a clip read from another offset than
  the voices' own count gives (exact: the limit is 0). A block whose rows
  come from two of those refreshes is sound: ``Context.sync_dsp`` reads the
  published snapshot once a voice, and the engine may publish between two
  voices. Such blocks are counted apart (:func:`audio_inputs`, ``torn``);
- ``audio_gap``: the widest max |program - reference| of a block's mix over
  the reference's peak over the window, the reference being
  ``reference_dsp.replay`` on the rows the DSP was fed.

A parameter's gap is relative to the reference's value, floored at
:data:`FLOOR`, for the gains, RT60, lowpass and onset delay, and absolute for
the unit vectors (direction and source directivity); equal values (the
never-found sentinels too) read 0, and a non-finite value on one side reads
:data:`NONFINITE`.
"""

from __future__ import annotations

import numpy as np

# the floor of a relative gap's denominator
FLOOR = 1e-6
# what a gap reads where one side is not finite (JSON has no infinity)
NONFINITE = 1e30
# columns of an output row compared absolutely: the two unit vectors
UNIT_COLUMNS = (4, 5, 6, 7)
# the row of an emitter outside the grid (occlusion -1, the rest 0)
INVALID_ROW = np.array([-1.0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def gap(got, want) -> float:
    """Widest gap between [..., C] rows (C = 8 outputs or 9 packed
    columns) of the program (``got``) and the reference (``want``)."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    if a.shape != b.shape:
        return NONFINITE
    if a.size == 0:
        return 0.0
    unit = np.zeros(a.shape[-1], bool)
    unit[list(UNIT_COLUMNS)] = True
    with np.errstate(invalid="ignore", over="ignore"):
        scale = np.where(unit, 1.0, np.maximum(np.abs(b), FLOOR))
        g = np.abs(a - b) / scale
    g = np.where(a == b, 0.0,
                 np.where(np.isfinite(a) & np.isfinite(b), g, np.inf))
    return float(min(np.max(g), NONFINITE))


def output_row(out) -> np.ndarray:
    """A ``PlaneverbOutput`` -> its [8] row in the packed column order."""
    return np.array([out.occlusion, out.wet_gain, out.rt60, out.lowpass,
                     out.direction.x, out.direction.y,
                     out.source_directivity.x, out.source_directivity.y],
                    np.float32)


def published_packed(pub: dict, views: int) -> np.ndarray:
    """Grids publish: the published host grids -> [B, gx, gy, 9]."""
    parts = [pub["occlusion"], pub["wet_gain"], pub["rt60"], pub["lowpass"]]
    g = np.concatenate([p[..., None] for p in parts]
                       + [pub["direction"], pub["source_directivity"],
                          pub["delay_samples"][..., None]], axis=-1)
    return g.reshape(views, *g.shape[-3:])


def fields_gap(beta, refl, want: dict) -> float:
    d = max(float((beta.float() - want["beta"].to(beta.device)).abs().max()),
            float((refl.float() - want["refl"].to(refl.device)).abs().max()))
    return d if np.isfinite(d) else NONFINITE


def recording_gap(got, want, block: int = 64) -> float:
    """max |got - want| / max |want| over [T, nx, ny] recordings, in blocks
    of ``block`` steps."""
    if tuple(got.shape) != tuple(want.shape):
        return NONFINITE
    diff = peak = 0.0
    for t in range(0, want.shape[0], block):
        w = want[t:t + block].float()
        g = got[t:t + block].to(w.device).float()
        diff = max(diff, float((g - w).abs().max()))
        peak = max(peak, float(w.abs().max()))
    if not np.isfinite(diff):
        return NONFINITE
    return diff / peak if peak > 0 else (0.0 if diff == 0 else NONFINITE)


def compare(sample: dict, want: dict, views: int) -> dict:
    """The numbers of one checked refresh: ``sample`` what the program
    published and returned (``drive.Window.samples``), ``want`` the
    reference's :meth:`Reference.refresh`."""
    out = {"fields_gap": fields_gap(sample["beta"], sample["refl"], want)}
    ref_packed = want["packed"]                      # [B, gx, gy, 9]
    pub = sample["published"]
    if "cells" in pub:
        rows = [pub["cells"].get(c) for c in want["cells"]]
        if any(r is None for r in rows):
            out["params_gap"] = NONFINITE
        else:
            got = np.stack([np.asarray(r).reshape(views, 9) for r in rows], 1)
            exp = np.stack([ref_packed[:, i, j] for i, j in want["cells"]], 1)
            out["params_gap"] = gap(got, exp)
    else:
        out["params_gap"] = gap(published_packed(pub, views), ref_packed)
    got = np.array([[output_row(o) for o in per_view]
                    for per_view in sample["outputs"]])
    exp = np.array([[INVALID_ROW if r is None else r[v] for r in
                     want["outputs"]] for v in range(views)])
    out["outputs_gap"] = gap(got, exp)
    return out


def judge(numbers: list[dict], limits: dict) -> tuple[dict, list]:
    """The widest of each number over the refreshes checked, and the names
    of the numbers above their limits. A number without a limit fails."""
    worst = {}
    for n in numbers:
        for k, v in n.items():
            worst[k] = max(worst.get(k, 0.0), v)
    failed = [k for k, v in worst.items()
              if k not in limits or not v <= limits[k]]
    return worst, failed


def audio_inputs(rows, fed, offsets, block_start, block_end, starts, ends,
                 refresh_rows, lengths, frames: int) -> dict:
    """Each block's inputs against the refresh loop's rows.

    rows [B, V, 8] and fed [B, V] what the DSP got, offsets [B, V] the clip
    offsets the voices read from, block_start / block_end [B] and starts /
    ends [R] (host clock, every refresh in order, warm-up included),
    refresh_rows [R, V, 8], lengths [V] the clips' frames. Returns ``gap``
    and ``torn`` [B] (see the module's ``audio_inputs_gap``) and ``rows``
    [B, V, 8]: the rows fed, and the row of the last refresh ended before
    the block where a voice got none (what the reference replays)."""
    import bisect

    blocks, voices = fed.shape
    got = np.ascontiguousarray(rows, np.float32).view(np.uint32)
    have = np.ascontiguousarray(refresh_rows, np.float32).view(np.uint32)
    want_off = (np.arange(blocks)[:, None] * frames) % np.asarray(lengths)
    gap = ~fed.all(1) | (np.asarray(offsets) != want_off).any(1)
    torn = np.zeros(blocks, bool)
    out = np.array(rows, np.float32)
    for b in range(blocks):
        first = max(bisect.bisect_right(ends, block_start[b]) - 1, 0)
        last = max(bisect.bisect_right(starts, block_end[b]) - 1, first)
        eq = (have[first:last + 1] == got[b][None]).all(-1)     # [k, V]
        gap[b] |= not (eq.any(0) | ~fed[b]).all()
        torn[b] = eq.any(0).all() and not eq.all(1).any()
        out[b, ~fed[b]] = refresh_rows[first][~fed[b]]
    return {"gap": gap, "torn": torn, "rows": out}


def audio_gap(got, want) -> np.ndarray:
    """[B]: each block's max |got - want| over the peak |want| of the whole
    window, mixes [B, frames, 2]."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.full(len(want), NONFINITE)
    peak = float(np.abs(want).max()) if want.size else 0.0
    with np.errstate(invalid="ignore"):
        d = np.abs(got - want).reshape(len(want), -1).max(1)
    d = np.where(np.isfinite(d), d, np.inf)
    if peak > 0:
        return np.minimum(d / peak, NONFINITE)
    return np.where(d == 0, 0.0, NONFINITE)
