"""State carried across from the JAX package.

The engine has no weights; what the two packages must share to compute on
the same inputs is the scene, the voxelized fields (beta, R), the source
pulse, and the calibrated EFree (a Python float, which needs no
conversion); the DSP's carried state (the batched renderer's smoothing and
filter memories, a reverb's rings and counter) lets both packages run on
from the same point of a stream. Nothing here imports ``planeverb_tpu``:
the JAX package's objects are read through their fields, and its arrays
through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch.dsp.ops import DSPState, SourceParams
from planeverb_tpu_torch.dsp.reverb import ReverbState
from planeverb_tpu_torch.scene import AABB, Scene

__all__ = ["scene_from_jax", "fields_from_numpy", "dsp_state_from_numpy",
           "reverb_state_from_numpy"]


def _tensor(a, device, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(
        device)


def scene_from_jax(scene) -> Scene:
    """A ``planeverb_tpu.scene.Scene`` (or any iterable of its ``AABB``s)
    -> the port's :class:`Scene`, boxes in the same paint order."""
    boxes = getattr(scene, "boxes", scene)
    return Scene(boxes=[AABB(float(b.x), float(b.y), float(b.width),
                             float(b.height), float(b.absorption))
                        for b in boxes],
                 name=getattr(scene, "name", ""))


def fields_from_numpy(beta, refl, pulse, *, device):
    """numpy [nx, ny] beta/R and [T] pulse (from either package) -> float32
    tensors on ``device``."""
    return (_tensor(beta, device), _tensor(refl, device),
            _tensor(pulse, device))


def dsp_state_from_numpy(state, *, device) -> DSPState:
    """A batched renderer's ``DSPState`` of either package (its fields
    readable by numpy: ``current``'s [S] / [S, 2] parameters, int32
    ``pattern``, and the [S] filter memories) -> the port's on ``device``."""
    cur = state.current
    current = SourceParams(*(
        _tensor(getattr(cur, f), device,
                np.int32 if f == "pattern" else np.float32)
        for f in SourceParams._fields))
    return DSPState(current=current, lpf_y1=_tensor(state.lpf_y1, device),
                    lpf_y2=_tensor(state.lpf_y2, device))


def reverb_state_from_numpy(state, *, device) -> ReverbState:
    """A ``ReverbState`` of either package ([B, 4, Lc] combs, [B, 4]
    damping memories, [B, 2, La] allpasses, the scalar counter) -> the
    port's on ``device``, ``pos`` a 0-dim int32 tensor."""
    return ReverbState(
        comb_buf=_tensor(state.comb_buf, device),
        comb_lp=_tensor(state.comb_lp, device),
        ap_buf=_tensor(state.ap_buf, device),
        pos=torch.tensor(int(np.asarray(state.pos)), dtype=torch.int32,
                         device=device))
