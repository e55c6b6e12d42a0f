"""State carried across from the JAX package.

The engine has no weights; what the two packages must share to compute on
the same inputs is the scene, the voxelized fields (beta, R), the source
pulse, and the calibrated EFree (a Python float, which needs no
conversion). Nothing here imports ``planeverb_tpu``: the JAX package's
scene objects are read through their dataclass fields, and its arrays
through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from planeverb_tpu_torch.scene import AABB, Scene

__all__ = ["scene_from_jax", "fields_from_numpy"]


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
    def conv(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.float32))).to(device)

    return conv(beta), conv(refl), conv(pulse)
