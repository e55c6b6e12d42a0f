"""planeverb_tpu_torch — the planeverb engine on PyTorch and CUDA.

The port of ``planeverb_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The engine step runs two hand-written CUDA kernels
(``csrc/fdtd_fused.cu``: the fused FDTD simulation and the RT60-moments
pass), built with nvcc at first use; on the CPU it runs their plain PyTorch
versions. This package imports neither ``jax`` nor ``planeverb_tpu``.

Quick start::

    import planeverb_tpu_torch as pv

    ctx = pv.Context(pv.PlaneverbConfig(grid_size_x=10, grid_size_y=10),
                     scene=pv.demo_scene("SmallRoom"), device="cuda")
    ctx.set_listener_position(5.0, 0.0, 5.0)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0)
    ctx.step()                       # or ctx.start() for continuous updates
    out = ctx.get_output(eid)        # occlusion, rt60, DOA, ...
"""

from planeverb_tpu_torch.config import (CONSTANTS, MATERIALS, BoundaryType,
                                        PlaneverbConfig, PlaneverbDSPConfig,
                                        Resolution, compute_grid_params,
                                        material_r)
from planeverb_tpu_torch.core.context import Context
from planeverb_tpu_torch.core.objects import ObjectManager
from planeverb_tpu_torch.scene import (AABB, AABB3D, Scene, demo_scene,
                                       load_pv, merge_bounds, save_pv)
from planeverb_tpu_torch.session import load_session, save_session
from planeverb_tpu_torch.types import PlaneverbOutput

__version__ = "0.1.0"

__all__ = [
    "AABB", "AABB3D", "BoundaryType", "CONSTANTS", "Context", "MATERIALS",
    "ObjectManager", "PlaneverbConfig", "PlaneverbDSPConfig",
    "PlaneverbOutput", "Resolution", "Scene", "compute_grid_params",
    "demo_scene", "load_pv", "load_session", "material_r", "merge_bounds",
    "save_pv", "save_session", "__version__",
]
