"""The sharded engine: a device mesh and the sharded FDTD solvers.

Counterpart of ``planeverb_tpu/parallel/``. A 2D ("x", "y") mesh of torch
devices, on which a device may repeat (``grid_mesh(["cuda:0"] * 4, (2, 2))``
runs a 2x2 mesh on one card), is driven by one process, or spans several
(``multihost.multihost_grid_mesh`` over ``torch.distributed``: each process
runs its own positions and the ghost slabs cross processes point to point).
The field is sharded over the mesh; shards advance in rounds of ``halo``
steps, each round one launch of a hand-written kernel per device over every
shard it holds, with the ghosts read on the device (B5 ``sharded_round``,
B6 ``banded_round``, ``csrc/solver_rounds.cu``). ``simulate_sharded`` and
``simulate_sharded_wide`` are the JAX module's per-step solvers in plain
torch, and ``scaling.measure_scaling`` sweeps the engine over device counts.
"""

from planeverb_tpu_torch.parallel.mesh import (Mesh, factor_mesh, grid_mesh,
                                               mesh_for, mesh_from_count,
                                               pad_to_mesh)
from planeverb_tpu_torch.parallel.multihost import (init_distributed,
                                                    layout_by_process,
                                                    multihost_grid_mesh)
from planeverb_tpu_torch.parallel.solver import (Sharded, assemble,
                                                 shard_fields,
                                                 simulate_sharded,
                                                 simulate_sharded_wide)
from planeverb_tpu_torch.parallel.solver_fused import (
    pipeline_sharded, simulate_moments_sharded,
    simulate_moments_sharded_reference, simulate_sharded_fused,
    simulate_sharded_reference)

__all__ = ["Mesh", "Sharded", "assemble", "factor_mesh", "grid_mesh",
           "init_distributed", "layout_by_process", "mesh_for",
           "mesh_from_count", "multihost_grid_mesh", "pad_to_mesh",
           "pipeline_sharded", "shard_fields", "simulate_moments_sharded",
           "simulate_moments_sharded_reference", "simulate_sharded",
           "simulate_sharded_fused", "simulate_sharded_reference",
           "simulate_sharded_wide"]
