"""The sharded engine: a device mesh and the sharded FDTD rounds.

Counterpart of ``planeverb_tpu/parallel/``, single-controller: one process
drives a 2D ("x", "y") mesh of torch devices, on which a device may repeat
(``grid_mesh(["cuda:0"] * 4, (2, 2))`` runs a 2x2 mesh on one card). The
field is sharded over the mesh; shards advance in rounds of ``halo`` steps,
each round one launch of a hand-written kernel per device over every shard
it holds, with the ghosts read on the device (B5 ``sharded_round``, B6
``banded_round``, ``csrc/solver_rounds.cu``).
Multi-process meshes (``multihost.py``) and the scaling harness are not
ported yet (ROADMAP A14).
"""

from planeverb_tpu_torch.parallel.mesh import (Mesh, factor_mesh, grid_mesh,
                                               mesh_for, mesh_from_count,
                                               pad_to_mesh)
from planeverb_tpu_torch.parallel.solver import assemble, shard_fields
from planeverb_tpu_torch.parallel.solver_fused import (
    Sharded, pipeline_sharded, simulate_moments_sharded,
    simulate_moments_sharded_reference, simulate_sharded_fused,
    simulate_sharded_reference)

__all__ = ["Mesh", "Sharded", "assemble", "factor_mesh", "grid_mesh",
           "mesh_for", "mesh_from_count", "pad_to_mesh", "pipeline_sharded",
           "shard_fields", "simulate_moments_sharded",
           "simulate_moments_sharded_reference", "simulate_sharded_fused",
           "simulate_sharded_reference"]
