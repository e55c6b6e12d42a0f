"""Device mesh construction and grid padding for spatial sharding.

Counterpart of ``planeverb_tpu/parallel/mesh.py``. A :class:`Mesh` is a 2D
grid of torch devices with axes "x" and "y", driven by one process (the
single-controller form of ``jax.sharding.Mesh`` under ``shard_map``). The
same device may stand at several mesh positions: a mesh of ``"cpu"``
repeated runs the plain versions, a mesh of ``"cuda:0"`` repeated runs the
sharded engine's kernels on one card, with real ghosts and a real exchange.

Each position also has an owning process (``ranks``, by default the calling
process for every position): a mesh made by
``multihost.multihost_grid_mesh`` spans several processes, each of which
allocates, simulates and launches only its own positions.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["Mesh", "factor_mesh", "grid_mesh", "mesh_for",
           "mesh_from_count", "pad_to_mesh"]


def process_rank() -> int:
    """The calling process's rank in the default process group (0 where
    none is initialised)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _device(d) -> torch.device:
    """torch.device(d), with a bare "cuda" read as "cuda:0" (where tensors
    moved to "cuda" land by default), so blocks compare equal to their mesh
    position's device."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


class Mesh:
    """A 2D ("x", "y") grid of torch devices.

    ``devices[i][j]`` holds the shard of rows block i and columns block j;
    ``shape["x"]``/``shape["y"]`` are the axis sizes. Every device is of one
    type, ``cuda`` or ``cpu``: the sharded engine launches its kernels on a
    CUDA mesh and runs their plain versions on a CPU mesh, never a mix.

    ``ranks[i][j]`` is the process that owns position (i, j) (default: the
    calling process, for every position); :meth:`is_local` says whether it
    is the calling one. A position's device is a device of its owner.
    """

    axis_names = ("x", "y")

    def __init__(self, devices, ranks=None):
        rows = [[_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                           for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        types = {d.type for row in rows for d in row}
        if len(types) != 1 or not types <= {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be cuda or all cpu, "
                             f"got {sorted(types)}")
        self.devices = rows
        self.shape = {"x": len(rows), "y": len(rows[0])}
        self.rank = process_rank()
        if ranks is None:
            ranks = [[self.rank] * len(rows[0]) for _ in rows]
        self.ranks = [[int(r) for r in row] for row in ranks]
        if [len(r) for r in self.ranks] != [len(r) for r in rows]:
            raise ValueError(f"ranks {self.ranks} do not match the "
                             f"{len(rows)}x{len(rows[0])} devices")

    def is_local(self, i: int, j: int) -> bool:
        """Whether the calling process owns position (i, j)."""
        return self.ranks[i][j] == self.rank

    @property
    def multi_process(self) -> bool:
        """Whether another process owns a position of this mesh."""
        return any(r != self.rank for row in self.ranks for r in row)

    @property
    def device_type(self) -> str:
        return self.devices[0][0].type

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]

    @property
    def local_device(self) -> torch.device:
        """The device of the calling process's first position."""
        for i, row in enumerate(self.devices):
            for j, d in enumerate(row):
                if self.is_local(i, j):
                    return d
        raise ValueError(f"process {self.rank} owns no position of {self}")

    def __repr__(self) -> str:
        ranks = (f", ranks={self.ranks}" if self.multi_process else "")
        return (f"Mesh({self.shape['x']}x{self.shape['y']}, "
                f"{[[str(d) for d in r] for r in self.devices]}{ranks})")


def factor_mesh(n: int) -> tuple[int, int]:
    """Split n devices into the most-square (mx, my) factorization.

    A square-ish mesh minimizes halo perimeter per shard (the exchanged
    ghost slabs are proportional to the shard boundary length).
    """
    best = (1, n)
    for mx in range(1, int(math.isqrt(n)) + 1):
        if n % mx == 0:
            best = (mx, n // mx)
    return best


def _cuda_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """Build a 2D ("x", "y") mesh over the given devices (default: every
    CUDA device), row-major. Devices may repeat: ``grid_mesh(["cuda:0"] * 4,
    (2, 2))`` is a 2x2 mesh on one card."""
    if devices is None:
        devices = _cuda_devices()
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = factor_mesh(n)
    mx, my = shape
    if mx * my != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh([devices[i * my:(i + 1) * my] for i in range(mx)])


def mesh_from_count(n_devices: int) -> Mesh:
    """Most-square 2D mesh over the first ``n_devices`` CUDA devices.

    Raises ``ValueError`` when the host has fewer devices than requested:
    a mesh of distinct cards is never made up from repeats here (build one
    with :func:`grid_mesh` for that).
    """
    devices = _cuda_devices()
    if n_devices > len(devices):
        raise ValueError(f"mesh wants {n_devices} devices, "
                         f"only {len(devices)} available")
    return grid_mesh(devices[:n_devices])


def mesh_for(n_devices: int, device) -> Mesh:
    """The front ends' mesh of ``n_devices`` for an engine on ``device``:
    that many distinct cards on a CUDA device (:func:`mesh_from_count`,
    which raises ``ValueError`` beyond the host's count), that many
    positions of the CPU on the CPU."""
    if torch.device(device).type == "cpu":
        return grid_mesh(["cpu"] * n_devices)
    return mesh_from_count(n_devices)


def pad_to_mesh(nx: int, ny: int, mesh: Mesh,
                multiple: int = 1) -> tuple[int, int]:
    """Padded field dims divisible by the mesh (and an optional multiple).

    Padding cells carry beta = 0 (solid), so they never develop pressure and
    the padded solve is exactly the unpadded solve on the real region.
    """
    qx = mesh.shape["x"] * multiple
    qy = mesh.shape["y"] * multiple
    return (-(-nx // qx) * qx, -(-ny // qy) * qy)
