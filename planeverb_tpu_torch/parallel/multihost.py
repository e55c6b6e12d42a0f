"""Multi-process meshes: process-group bring-up, a process-grouped mesh
layout, and the transfers between processes.

Counterpart of ``planeverb_tpu/parallel/multihost.py`` over
``torch.distributed``. A single-controller :class:`~.mesh.Mesh` is driven
by one process; a multi-process mesh gives each position an owning process
(``Mesh.ranks``), and each process allocates, simulates and launches only
its own positions. Three concerns live here:

1. :func:`init_distributed` joins the default process group (the
   counterpart of ``jax.distributed.initialize``).

2. :func:`multihost_grid_mesh` / :func:`layout_by_process` build a 2D
   ("x", "y") mesh in which each process's devices form a contiguous block
   of mesh rows, so the y axis never crosses a process and one slab per
   round and process boundary crosses between processes along x (the JAX
   module's layout rules and messages).

3. :func:`post` / :func:`transfer` and :func:`broadcast` move the sharded engine's slabs
   between processes: every send and receive of one exchange posted in one
   ``dist.batch_isend_irecv`` and waited on before anything reads the
   buffers. On the gloo backend, which takes CPU tensors only, a card's
   slab is staged through pinned host memory (device -> host, send,
   receive, host -> device); NCCL moves device tensors directly, and its
   ``work.wait()`` orders its own streams with the current one.

4. :func:`agree` holds the host inputs of a step equal on every process
   (what SPMD requires of the JAX program): each rank all-gathers a
   fixed-size digest of its items, and every rank raises the same
   ``ValueError`` where they differ. Nothing is broadcast: no rank's state
   is ever replaced by another's.

NCCL refuses two ranks on one card, so several processes sharing a card
use gloo; nothing here picks a backend on its own.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from planeverb_tpu_torch.parallel.mesh import Mesh, factor_mesh

__all__ = ["init_distributed", "layout_by_process", "multihost_grid_mesh",
           "Pending", "post", "transfer", "broadcast", "agree"]

# agree's digest: up to AGREE_ITEMS items, each hashed to 16 bytes (two
# int64 words), after one row for the items' names; then the flag
AGREE_ITEMS = 16
_HASH_WORDS = 2


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "nccl") -> None:
    """Join the default process group. Call once per process before any
    cross-process work. A no-op for ``num_processes == 1`` and where the
    group is already initialised (idempotent bring-up).

    ``coordinator_address`` is ``host:port`` of rank 0's store
    (``tcp://``); without it the group reads the standard ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` variables (``env://``, the
    counterpart of JAX's cluster detection). ``backend="nccl"`` first binds
    the process to its card (``LOCAL_RANK``, else the rank modulo the
    cards present) and raises where there is none; a CPU run, or several
    processes on one card, pass ``backend="gloo"``. The group's first
    collective is a barrier, so a later ``batch_isend_irecv`` is never the
    group's first call.
    """
    if num_processes == 1:
        return
    if dist.is_initialized():
        return
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(backend='nccl'): no CUDA "
                               "device is available; pass backend='gloo' "
                               "for a CPU run")
        rank = process_id if process_id is not None else \
            int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def layout_by_process(devices, shape: tuple[int, int] | None = None) -> Mesh:
    """Arrange ``(process_index, device)`` pairs into a [mx, my] Mesh,
    rows grouped by process.

    Devices are bucketed by process; each process's bucket is reshaped to
    an (a, my) block and the blocks are stacked along x, so the mesh's y
    axis never crosses a process. With one process this reduces to the
    most-square factorization (``mesh.factor_mesh``). ``shape`` overrides
    the global (mx, my) but must keep per-process blocks contiguous: my
    must divide the per-process device count.
    """
    pairs = [(int(p), d) for p, d in devices]
    n = len(pairs)
    by_proc: dict[int, list] = {}
    for p, d in pairs:
        by_proc.setdefault(p, []).append(d)
    nproc = len(by_proc)
    local = n // nproc
    if any(len(v) != local for v in by_proc.values()):
        raise ValueError("uneven devices per process: "
                         f"{ {k: len(v) for k, v in by_proc.items()} }")

    if shape is None:
        if nproc == 1:
            shape = factor_mesh(n)
        else:
            # most-square local block; processes stack along x
            a, my = factor_mesh(local)
            shape = (nproc * a, my)
    mx, my = shape
    if mx * my != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if local % my != 0:
        raise ValueError(
            f"shape {shape}: y-extent {my} does not divide the per-process "
            f"device count {local}; y-axis halos would cross DCN")

    devs, ranks = [], []
    for pid in sorted(by_proc):
        block = by_proc[pid]
        for r in range(local // my):
            devs.append(block[r * my:(r + 1) * my])
            ranks.append([pid] * my)
    return Mesh(devs, ranks)


def multihost_grid_mesh(shape: tuple[int, int] | None = None,
                        local_devices=None) -> Mesh:
    """2D ("x", "y") mesh over every process's devices, process-contiguous
    (see :func:`layout_by_process`). Each process names its own devices
    (default: every CUDA device it sees; ``["cpu", "cpu"]`` on a CPU run,
    ``["cuda:0", "cuda:0"]`` for two positions of one card); they are
    gathered from every rank with ``all_gather_object``. Outside a process
    group this is the single-process mesh over ``local_devices``."""
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_grid_mesh: no CUDA device is "
                               "available; pass local_devices=['cpu', ...] "
                               "for a CPU run")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local_devices = [torch.device(d) for d in local_devices]
    if dist.is_available() and dist.is_initialized():
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (dist.get_rank(), local_devices))
    else:
        gathered = [(0, local_devices)]
    return layout_by_process([(r, d) for r, ds in gathered for d in ds],
                             shape)


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` crosses through pinned host memory: a card's tensor on
    the gloo backend, which moves CPU tensors only."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class Pending:
    """The posted operations of one exchange; :meth:`wait` waits on them
    and lands the staged receives in their buffers."""

    def __init__(self, works, landed):
        self._works, self._landed = works, landed

    def wait(self) -> None:
        for work in self._works:
            work.wait()
        for buf, host in self._landed:
            buf.copy_(host)
        self._works, self._landed = [], []


def post(sends, recvs) -> Pending:
    """Post one exchange between processes: ``sends`` are (tensor, peer
    rank, tag), ``recvs`` (contiguous buffer, peer rank, tag), all in one
    ``dist.batch_isend_irecv``. NCCL ignores tags and pairs a peer's
    operations in order, so both sides list them in one global order. Wait
    on the result before anything reads the buffers (on NCCL the wait
    orders the current stream after its own streams)."""
    if not sends and not recvs:
        return Pending([], [])
    ops, landed = [], []
    for t, peer, tag in sends:
        if _staged(t):
            host = _host(t)
            host.copy_(t)          # blocking: the slab is written
            t = host
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer, tag=tag))
    for buf, peer, tag in recvs:
        if not buf.is_contiguous():
            raise ValueError("transfer: a receive buffer must be contiguous")
        into = buf
        if _staged(buf):
            into = _host(buf)
            landed.append((buf, into))
        ops.append(dist.P2POp(dist.irecv, into, peer, tag=tag))
    return Pending(dist.batch_isend_irecv(ops), landed)


def transfer(sends, recvs) -> None:
    """:func:`post` and wait: the buffers hold their slabs on return."""
    post(sends, recvs).wait()


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` (contiguous, on every rank; the source's holds the values)
    filled from rank ``src``, staged through host memory on gloo."""
    if _staged(t):
        host = _host(t)
        if dist.get_rank() == src:
            host.copy_(t)
        dist.broadcast(host, src)
        if dist.get_rank() != src:
            t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


def _item_bytes(value) -> bytes:
    """The bytes an item is hashed by: an array's dtype, shape and data,
    ``bytes`` as they are, anything else by its ``repr``."""
    if isinstance(value, np.ndarray):
        return (f"{value.dtype.str}{value.shape}".encode()
                + np.ascontiguousarray(value).tobytes())
    if isinstance(value, bytes):
        return value
    return repr(value).encode()


def _hash_words(data: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.blake2b(data, digest_size=8 * _HASH_WORDS)
                         .digest(), np.int64)


def agree(items: dict, flag: bool = False) -> bool:
    """Hold ``items`` ({name: value}) equal on every rank of the default
    process group, and OR ``flag`` over the ranks.

    Every rank all-gathers a fixed-size digest: a hash of the sorted item
    names, one of each item's bytes (an array's dtype, shape and data,
    ``bytes`` as they are, else its ``repr``) and the flag. Where any
    digest differs from rank 0's, every rank raises the same
    ``ValueError``, naming the ranks that differ and the items they differ
    on; nothing is broadcast, so no rank's state is replaced by another's.
    Returns whether any rank raised ``flag`` (the one value that may
    differ). A collective: every rank calls it, in the same order. Outside
    a process group it returns ``flag``. The digest is staged as the
    backend needs it: a CPU tensor on gloo, one on the current card on
    NCCL.
    """
    names = sorted(items)
    if len(names) > AGREE_ITEMS:
        raise ValueError(f"agree: {len(names)} items, at most {AGREE_ITEMS}")
    if not (dist.is_available() and dist.is_initialized()):
        return bool(flag)
    words = np.zeros((AGREE_ITEMS + 1) * _HASH_WORDS + 1, np.int64)
    words[:_HASH_WORDS] = _hash_words(repr(names).encode())
    for k, name in enumerate(names, 1):
        words[k * _HASH_WORDS:(k + 1) * _HASH_WORDS] = _hash_words(
            _item_bytes(items[name]))
    words[-1] = int(bool(flag))
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.from_numpy(words).to(device)
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    table = torch.stack(gathered).cpu().numpy()
    digests = table[:, :-1].reshape(len(gathered), AGREE_ITEMS + 1,
                                    _HASH_WORDS)
    differ = (digests != digests[0]).any(axis=2)      # [ranks, rows]
    ranks = [r for r in range(len(gathered)) if differ[r].any()]
    if ranks:
        if differ[:, 0].any():
            what = "the items' names"
        else:
            what = ", ".join(repr(n) for k, n in enumerate(names, 1)
                             if differ[:, k].any())
        raise ValueError(f"agree: rank(s) {ranks} differ from rank 0 on "
                         f"{what}")
    return bool(table[:, -1].any())
