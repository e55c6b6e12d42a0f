"""The sharded engine's layout, its ghost exchange and the per-step solvers.

Counterpart of ``planeverb_tpu/parallel/solver.py``. A field sharded over a
:class:`~planeverb_tpu_torch.parallel.mesh.Mesh` is a block grid: a list of
``mesh.shape["x"]`` rows of ``mesh.shape["y"]`` tensors, block (i, j) on
``mesh.devices[i][j]`` (``None`` at a position another process owns). The
JAX package's ``shard_map`` body runs once per shard with ``ppermute``
between them; here the calling process holds its blocks, a neighbour's slab
crosses devices with ``.to(device)`` (a no-op when both shards share a
device) and processes with ``multihost.transfer`` (every send and receive
of one exchange in one ``batch_isend_irecv``).

The exchange never writes a block it was given; on an axis with ghosts it
returns new tensors. The per-step solvers below run it every step or round;
the fused rounds (``parallel/solver_fused.py``) build every shard's
extended beta and Y once a simulation and read each round's ghosts on the
device instead, in place from a neighbour on the same device and from a
ghost buffer where the neighbour sits on another device or process. After a
round the rounds' loop copies the slab each ghost buffer holds from its
sender (across processes: ``multihost.transfer``).

On a multi-process mesh the static fields do not cross: every process holds
the whole padded beta and refl (as the JAX worker ``device_put``s the global
host array) and cuts its own shards' extended blocks from them
(:func:`extended_blocks`); only state crosses processes.

The overlap split of the rounds copies only the new frames
(:func:`_exchange_frames`, after ``solver_pallas.py:667-672`` and
``:882-887``): each shard's new bottom k rows go to the next shard's top
ghost buffer, its new top k rows to the previous shard's bottom one. It is
enqueued after the round's frame launches and before its interior launches.
Between two cards the copy runs on side streams, after events recorded
behind both cards' frame launches, so it can run under the interior
launches; the receiver's next frame launch waits on the copy's event and
its interior launch does not. Shards sharing a device (a mesh of one card
repeated, as on a one-card machine, or of ``"cpu"``) read each other's
frames in place: nothing is copied, no side stream is used, and no exchange
is left to hide.

:func:`simulate_sharded` (one-cell halos exchanged every step) and
:func:`simulate_sharded_wide` (k-cell halos every k steps) are the JAX
module's per-step scan solvers. They are XLA programs there, not Pallas
kernels, so their port is plain torch on every device: on a card a step
launches about 30 small ops per shard, and the rounds of B5/B6
(``simulate_sharded_fused``) are the fast path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from planeverb_tpu_torch.config import BoundaryType, GridParams
from planeverb_tpu_torch.ops._common import (check_field, fresh_acc,
                                             stream_step, window_scalars)
from planeverb_tpu_torch.ops.fdtd import (FdtdResult, admittance,
                                          fdtd_step_folded,
                                          stencil_coefficients)
from planeverb_tpu_torch.parallel import multihost
from planeverb_tpu_torch.parallel.mesh import Mesh

__all__ = ["Sharded", "shard_fields", "assemble", "extended_blocks",
           "field_blocks", "static_blocks", "extend_statics",
           "fold_coefficients", "simulate_sharded", "simulate_sharded_wide"]


def _local(mesh: Mesh | None, i: int, j: int) -> bool:
    return mesh is None or mesh.is_local(i, j)


def shard_fields(mesh: Mesh, *tensors: torch.Tensor):
    """Split each [nx_pad, ny_pad] tensor into the mesh's [bx, by] blocks,
    each a contiguous copy on its mesh device (``None`` at another
    process's positions). Returns one block grid per tensor."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    out = []
    for t in tensors:
        nx, ny = t.shape[-2:]
        if nx % mx or ny % my:
            raise ValueError(f"field {tuple(t.shape)} is not divisible by "
                             f"the {mx}x{my} mesh (see pad_to_mesh)")
        bx, by = nx // mx, ny // my
        out.append([[t[..., i * bx:(i + 1) * bx, j * by:(j + 1) * by]
                     .to(mesh.devices[i][j]).contiguous()
                     if mesh.is_local(i, j) else None
                     for j in range(my)] for i in range(mx)])
    return tuple(out)


def assemble(blocks, device, mesh: Mesh | None = None) -> torch.Tensor:
    """Inverse of :func:`shard_fields`: the block grid (blocks [..., bx,
    by]) as one [..., nx_pad, ny_pad] tensor on ``device``. On a
    multi-process ``mesh`` every block is broadcast from its owner, so
    every process gets the whole field (JAX's replicated outputs); every
    process must call it, in the same order."""
    if mesh is not None and mesh.multi_process:
        like = next(b for row in blocks for b in row if b is not None)
        blocks = [[multihost.broadcast(
            (b.to(device) if b is not None else
             torch.empty(like.shape, dtype=like.dtype, device=device))
            .contiguous(), mesh.ranks[i][j])
            for j, b in enumerate(row)] for i, row in enumerate(blocks)]
    rows = [torch.cat([b.to(device) for b in row], dim=-1) for row in blocks]
    return torch.cat(rows, dim=-2)


class Sharded:
    """Per-shard fields of a sharded pass.

    ``blocks[name]`` is a block grid: ``mesh.shape["x"]`` rows of
    ``mesh.shape["y"]`` tensors [..., bx, by], each on its shard's device
    (the recording [T, bx, by], the grids [bx, by]; ``None`` where another
    process owns the shard). ``kind`` is the NamedTuple the fields make up
    (``FdtdResult`` or ``analyzer.Moments``); :meth:`assemble` builds it,
    padded to [nx_pad, ny_pad], on one device (on a multi-process ``mesh``
    on every process, each block broadcast from its owner).
    """

    def __init__(self, kind, blocks: dict, mesh: Mesh | None = None):
        self.kind = kind
        self.blocks = blocks
        self.mesh = mesh

    def field(self, name: str, device) -> torch.Tensor:
        """One field, assembled on ``device``."""
        return assemble(self.blocks[name], device, self.mesh)

    def assemble(self, device):
        return self.kind(**{n: self.field(n, device)
                            for n in self.kind._fields})

    def at(self, name: str, i: int, j: int) -> torch.Tensor:
        """The values of global cell (i, j), read from its owning shard;
        raises where another process owns it."""
        grid = self.blocks[name]
        bx, by = next(b for row in grid for b in row
                      if b is not None).shape[-2:]
        block = grid[i // bx][j // by]
        if block is None:
            raise ValueError(f"cell ({i}, {j}) is on shard "
                             f"({i // bx}, {j // by}), held by process "
                             f"{self.mesh.ranks[i // bx][j // by]}")
        return block[..., i % bx, j % by]


def _neighbour(slabs, di: int, dj: int, mesh: Mesh | None):
    """Each local shard's slab from its neighbour at offset (di, dj) (zeros
    beyond the global edge), on the receiving shard's device. ``slabs`` is
    a block grid; so is the result. A neighbour of another process sends
    its slab through ``multihost.transfer``, one exchange for the whole
    grid; both sides enumerate the pairs in mesh order of the receiver."""
    mx, my = len(slabs), len(slabs[0])
    out = [[None] * my for _ in range(mx)]
    sends, recvs = [], []
    tag = 0
    for i in range(mx):
        for j in range(my):
            si, sj = i + di, j + dj
            inside = 0 <= si < mx and 0 <= sj < my
            if _local(mesh, i, j):
                mine = slabs[i][j]
                if not inside:
                    out[i][j] = torch.zeros_like(mine)
                elif _local(mesh, si, sj):
                    out[i][j] = slabs[si][sj].to(mine.device)
                else:
                    out[i][j] = torch.empty_like(mine,
                                                 memory_format=torch.
                                                 contiguous_format)
                    recvs.append((out[i][j], mesh.ranks[si][sj], tag))
            elif inside and _local(mesh, si, sj):
                sends.append((slabs[si][sj], mesh.ranks[i][j], tag))
            tag += inside
    multihost.transfer(sends, recvs)
    return out


def _from_prev(slabs, axis: str, mesh: Mesh | None = None):
    """Each shard's slab from its previous neighbour along ``axis`` (zeros
    at the global edge and on a size-1 axis), on the receiving shard's
    device. ``slabs`` is a block grid; so is the result."""
    return _neighbour(slabs, -(axis == "x"), -(axis == "y"), mesh)


def _from_next(slabs, axis: str, mesh: Mesh | None = None):
    """Each shard's slab from its next neighbour along ``axis`` (zeros at
    the global edge and on a size-1 axis), on the receiving shard's
    device."""
    return _neighbour(slabs, int(axis == "x"), int(axis == "y"), mesh)


def _map(fn, *grids):
    """``fn`` over the local blocks of block grids (None elsewhere)."""
    return [[None if row[0] is None else fn(*row) for row in zip(*rows)]
            for rows in zip(*grids)]


def _exchange_axes(blocks, kx: int, ky: int, mesh: Mesh | None = None):
    """Per-axis ghost exchange: extend every [..., bx, by] block by
    ``kx``/``ky`` neighbour ghost cells per side (a width of 0 skips the
    axis); leading axes ride along, so the sharded rounds exchange p, vx
    and vy as one [3, bx, by] block. The x phase runs first and the y phase
    exchanges the x-extended blocks, so the corners are carried, which the
    k-step dependency cone needs. Missing neighbours (global edges) fill
    with zeros, matching the zero padding of the single-device solver."""
    if kx:
        top = _from_prev(_map(lambda b: b[..., -kx:, :], blocks), "x", mesh)
        bot = _from_next(_map(lambda b: b[..., :kx, :], blocks), "x", mesh)
        blocks = _map(lambda t, b, u: torch.cat([t, b, u], dim=-2),
                      top, blocks, bot)
    if ky:
        left = _from_prev(_map(lambda b: b[..., -ky:], blocks), "y", mesh)
        right = _from_next(_map(lambda b: b[..., :ky], blocks), "y", mesh)
        blocks = _map(lambda lft, b, rgt: torch.cat([lft, b, rgt], dim=-1),
                      left, blocks, right)
    return blocks


def _exchange_halo(blocks, halo: int, mesh: Mesh | None = None):
    """Symmetric form of :func:`_exchange_axes`: [..., bx, by] ->
    [..., bx+2h, by+2h]."""
    return _exchange_axes(blocks, halo, halo, mesh)


def extended_blocks(mesh: Mesh, field: torch.Tensor, kx: int, ky: int):
    """Each local shard's block of a whole [nx_pad, ny_pad] field extended
    by ``kx``/``ky`` cells per side (zeros beyond the field), cut locally
    and placed on the shard's device: the values :func:`_exchange_axes`
    gives, corners included, with nothing crossing a process."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    bx, by = field.shape[-2] // mx, field.shape[-1] // my
    padded = F.pad(field, (ky, ky, kx, kx))
    return [[padded[..., i * bx:(i + 1) * bx + 2 * kx,
                    j * by:(j + 1) * by + 2 * ky]
             .to(mesh.devices[i][j]).contiguous()
             if mesh.is_local(i, j) else None
             for j in range(my)] for i in range(mx)]


def field_blocks(where: str, mesh: Mesh, name: str, x, nx_pad: int,
                 ny_pad: int):
    """A [nx_pad, ny_pad] field as the mesh's block grid: a tensor is
    sharded, a block grid (from ``shard_fields``, single-process meshes
    only) is checked."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    if isinstance(x, torch.Tensor):
        check_field(where, name, x, (nx_pad, ny_pad))
        return shard_fields(mesh, x)[0]
    if mesh.multi_process:
        raise ValueError(f"{where}: on a multi-process mesh {name} must be "
                         f"the whole padded field, which every process "
                         f"holds")
    if len(x) != mx or any(len(row) != my for row in x):
        raise ValueError(f"{where}: {name} is not a {mx}x{my} block grid")
    for i, row in enumerate(x):
        for j, b in enumerate(row):
            check_field(where, name, b, (nx_pad // mx, ny_pad // my))
            if b.device != mesh.devices[i][j]:
                raise ValueError(f"{where}: {name} block ({i}, {j}) is on "
                                 f"{b.device}, its shard on "
                                 f"{mesh.devices[i][j]}")
    return x


def static_blocks(where: str, mesh: Mesh, beta, refl, nx_pad: int,
                  ny_pad: int):
    """The static fields of a sharded pass: (beta blocks, refl blocks,
    statics), ``statics`` the (beta, admittance Y) pair
    :func:`extend_statics` extends: on a multi-process mesh the whole
    padded fields, which every process holds, so nothing static crosses a
    process; on a single-process mesh the block grids."""
    beta_b = field_blocks(where, mesh, "beta", beta, nx_pad, ny_pad)
    refl_b = field_blocks(where, mesh, "refl", refl, nx_pad, ny_pad)
    if mesh.multi_process:
        return beta_b, refl_b, (beta, admittance(refl))
    return beta_b, refl_b, (beta_b, [[admittance(r) for r in row]
                                     for row in refl_b])


def extend_statics(mesh: Mesh, beta, y, kx: int, ky: int):
    """The local shards' beta and Y blocks extended by kx / ky cells per
    side (zeros beyond the field): whole padded tensors are cut locally
    (:func:`extended_blocks`), block grids exchanged
    (:func:`_exchange_axes`)."""
    if isinstance(beta, torch.Tensor):
        return (extended_blocks(mesh, beta, kx, ky),
                extended_blocks(mesh, y, kx, ky))
    return _exchange_axes(beta, kx, ky, mesh), _exchange_axes(y, kx, ky, mesh)


def fold_coefficients(params: GridParams, beta_e, y_e, gi0: int, gj0: int):
    """The six stencil coefficients of an extended block whose cell (0, 0)
    is global cell (gi0, gj0), and its global coordinates. Zeros shift in
    at the block edge (the JAX solvers' ``concatenate`` of a zero row):
    wrong on the block's first row and column, which the callers discard
    or keep outside the cone of the cells they keep."""
    ex, ey = beta_e.shape
    dev = beta_e.device
    gi = (gi0 + torch.arange(ex, device=dev)).view(ex, 1)
    gj = (gj0 + torch.arange(ey, device=dev)).view(1, ey)
    coefs = stencil_coefficients(
        beta_e, y_e, F.pad(beta_e[:-1], (0, 0, 1, 0)),
        F.pad(y_e[:-1], (0, 0, 1, 0)), F.pad(beta_e[:, :-1], (1, 0)),
        F.pad(y_e[:, :-1], (1, 0)), gi, gj, params.grid_x, params.grid_y,
        params.boundary_type == BoundaryType.ABSORBING)
    return coefs, gi, gj


def _solver_setup(where: str, params: GridParams, beta, refl, pulse,
                  mesh: Mesh, nx_pad: int, ny_pad: int, k: int):
    """Checks shared by the per-step solvers; the local shards' extended
    beta and Y (k ghosts a side) and the pulse on each of their devices."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    if (nx_pad % mx or ny_pad % my or nx_pad < params.nx
            or ny_pad < params.ny):
        raise ValueError(f"{where}: padded field ({nx_pad}, {ny_pad}) must "
                         f"cover ({params.nx}, {params.ny}) and divide over "
                         f"the {mx}x{my} mesh (see pad_to_mesh)")
    check_field(where, "pulse", pulse, (params.response_length,))
    beta_e, y_e = extend_statics(mesh, *static_blocks(
        where, mesh, beta, refl, nx_pad, ny_pad)[2], k, k)
    pulses = {}
    for row in beta_e:
        for b in row:
            if b is not None and b.device not in pulses:
                pulses[b.device] = pulse.to(b.device)
    return beta_e, y_e, pulses


def simulate_sharded(params: GridParams, beta, refl, pulse,
                     listener_ix: int, listener_iy: int, mesh: Mesh,
                     nx_pad: int, ny_pad: int) -> Sharded:
    """One simulation pass sharded over ``mesh``, one-cell halos exchanged
    every step (the JAX module's ``simulate_sharded``).

    ``beta``/``refl`` are the [nx_pad, ny_pad] fields padded with beta = 0
    (``mesh.pad_to_mesh``), as tensors or (on a single-process mesh) as
    ``shard_fields`` block grids. Each step exchanges four slabs: vx from
    the next shard along x and vy along y for the pressure update, then
    the new p from the previous shard along x and y for the velocities.
    The wall admittance and the edge ABC are folded once into per-cell
    coefficients on global coordinates, so every shard runs the same ops.
    The recording is taken before the listener's injection; the onset is
    +inf where never crossed. Plain torch on every device (about 30 ops a
    shard and step on a card).

    Returns the per-shard :class:`Sharded` FdtdResult: padded [T, nx_pad,
    ny_pad] recording and [nx_pad, ny_pad] onset/flux when assembled, equal
    to the single-device plain pass on [:nx, :ny].
    """
    where = "simulate_sharded"
    beta_e, y_e, pulses = _solver_setup(where, params, beta, refl, pulse,
                                        mesh, nx_pad, ny_pad, 1)
    mx, my = mesh.shape["x"], mesh.shape["y"]
    bx, by = nx_pad // mx, ny_pad // my
    T = params.response_length
    scalars = window_scalars(params)
    courant = scalars[0]
    lix, liy = int(listener_ix), int(listener_iy)
    inner = (slice(1, bx + 1), slice(1, by + 1))

    def setup(i, j):
        b = beta_e[i][j]
        coefs, gi, gj = fold_coefficients(params, b, y_e[i][j], i * bx - 1, j * by - 1)
        src = ((gi == lix) & (gj == liy)).to(torch.float32)[inner]
        zeros = torch.zeros((bx, by), dtype=torch.float32, device=b.device)
        return {"beta": b[inner], "coefs": [c[inner] for c in coefs],
                "src": src, "pulse": pulses[b.device],
                "p": zeros, "vx": zeros, "vy": zeros,
                "acc": fresh_acc((bx, by), b.device),
                "rec": torch.empty((T, bx, by), dtype=torch.float32,
                                   device=b.device)}

    shards = [[setup(i, j) if mesh.is_local(i, j) else None
               for j in range(my)] for i in range(mx)]

    def field(name):
        return _map(lambda s: s[name], shards)

    for t in range(T):
        # -- pressure: p = beta * (p - C * div v)    (FDTD.cpp:124-141)
        vx_n = _from_next(_map(lambda s: s["vx"][:1], shards), "x", mesh)
        vy_n = _from_next(_map(lambda s: s["vy"][:, :1], shards), "y", mesh)
        for s, vxn, vyn in _cells(shards, vx_n, vy_n):
            vx_xp = torch.cat([s["vx"][1:], vxn], dim=0)
            vy_yp = torch.cat([s["vy"][:, 1:], vyn], dim=1)
            div = (vx_xp - s["vx"]) + (vy_yp - s["vy"])
            s["p"] = s["beta"] * (s["p"] - courant * div)
        # -- velocities: walls + edge ABC prefolded  (FDTD.cpp:143-223)
        p_x = _from_prev(_map(lambda s: s["p"][-1:], shards), "x", mesh)
        p_y = _from_prev(_map(lambda s: s["p"][:, -1:], shards), "y", mesh)
        for s, pxm, pym in _cells(shards, p_x, p_y):
            p = s["p"]
            a_x, b_x, d_x, a_y, b_y, d_y = s["coefs"]
            p_xm = torch.cat([pxm, p[:-1]], dim=0)
            air = s["vx"] - courant * (p - p_xm)
            s["vx"] = a_x * air + b_x * p + d_x * p_xm
            p_ym = torch.cat([pym, p[:, :-1]], dim=1)
            air = s["vy"] - courant * (p - p_ym)
            s["vy"] = a_y * air + b_y * p + d_y * p_ym
            # the streaming onset (+inf: never crossed) and flux, as the
            # single-device pass streams them (its energies go unused)
            s["acc"] = stream_step(t, p, s["vx"], s["vy"], s["acc"], scalars)
            s["rec"][t] = p   # record pre-injection, then inject
            s["p"] = p + s["src"] * s["pulse"][t]
    return Sharded(FdtdResult, {"pressure": field("rec"),
                                "onset": _map(lambda s: s["acc"][0], shards),
                                "flux_x": _map(lambda s: s["acc"][1], shards),
                                "flux_y": _map(lambda s: s["acc"][2], shards)},
                   mesh)


def _cells(shards, *grids):
    """(shard, *its blocks of ``grids``) for every local shard."""
    return [(s, *blocks) for rows in zip(shards, *grids)
            for s, *blocks in zip(*rows) if s is not None]


def simulate_sharded_wide(params: GridParams, beta, refl, pulse,
                          listener_ix: int, listener_iy: int, mesh: Mesh,
                          nx_pad: int, ny_pad: int,
                          halo: int = 8) -> Sharded:
    """Sharded solver with multi-step halo widening (the JAX module's
    ``simulate_sharded_wide``).

    Each shard extends its block by ``halo`` = k ghost cells a side
    (corners included, zeros beyond the field), runs k steps locally, then
    re-exchanges p, vx and vy (one [3, bx, by] exchange a round): the
    per-step stencil radius is one cell, so a k-wide ghost stays exact for
    k steps. The last round is padded to k steps; its steps past T (the JAX
    ``live`` mask) record nothing and leave the onset and flux as they
    are. Arguments and result as :func:`simulate_sharded`; plain torch on
    every device (about 30 ops a shard and step on a card, on the extended
    block). Raises ``ValueError`` when the halo exceeds the shard block.
    """
    where = "simulate_sharded_wide"
    mx, my = mesh.shape["x"], mesh.shape["y"]
    bx, by = nx_pad // mx, ny_pad // my
    k = int(halo)
    if k > bx or k > by:
        raise ValueError(f"halo {k} exceeds shard block ({bx}, {by})")
    if k < 1:
        raise ValueError(f"{where}: halo {k} must be >= 1")
    beta_e, y_e, pulses = _solver_setup(where, params, beta, refl, pulse,
                                        mesh, nx_pad, ny_pad, k)
    T = params.response_length
    rounds = -(-T // k)
    scalars = window_scalars(params)
    lix, liy = int(listener_ix), int(listener_iy)
    inner = (slice(k, k + bx), slice(k, k + by))

    def setup(i, j):
        b = beta_e[i][j]
        coefs, gi, gj = fold_coefficients(params, b, y_e[i][j], i * bx - k, j * by - k)
        dev = b.device
        pulse_pad = torch.zeros(rounds * k, dtype=torch.float32, device=dev)
        pulse_pad[:T] = pulses[dev]
        return {"beta": b, "coefs": coefs, "pulse": pulse_pad,
                "src": ((gi == lix) & (gj == liy)).to(torch.float32),
                "state": torch.zeros((3, bx, by), dtype=torch.float32,
                                     device=dev),
                "acc": fresh_acc((bx, by), dev),
                "rec": torch.empty((T, bx, by), dtype=torch.float32,
                                   device=dev)}

    shards = [[setup(i, j) if mesh.is_local(i, j) else None
               for j in range(my)] for i in range(mx)]
    for r in range(rounds):
        t0 = r * k
        ext = _exchange_halo(_map(lambda s: s["state"], shards), k, mesh)
        for s, e in _cells(shards, ext):
            p, vx, vy = e.unbind(0)
            for t in range(t0, t0 + k):
                p, vx, vy = fdtd_step_folded(p, vx, vy, s["beta"],
                                             s["coefs"], scalars[0])
                if t < T:    # a padded tail step streams and records nothing
                    p_int = p[inner]
                    s["acc"] = stream_step(t, p_int, vx[inner], vy[inner],
                                           s["acc"], scalars)
                    s["rec"][t] = p_int   # record pre-injection, then inject
                p = p + s["src"] * s["pulse"][t]
            s["state"] = torch.stack([p[inner], vx[inner], vy[inner]])
    return Sharded(FdtdResult, {"pressure": _map(lambda s: s["rec"], shards),
                                "onset": _map(lambda s: s["acc"][0], shards),
                                "flux_x": _map(lambda s: s["acc"][1], shards),
                                "flux_y": _map(lambda s: s["acc"][2], shards)},
                   mesh)


_SIDE_STREAMS: dict = {}


def _side_stream(device) -> "torch.cuda.Stream":
    """The exchange's side stream on a CUDA device, made at first use."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _FrameCopies:
    """The copies of one frame exchange into the receivers' ghost buffers.

    A copy within one device runs on its current stream, in order with the
    launches. A copy between two cards runs on their side streams, after
    events recorded on both cards' current streams behind their frame
    launches (the sender's new frames are written; the receiver's frame
    launch has read the buffer's last contents), and the receiver waits on
    its end (:meth:`wait`) before its next frame launch. Each tensor used
    on a side stream is recorded there (``record_stream``), so the
    allocator never hands its memory out while a copy still reads or
    writes it.
    """

    def __init__(self):
        self._ready = {}   # device -> event behind its frame launches
        self._copied = {}  # receiver device -> events of its copies

    def _behind_frames(self, device) -> "torch.cuda.Event":
        if device not in self._ready:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            self._ready[device] = ready
        return self._ready[device]

    def __call__(self, slab: torch.Tensor, ghost: torch.Tensor) -> None:
        if slab.device == ghost.device:
            ghost.copy_(slab)
            return
        src, dst = slab.device, ghost.device
        sent, free = self._behind_frames(src), self._behind_frames(dst)
        side_src, side_dst = _side_stream(src), _side_stream(dst)
        with torch.cuda.stream(side_src), torch.cuda.stream(side_dst):
            side_src.wait_event(sent)
            side_src.wait_event(free)
            ghost.copy_(slab, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side_dst)
        slab.record_stream(side_src)
        ghost.record_stream(side_src)
        self._copied.setdefault(dst, []).append(copied)

    def wait(self, device) -> None:
        """Make ``device``'s current stream wait for the copies it
        received from other cards (nothing to wait for where none crossed
        a device)."""
        for copied in self._copied.get(device, ()):
            torch.cuda.current_stream(device).wait_event(copied)


def _exchange_frames(pairs) -> _FrameCopies:
    """The overlap split's exchange: each (slab, ghost) pair's slab, a
    shard's new frame rows [3, k, by], copied into the ghost buffer a
    neighbour reads in the next round's frame launch. Returns the copies;
    call ``copies.wait(device)`` before a receiver's next frame launch."""
    copies = _FrameCopies()
    for slab, ghost in pairs:
        copies(slab, ghost)
    return copies
