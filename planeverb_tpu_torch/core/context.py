"""Engine context: owns all subsystems and the simulation loop.

Counterpart of ``planeverb_tpu/core/context.py`` (the reference's
ProjectPlaneverb/src/Context/PvContext.cpp):

  - Each iteration takes a *snapshot* of (listener, geometry version) on
    the host, runs one pass on the context's device, and atomically
    publishes the host-side results dict.
  - Geometry changes re-rasterize the whole field set on the device
    (ops/voxelize.py).
  - ``Context.step()`` runs one sim+analyze iteration synchronously;
    ``Context.start()`` runs the same loop on a background thread like the
    reference's BackgroundProcessor (PvContext.cpp:160).

One step on a CUDA device is: voxelize (when the geometry changed) -> the
simulation and RT60-moments kernels -> parameter assembly and DOA -> the
publish. The kernels take one of two routes
(``ops/fdtd_fused.py::pipeline_auto``), as ``fdtd_fused.route_tiled``
decides: the tiled B3 and B4 (``csrc/fdtd_tiled.cu``: the whole pass in one
cooperative launch, k steps a round over tiles spread across every SM, and
the moments staged in reverse chunks), or B1 and B2
(``csrc/fdtd_fused.cu``, ``csrc/moments.cu``: one thread-block cluster a
listener, one launch a pass). On the CPU the same step runs the kernels'
plain versions.

With ``mesh=`` the step runs the sharded engine
(``parallel/solver_fused.py::pipeline_sharded``): the fields are padded to
the mesh and sharded over it, and the shards advance in rounds of
``halo`` steps, one B5 (``sharded_round``) or, for shards above
``TILED_MIN_CELLS`` cells, one B6 (``banded_round``) launch per device and
round over every shard it holds, reading the ghosts on the device
(``csrc/solver_rounds.cu``); each shard's moments come from B2 or B4 on
its own recording. On a 1D ("x", N) mesh the rounds take the overlap
split when the shards hold it (``_overlap``): per device and round a frame
launch, the frames' exchange across devices, and an interior launch that
does not wait for it. The published grids equal the single-device step's
bit for bit.

A mesh may span several processes (``parallel.multihost_grid_mesh`` over
``torch.distributed``): every rank builds the same Context on it and calls
the same methods in the same order, and each runs only its own shards,
calibrates on its own first device and publishes the same grids (the
analysis inputs are assembled on every rank, as JAX's replicated outputs
are). Each step first holds its host inputs equal on every rank
(``multihost.agree``: the listeners, the geometry, the publish mode, the
wanted cells, the lazy-directions switch) and raises the same
``ValueError`` on every rank where they differ. ``stop()`` on any rank
raises a stop flag that rides the next step's agreement, so every rank's
loop ends on the same iteration. The hazard that remains: a rank that
fails or dies inside a step's collectives leaves the others blocked in
them until the process group's timeout.

Publish modes:

  - ``"grids"``: one packed [gx, gy, 9] host copy per step. With lazy
    directions (the default above ``LAZY_DOA_CELLS`` analysis cells) the
    step skips the DOA pass and each query walks its own direction on the
    host (``ops/doa.py::walk_direction``).
  - ``"cells"``: only the live emitters' rows are gathered on the device
    and copied; the packed grid stays on the device and any other probe
    fetches its row on demand.

Several listeners (:meth:`Context.set_listener_positions`: split screen,
multiplayer) run every view in one step and publish them together, with a
leading [B] axis (``ops/fdtd_fused.py::pipeline_auto_batch``): through the
batched B1 and B2 (one launch each for all views) or, on the tiled route,
one B3 + B4 pass per view, each view's recording freed before the next; on
a mesh one sharded pass per view. The views' recordings are not
published.

``precision="bf16"`` keeps B1's wave state and recording in bf16 (the
accumulators stay float32); the tiled route and the sharded engine run
float32.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from planeverb_tpu_torch.config import (GridParams, PlaneverbConfig,
                                        compute_grid_params, gaussian_pulse)
from planeverb_tpu_torch.core.emissions import EmissionRegistry
from planeverb_tpu_torch.core.free_grid import calibrate_free_field
from planeverb_tpu_torch.core.geometry import GeometryRegistry
from planeverb_tpu_torch.ops import voxelize
from planeverb_tpu_torch.ops.doa import walk_direction
from planeverb_tpu_torch.ops.fdtd_fused import (pipeline_auto,
                                               pipeline_auto_batch)
from planeverb_tpu_torch.parallel import multihost
from planeverb_tpu_torch.parallel.mesh import Mesh, pad_to_mesh
from planeverb_tpu_torch.parallel.solver import shard_fields
from planeverb_tpu_torch.parallel.solver_fused import pipeline_sharded
from planeverb_tpu_torch.scene import Scene
from planeverb_tpu_torch.types import PlaneverbOutput, invalid_output, vec2
from planeverb_tpu_torch.utils.profiling import (StageTimer, count, span,
                                                 throughput)

__all__ = ["Context", "LAZY_DOA_CELLS"]


def _pack(out) -> torch.Tensor:
    """Analyzer grids -> the ONE packed [gx, gy, 9] publish array.

    The column layout — occlusion, wet_gain, rt60, lowpass, direction xy,
    source_directivity xy, delay_samples — is load-bearing: it is the JAX
    engine's layout (and its server/C-ABI "rows" wire format).
    """
    with span("pack"):
        return torch.cat([
            out.occlusion[..., None], out.wet_gain[..., None],
            out.rt60[..., None], out.lowpass[..., None],
            out.direction, out.source_directivity,
            out.delay_samples[..., None],
        ], dim=-1)


def _grids_dict(grids) -> dict:
    """Fetched packed array -> named grids (the one place the :func:`_pack`
    column layout is unpacked for publishing)."""
    return {
        "occlusion": grids[..., 0],
        "wet_gain": grids[..., 1],
        "rt60": grids[..., 2],
        "lowpass": grids[..., 3],
        "direction": grids[..., 4:6],
        "source_directivity": grids[..., 6:8],
        "delay_samples": grids[..., 8],
    }


def _output_from_row(row) -> PlaneverbOutput:
    """One packed [9] row (layout of :func:`_pack`) -> PlaneverbOutput."""
    return PlaneverbOutput(
        occlusion=float(row[0]), wet_gain=float(row[1]), rt60=float(row[2]),
        lowpass=float(row[3]),
        direction=vec2(float(row[4]), float(row[5])),
        source_directivity=vec2(float(row[6]), float(row[7])),
    )


# grids above this many analysis cells compute DOA lazily per query (a host
# walk, ops/doa.py::walk_direction) instead of the full-grid device pass;
# the JAX engine's threshold (planeverb_tpu/core/context.py)
LAZY_DOA_CELLS = 1 << 20


class Context:
    def __init__(self, config: PlaneverbConfig, scene: Scene | None = None,
                 lazy_directions: bool | None = None,
                 publish: str = "grids", mesh: Mesh | None = None,
                 halo: int | None = None, precision: str = "f32",
                 device=None):
        """The engine on one torch ``device`` (default ``"cuda"``), or
        sharded over a ``mesh`` (``parallel.grid_mesh``).

        On a CUDA device every step runs the hand-written kernels; on
        ``"cpu"`` it runs their plain versions. A CUDA device without a
        card raises: there is no silent move to the CPU.

        ``mesh`` shards every step over the mesh's devices (all CUDA or all
        CPU; a ``device`` of another type raises), in rounds of ``halo``
        steps between ghost exchanges; the default halo is the largest
        power of two up to 16 that fits a shard. Calibration runs on the
        calling process's first device of the mesh, and the published
        grids equal the single-device Context's. On a mesh of several
        processes every rank builds this Context and steps it in turn
        (see the module docstring). On a 1D ("x", N) mesh with N > 1 whose
        shards have at least 3 * halo rows the step takes the overlap
        split of the rounds (``_overlap``, the JAX Context's rule), which
        publishes the same bits. The rule reads the shard rows bx of this
        Context's padding: the field is padded to a multiple of the mesh
        only, where the JAX Context pads to a multiple of 8 shards' worth
        (its banded kernel's DMA alignment), so the two may decide apart.
        At 25 m and 275 Hz (71 x 71 cells) on an (8, 1) mesh with halo 4,
        JAX pads to 128 rows (bx 16: the split) and this Context to 72 (bx
        9: the plain rounds); the results are equal either way.

        ``publish`` picks the per-step result transfer: ``"grids"`` copies
        the packed [gx, gy, 9] grids to the host; ``"cells"`` copies only
        the live emitters' rows and keeps the packed grid on the device,
        where other probes fetch their row on demand.
        ``lazy_directions`` skips the device DOA pass and walks each
        query's direction on the host; the default ``None`` means lazy on
        grids publish above :data:`LAZY_DOA_CELLS` analysis cells. Cells
        publish computes directions on the device, so it refuses
        ``lazy_directions=True``.

        ``precision="bf16"`` runs B1 with bf16 wave state and recording
        (the JAX engine's half-precision mode; its parameters stay within
        the bf16 bounds of the float32 engine's, not bit-equal). Passes on
        the tiled route run float32 whatever it is; with a mesh it is
        refused.
        """
        config.validate()
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        if mesh is not None and precision == "bf16":
            raise ValueError("precision='bf16' is single-device only (the "
                             "sharded pipeline runs f32)")
        self._state_dtype = (torch.bfloat16 if precision == "bf16"
                             else torch.float32)
        if publish not in ("grids", "cells"):
            raise ValueError(f"unknown publish mode {publish!r}")
        self._publish_cells = publish == "cells"
        params = compute_grid_params(config)
        if lazy_directions is None:
            lazy_directions = (not self._publish_cells
                               and params.grid_x * params.grid_y
                               > LAZY_DOA_CELLS)
        if lazy_directions and self._publish_cells:
            raise ValueError("publish='cells' computes directions on the "
                             "device; lazy_directions needs host-side grids")
        self._lazy_doa = bool(lazy_directions)
        self._probe_lock = threading.Lock()   # guards cells-cache fills
        if mesh is None:
            if halo is not None:
                raise ValueError("halo is the sharded engine's round length; "
                                 "it needs a mesh")
            self.device = torch.device("cuda" if device is None else device)
        else:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh (grid_mesh), "
                                f"got {type(mesh).__name__}")
            self.device = mesh.local_device
            if device is not None and torch.device(device).type \
                    != mesh.device_type:
                raise ValueError(
                    f"Context(device={device!r}) but the mesh's devices are "
                    f"{mesh.device_type}: nothing moves between them")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Context(device={str(self.device)!r}): no CUDA device is "
                f"available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

        self.config = config
        self.params: GridParams = params
        self.mesh = mesh
        # a mesh of several processes: every step agrees its inputs first
        self._multi_process = mesh is not None and mesh.multi_process
        self._stop_flag = False
        if mesh is not None:
            self._nx_pad, self._ny_pad = pad_to_mesh(params.nx, params.ny,
                                                     mesh)
            bx = self._nx_pad // mesh.shape["x"]
            by = self._ny_pad // mesh.shape["y"]
            if halo is None:
                halo = 16
                while halo > min(bx, by):
                    halo //= 2
            if not 1 <= halo <= min(bx, by):
                raise ValueError(f"halo {halo} exceeds per-shard block "
                                 f"({bx}, {by})")
            self._halo = int(halo)
            # the JAX Context's rule: the overlap split on every 1D ("x", N)
            # mesh whose shards hold its frames; bit-equal to the plain
            # rounds, so users never choose
            self._overlap = (mesh.shape["y"] == 1 and mesh.shape["x"] > 1
                             and bx >= 3 * self._halo)
        self.geometry = GeometryRegistry()
        self.emissions = EmissionRegistry()
        self.timer = StageTimer()

        self._pulse = torch.from_numpy(gaussian_pulse(self.params)).to(
            self.device)
        self._listener = (0.0, 0.0, 0.0)
        self._listeners_multi: list | None = None
        self._listener_lock = threading.Lock()
        self._coverage_warned = False
        self._coverage_checked = False   # first-step check done?

        # calibration (FreeGrid analog) — one empty-grid sim at init
        with self.timer.span("calibration"):
            self.efree = calibrate_free_field(self.params, self.device)

        self._fields_version = -1
        self._beta = None
        self._refl = None

        # one snapshot object published per iteration: a single attribute
        # assignment is atomic, so readers never pair new results with an
        # old listener position (or vice versa)
        self._published: dict | None = None
        # the same snapshot without the recording, which result_at reads: a
        # reader held up inside it (an audio callback the loop's thread took
        # the interpreter lock from) then keeps no recording alive beside
        # the published one and the one the next step writes
        self._queried: dict | None = None
        self._iteration = 0
        self._iter_cond = threading.Condition()

        self._thread: threading.Thread | None = None
        self._running = False
        # serializes whole iterations: a manual step() alongside the
        # background loop queues instead of interleaving
        self._step_lock = threading.Lock()
        self.error: BaseException | None = None  # set if the loop dies

        if scene is not None:
            self.geometry.load_scene(scene)

    # ------------------------------------------------------------- listener
    def _warn_if_uncovered(self, x: float, z: float) -> None:
        """Warn (once per context) when the IR length cannot cover the whole
        grid from this listener position (see the JAX Context)."""
        if self._coverage_warned:
            return
        p = self.params
        gx_m = p.grid_x * p.dx
        gy_m = p.grid_y * p.dx
        wx = x + p.grid_offset_x
        wz = z + p.grid_offset_y
        far = max(np.hypot(wx - cx, wz - cy)
                  for cx in (0.0, gx_m) for cy in (0.0, gy_m))
        slack = 2.0 * p.constants.c / p.fs + 2.0 * p.dx
        if far > p.covered_travel_m + slack:
            import warnings

            self._coverage_warned = True
            warnings.warn(
                f"listener at ({x:.1f}, {z:.1f}) is {far:.1f} m from the "
                f"farthest grid corner but the impulse response only covers "
                f"{p.covered_travel_m:.1f} m of travel; cells beyond that "
                f"distance will publish never-found sentinel values "
                f"(center the listener or enlarge the grid/IR length)",
                RuntimeWarning, stacklevel=3)

    def set_listener_position(self, x: float, y: float, z: float) -> None:
        """One listener (clears the views of :meth:`set_listener_positions`)."""
        self._warn_if_uncovered(x, z)
        with self._listener_lock:
            self._listener = (x, y, z)
            self._listeners_multi = None

    def get_listener_position(self):
        with self._listener_lock:
            return self._listener

    def set_listener_positions(self, positions) -> None:
        """B listeners at once: split screen, multiplayer.

        ``step()`` then runs one simulation per view (batched on the card,
        see the module docstring) and publishes every view's results
        together: [B, ...] grids on grids publish, the live emitters'
        [B, 9] rows on cells publish. Query a view with
        ``result_at(x, z, listener=i)`` or ``get_output(eid, listener=i)``.
        Works with a mesh too; a 1-element list (or
        :meth:`set_listener_position`) returns to the single listener.
        """
        positions = [tuple(float(v) for v in p) for p in positions]
        if not positions:
            raise ValueError("need at least one listener position")
        if any(len(p) != 3 for p in positions):
            raise ValueError("listener positions are (x, y, z) triples")
        for px, _, pz in positions:
            self._warn_if_uncovered(px, pz)
        with self._listener_lock:
            self._listener = positions[0]
            self._listeners_multi = positions if len(positions) > 1 else None

    def get_listener_positions(self) -> list:
        with self._listener_lock:
            if self._listeners_multi is not None:
                return list(self._listeners_multi)
            return [self._listener]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Spawn the background processing loop (PvContext.cpp:160 analog)."""
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="planeverb-background")
        self._thread.start()

    def stop(self) -> None:
        """End the background loop. On a mesh of several processes it
        raises the stop flag instead: the next step agrees it on every
        rank, and every rank's loop finishes that step and ends, so all
        ranks stop on the same iteration; a rank whose loop ends that way
        still calls ``stop()`` to join it."""
        if self._thread is None:
            return
        if self._multi_process:
            self._stop_flag = True
        else:
            self._running = False
        self._thread.join()
        self._thread = None
        self._stop_flag = False

    def _loop(self) -> None:
        import traceback

        while self._running:
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must not die silently
                self.error = e
                traceback.print_exc()
                self._running = False
                with self._iter_cond:
                    self._iter_cond.notify_all()
                return

    # ------------------------------------------------------------ iteration
    def _sync_fields(self, snapshot) -> None:
        version, boxes = snapshot
        if version == self._fields_version:
            return
        with self.timer.span("fields"):
            if boxes:
                arr = torch.from_numpy(voxelize.boxes_to_array(boxes))
                beta, refl = voxelize.voxelize(self.params,
                                               arr.to(self.device))
            else:
                b, r = voxelize.base_fields(self.params)
                beta = torch.from_numpy(b).to(self.device)
                refl = torch.from_numpy(r).to(self.device)
            if self.mesh is not None:
                # pad to the mesh (beta = 0, silent) and keep the shards,
                # each on its mesh device; on a mesh of several processes
                # the whole padded fields, from which each pass cuts this
                # process's shards (only state crosses processes)
                pad = (0, self._ny_pad - self.params.ny,
                       0, self._nx_pad - self.params.nx)
                beta, refl = F.pad(beta, pad), F.pad(refl, pad)
                if not self._multi_process:
                    beta, refl = shard_fields(self.mesh, beta, refl)
            self._beta, self._refl = beta, refl
            self._fields_version = version

    @property
    def background_running(self) -> bool:
        """True while the background loop thread owns the iteration cadence."""
        return self._thread is not None and self._running

    def step(self) -> None:
        """One background-loop iteration: sim -> analyze -> publish.

        Thread-safe: concurrent callers serialize on a step lock, so a
        manual step can never interleave with the background loop's. On a
        mesh of several processes every rank calls it in turn: it is a
        collective, and it raises the same ``ValueError`` on every rank
        whose inputs differ from rank 0's.
        """
        with self._step_lock, self.timer.step(self._iteration + 1):
            self._step_locked()

    def _step_locked(self) -> None:
        with self._listener_lock:
            multi = self._listeners_multi
            listeners = multi or [self._listener]
        if not self._coverage_checked:
            # a Context stepped with the never-set default listener (a grid
            # corner) still gets the coverage warning
            self._coverage_checked = True
            for px, _, pz in listeners:
                self._warn_if_uncovered(px, pz)
        if self._multi_process:
            snapshot, wanted = self._agreed_inputs(listeners)
        else:
            snapshot, wanted = self._inputs()
        self._sync_fields(snapshot)
        views = [(lx, lz) for lx, _, lz in listeners]
        with self.timer.span("simulate+analyze"):
            pressure, packed = self._pass(views, multi is not None)
            # the single host copy: the packed grids, or on cells publish
            # only the emitters' rows, gathered on the device (with a
            # leading [B] axis for several views). It waits for the device,
            # so this span times the whole pass, not its enqueue
            with span("fetch"):
                if wanted is None:
                    fetched = packed.cpu().numpy()
                elif wanted:
                    idx = torch.tensor(wanted, device=packed.device)
                    fetched = packed[..., idx[:, 0], idx[:, 1], :]
                    fetched = fetched.cpu().numpy()
                else:
                    fetched = np.zeros((*packed.shape[:-3], 0, 9),
                                       np.float32)
                    if packed.is_cuda:
                        torch.cuda.synchronize(packed.device)
                count("fetch.bytes", fetched.nbytes)
        with self.timer.span("publish"):
            published = {"listener": views[0]}
            if multi is None:
                # the recording stays on the device, exactly [T, nx, ny]; on
                # a mesh, per shard (the Sharded result)
                published["pressure"] = pressure
            else:
                published["listeners"] = views
            if wanted is None:
                published.update(_grids_dict(fetched))
            else:
                # a [9] row per emitter cell, [B, 9] with several views
                published["cells"] = {cell: fetched[..., i, :]
                                      for i, cell in enumerate(wanted)}
                published["packed_device"] = packed   # [(B,) gx, gy, 9]
            self._queried = {k: v for k, v in published.items()
                             if k != "pressure"}
            self._published = published        # single atomic assignment
            with self._iter_cond:
                self._iteration += 1
                self._iter_cond.notify_all()

    def _inputs(self):
        """This step's host inputs besides the listeners: the geometry
        snapshot and, on cells publish, the wanted cells."""
        wanted = self._wanted_cells() if self._publish_cells else None
        return self.geometry.snapshot(), wanted

    # the host inputs a step on a mesh of several processes holds equal on
    # every rank (``_agreed_inputs``)
    _AGREED = ("listeners", "geometry_version", "boxes", "publish", "cells",
               "lazy_directions", "error")

    def _agreed_inputs(self, listeners):
        """:meth:`_inputs`, held equal on every rank with the listeners and
        the switches, and the loop stopped where any rank raised the stop
        flag. An error in reading them rides the agreement, so every rank
        raises the same ValueError (chained, on the rank that failed, to
        its own error)."""
        failed = None
        try:
            snapshot, wanted = self._inputs()
            version, boxes = snapshot
            items = {
                "listeners": np.asarray(listeners, np.float32),
                "geometry_version": version,
                "boxes": voxelize.boxes_to_array(boxes).tobytes(),
                "publish": "cells" if self._publish_cells else "grids",
                "cells": None if wanted is None else
                np.asarray(wanted, np.int64).reshape(-1, 2),
                "lazy_directions": self._lazy_doa,
                "error": None}
        except Exception as e:  # noqa: BLE001 — raised below, on every rank
            failed = e
            items = dict.fromkeys(self._AGREED)
            items["error"] = f"{type(e).__name__}: {e}"
        try:
            stop = multihost.agree(items, flag=self._stop_flag)
        except ValueError as e:
            raise e from failed
        if failed is not None:
            raise failed
        if stop:
            self._running = False     # every rank's loop ends after this step
        return snapshot, wanted

    def _pass(self, views, multi: bool):
        """One pass for every view -> (recording, packed grids): the
        recording of the single view (per shard on a mesh) and its
        [gx, gy, 9] grids, or for several views no recording and
        [B, gx, gy, 9] grids."""
        p = self.params
        fields = (p, self._beta, self._refl, self._pulse)
        cells = [p.world_to_cell(lx, lz) for lx, lz in views]
        lpos = [(float(np.float32(lx)), float(np.float32(lz)))
                for lx, lz in views]
        compute = not self._lazy_doa
        if self.mesh is None:
            if multi:
                out = pipeline_auto_batch(
                    *fields, cells, self.efree, lpos,
                    compute_directions=compute,
                    state_dtype=self._state_dtype)
                return None, _pack(out)
            res, out = pipeline_auto(*fields, *cells[0], self.efree,
                                     *lpos[0], compute_directions=compute,
                                     state_dtype=self._state_dtype)
            return res.pressure, _pack(out)

        def sharded(cell, pos):
            return pipeline_sharded(*fields, *cell, self.mesh, self._nx_pad,
                                    self._ny_pad, self.efree, *pos,
                                    halo=self._halo,
                                    compute_directions=compute,
                                    overlap=self._overlap)

        if not multi:
            res, out = sharded(cells[0], lpos[0])
            return res, _pack(out)
        # one sharded pass per view; each view's recordings are dropped
        # before the next view's pass
        return None, torch.stack([_pack(sharded(cell, pos)[1])
                                  for cell, pos in zip(cells, lpos)])

    def _wanted_cells(self) -> list[tuple[int, int]]:
        """The live emitters' in-grid cells, deduplicated and sorted: the
        rows the cells publish copies each step."""
        p = self.params
        wanted = set()
        for em in self.emissions.snapshot_emissions().values():
            cx, cy = p.world_to_cell(em.position[0], em.position[2])
            if 0 <= cx < p.grid_x and 0 <= cy < p.grid_y:
                wanted.add((cx, cy))
        return sorted(wanted)

    @property
    def iteration(self) -> int:
        return self._iteration

    def wait_for_iteration(self, n: int, timeout: float = 60.0) -> bool:
        with self._iter_cond:
            return self._iter_cond.wait_for(
                lambda: self._iteration >= n, timeout=timeout)

    # -------------------------------------------------------------- queries
    def result_at(self, x: float, z: float,
                  listener: int = 0) -> PlaneverbOutput:
        """World position -> acoustic output (GetResponseResult analog,
        Analyzer.cpp:106-116 + FDTD.cpp:16-58).

        ``listener`` selects the view after :meth:`set_listener_positions`;
        an index out of range returns the invalid sentinel, and a single
        listener's snapshot answers only ``listener=0``.
        """
        results = self._queried                # one consistent snapshot
        if results is None:
            return invalid_output()
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.grid_x and 0 <= cy < p.grid_y):
            return invalid_output()
        views = results.get("listeners")
        n_views = 1 if views is None else len(views)
        if not 0 <= listener < n_views:
            return invalid_output()
        view = () if views is None else (listener,)   # index into [B, ...]
        if "cells" in results:
            cache = results["cells"]
            row = cache.get((cx, cy))
            if row is None:
                # a probe outside the published emitter set: fetch its row
                # (every view's) on demand and memoize it in this snapshot's
                # cache
                with self._probe_lock:
                    row = cache.get((cx, cy))
                    if row is None:
                        row = results["packed_device"][..., cx, cy, :]
                        row = row.cpu().numpy()
                        cache[(cx, cy)] = row
            return _output_from_row(row[view])

        def sel(key):
            return results[key][view]

        if self._lazy_doa:
            llx, llz = (views or [results["listener"]])[listener]
            d = walk_direction(p, sel("occlusion"), sel("delay_samples"),
                               cx, cy, llx + p.grid_offset_x,
                               llz + p.grid_offset_y)
        else:
            d = sel("direction")[cx, cy]
        s = sel("source_directivity")[cx, cy]
        return PlaneverbOutput(
            occlusion=float(sel("occlusion")[cx, cy]),
            wet_gain=float(sel("wet_gain")[cx, cy]),
            rt60=float(sel("rt60")[cx, cy]),
            lowpass=float(sel("lowpass")[cx, cy]),
            direction=vec2(float(d[0]), float(d[1])),
            source_directivity=vec2(float(s[0]), float(s[1])),
        )

    def get_output(self, emission_id: int,
                   listener: int = 0) -> PlaneverbOutput:
        pos = self.emissions.get(emission_id)
        if pos is None:
            return invalid_output()
        return self.result_at(pos[0], pos[2], listener=listener)

    def sync_dsp(self, dsp,
                 listener: int = 0) -> dict[int, tuple[PlaneverbOutput,
                                                       float]]:
        """Push every live emission's state into a DSP context and return
        ``{eid: (acoustic output, emit-time volume gain)}``. In
        multi-listener mode pass one DSP context per view with its
        ``listener`` index (each split-screen player mixes against their
        own parameters).

        This is the per-frame engine->DSP handoff the reference spreads over
        its Unity components (PlaneverbEmitter.cs:52-60 UpdateEmission/
        UpateEmitter/GetOutput each frame, :93 SetEmitterDirectivityPattern
        at emit): position+forward and the directivity pattern go to the DSP
        side; the caller scales the source audio by the returned volume gain
        before ``submit_source`` (PlaneverbAudioSource applies
        GetVolumeGain() to its samples).
        """
        results: dict[int, tuple[PlaneverbOutput, float]] = {}
        live = self.emissions.snapshot_emissions()
        for eid, em in sorted(live.items()):
            dsp.update_emitter(eid, em.position, em.forward)
            dsp.set_emitter_directivity_pattern(eid, em.pattern)
            results[eid] = (self.result_at(em.position[0], em.position[2],
                                           listener=listener),
                            em.volume_gain)
        # drop DSP-side state for emitters that ended since the last sync:
        # emission ids are free-list-reused (EmissionManager.cpp:37-67), and
        # a reused id must not inherit the dead sound's interpolation state
        # (current gains/pan, lowpass filter memory, directivity pattern)
        prev = getattr(dsp, "_pv_synced_ids", ())
        for eid in prev:
            if eid not in live:
                dsp.remove_emitter(eid)
        dsp._pv_synced_ids = frozenset(live)
        return results

    def get_impulse_response(self, x: float, z: float) -> np.ndarray:
        """Debug IR accessor (Planeverb::GetImpulseResponse analog).

        Out-of-grid probes return an empty array — the reference returns
        null for positions outside the grid (FDTD.cpp:60-70) — and so does
        a snapshot of several listeners, whose recordings are not kept (B
        of them would multiply the recording memory). The IR is float32
        (a bf16 recording is cast on the device).

        On a mesh of several processes it is a collective, as indexing a
        global array is in JAX: every rank must call it with the same
        position, in the same order relative to its steps (so not while
        the background loop runs), and every rank returns the same array,
        broadcast from the process that owns the cell's shard. It takes
        the step lock, so it never interleaves with a step of this
        process. The empty answers above need no collective.
        """
        if self._multi_process:
            with self._step_lock:
                return self._impulse_response(x, z)
        return self._impulse_response(x, z)

    def _impulse_response(self, x: float, z: float) -> np.ndarray:
        published = self._published
        if published is None:
            return np.zeros(self.params.response_length, np.float32)
        if published.get("pressure") is None:
            return np.zeros(0, np.float32)
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.nx and 0 <= cy < p.ny):
            return np.zeros(0, np.float32)
        if self._multi_process:
            # the owner's column, broadcast to every rank
            mesh = self.mesh
            i = cx // (self._nx_pad // mesh.shape["x"])
            j = cy // (self._ny_pad // mesh.shape["y"])
            col = (published["pressure"].at("pressure", cx, cy)
                   .to(self.device).contiguous() if mesh.is_local(i, j)
                   else torch.empty(p.response_length, dtype=torch.float32,
                                    device=self.device))
            return multihost.broadcast(col, mesh.ranks[i][j]).cpu().numpy()
        if self.mesh is not None:   # the owning shard's recording
            return published["pressure"].at("pressure", cx, cy).cpu().numpy()
        return published["pressure"][:, cx, cy].float().cpu().numpy()

    # --------------------------------------------------------------- admin
    def profile_summary(self) -> dict:
        """This Context's spans on the host clock ({name: mean_s, last_s,
        count, self_mean_s}), its counters ({name: total, last, count}) and
        the pass's ``throughput``. Device time is in a profiler's trace."""
        summary = self.timer.stats.summary()
        pipe = summary.get("simulate+analyze")
        if pipe:
            # the span times the whole step: B passes with several
            # listeners, so a listener's share is mean / B
            b = len(self.get_listener_positions())
            summary["throughput"] = throughput(self.params,
                                               pipe["mean_s"] / b)
            if b > 1:
                summary["throughput"]["listeners"] = b
        return summary
