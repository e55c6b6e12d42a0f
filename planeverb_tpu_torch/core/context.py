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
publish. The kernels take one of two routes by grid size
(``ops/fdtd_fused.py::pipeline_auto``): up to ``TILED_MIN_CELLS`` solver
cells the one-launch-per-step B1 and B2 (``csrc/fdtd_fused.cu``), above it
the large-world B3 and B4 (``csrc/fdtd_tiled.cu``: k steps per launch over
tiles, and the moments staged in reverse chunks). On the CPU the same step
runs the kernels' plain versions.

Publish modes:

  - ``"grids"``: one packed [gx, gy, 9] host copy per step. With lazy
    directions (the default above ``LAZY_DOA_CELLS`` analysis cells) the
    step skips the DOA pass and each query walks its own direction on the
    host (``ops/doa.py::walk_direction``).
  - ``"cells"``: only the live emitters' rows are gathered on the device
    and copied; the packed grid stays on the device and any other probe
    fetches its row on demand.

Several listeners, ``mesh``/``halo`` and ``precision="bf16"`` are not
ported yet and raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from planeverb_tpu_torch.config import (GridParams, PlaneverbConfig,
                                        compute_grid_params, gaussian_pulse)
from planeverb_tpu_torch.core.emissions import EmissionRegistry
from planeverb_tpu_torch.core.free_grid import calibrate_free_field
from planeverb_tpu_torch.core.geometry import GeometryRegistry
from planeverb_tpu_torch.ops import voxelize
from planeverb_tpu_torch.ops.doa import walk_direction
from planeverb_tpu_torch.ops.fdtd_fused import pipeline_auto
from planeverb_tpu_torch.scene import Scene
from planeverb_tpu_torch.types import PlaneverbOutput, invalid_output, vec2
from planeverb_tpu_torch.utils.profiling import StageTimer

__all__ = ["Context", "LAZY_DOA_CELLS"]


def _pack(out) -> torch.Tensor:
    """Analyzer grids -> the ONE packed [gx, gy, 9] publish array.

    The column layout — occlusion, wet_gain, rt60, lowpass, direction xy,
    source_directivity xy, delay_samples — is load-bearing: it is the JAX
    engine's layout (and its server/C-ABI "rows" wire format).
    """
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


def _unported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to planeverb_tpu_torch yet "
        f"(ROADMAP.md queue A, item {item}); use planeverb_tpu for it")


class Context:
    def __init__(self, config: PlaneverbConfig, scene: Scene | None = None,
                 lazy_directions: bool | None = None,
                 publish: str = "grids", mesh=None, halo: int | None = None,
                 precision: str = "f32", device="cuda"):
        """The engine on one torch ``device`` (default ``"cuda"``).

        On a CUDA device every step runs the hand-written kernels; on
        ``"cpu"`` it runs their plain versions. A CUDA device without a
        card raises: there is no silent move to the CPU.

        ``publish`` picks the per-step result transfer: ``"grids"`` copies
        the packed [gx, gy, 9] grids to the host; ``"cells"`` copies only
        the live emitters' rows and keeps the packed grid on the device,
        where other probes fetch their row on demand.
        ``lazy_directions`` skips the device DOA pass and walks each
        query's direction on the host; the default ``None`` means lazy on
        grids publish above :data:`LAZY_DOA_CELLS` analysis cells. Cells
        publish computes directions on the device, so it refuses
        ``lazy_directions=True``.

        Not ported yet (each raises NotImplementedError): ``mesh``/``halo``,
        ``precision="bf16"`` and more than one listener
        (:meth:`set_listener_positions`).
        """
        config.validate()
        if mesh is not None or halo is not None:
            raise _unported("Context(mesh=..., halo=...)", "A14")
        if precision == "bf16":
            raise _unported("Context(precision='bf16')", "A11")
        if precision != "f32":
            raise ValueError(f"unknown precision {precision!r}")
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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Context(device={device!r}): no CUDA device is available; "
                f"pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

        self.config = config
        self.params: GridParams = params
        self.geometry = GeometryRegistry()
        self.emissions = EmissionRegistry()
        self.timer = StageTimer()

        self._pulse = torch.from_numpy(gaussian_pulse(self.params)).to(
            self.device)
        self._listener = (0.0, 0.0, 0.0)
        self._listener_lock = threading.Lock()
        self._coverage_warned = False
        self._coverage_checked = False   # first-step check done?

        # calibration (FreeGrid analog) — one empty-grid sim at init
        with self.timer.stage("calibration"):
            self.efree = calibrate_free_field(self.params, self.device)

        self._fields_version = -1
        self._beta = None
        self._refl = None

        # one snapshot object published per iteration: a single attribute
        # assignment is atomic, so readers never pair new results with an
        # old listener position (or vice versa)
        self._published: dict | None = None
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
        self._warn_if_uncovered(x, z)
        with self._listener_lock:
            self._listener = (x, y, z)

    def get_listener_position(self):
        with self._listener_lock:
            return self._listener

    def set_listener_positions(self, positions) -> None:
        """One listener only in this slice: a 1-element list is
        :meth:`set_listener_position`; more raise NotImplementedError."""
        positions = [tuple(float(v) for v in p) for p in positions]
        if not positions:
            raise ValueError("need at least one listener position")
        if any(len(p) != 3 for p in positions):
            raise ValueError("listener positions are (x, y, z) triples")
        if len(positions) > 1:
            raise _unported("set_listener_positions with several listeners",
                            "A9")
        self.set_listener_position(*positions[0])

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
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
    def _sync_fields(self) -> None:
        version, boxes = self.geometry.snapshot()
        if version == self._fields_version:
            return
        with self.timer.stage("voxelize"):
            if boxes:
                arr = torch.from_numpy(voxelize.boxes_to_array(boxes))
                beta, refl = voxelize.voxelize(self.params,
                                               arr.to(self.device))
            else:
                b, r = voxelize.base_fields(self.params)
                beta = torch.from_numpy(b).to(self.device)
                refl = torch.from_numpy(r).to(self.device)
            self._beta, self._refl = beta, refl
            self._fields_version = version

    @property
    def background_running(self) -> bool:
        """True while the background loop thread owns the iteration cadence."""
        return self._thread is not None and self._running

    def step(self) -> None:
        """One background-loop iteration: sim -> analyze -> publish.

        Thread-safe: concurrent callers serialize on a step lock, so a
        manual step can never interleave with the background loop's.
        """
        with self._step_lock:
            self._step_locked()

    def _step_locked(self) -> None:
        with self._listener_lock:
            lx, ly, lz = self._listener
        if not self._coverage_checked:
            # a Context stepped with the never-set default listener (a grid
            # corner) still gets the coverage warning
            self._coverage_checked = True
            self._warn_if_uncovered(lx, lz)
        self._sync_fields()
        cix, ciy = self.params.world_to_cell(lx, lz)
        wanted = self._wanted_cells() if self._publish_cells else None
        with self.timer.stage("simulate+analyze"):
            res, out = pipeline_auto(
                self.params, self._beta, self._refl, self._pulse, cix, ciy,
                self.efree, float(np.float32(lx)), float(np.float32(lz)),
                compute_directions=not self._lazy_doa)
            packed = _pack(out)
            # the single host copy: the packed grids, or on cells publish
            # only the emitters' rows, gathered on the device. It waits for
            # the device, so this stage times the whole pass, not its enqueue
            if wanted is None:
                fetched = packed.cpu().numpy()
            elif wanted:
                idx = torch.tensor(wanted, device=packed.device)
                fetched = packed[idx[:, 0], idx[:, 1]].cpu().numpy()
            else:
                fetched = np.zeros((0, 9), np.float32)  # no emitters
                if packed.is_cuda:
                    torch.cuda.synchronize(packed.device)
        with self.timer.stage("publish"):
            # the recording stays on the device, exactly [T, nx, ny]
            published = {"listener": (lx, lz), "pressure": res.pressure}
            if wanted is None:
                published.update(_grids_dict(fetched))
            else:
                published["cells"] = {cell: fetched[i]
                                      for i, cell in enumerate(wanted)}
                published["packed_device"] = packed   # [gx, gy, 9] on device
        self._published = published            # single atomic assignment
        with self._iter_cond:
            self._iteration += 1
            self._iter_cond.notify_all()

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
        Analyzer.cpp:106-116 + FDTD.cpp:16-58). Only ``listener=0`` exists
        in this slice; other indices return the invalid sentinel."""
        results = self._published              # one consistent snapshot
        if results is None or listener != 0:
            return invalid_output()
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.grid_x and 0 <= cy < p.grid_y):
            return invalid_output()
        if "cells" in results:
            cache = results["cells"]
            row = cache.get((cx, cy))
            if row is None:
                # a probe outside the published emitter set: fetch its row
                # on demand and memoize it in this snapshot's cache
                with self._probe_lock:
                    row = cache.get((cx, cy))
                    if row is None:
                        row = results["packed_device"][cx, cy].cpu().numpy()
                        cache[(cx, cy)] = row
            return _output_from_row(row)
        if self._lazy_doa:
            llx, llz = results["listener"]
            d = walk_direction(p, results["occlusion"],
                               results["delay_samples"], cx, cy,
                               llx + p.grid_offset_x, llz + p.grid_offset_y)
        else:
            d = results["direction"][cx, cy]
        s = results["source_directivity"][cx, cy]
        return PlaneverbOutput(
            occlusion=float(results["occlusion"][cx, cy]),
            wet_gain=float(results["wet_gain"][cx, cy]),
            rt60=float(results["rt60"][cx, cy]),
            lowpass=float(results["lowpass"][cx, cy]),
            direction=vec2(float(d[0]), float(d[1])),
            source_directivity=vec2(float(s[0]), float(s[1])),
        )

    def get_output(self, emission_id: int,
                   listener: int = 0) -> PlaneverbOutput:
        pos = self.emissions.get(emission_id)
        if pos is None:
            return invalid_output()
        return self.result_at(pos[0], pos[2], listener=listener)

    def get_impulse_response(self, x: float, z: float) -> np.ndarray:
        """Debug IR accessor (Planeverb::GetImpulseResponse analog).

        Out-of-grid probes return an empty array — the reference returns
        null for positions outside the grid (FDTD.cpp:60-70).
        """
        published = self._published
        if published is None:
            return np.zeros(self.params.response_length, np.float32)
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.nx and 0 <= cy < p.ny):
            return np.zeros(0, np.float32)
        return published["pressure"][:, cx, cy].cpu().numpy()

    # --------------------------------------------------------------- admin
    def profile_summary(self) -> dict:
        summary = self.timer.stats.summary()
        pipe = summary.get("simulate+analyze")
        if pipe:
            from planeverb_tpu_torch.utils.profiling import throughput

            summary["throughput"] = throughput(self.params, pipe["mean_s"])
        return summary
