"""Driving the program under test: the ``planeverb_tpu_torch.Context`` a cell
runs, its warm-up, and the measured window of refreshes.

One refresh is what a game's engine loop does for one parameter update, on
the port's public API:

1. set the listener position(s) of this refresh;
2. move the door, where the traffic has one (``Context.geometry.update``);
3. ``Context.step()``;
4. read every emitter's parameters with ``Context.get_output``, for every
   view.

The loop is closed: one client runs refresh after refresh. A refresh is
timed on the host clock from step 1 until step 4 returns; ``step()`` ends in
its host copy, so the device's work is inside that time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

# refreshes before the window: the first builds the kernels and fills the
# allocator's cache, the rest run every shape the window runs
WARM_REFRESHES = 5
# refreshes the reference checks besides the window's last one, drawn from
# the seed uniformly over the window (reservoir sampling)
CHECKED = 3
# refreshes a second of the window whose walks are laid out in set-up: over
# twice the fastest cell's rate (about 170 a second on the H100); a faster
# window extends them as it goes
PREPARED_PER_S = 400
# the seed's stream for the choice of the refreshes checked
_CHECK_STREAM = 99


@dataclasses.dataclass
class Window:
    """What a measured window gives: each refresh's latency and end (s from
    the window's start), the window's seconds, the peak device memory over
    it, the refreshes kept for the check (``index``, ``listeners``,
    ``boxes``, ``outputs`` [view][emitter], ``published`` (the host side of
    the publish), ``beta``/``refl`` (the fields it stepped on)), and the
    main thread's CPU seconds over the window (the host's speed)."""
    latencies: list
    ends: list
    seconds: float
    memory_peak: int
    samples: list
    main_thread_cpu_s: float


class Program:
    """The Context of one cell, with the traffic's emitters and door."""

    def __init__(self, config: dict, traffic, device, precision="f32",
                 spans=False):
        import planeverb_tpu_torch as pv

        self.traffic = traffic
        self.device = torch.device(device)
        self.spans = spans
        cfg = pv.PlaneverbConfig(
            grid_size_x=float(config["world_m"][0]),
            grid_size_y=float(config["world_m"][1]),
            grid_resolution=int(config["resolution_hz"]),
            grid_boundary_type=(pv.BoundaryType.ABSORBING
                                if config["boundary"] == "absorbing"
                                else pv.BoundaryType.REFLECTING),
            grid_offset_x=float(config["offset_m"][0]),
            grid_offset_y=float(config["offset_m"][1]))
        scene = pv.Scene(boxes=[pv.AABB(*b) for b in traffic.boxes])
        self.ctx = pv.Context(cfg, scene=scene, publish=config["publish"],
                              precision=precision, device=device)
        self.aabb = pv.AABB
        door = traffic.door(0)
        self.door_id = (None if door is None
                        else self.ctx.geometry.add(pv.AABB(*door)))
        h = traffic.height
        self.eids = [self.ctx.emissions.emit(x, h, z)
                     for x, z in traffic.emitters]
        self.views = len(traffic.walks)

    def _span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("pvb." + name)

    def refresh(self, listeners, door) -> list:
        """One refresh (steps 1-4). Returns the outputs [view][emitter]."""
        ctx, h = self.ctx, self.traffic.height
        with self._span("refresh"):
            with self._span("inputs"):
                if self.views == 1:
                    ctx.set_listener_position(listeners[0][0], h,
                                              listeners[0][1])
                else:
                    ctx.set_listener_positions([(x, h, z)
                                                for x, z in listeners])
                if door is not None:
                    ctx.geometry.update(self.door_id, self.aabb(*door))
            with self._span("step"):
                ctx.step()
            with self._span("query"):
                return [[ctx.get_output(e, listener=v) for e in self.eids]
                        for v in range(self.views)]

    def sample(self, index: int, listeners, outputs) -> dict:
        """What the check needs of the refresh just made, without the
        recording (device memory); the fields are the tensors the step
        used, which a moving door replaces each refresh."""
        pub = self.ctx._published
        return {"index": index, "listeners": listeners,
                "boxes": self.traffic.boxes_at(index), "outputs": outputs,
                "published": {k: v for k, v in pub.items()
                              if k not in ("pressure", "packed_device")},
                "beta": self.ctx._beta, "refl": self.ctx._refl}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(prog: Program) -> None:
    for i in range(WARM_REFRESHES):
        prog.refresh(prog.traffic.listeners(i), prog.traffic.door(i))
    _sync(prog.device)


def prepare(traffic, seconds: float) -> None:
    """Lay out the walks of the window's refreshes in set-up, as far as
    :data:`PREPARED_PER_S` a second of the window."""
    traffic.reach(WARM_REFRESHES + int(seconds * PREPARED_PER_S))


def run_window(prog: Program, seconds: float, seed: int,
               profile_first: int = 0, profiler=None) -> Window:
    """Refresh after refresh for ``seconds``, the traffic continuing from
    the warm-up; each refresh's inputs are read before its clock starts.
    With a ``profiler`` (a started ``torch.profiler.profile``) the first
    ``profile_first`` refreshes are traced, then it is stopped."""
    traffic, dev = prog.traffic, prog.device
    first = WARM_REFRESHES
    rng = np.random.default_rng([seed, _CHECK_STREAM])
    kept: list = []
    lat, ends = [], []
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cpu_open = time.thread_time()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    k = 0
    while True:
        i = first + k
        listeners, door = traffic.listeners(i), traffic.door(i)
        t0 = time.perf_counter()
        outs = prog.refresh(listeners, door)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        ends.append(t1 - t_open)
        # the reservoir: refresh k is kept with chance CHECKED / (k + 1)
        if k < CHECKED:
            kept.append(prog.sample(i, listeners, outs))
        else:
            j = int(rng.integers(k + 1))
            if j < CHECKED:
                kept[j] = prog.sample(i, listeners, outs)
        k += 1
        if profiler is not None and k == profile_first:
            _sync(dev)
            profiler.stop()
            profiler = None
        if t1 >= deadline:
            break
    t_close = time.perf_counter()
    cpu_s = time.thread_time() - cpu_open
    if profiler is not None:
        _sync(dev)
        profiler.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    last = prog.sample(first + k - 1, listeners, outs)
    if all(s["index"] != last["index"] for s in kept):
        kept.append(last)
    kept.sort(key=lambda s: s["index"])
    return Window(lat, ends, t_close - t_open, int(peak), kept, cpu_s)
