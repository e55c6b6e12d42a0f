"""The one traffic generator: listeners' walks, emitters and door moves,
drawn from a seed and a traffic file's parameters.

A traffic file (``benchmark/traffic/<name>.json``) holds:

- ``listeners``: views refreshed together (1, or more for split screen);
- ``speed_m_s`` and ``refresh_period_s``: each listener walks its path at
  this speed, advancing ``speed_m_s * refresh_period_s`` a refresh, so a
  seed gives the same positions whatever rate the engine reaches;
- ``walk_radius_m``: a walk keeps within this distance of its start;
- ``leg_m``: [shortest, longest] straight leg of a walk;
- ``emitters`` and ``emitter_radius_m``: static emitters at free points
  within this distance of the first listener's start;
- ``clearance_m``: the least distance from any box of a listener's path and
  of an emitter;
- ``height_m``: the listeners' and emitters' height, inside the head slice
  (the engine simulates the horizontal slice; the height is passed as is);
- ``door`` (optional): {"positions", "thickness_m"}: a door box across one
  doorway of the scene, drawn from the seed, moved one position a refresh
  from closed to open and round again, starting at a seeded position.
  Listeners and emitters then keep out of the doorways.
- ``audio`` (optional): an audio callback beside the refresh loop
  (``drive.AudioPump``): ``rate_hz`` and ``frames`` of its stream,
  ``voices`` (the first emitters, each looping a clip of its own),
  ``renderer`` (a name in the pump's table), ``smoothing``,
  ``spatialization`` and ``wet_gain_ratio`` (the DSP's settings),
  ``reverb_rt60_s`` (one reverb a wet bus), ``clip_s`` ([shortest,
  longest] clip) and ``clip_dbfs`` (each clip's peak): every clip is
  stereo white noise, uniform within its peak.

Every draw comes from ``numpy.random.default_rng([seed, stream])``, one
stream per listener, one for the emitters, one for the door and one for the
clips, so the positions of refresh i never depend on how many refreshes a
run makes, and the clips take nothing from the positions' streams.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from benchmark import scenes

# candidate legs tried before a walk turns back along its last leg
LEG_TRIES = 200
# streams of the seed's generator; listener k takes _LISTENERS + k
_EMITTERS, _DOOR, _LISTENERS, _CLIPS = 0, 1, 2, 100


@dataclasses.dataclass
class Space:
    """Where traffic may go: the free cells of the static scene, shrunk by
    the clearance, minus the doorways when a door moves."""
    free: np.ndarray
    dx: float
    offset: tuple[float, float]

    def ok(self, x: float, z: float) -> bool:
        i = int(np.float32(x + self.offset[0]) / np.float32(self.dx))
        j = int(np.float32(z + self.offset[1]) / np.float32(self.dx))
        return (0 <= i < self.free.shape[0] and 0 <= j < self.free.shape[1]
                and bool(self.free[i, j]))

    def clear(self, a, b) -> bool:
        """Every point of the segment a-b, at a quarter cell apart, is ok."""
        n = max(1, int(math.ceil(math.dist(a, b) / (0.25 * self.dx))))
        return all(self.ok(a[0] + (b[0] - a[0]) * k / n,
                           a[1] + (b[1] - a[1]) * k / n)
                   for k in range(n + 1))

    def point(self, rng, center=None, radius=None):
        """A uniform free point (within ``radius`` of ``center``)."""
        nx, ny = self.free.shape
        for _ in range(100000):
            if center is None:
                x = rng.uniform(0.0, nx * self.dx) - self.offset[0]
                z = rng.uniform(0.0, ny * self.dx) - self.offset[1]
            else:
                r = radius * math.sqrt(rng.uniform())
                a = rng.uniform(0.0, 2.0 * math.pi)
                x, z = center[0] + r * math.cos(a), center[1] + r * math.sin(a)
            if self.ok(x, z):
                return (float(x), float(z))
        raise ValueError("no free point found for the traffic")


def space(grid, scene: dict, clearance_m: float, door: bool) -> Space:
    """The static scene's free cells on ``grid`` (a ``reference.Grid``),
    shrunk by ``clearance_m``; with a door, its doorways' swept boxes are
    taken too."""
    boxes = list(scene["boxes"])
    if door:
        for d in scene["doorways"]:
            (x0, x1), shift = d["x"], d["slide"] * (d["x"][1] - d["x"][0])
            lo, hi = min(x0, x0 + shift), max(x1, x1 + shift)
            boxes.append([(lo + hi) / 2, d["y"], hi - lo, 2 * clearance_m,
                          0.0])
    free = scenes.paint(boxes, grid.nx, grid.ny, grid.dx, grid.grid_x,
                        grid.grid_y, (grid.offset_x, grid.offset_y))
    cells = int(math.ceil(clearance_m / grid.dx))
    return Space(scenes.erode(free, cells), grid.dx,
                 (grid.offset_x, grid.offset_y))


class Walk:
    """A listener's path: straight legs between free waypoints, each leg
    clear of the boxes, within ``radius`` of the start; extended as the
    refreshes need it, from its own generator."""

    def __init__(self, sp: Space, rng, radius: float, leg, step: float):
        self.sp, self.rng, self.radius = sp, rng, float(radius)
        self.leg = (float(leg[0]), float(leg[1]))
        self.step = float(step)
        self.start = sp.point(rng)
        self.points = [self.start]
        self.lengths = [0.0]          # path length at each waypoint

    def _extend(self) -> None:
        cur = self.points[-1]
        for _ in range(LEG_TRIES):
            a = self.rng.uniform(0.0, 2.0 * math.pi)
            r = self.rng.uniform(*self.leg)
            nxt = (cur[0] + r * math.cos(a), cur[1] + r * math.sin(a))
            if (math.dist(nxt, self.start) <= self.radius
                    and self.sp.clear(cur, nxt)):
                break
        else:
            # boxed in: walk back along the last leg
            nxt = self.points[-2] if len(self.points) > 1 else cur
        self.points.append((float(nxt[0]), float(nxt[1])))
        self.lengths.append(self.lengths[-1] + math.dist(cur, nxt))

    def reach(self, i: int) -> None:
        """Extend the path as far as refresh ``i``."""
        s = i * self.step
        while self.lengths[-1] < s or len(self.points) < 2:
            self._extend()

    def at(self, i: int) -> tuple[float, float]:
        """(x, z) at refresh ``i``."""
        self.reach(i)
        s = i * self.step
        k = bisect.bisect_right(self.lengths, s) - 1
        k = min(k, len(self.points) - 2)
        seg = self.lengths[k + 1] - self.lengths[k]
        f = 0.0 if seg == 0.0 else (s - self.lengths[k]) / seg
        (x0, z0), (x1, z1) = self.points[k], self.points[k + 1]
        return (x0 + (x1 - x0) * f, z0 + (z1 - z0) * f)


@dataclasses.dataclass
class Traffic:
    """What a run sends: ``listeners(i)`` and ``door(i)`` at refresh i, the
    static ``emitters``, and the static ``boxes`` the door box follows in
    paint order."""
    walks: list
    emitters: list
    boxes: list
    height: float
    door_way: dict | None = None
    door_positions: int = 0
    door_phase: int = 0
    door_thickness: float = 0.0
    audio: dict | None = None
    clips: list | None = None

    def reach(self, i: int) -> None:
        """Lay out every walk as far as refresh ``i``, so that reading a
        refresh up to there only interpolates."""
        for w in self.walks:
            w.reach(i)

    def listeners(self, i: int) -> list[tuple[float, float]]:
        return [w.at(i) for w in self.walks]

    def door(self, i: int):
        """The door box [x, y, w, h, R] at refresh ``i``, or None."""
        if self.door_way is None:
            return None
        d = self.door_way
        (x0, x1), width = d["x"], d["x"][1] - d["x"][0]
        k = (self.door_phase + i) % self.door_positions
        shift = d["slide"] * width * k / (self.door_positions - 1)
        return [(x0 + x1) / 2 + shift, d["y"], width, self.door_thickness,
                d["absorption"]]

    def boxes_at(self, i: int) -> list:
        """Every box of refresh ``i`` in paint order: the scene's, then the
        door."""
        door = self.door(i)
        return self.boxes + ([door] if door is not None else [])


def make(grid, scene: dict, params: dict, seed: int) -> Traffic:
    """The traffic of one run: ``grid`` a ``reference.Grid``, ``scene`` from
    :func:`scenes.load`, ``params`` a traffic file's contents."""
    door = params.get("door")
    if door is not None and not scene["doorways"]:
        raise ValueError(f"traffic moves a door but scene {scene['name']} "
                         f"has no doorway")
    sp = space(grid, scene, float(params["clearance_m"]), door is not None)
    step = float(params["speed_m_s"]) * float(params["refresh_period_s"])
    walks = [Walk(sp, np.random.default_rng([seed, _LISTENERS + k]),
                  params["walk_radius_m"], params["leg_m"], step)
             for k in range(int(params["listeners"]))]
    rng = np.random.default_rng([seed, _EMITTERS])
    emitters = [sp.point(rng, walks[0].start, params["emitter_radius_m"])
                for _ in range(int(params["emitters"]))]
    t = Traffic(walks, emitters, [list(b) for b in scene["boxes"]],
                float(params["height_m"]))
    if door is not None:
        rng = np.random.default_rng([seed, _DOOR])
        t.door_way = scene["doorways"][int(rng.integers(len(
            scene["doorways"])))]
        t.door_positions = int(door["positions"])
        t.door_phase = int(rng.integers(t.door_positions))
        t.door_thickness = float(door["thickness_m"])
    if "audio" in params:
        t.audio = dict(params["audio"])
        t.clips = clips(t.audio, seed)
    return t


def clips(audio: dict, seed: int) -> list:
    """The voices' clips, [frames, 2] float32 each, from the clips' own
    stream: a length drawn from ``clip_s``, then white noise uniform within
    ``clip_dbfs`` of full scale."""
    rng = np.random.default_rng([seed, _CLIPS])
    rate = int(audio["rate_hz"])
    peak = 10.0 ** (float(audio["clip_dbfs"]) / 20.0)
    out = []
    for _ in range(int(audio["voices"])):
        n = int(round(rng.uniform(*audio["clip_s"]) * rate))
        out.append(rng.uniform(-peak, peak, (n, 2)).astype(np.float32))
    return out
