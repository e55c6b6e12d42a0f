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

Where the traffic has ``audio``, an audio callback runs beside the loop on a
thread of its own (:class:`AudioPump`), as a game's audio thread does beside
the engine's background loop: deadline-paced blocks through the port's audio
manager, its native DSP and reverbs. The refresh loop is then an
:class:`AudioProgram`, which publishes its listener for the callback and
keeps every refresh's rows for the check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from benchmark import check

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
# blocks the audio pump renders on a throwaway DSP in set-up
WARM_BLOCKS = 8
# what the harness emits its voices with: forward, volume (dB), pattern
VOICE_FORWARD = (1.0, 0.0, 0.0)
VOICE_DB = 0.0
VOICE_PATTERN = 0


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
    # host clock at the end of the last traced refresh (None: no profiler)
    traced_until: float | None = None


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


class AudioProgram(Program):
    """The Program of a traffic with ``audio``: before each refresh it
    publishes its listener for the pump, as one tuple (x, z, forward x,
    forward z; forward along the walk's last step), and it keeps every
    refresh's start, end and the playing emitters' rows (warm-up
    included), for the check."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.voices = int(self.traffic.audio["voices"])
        for e, (x, z) in zip(self.eids[:self.voices], self.traffic.emitters):
            self.ctx.emissions.update(e, x, self.traffic.height, z,
                                      forward=VOICE_FORWARD,
                                      volume_db=VOICE_DB,
                                      pattern=VOICE_PATTERN)
        x, z = self.traffic.listeners(0)[0]
        self.listener = (x, z, 1.0, 0.0)
        self.starts: list = []
        self.ends: list = []
        self.rows: list = []

    def refresh(self, listeners, door) -> list:
        x, z = listeners[0]
        px, pz, fx, fz = self.listener
        step = math.hypot(x - px, z - pz)
        if step > 0.0:
            fx, fz = (x - px) / step, (z - pz) / step
        self.listener = (x, z, fx, fz)
        t0 = time.perf_counter()
        outs = super().refresh(listeners, door)
        t1 = time.perf_counter()
        self.starts.append(t0)
        self.ends.append(t1)
        self.rows.append(np.stack([check.output_row(o) for o in
                                   outs[0][:self.voices]]))
        return outs


class RecordingDSP:
    """A thin proxy around the pump's DSP context: it keeps what each block
    fed the DSP (the listener transform, each voice's parameter row) into
    arrays made in set-up, and passes every call on unchanged. ``block`` is
    the block being fed."""

    def __init__(self, dsp, slots: dict, blocks: int):
        self._dsp = dsp
        self._slots = slots                       # eid -> voice
        self.block = 0
        self.listener = np.zeros((blocks, 6), np.float32)
        self.rows = np.zeros((blocks, len(slots), 8), np.float32)
        self.fed = np.zeros((blocks, len(slots)), bool)
        self.update_emitter = dsp.update_emitter
        self.set_emitter_directivity_pattern = \
            dsp.set_emitter_directivity_pattern
        self.remove_emitter = dsp.remove_emitter
        self.get_output = dsp.get_output

    def set_listener_transform(self, position, forward) -> None:
        self.listener[self.block] = (*position, *forward)
        self._dsp.set_listener_transform(position, forward)

    def submit_source(self, eid, dsp_input, audio) -> None:
        v = self._slots.get(eid)
        if v is not None:
            self.rows[self.block, v] = check.output_row(dsp_input)
            self.fed[self.block, v] = True
        self._dsp.submit_source(eid, dsp_input, audio)


def _noop(*a, **k) -> None:
    return None


def proxy_ms(eids, row, blocks: int = 100) -> float:
    """The proxy's own cost a block, ms: a block's calls (the listener, one
    submission a voice) through a :class:`RecordingDSP` around a DSP that
    does nothing, less the same calls made on that DSP directly."""
    import types

    null = types.SimpleNamespace(
        set_listener_transform=_noop, submit_source=_noop,
        update_emitter=_noop, set_emitter_directivity_pattern=_noop,
        remove_emitter=_noop, get_output=_noop)
    proxy = RecordingDSP(null, {e: v for v, e in enumerate(eids)}, blocks)

    def run(dsp) -> float:
        t0 = time.perf_counter()
        for b in range(blocks):
            proxy.block = b
            dsp.set_listener_transform((0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
            for e in eids:
                dsp.submit_source(e, row, None)
        return time.perf_counter() - t0

    direct = run(null)
    return (run(proxy) - direct) * 1e3 / blocks


def _native(audio: dict):
    """The native renderer: ``NativeDSPContext`` and one ``NativeReverb``
    a wet bus, the port's defaults for a real-time callback."""
    from planeverb_tpu_torch import PlaneverbDSPConfig
    from planeverb_tpu_torch.native import NativeDSPContext, NativeReverb

    cfg = PlaneverbDSPConfig(
        max_callback_length=int(audio["frames"]),
        dsp_smoothing_factor=audio["smoothing"],
        sampling_rate=int(audio["rate_hz"]),
        use_spatialization=bool(audio["spatialization"]),
        wet_gain_ratio=float(audio["wet_gain_ratio"]))
    return (NativeDSPContext(cfg),
            [NativeReverb(rt, int(audio["rate_hz"]))
             for rt in audio["reverb_rt60_s"]])


# the renderers a traffic's ``audio.renderer`` names
RENDERERS = {"native": _native}


@dataclasses.dataclass
class AudioRecord:
    """What the pump's window gives, a row a block: its due, start and end
    (s on the host clock), the clip offsets each voice read from, and the
    mix it returned. What it fed the DSP is in the proxy."""
    due: np.ndarray
    start: np.ndarray
    end: np.ndarray
    offsets: np.ndarray
    mix: np.ndarray


class AudioPump:
    """The audio callback beside the refresh loop, built in set-up: the
    renderer of the traffic's ``audio``, the voices' clips looping, a few
    warm blocks on a throwaway renderer, and a thread that waits for the
    window. In the window, block i is due at the window's open plus i
    blocks of audio; the thread sleeps until then (a late block starts at
    once and none is skipped, as ``RealtimePlayer.run`` paces), sets the
    DSP's listener from the refresh loop's, and runs
    ``AudioSourceManager.process_block``. It renders the blocks due before
    the window's end, then ends."""

    def __init__(self, prog: AudioProgram, seconds: float):
        from planeverb_tpu_torch.native import load_library
        from planeverb_tpu_torch.sandbox.audio_manager import \
            AudioSourceManager

        audio = prog.traffic.audio
        self.prog = prog
        self.frames = int(audio["frames"])
        self.period = self.frames / int(audio["rate_hz"])
        self.blocks = int(math.ceil(seconds / self.period - 1e-9))
        voices = prog.voices
        eids = prog.eids[:voices]
        clips = prog.traffic.clips
        load_library()
        make = RENDERERS[audio["renderer"]]
        # first-call costs (the library, the renderer's and the clips'
        # first blocks) fall on a throwaway renderer, in set-up
        dsp, revs = make(audio)
        warm = AudioSourceManager(prog.ctx, dsp, revs)
        for e, clip in zip(eids, clips):
            warm.play(e, clip, loop=True)
        for _ in range(WARM_BLOCKS):
            warm.process_block(self.frames)
        dsp.close()
        for r in revs:
            r.close()
        self.proxy_ms = proxy_ms(eids, prog.ctx.get_output(eids[0]))
        self._native, self.reverbs = make(audio)
        self.dsp = RecordingDSP(self._native,
                                {e: v for v, e in enumerate(eids)},
                                self.blocks)
        self.manager = AudioSourceManager(prog.ctx, self.dsp, self.reverbs)
        self.sources = [self.manager._sources[self.manager.play(
            e, clip, loop=True)] for e, clip in zip(eids, clips)]
        n = self.blocks
        self.rec = AudioRecord(np.zeros(n), np.zeros(n), np.zeros(n),
                               np.zeros((n, voices), np.int64),
                               np.zeros((n, self.frames, 2), np.float32))
        self.error = None
        self._open = threading.Event()
        self._t_open = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="benchmark-audio")
        self._thread.start()

    def open(self, t_open: float) -> None:
        """Start the window's blocks, the first due at ``t_open``."""
        self._t_open = t_open
        self._open.set()

    def join(self) -> AudioRecord:
        """Wait for the last block (every block due in the window is then
        rendered); raise what the thread raised."""
        self._open.set()
        self._thread.join()
        if self.error is not None:
            raise self.error
        self._native.close()
        for r in self.reverbs:
            r.close()
        return self.rec

    def _run(self) -> None:
        try:
            self._open.wait()
            prog, rec, dsp, h = self.prog, self.rec, self.dsp, \
                self.prog.traffic.height
            t_open = self._t_open
            for b in range(self.blocks):
                due = t_open + b * self.period
                slack = due - time.perf_counter()
                if slack > 0.0:
                    time.sleep(slack)
                t0 = time.perf_counter()
                x, z, fx, fz = prog.listener
                dsp.block = b
                dsp.set_listener_transform((x, h, z), (fx, 0.0, fz))
                rec.offsets[b] = [s.read_index for s in self.sources]
                rec.mix[b] = self.manager.process_block(self.frames)
                t1 = time.perf_counter()
                rec.due[b], rec.start[b], rec.end[b] = due, t0, t1
        except BaseException as e:  # noqa: BLE001 - raised again in join
            self.error = e


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
               profile_first: int = 0, profiler=None,
               pump: AudioPump | None = None) -> Window:
    """Refresh after refresh for ``seconds``, the traffic continuing from
    the warm-up; each refresh's inputs are read before its clock starts.
    With a ``profiler`` (a started ``torch.profiler.profile``) the first
    ``profile_first`` refreshes are traced, then it is stopped. A ``pump``
    renders its blocks from the window's open and is joined at its close."""
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
    if pump is not None:
        pump.open(t_open)
    deadline = t_open + seconds
    traced_until = None
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
            traced_until = t1
            _sync(dev)
            profiler.stop()
            profiler = None
        if t1 >= deadline:
            break
    t_close = time.perf_counter()
    cpu_s = time.thread_time() - cpu_open
    if pump is not None:
        pump.join()
    if profiler is not None:
        traced_until = t1
        _sync(dev)
        profiler.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    last = prog.sample(first + k - 1, listeners, outs)
    if all(s["index"] != last["index"] for s in kept):
        kept.append(last)
    kept.sort(key=lambda s: s["index"])
    return Window(lat, ends, t_close - t_open, int(peak), kept, cpu_s,
                  traced_until)
