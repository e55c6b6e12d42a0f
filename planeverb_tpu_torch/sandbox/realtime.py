"""Real-time audio playout through the full Planeverb chain.

The reference sandbox plays audio live through PortAudio: a 44.1 kHz stereo
stream pulls 512-frame blocks from a callback that reads the engine's
current output, submits the source block to the DSP, and copies the dry bus
out (reference PlaneverbSandbox/src/Audio/AudioCore.cpp:28-42,90-185,
Util.h:6-10), with a "Use Planeverb" A/B bypass toggle
(AudioCore.cpp:98-143). This module is that loop re-imagined for a host
process without an audio device: a deadline-paced block pump with the same
callback budget (frames/rate per block) and the same chain:

  block i deadline = t0 + (i+1) * frames / rate
    1. read the engine's current output for the emitter  (GetOutput)
    2. submit the block to the DSP context               (SendSource)
    3. collect the four buses                            (GetOutput)
    4. mix dry + the three canonical reverbs             (PlaneverbReverb.cs)
    5. deliver the mix to the sink, sleep until the deadline

A block whose processing runs past its deadline is an underrun — the
real-time compliance metric a PortAudio callback would enforce by glitching.
``use_planeverb=False`` bypasses the chain (out = in * volume), the
reference's A/B toggle. The native C++ DSP path (planeverb_tpu_torch.native:
the renderer and the three reverbs, on the host) is the default; the
engine's step still runs on the Context's device. ``native=False`` runs the
streaming Python renderer (dsp/context.py) and then the reverbs' mix
(``dsp/reverb.py mix_output``) on the Context's device: on a card one D2
launch a block, on a CUDA stream of the player's own (high priority,
non-blocking), so a block's copies and D2 never queue behind the engine's
step, which a background loop enqueues on the default stream.

An audio *device* sink plugs in via the ``sink`` callable:
:class:`AudioDeviceSink` is the ready-made one (optional ``sounddevice`` /
PortAudio, import-guarded — this container has no output device, but a
desktop user hears the engine live through it).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

__all__ = ["RealtimePlayer", "PlayoutReport", "AudioDeviceSink"]

@dataclasses.dataclass
class PlayoutReport:
    """Result of one playout run (the measurement harness output)."""

    blocks: int
    frames: int
    rate: int
    budget_ms: float            # callback budget per block
    mean_process_ms: float
    max_process_ms: float
    underruns: int              # blocks whose processing missed the deadline
    realtime: bool              # whether pacing sleeps were applied
    wall_s: float
    duration_s: float           # audio duration delivered
    output: np.ndarray          # [N, 2] f32 final mix

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("output")
        return d


class RealtimePlayer:
    """Deadline-paced playout of one emitter's audio through engine + DSP.

    Args:
      ctx: live :class:`planeverb_tpu_torch.Context` (stepped or running in the
        background — the loop reads whatever output is current per block,
        like the reference callback does).
      eid: emission id of the playing source (its emit-time volume gain is
        applied, PlaneverbEmitter.cs:46).
      audio: [N] mono or [N, 2] stereo float source samples.
      rate: sample rate in Hz (reference: 44100, Util.h:6).
      frames: frames per block (reference: 512, Util.h:9).
      use_planeverb: False = A/B bypass (out = in * volume only).
      native: route through the C++ DSP + reverbs (NativeDSPContext/
        NativeReverb, on the host); False = Python streaming renderer +
        the reverbs on the Context's device.
      reverb: include the three canonical reverb tails in the mix.
      volume: extra linear gain on top of the emitter's volume_db.
      sink: optional callable(block_ndarray) invoked per processed block
        (an audio-device writer); blocks are also collected in the report.

    With ``native=False`` on a card (a Context on a CUDA device, reverb
    on) the player creates one stream, :attr:`stream`, with pinned staging
    buffers for the four buses' upload and the mix's download: each block
    copies, mixes and runs D2 there and waits on that stream alone (the
    wait's ms go to :attr:`copy_wait_ms`, a block each). The reverb states
    live on that stream for the player's life; a caller who hands them to
    ``mix_output`` on another stream must order the two streams first
    (``other.wait_stream(player.stream)``). On the CPU, and with the native
    DSP, the player creates no stream and touches no ``torch.cuda`` API.
    """

    def __init__(self, ctx, eid: int, audio: np.ndarray, rate: int,
                 frames: int = 512, use_planeverb: bool = True,
                 native: bool = True, reverb: bool = True,
                 volume: float = 1.0, sink=None):
        from planeverb_tpu_torch.config import PlaneverbDSPConfig

        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = np.stack([audio, audio], axis=-1)
        self.ctx = ctx
        self.eid = eid
        self.audio = audio
        self.rate = int(rate)
        self.frames = int(frames)
        self.use_planeverb = use_planeverb
        self.reverb = reverb
        self.volume = float(volume)
        self.sink = sink
        self._native = native
        cfg = PlaneverbDSPConfig(max_callback_length=self.frames,
                                 sampling_rate=self.rate)
        self.stream = None
        self.copy_wait_ms: list[float] = []
        if native:
            from planeverb_tpu_torch.native import (NativeDSPContext,
                                                    NativeReverb)

            self.dsp = NativeDSPContext(cfg)
            self._reverbs = [NativeReverb(rt60, self.rate)
                             for rt60 in _canonical_rt60s()] if reverb else []
            return
        from planeverb_tpu_torch.dsp import DSPContext

        self.dsp = DSPContext(cfg)
        self._reverbs = None
        self._mix_states = {}
        dev = torch.device(ctx.device)
        if reverb and dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev, priority=-1)
            self._up = torch.empty(4 * self.frames * 2, dtype=torch.float32,
                                   pin_memory=True)
            self._down = torch.empty(self.frames * 2, dtype=torch.float32,
                                     pin_memory=True)

    # ------------------------------------------------------------ one block
    def process_block(self, block: np.ndarray) -> np.ndarray:
        """The callback body (AudioCore::ProcessBlock analog): one [m, 2]
        block in, the audible [m, 2] mix out."""
        em = self.ctx.emissions.get_emission(self.eid)
        gain = self.volume * (em.volume_gain if em is not None else 1.0)
        if not self.use_planeverb or em is None:
            # A/B bypass: dryGain forced to 1 (AudioCore.cpp:98-101)
            return block * np.float32(gain)

        synced = self.ctx.sync_dsp(self.dsp)
        if self.eid not in synced:
            # the emission ended between the snapshot reads (live context on
            # another thread) — fall back to the bypass path for this block
            return block * np.float32(gain)
        out, _ = synced[self.eid]
        self.dsp.submit_source(self.eid, out, block * np.float32(gain))
        dry, wa, wb, wc = self.dsp.get_output()
        m = len(block)
        mix = np.array(dry[:m], np.float32, copy=True)
        if not self.reverb:
            return mix
        if self._reverbs is not None:
            for rev, bus in zip(self._reverbs, (wa, wb, wc)):
                rev.process_add(np.asarray(bus[:m], np.float32), mix)
            return mix
        from planeverb_tpu_torch.dsp.reverb import mix_output

        if self.stream is None:
            # the four buses in one copy to the device
            buses = torch.from_numpy(np.stack([dry[:m], wa[:m], wb[:m],
                                               wc[:m]])).to(self.ctx.device)
            mixed, self._mix_states = mix_output(
                *buses, self.rate, states=self._mix_states)
            return mixed.cpu().numpy()
        # the four buses staged channel-major in pinned memory ([4, 2, m]:
        # each channel a row, as D2 takes it, so mix_output copies nothing
        # to transpose) and copied up, mixed and copied down on the
        # player's stream; the last block's copies ended with its wait, so
        # the staging buffers are free
        up = self._up[:8 * m].view(4, 2, m)
        np.stack([dry[:m].T, wa[:m].T, wb[:m].T, wc[:m].T], out=up.numpy())
        down = self._down[:2 * m].view(2, m)
        with torch.cuda.stream(self.stream):
            buses = up.to(self.ctx.device, non_blocking=True)
            mixed, self._mix_states = mix_output(
                *(b.T for b in buses), self.rate, states=self._mix_states)
            down.copy_(mixed.T, non_blocking=True)
        t0 = time.perf_counter()
        self.stream.synchronize()
        self.copy_wait_ms.append((time.perf_counter() - t0) * 1e3)
        return down.numpy().T.copy()

    # ------------------------------------------------------------- the pump
    def run(self, realtime: bool = True) -> PlayoutReport:
        """Play the whole clip. ``realtime=True`` paces blocks against their
        deadlines (sleeping in the slack); False measures processing cost
        only (the budget-compliance harness mode)."""
        n = len(self.audio)
        budget = self.frames / self.rate
        chunks: list[np.ndarray] = []
        proc_times: list[float] = []
        underruns = 0
        t0 = time.perf_counter()
        for i, start in enumerate(range(0, n, self.frames)):
            block = self.audio[start:start + self.frames]
            bt = time.perf_counter()
            mixed = self.process_block(block)
            pt = time.perf_counter() - bt
            proc_times.append(pt)
            if self.sink is not None:
                self.sink(mixed)
            chunks.append(mixed)
            deadline = t0 + (i + 1) * budget
            slack = deadline - time.perf_counter()
            if slack < 0:
                underruns += 1
            elif realtime:
                time.sleep(slack)
        wall = time.perf_counter() - t0
        out = np.concatenate(chunks, axis=0) if chunks \
            else np.zeros((0, 2), np.float32)
        return PlayoutReport(
            blocks=len(chunks), frames=self.frames, rate=self.rate,
            budget_ms=budget * 1e3,
            mean_process_ms=float(np.mean(proc_times) * 1e3) if proc_times
            else 0.0,
            max_process_ms=float(np.max(proc_times) * 1e3) if proc_times
            else 0.0,
            underruns=underruns, realtime=realtime, wall_s=wall,
            duration_s=n / self.rate, output=out)

    def close(self) -> None:
        """Release the native renderer's and reverbs' handles (the Python
        renderer holds none; its stream and staging buffers go with the
        player)."""
        if self._native:
            self.dsp.close()
            for rev in self._reverbs:
                rev.close()


def _canonical_rt60s():
    from planeverb_tpu_torch.dsp.gains import T_ER_1, T_ER_2, T_ER_3

    return (T_ER_1, T_ER_2, T_ER_3)


class AudioDeviceSink:
    """Live audio-device sink for :class:`RealtimePlayer` — the reference
    sandbox's PortAudio output stream (AudioCore.cpp:28-42: 44.1 kHz stereo,
    512-frame blocks) as an optional, import-guarded plug-in.

    Requires the optional ``sounddevice`` package (PortAudio bindings — the
    exact library the reference streams through). It is not bundled: this
    container has no audio device, so construction raises a clear
    RuntimeError here; on a desktop with ``pip install sounddevice`` this is
    how you actually *hear* the engine::

        with AudioDeviceSink(rate=44100, frames=512) as sink:
            RealtimePlayer(ctx, eid, clip, 44100, sink=sink).run()
    """

    def __init__(self, rate: int = 44100, channels: int = 2,
                 frames: int = 512, device=None):
        try:
            import sounddevice
        except ImportError as e:
            raise RuntimeError(
                "AudioDeviceSink needs the optional 'sounddevice' package "
                "(PortAudio bindings): pip install sounddevice") from e
        self._stream = sounddevice.OutputStream(
            samplerate=rate, channels=channels, blocksize=frames,
            dtype="float32", device=device)
        self._stream.start()

    def __call__(self, block: np.ndarray) -> None:
        """Per-block writer (RealtimePlayer's ``sink`` contract): blocks
        until the device consumed the block — the device clock then paces
        the pump exactly like the reference's blocking PortAudio write."""
        self._stream.write(np.ascontiguousarray(block, np.float32))

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()

    def __enter__(self) -> "AudioDeviceSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
