"""Sandbox front-end: the headless CLI, the browser viewer, the audio-frame
loops (real-time playout, the multi-source playback manager), WAV I/O and
measurement sweeps (PlaneverbSandbox + WetDryDoorPlot analogs; see
cli.py)."""

from planeverb_tpu_torch.sandbox.sweep import SweepResult, door_sweep
from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav

__all__ = ["SweepResult", "door_sweep", "read_wav", "write_wav"]
