"""Sandbox front-end: the audio-frame loops (real-time playout, the
multi-source playback manager) and WAV I/O."""

from planeverb_tpu_torch.sandbox.wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
