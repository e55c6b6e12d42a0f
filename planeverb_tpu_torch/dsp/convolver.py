"""Convolution engine: auralize simulated or synthetic impulse responses.

The reference ships only dead stubs here: ``Convolver::operator()`` returns
nullptr and the enveloped-noise ``ImpulseResponse`` is allocated but never
used (reference PlaneverbDSP/src/DSP/Convolver.h:30-33,
ImpulseResponse.cpp:13-26, PvDSPContext.cpp:110-111 "not currently
supported"). This module implements the intended capability for real:

  - :func:`synthetic_ir`: the reference's enveloped-noise IR law
    ``noise * exp(-t * 6.91 / rt60)`` (6.91 = ln(1000) => -60 dB at rt60),
    actually usable.
  - :func:`resample_ir`: band-limited-ish linear resampling of the
    simulation-rate IR (fs = 1443-3937 Hz) up to audio rate.
  - :func:`convolve_offline`: one-shot FFT convolution.
  - :class:`PartitionedConvolver`: uniformly partitioned overlap-save
    convolution with a frequency-domain delay line — streaming blocks with
    state, the standard real-time convolution-reverb structure.

Both run on NumPy arrays by default; with ``xp=torch`` they take tensors of
any device and transform with ``torch.fft`` (cuFFT on a card).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["synthetic_ir", "resample_ir", "convolve_offline",
           "PartitionedConvolver"]


def synthetic_ir(rt60: float, fs: int, seconds: float | None = None,
                 seed: int = 0) -> np.ndarray:
    """Enveloped-noise IR (ImpulseResponse.cpp:13-26, working version)."""
    if seconds is None:
        seconds = max(float(rt60), 0.1) * 1.2
    n = max(int(seconds * fs), 1)
    rng = np.random.default_rng(seed)
    noise = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    t = np.arange(n, dtype=np.float32)
    env = np.exp(-t * np.float32(6.91 / (max(rt60, 1e-3) * fs)))
    return noise * env


def resample_ir(ir: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Linear resampling of an IR to a new rate, preserving duration and
    per-impulse energy (amplitude scaled by sqrt(fs_in/fs_out))."""
    ir = np.asarray(ir, np.float32)
    n_out = max(int(round(len(ir) * fs_out / fs_in)), 1)
    t_out = np.arange(n_out, dtype=np.float64) * (fs_in / fs_out)
    out = np.interp(t_out, np.arange(len(ir)), ir).astype(np.float32)
    return out * np.float32(np.sqrt(fs_in / fs_out))


def convolve_offline(audio, ir, xp=None):
    """Full linear convolution via FFT; returns len(audio)+len(ir)-1 samples.

    Works on numpy arrays by default; pass ``xp=torch`` to run on the
    device of a tensor ``audio`` (the CPU for an array).
    Multichannel audio [N, C] convolves each channel with the same IR.
    """
    if xp is torch:
        return _convolve_offline_torch(audio, ir)
    if xp is None:
        xp = np
    audio = xp.asarray(audio, dtype=xp.float32)
    ir = xp.asarray(ir, dtype=xp.float32)
    n = audio.shape[0] + ir.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    multi = audio.ndim == 2
    a = xp.fft.rfft(audio, nfft, axis=0)
    b = xp.fft.rfft(ir, nfft)
    if multi:
        b = b[:, None]
    y = xp.fft.irfft(a * b, nfft, axis=0)[:n]
    return y.astype(xp.float32)


def _convolve_offline_torch(audio, ir):
    audio = torch.as_tensor(audio, dtype=torch.float32)
    ir = torch.as_tensor(ir, dtype=torch.float32).to(audio.device)
    n = audio.shape[0] + ir.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    a = torch.fft.rfft(audio, nfft, dim=0)
    b = torch.fft.rfft(ir, nfft)
    if audio.dim() == 2:
        b = b[:, None]
    return torch.fft.irfft(a * b, nfft, dim=0)[:n]


class PartitionedConvolver:
    """Uniformly partitioned overlap-save convolver (streaming).

    The IR is split into P chunks of the block size L; each incoming block
    contributes one new input spectrum to a frequency-domain delay line, and
    the output block is IFFT(sum_p FDL[p] * H[p]). Deterministic streaming:
    concatenated block outputs equal offline convolution (pinned in tests).
    With ``xp=torch`` the state lives on ``device`` (default "cuda") and
    ``process`` takes and returns tensors there.
    """

    def __init__(self, ir: np.ndarray, block: int, xp=None, device=None):
        self.xp = xp if xp is not None else np
        self.block = block
        ir = np.asarray(ir, np.float32)
        p = max(1, -(-len(ir) // block))
        padded = np.zeros(p * block, np.float32)
        padded[:len(ir)] = ir
        parts = padded.reshape(p, block)
        nfft = 2 * block
        self.nfft = nfft
        self.p = p
        self.h = self.xp.asarray(
            np.fft.rfft(parts, nfft, axis=1).astype(np.complex64))
        self._fdl = self.xp.zeros((p, nfft // 2 + 1), dtype=self.xp.complex64)
        self._prev = self.xp.zeros(block, dtype=self.xp.float32)
        if self.xp is torch:
            self.device = torch.device("cuda" if device is None else device)
            self.h, self._fdl, self._prev = (
                t.to(self.device) for t in (self.h, self._fdl, self._prev))

    def _process_torch(self, x):
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape[0] != self.block:
            x = torch.nn.functional.pad(x, (0, self.block - x.shape[0]))
        spec = torch.fft.rfft(torch.cat([self._prev, x]))
        self._fdl = torch.cat([spec[None], self._fdl[:-1]], dim=0)
        acc = torch.sum(self._fdl * self.h, dim=0)
        self._prev = x
        return torch.fft.irfft(acc, self.nfft)[self.block:]

    def process(self, x):
        """Convolve one [L] block; returns the next [L] output samples."""
        if self.xp is torch:
            return self._process_torch(x)
        xp = self.xp
        x = xp.asarray(x, dtype=xp.float32)
        if x.shape[0] != self.block:
            pad = self.block - x.shape[0]
            x = xp.concatenate([x, xp.zeros(pad, xp.float32)])
        seg = xp.concatenate([self._prev, x])           # overlap-save input
        spec = xp.fft.rfft(seg)
        # shift the delay line, newest first
        self._fdl = xp.concatenate([spec[None], self._fdl[:-1]], axis=0)
        acc = xp.sum(self._fdl * self.h, axis=0)
        y = xp.fft.irfft(acc, self.nfft)[self.block:]   # valid half
        self._prev = x
        return y
