"""WAV file I/O (AudioData analog, reference PlaneverbSandbox/Audio/AudioData.cpp).

Supports 8/16-bit PCM and 32-bit float, mono or stereo, like the reference
reader (AudioData.cpp:29-172); writes 16-bit PCM or 32-bit float.
Arrays are float32 in [-1, 1], shaped [frames] (mono) or [frames, channels].
"""

from __future__ import annotations

import struct
import wave

import numpy as np

__all__ = ["read_wav", "write_wav"]


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (samples [N] or [N, C] float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 1 and bits == 8:
        x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(data, "<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}-bit")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              float32: bool = False) -> None:
    """Write mono [N] or multichannel [N, C] float32 samples."""
    x = np.asarray(samples, np.float32)
    channels = 1 if x.ndim == 1 else x.shape[1]
    if float32:
        data = x.astype("<f4").tobytes()
        fmt, bits = 3, 32
        with open(path, "wb") as f:
            byte_rate = sample_rate * channels * 4
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels,
                                          sample_rate, byte_rate,
                                          channels * 4, bits))
            f.write(b"data" + struct.pack("<I", len(data)) + data)
        return
    pcm = np.clip(x, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
