"""Host-side audio I/O and resampling, dependency-light.

A copy of ``llmvox_tpu/utils/audio.py`` (the port imports nothing of the
JAX package): WAV files go through the stdlib ``wave`` module and
resampling through scipy's polyphase filter.  These run on the host CPU,
as data preparation, never on the device path.
"""
from __future__ import annotations

import math
import wave
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples (channels, T), sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch).T, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float32 (T,) or (1, T) samples as 16-bit PCM (the reference
    saves PCM16 too, encoder/utils.py:102)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def convert_audio(wav: np.ndarray, sr: int, target_sr: int,
                  target_channels: int = 1) -> np.ndarray:
    """Mono-ize + resample (reference encoder/utils.py:78-91)."""
    if wav.ndim == 1:
        wav = wav[None]
    if target_channels == 1 and wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    if sr != target_sr:
        g = math.gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g, axis=-1)
    return wav.astype(np.float32)


def float32_bytes(wav: np.ndarray) -> bytes:
    """The streaming wire format: raw little-endian float32 samples
    (streaming_server.py:368, client/endpoints.py:9)."""
    return np.asarray(wav, dtype="<f4").tobytes()
