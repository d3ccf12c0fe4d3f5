"""Host audio helpers: resampling, PCM16 conversion, gain, a byte ring.

Counterpart of ``llmvox_tpu/utils/native.py`` on its numpy/scipy path.
The port loads no native library: resampling is scipy's polyphase filter
(as ``utils/audio.py`` resamples) and the ring is a bytearray.  JAX's
``resample_poly`` takes a Kaiser-sinc FIR from ``csrc/libllmvox_audio.so``
when that library is built, which differs from scipy's filter by up to
5e-3 in the interior of a signal; without it the two are equal.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly as _scipy_resample_poly


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase resampling by ``up / down`` (reduced by their gcd), f32."""
    g = math.gcd(up, down)
    x = np.ascontiguousarray(x, np.float32)
    return _scipy_resample_poly(x, up // g, down // g).astype(np.float32)


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    return (np.clip(x, -1.0, 1.0) * 32767.0).round().astype(np.int16)


def pcm16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.int16).astype(np.float32) / 32768.0


def gain_normalize(x: np.ndarray, gain_db: float) -> np.ndarray:
    """Scale so the peak sits at ``gain_db`` dBFS."""
    x = np.ascontiguousarray(x, np.float32)
    peak = np.max(np.abs(x)) + 1e-9
    return x * (10.0 ** (gain_db / 20.0) / peak)


class RingBuffer:
    """A bounded FIFO of bytes: ``write`` keeps what fits, ``read`` takes
    up to ``n`` bytes from the front."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        n = min(len(data), self.capacity - len(self._buf))
        self._buf.extend(data[:n])
        return n

    def read(self, n: int) -> bytes:
        got = min(n, len(self._buf))
        out = bytes(self._buf[:got])
        del self._buf[:got]
        return out

    def available(self) -> int:
        return len(self._buf)
