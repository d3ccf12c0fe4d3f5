"""STFT with torch.stft's conventions, and mel spectrograms.

Counterpart of ``llmvox_tpu/codec/mel.py``: ``_frame``, ``stft``,
``spectrogram``, ``mel_filterbank``, ``mel_spectrogram``, ``safe_log`` and
``mel_spectrogram_features`` (centered, or reflect-padded by ``n_fft -
hop`` first with ``padding="same"``).  The codec's training losses take
the magnitude mel spectrogram, the discriminators the rectangular-window
STFT.  Whisper's log-mel frontend
(``models/whisper.py::log_mel``) uses the STFT: reflect padding of
``n_fft // 2`` on both sides when ``center``, sliding frames, the periodic
Hann window, and ``torch.fft.rfft`` over each frame.  The JAX side is XLA
there, not a Pallas kernel.  The window comes from
``ops/istft.py::device_window``, made once per device, so a CUDA graph can
capture the STFT.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.ops.istft import device_window, np_dtype
from llmvox_tpu_torch.ops.nn import wide_dtype


def _frame(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, 1 + (T - win) // hop, win) sliding frames (a view)."""
    return x.unfold(-1, win, hop)


def stft(x: torch.Tensor, *, n_fft: int, hop_length: int,
         win_length: int = None, windowed: bool = True,
         center: bool = True) -> torch.Tensor:
    """STFT of (B, T) -> complex (B, n_frames, n_fft // 2 + 1).

    ``center`` reflect-pads ``n_fft // 2`` on both sides; ``windowed=False``
    is torch's ``window=None`` (rectangular); a ``win_length`` below
    ``n_fft`` is zero-padded to ``n_fft`` on both sides of each frame."""
    win_length = win_length or n_fft
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = _frame(x, win_length, hop_length)
    if windowed:
        frames = frames * device_window(win_length, x.device,
                                        wide_dtype(x.dtype))
    if win_length < n_fft:
        pad = n_fft - win_length
        frames = F.pad(frames, (pad // 2, pad - pad // 2))
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   f_min: float = 0.0, f_max: float = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank, torchaudio's
    ``melscale_fbanks(norm=None, mel_scale='htk')``."""
    f_max = f_max or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


# filterbanks on their devices, made once (a pageable host copy per call
# would sync the stream at every loss)
_filterbanks: Dict[Tuple, torch.Tensor] = {}
_filterbanks_lock = threading.Lock()


def device_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                      device, dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    key = (sample_rate, n_fft, n_mels, torch.device(device), dtype)
    with _filterbanks_lock:
        fb = _filterbanks.get(key)
        if fb is None:
            fb = _filterbanks[key] = torch.from_numpy(mel_filterbank(
                sample_rate, n_fft, n_mels).astype(np_dtype(dtype))).to(
                    key[3])
        return fb


def spectrogram(x: torch.Tensor, *, n_fft: int, hop_length: int,
                win_length: int = None, windowed: bool = True,
                power: float = 1.0) -> torch.Tensor:
    """|STFT| (centered) of (B, T) -> (B, frames, bins), to ``power``."""
    mag = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
               windowed=windowed).abs()
    return mag if power == 1.0 else mag ** power


def mel_spectrogram(x: torch.Tensor, *, sample_rate: int = 24000,
                    n_fft: int = 1024, hop_length: int = 256,
                    n_mels: int = 100) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) magnitude mel spectrogram (power 1,
    the mel loss's transform)."""
    spec = spectrogram(x, n_fft=n_fft, hop_length=hop_length)
    fb = device_filterbank(sample_rate, n_fft, n_mels, spec.device,
                           wide_dtype(spec.dtype))
    return torch.einsum("btf,fm->bmt", spec, fb.to(spec.dtype))


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    return torch.log(x.clamp_min(clip_val))


def mel_spectrogram_features(audio: torch.Tensor, *,
                             sample_rate: int = 24000, n_fft: int = 1024,
                             hop_length: int = 256, n_mels: int = 100,
                             padding: str = "center") -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames): the safe log of the magnitude mel
    spectrogram.  ``padding="same"`` reflect-pads ``(n_fft - hop) // 2``
    a side before the (still centered) STFT, as JAX's function does."""
    if padding == "same":
        pad = (n_fft - hop_length) // 2
        audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    return safe_log(mel_spectrogram(audio, sample_rate=sample_rate,
                                    n_fft=n_fft, hop_length=hop_length,
                                    n_mels=n_mels))
