"""STFT with torch.stft's conventions, and mel spectrograms.

Counterpart of ``_frame``, ``stft``, ``mel_filterbank`` and
``mel_spectrogram_features`` (its centered form) in
``llmvox_tpu/codec/mel.py``.  Whisper's log-mel frontend
(``models/whisper.py::log_mel``) uses the STFT: reflect padding of
``n_fft // 2`` on both sides when ``center``, sliding frames, the periodic
Hann window, and ``torch.fft.rfft`` over each frame.  The JAX side is XLA
there, not a Pallas kernel.  The window comes from
``ops/istft.py::device_window``, made once per device, so a CUDA graph can
capture the STFT.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.ops.istft import device_window


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
        frames = frames * device_window(win_length, x.device)
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


def mel_spectrogram_features(audio: torch.Tensor, *,
                             sample_rate: int = 24000, n_fft: int = 1024,
                             hop_length: int = 256,
                             n_mels: int = 100) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames): the log (clipped at 1e-7) of the
    magnitude mel spectrogram with a centered Hann STFT."""
    spec = stft(audio, n_fft=n_fft, hop_length=hop_length).abs()
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(
        spec.device)
    mel = torch.einsum("btf,fm->bmt", spec, fb)
    return torch.log(mel.clamp_min(1e-7))
