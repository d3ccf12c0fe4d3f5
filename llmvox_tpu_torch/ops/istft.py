"""Inverse STFT with "same" padding.

Counterpart of ``llmvox_tpu/ops/istft.py::istft_same``: irfft per frame,
Hann window, overlap-add, window-envelope normalisation, then trimming
``(win - hop) // 2`` samples per side so the output is ``hop * T``
samples.  Overlap-add uses the ratio ``r = win // hop``: each frame is cut
into r hop-sized segments that are summed with r shifted adds.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.ops.nn import valid_mask

# Hann windows on their devices, made once: a copy from pageable host
# memory per call would sync the stream (every synthesis would wait for
# the decode work queued before it), and a CUDA graph cannot capture it.
_windows: Dict[Tuple[int, torch.device], torch.Tensor] = {}
_windows_lock = threading.Lock()


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window: 0.5 * (1 - cos(2 pi n / N))."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(
        np.float32)


def device_window(win_length: int, device) -> torch.Tensor:
    """The periodic Hann window as a tensor on ``device``, cached per
    (length, device)."""
    key = (win_length, torch.device(device))
    with _windows_lock:
        w = _windows.get(key)
        if w is None:
            w = _windows[key] = torch.from_numpy(
                hann_window(win_length)).to(key[1])
        return w


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of (B, T, win) frames -> (B, (T-1)*hop + win) samples."""
    b, t, win = frames.shape
    r = win // hop
    assert r * hop == win, "win_length must be a multiple of hop_length"
    segs = frames.reshape(b, t, r, hop)
    out = frames.new_zeros(b, t + r - 1, hop)
    for j in range(r):
        out[:, j:j + t] += segs[:, :, j]
    return out.reshape(b, (t + r - 1) * hop)


def istft_same(spec: torch.Tensor, *, n_fft: int, hop_length: int,
               valid_len=None) -> torch.Tensor:
    """Complex spectrogram (B, T, n_fft//2 + 1) -> (B, hop*T) waveform.

    With ``valid_len`` (int, 0-d or per-batch tensor), frames at index >=
    valid_len are absent from both the signal's overlap-add and the window
    envelope, so samples [0, hop*valid_len) equal an exact-length call;
    later samples are meaningless and the caller trims them.
    """
    win = n_fft
    pad = (win - hop_length) // 2
    b, t, nbins = spec.shape
    assert nbins == n_fft // 2 + 1
    window = device_window(win, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1).float() * window
    env_frames = window.square().expand(1, t, win)
    if valid_len is not None:
        fmask = valid_mask(t, valid_len, spec.device)[:, :, None]
        frames = frames * fmask
        env_frames = env_frames * fmask
    y = _overlap_add(frames, hop_length)[:, pad:-pad]
    envelope = _overlap_add(env_frames.contiguous(), hop_length)[:, pad:-pad]
    # with Hann at 4x overlap the interior envelope is strictly positive;
    # the clamp guards only masked tail samples, which are trimmed
    return y / envelope.clamp_min(1e-11)
