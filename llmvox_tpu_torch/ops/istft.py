"""Inverse STFT with "same" padding, and the inverse MDCT.

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

from llmvox_tpu_torch.ops.nn import valid_mask, wide

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


def np_dtype(dtype: torch.dtype):
    """numpy's f32 or f64 for torch's."""
    return np.float64 if dtype == torch.float64 else np.float32


def device_window(win_length: int, device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The periodic Hann window (its f32 values) as a ``dtype`` tensor on
    ``device``, cached per (length, device, dtype)."""
    key = (win_length, torch.device(device), dtype)
    with _windows_lock:
        w = _windows.get(key)
        if w is None:
            w = _windows[key] = torch.from_numpy(hann_window(
                win_length).astype(np_dtype(dtype))).to(key[1])
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


def cosine_window(n: int) -> np.ndarray:
    """scipy.signal.windows.cosine: sin(pi * (k + 0.5) / n)."""
    k = np.arange(n)
    return np.sin(np.pi * (k + 0.5) / n).astype(np.float32)


def imdct(x: torch.Tensor, *, frame_len: int,
          padding: str = "same") -> torch.Tensor:
    """Inverse MDCT (reference decoder/spectral_ops.py:133-192), as
    ``llmvox_tpu/ops/istft.py::imdct``: (B, L, N) MDCT coefficients, N =
    frame_len // 2 -> (B, T) waveform; "same" keeps hop * L samples (hop
    = N), "center" trims N a side.  Complex64 (complex128 for f64)."""
    b, l, n = x.shape
    assert n == frame_len // 2
    cdtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    n0 = (n + 1) / 2.0
    k2 = np.arange(2 * n)
    npc = np.complex128 if cdtype == torch.complex128 else np.complex64
    pre = torch.from_numpy(np.exp(1j * np.pi * n0 * k2 / n).astype(npc))
    post = torch.from_numpy(
        np.exp(1j * np.pi * (k2 + n0) / (2 * n)).astype(npc))
    xc = x.to(cdtype)
    y_full = torch.cat([xc, -torch.conj(torch.flip(xc, dims=(-1,)))], dim=-1)
    y = torch.fft.ifft(y_full * pre.to(x.device), dim=-1)
    y = torch.real(y * post.to(x.device)) * np.sqrt(n) * np.sqrt(2.0)
    window = torch.from_numpy(cosine_window(frame_len).astype(
        np_dtype(y.dtype))).to(x.device)
    audio = _overlap_add(y * window, frame_len // 2)
    pad = frame_len // 2 if padding == "center" else frame_len // 4
    return audio[:, pad:-pad]


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
    frames = wide(torch.fft.irfft(spec, n=n_fft, dim=-1))
    window = device_window(win, spec.device, frames.dtype)
    frames = frames * window
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
