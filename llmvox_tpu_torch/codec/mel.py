"""STFT with torch.stft's conventions, for Whisper's log-mel frontend.

Counterpart of ``_frame`` and ``stft`` in ``llmvox_tpu/codec/mel.py``
(only what ``models/whisper.py::log_mel`` needs): reflect padding of
``n_fft // 2`` on both sides when ``center``, sliding frames, the periodic
Hann window, and ``torch.fft.rfft`` over each frame.  The JAX side is XLA
there, not a Pallas kernel.  The window comes from
``ops/istft.py::device_window``, made once per device, so a CUDA graph can
capture the STFT.
"""
from __future__ import annotations

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
