"""ISTFT vocoder head: Linear(768 -> n_fft + 2) predicts log-magnitude and
phase; S = min(exp(mag), 1e2) * e^(i phase); the "same"-padded ISTFT
gives hop_length * T samples.  Counterpart of
``llmvox_tpu/codec/heads.py::apply_istft_head``."""
from __future__ import annotations

from typing import Dict

import torch

from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.ops.istft import istft_same
from llmvox_tpu_torch.utils.config import CodecConfig


def apply_istft_head(params: Dict, x: torch.Tensor, cfg: CodecConfig,
                     valid_len=None) -> torch.Tensor:
    """(B, L, 768) hidden -> (B, hop_length * L) waveform."""
    h = nn.wide(nn.linear(x, params["w"], params["b"]))
    nbins = cfg.n_fft // 2 + 1
    mag = torch.exp(h[..., :nbins]).clamp(max=1e2)
    phase = h[..., nbins:]
    spec = torch.polar(mag, phase)
    return istft_same(spec, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                      valid_len=valid_len)
