"""ISTFT vocoder head: Linear(768 -> n_fft + 2) predicts log-magnitude and
phase; S = min(exp(mag), 1e2) * e^(i phase); the "same"-padded ISTFT
gives hop_length * T samples.  Counterpart of
``llmvox_tpu/codec/heads.py::apply_istft_head``, and of its IMDCT heads."""
from __future__ import annotations

from typing import Dict

import torch

from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.ops.istft import imdct, istft_same
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


# ---------------------------------------------------------------------------
# IMDCT head variants (reference heads.py:70-157, the shipped alternatives
# to the deployed ISTFT head); their initialisers are
# ``utils/params.py::init_imdct_symexp_head`` / ``init_imdct_cos_head``
# ---------------------------------------------------------------------------

def apply_imdct_symexp_head(params: Dict, x: torch.Tensor,
                            mdct_frame_len: int,
                            clip_audio: bool = False) -> torch.Tensor:
    """IMDCTSymExpHead (heads.py:70-120): Linear -> symexp -> clip 1e2 ->
    IMDCT; (B, L, dim) -> (B, L * mdct_frame_len // 2)."""
    h = nn.wide(nn.linear(x, params["w"], params["b"]))
    h = torch.sign(h) * (torch.exp(h.abs()) - 1.0)        # symexp
    audio = imdct(h.clamp(-1e2, 1e2), frame_len=mdct_frame_len)
    return audio.clamp(-1.0, 1.0) if clip_audio else audio


def apply_imdct_cos_head(params: Dict, x: torch.Tensor, mdct_frame_len: int,
                         clip_audio: bool = False) -> torch.Tensor:
    """IMDCTCosHead (heads.py:123-157): Linear -> min(exp(m), 1e2) cos(p)
    -> IMDCT."""
    h = nn.wide(nn.linear(x, params["w"], params["b"]))
    m, p = h.chunk(2, dim=-1)
    audio = imdct(torch.exp(m).clamp(max=1e2) * torch.cos(p),
                  frame_len=mdct_frame_len)
    return audio.clamp(-1.0, 1.0) if clip_audio else audio
