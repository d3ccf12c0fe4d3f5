"""Codec GAN losses.

Counterpart of ``llmvox_tpu/codec/losses.py``: the hinge discriminator
and generator losses and feature matching (vocos MPD / MRD), DAC's
least-squares losses and feature L1, and the L1 between safe-log mel
spectrograms (n_fft 1024, hop 256, 100 mels, power 1).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from llmvox_tpu_torch.codec.mel import mel_spectrogram, safe_log


def discriminator_loss(real_outputs: List[torch.Tensor],
                       gen_outputs: List[torch.Tensor]) -> torch.Tensor:
    """Hinge loss, summed over sub-discriminators."""
    loss = 0.0
    for dr, dg in zip(real_outputs, gen_outputs):
        loss = loss + (1.0 - dr).clamp_min(0.0).mean()
        loss = loss + (1.0 + dg).clamp_min(0.0).mean()
    return loss


def generator_loss(gen_outputs: List[torch.Tensor]) -> torch.Tensor:
    loss = 0.0
    for dg in gen_outputs:
        loss = loss + (1.0 - dg).clamp_min(0.0).mean()
    return loss


def feature_matching_loss(fmap_real: List[List[torch.Tensor]],
                          fmap_gen: List[List[torch.Tensor]]) -> torch.Tensor:
    """L1 summed over every feature map."""
    loss = 0.0
    for dr, dg in zip(fmap_real, fmap_gen):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss


def mel_loss(y_hat: torch.Tensor, y: torch.Tensor, *,
             sample_rate: int = 24000, n_fft: int = 1024,
             hop_length: int = 256, n_mels: int = 100) -> torch.Tensor:
    kw = dict(sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
              n_mels=n_mels)
    return (safe_log(mel_spectrogram(y, **kw)) -
            safe_log(mel_spectrogram(y_hat, **kw))).abs().mean()


def dac_discriminator_loss(d_fake: List[List[torch.Tensor]],
                           d_real: List[List[torch.Tensor]]) -> torch.Tensor:
    """Least squares on the score maps (the last map of each list)."""
    loss = 0.0
    for xf, xr in zip(d_fake, d_real):
        loss = loss + xf[-1].square().mean()
        loss = loss + (1.0 - xr[-1]).square().mean()
    return loss


def dac_generator_loss(d_fake: List[List[torch.Tensor]],
                       d_real: List[List[torch.Tensor]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(adversarial least squares, feature L1 over every map but the
    score)."""
    loss_g = 0.0
    for xf in d_fake:
        loss_g = loss_g + (1.0 - xf[-1]).square().mean()
    loss_feat = 0.0
    for df, dr in zip(d_fake, d_real):
        for j in range(len(df) - 1):
            loss_feat = loss_feat + (df[j] - dr[j]).abs().mean()
    return loss_g, loss_feat
