"""Codebook lookup: speech codes -> codec input features.

Counterpart of ``llmvox_tpu/codec/vq.py::codes_to_features``: embed each
code in each quantizer's codebook and sum over quantizers (the deployed
codec has one quantizer, so this is one embedding lookup).
"""
from __future__ import annotations

import torch


def codes_to_features(codebooks: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
    """(n_q, bins, dim) codebooks, (B, L) or (n_q, B, L) integer codes ->
    (B, L, dim) channel-last features."""
    if codes.dim() == 2:
        codes = codes[None]
    codes = codes.long()
    feats = codebooks[0][codes[0]]
    for q in range(1, codebooks.shape[0]):
        feats = feats + codebooks[q][codes[q]]
    return feats
