"""Codebook lookup: speech codes -> codec input features.

Counterpart of ``llmvox_tpu/codec/vq.py``: ``codes_to_features`` embeds
each code in each quantizer's codebook and sums over quantizers (the
deployed codec has one quantizer, so this is one embedding lookup);
``nearest_code`` is the encoder side's assignment.
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


def nearest_code(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(bins, dim) codebook, (..., dim) vectors -> (...,) int32 codes: the
    argmax of -(||x||^2 - 2 x.e + ||e||^2), ties to the first index."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    e2 = codebook.square().sum(dim=-1)
    xe = torch.einsum("...d,bd->...b", x, codebook)
    return torch.argmax(-(x2 - 2.0 * xe + e2), dim=-1).int()
