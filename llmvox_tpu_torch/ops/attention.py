"""Plain PyTorch decode attention: the references for kernels K1 and K2.

Counterparts of ``llmvox_tpu/ops/attention.py::decode_attention`` (K1)
and ``llmvox_tpu/models/decoder.py::_batched_decode_attention`` (K2).  The
CPU path of the decoder runs them, and the card compares the CUDA kernels
(``ops/cuda_attn.py``, ``ops/cuda_batched_attn.py``) against them.  They
mask the full cache rather than slicing ``[0, pos]``, so they never read
``pos`` on the host.
"""
from __future__ import annotations

import math

import torch


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     n_head: int) -> torch.Tensor:
    """One-token attention over cache rows [0..pos] inclusive.

    Args:
      q: (C,) the current token's query, C = n_head * head_dim.
      k_cache, v_cache: (S, C) caches with row ``pos`` already written.
      pos: 0-d integer tensor, the current position.
    Returns:
      (C,) attention output in q's dtype; softmax and sums in f32.
    """
    s, c = k_cache.shape
    h, d = n_head, c // n_head
    qh = q.float().reshape(h, d)
    kc = k_cache.float().reshape(s, h, d)
    vc = v_cache.float().reshape(s, h, d)
    logits = torch.einsum("hd,shd->hs", qh, kc) * (1.0 / math.sqrt(d))
    idx = torch.arange(s, device=k_cache.device)
    logits = logits.masked_fill((idx > pos)[None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("hs,shd->hd", p, vc)
    return out.reshape(c).to(q.dtype)


def batched_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor, *,
                             n_head: int) -> torch.Tensor:
    """One-token attention for B streams, row b over its cache rows
    [0..pos[b]] inclusive.

    Args:
      q: (B, C) the streams' queries, C = n_head * head_dim.
      k_cache, v_cache: (B, S, C) caches with each row ``pos[b]`` written.
      pos: (B,) integer tensor, each stream's current position.
    Returns:
      (B, C) attention outputs in q's dtype; softmax and sums in f32.
    """
    b, s, c = k_cache.shape
    h, d = n_head, c // n_head
    qh = q.float().reshape(b, h, d)
    kc = k_cache.float().reshape(b, s, h, d)
    vc = v_cache.float().reshape(b, s, h, d)
    logits = torch.einsum("bhd,bshd->bhs", qh, kc) * (1.0 / math.sqrt(d))
    idx = torch.arange(s, device=k_cache.device)
    logits = logits.masked_fill((idx[None, :] > pos[:, None])[:, None, :],
                                float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vc)
    return out.reshape(b, c).to(q.dtype)
