"""Plain PyTorch decode attention: the reference for kernel K1.

Counterpart of ``llmvox_tpu/ops/attention.py::decode_attention``.  The CPU
path of the decoder runs it, and the card compares the CUDA kernel
(``ops/cuda_attn.py``) against it.  It masks the full cache rather than
slicing ``[0, pos]`` so it never reads ``pos`` on the host.
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
