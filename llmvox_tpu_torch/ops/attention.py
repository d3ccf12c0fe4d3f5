"""Plain PyTorch attention: the references for kernels K1, K2 and K3.

Counterparts of ``llmvox_tpu/ops/attention.py::decode_attention`` (K1),
``llmvox_tpu/models/decoder.py::_batched_decode_attention`` (K2) and
``llmvox_tpu/models/decoder.py::_batched_verify_attention`` (K3).  The CPU
path of the decoder runs them, and the card compares the CUDA kernels
(``ops/cuda_attn.py``, ``ops/cuda_batched_attn.py``,
``ops/cuda_verify_attn.py``) against them.  They mask the full cache
rather than slicing ``[0, pos]``, so they never read ``pos`` on the host.
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


def batched_verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor, *,
                             n_head: int) -> torch.Tensor:
    """Speculative verify attention: n queries for each of B streams, query
    j of stream b at position pos[b]+j over its cache rows
    [0..min(pos[b]+j, S-1)].  A query past the cache (pos[b]+j >= S) attends
    every row; no committed token depends on its output.

    Args:
      q: (B, n, C) the streams' queries, C = n_head * head_dim.
      k_cache, v_cache: (B, S, C) caches with rows pos[b]..pos[b]+n-1
        written (those below S).
      pos: (B,) integer tensor, each stream's first query position.
    Returns:
      (B, n, C) attention outputs in q's dtype; softmax and sums in f32.
    """
    b, n, c = q.shape
    s = k_cache.shape[1]
    h, d = n_head, c // n_head
    qh = q.float().reshape(b, n, h, d)
    kc = k_cache.float().reshape(b, s, h, d)
    vc = v_cache.float().reshape(b, s, h, d)
    logits = torch.einsum("bnhd,bshd->bnhs", qh, kc) * (1.0 / math.sqrt(d))
    idx = torch.arange(s, device=k_cache.device)
    last = pos[:, None] + torch.arange(n, device=pos.device)[None, :]
    logits = logits.masked_fill((idx > last[..., None])[:, :, None, :],
                                float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhs,bshd->bnhd", p, vc)
    return out.reshape(b, n, c).to(q.dtype)
