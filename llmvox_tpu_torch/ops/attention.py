"""Plain PyTorch attention: the references for kernels K1, K2 and K3, and
the full-sequence causal attention of training.

Counterparts of ``llmvox_tpu/ops/attention.py::decode_attention`` (K1),
``llmvox_tpu/models/decoder.py::_batched_decode_attention`` (K2) and
``llmvox_tpu/models/decoder.py::_batched_verify_attention`` (K3).  The CPU
path of the decoder runs them, and the card compares the CUDA kernels
(``ops/cuda_attn.py``, ``ops/cuda_batched_attn.py``,
``ops/cuda_verify_attn.py``) against them.  They mask the full cache
rather than slicing ``[0, pos]``, so they never read ``pos`` on the host.

``causal_attention``, ``flash_causal_attention`` and
``causal_attention_auto`` are the training forward's attention
(``llmvox_tpu/ops/attention.py:31-183``, lax code in the JAX package, not
a Pallas kernel): softmax in f32, and with packed ``segments`` a query
attends a key iff it is causal and in the same segment.  On CUDA tensors
``causal_attention_auto`` calls ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# the blockwise path's tiles, JAX's defaults
BLOCK_Q = 512
BLOCK_K = 1024


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


def segment_mask(t: int, segments: Optional[torch.Tensor], device
                 ) -> torch.Tensor:
    """(T, T) causal mask, or (B, 1, T, T) causal & same-segment mask.
    The diagonal is always kept, so no row is empty."""
    mask = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    if segments is None:
        return mask
    same = segments[:, :, None] == segments[:, None, :]
    return (mask[None] & same)[:, None]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     segments: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, H, D) q/k/v -> (B, T, H, D), causal, softmax in f32.

    ``segments`` (B, T): block-diagonal-causal masking for packed batches
    (``train/data.py::collate_packed``); ``mask`` (T, T) or (B, 1, T, T),
    True where a query attends a key, replaces both."""
    t, d = q.shape[1], q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if mask is None:
        mask = segment_mask(t, segments, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", w, v)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           segments: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Blockwise causal attention: the online softmax of
    ``causal_attention`` over (BLOCK_Q, BLOCK_K) tiles, visiting only the
    tiles on or below the diagonal.  T must divide by both tile sizes
    (or be below them).

    A query block whose keys so far are all masked (a segment that starts
    inside a later key tile) keeps a running max of -inf; it subtracts 0
    instead, so its partial sums stay exact zeros, as JAX's does."""
    b, t, h, d = q.shape
    block_q, block_k = min(BLOCK_Q, t), min(BLOCK_K, t)
    assert t % block_q == 0 and t % block_k == 0, (t, block_q, block_k)
    scale = 1.0 / math.sqrt(d)
    iq = torch.arange(block_q, device=q.device)[:, None]
    ik = torch.arange(block_k, device=q.device)[None, :]
    outs = []
    for qi in range(t // block_q):
        q0 = qi * block_q
        qb = q[:, q0:q0 + block_q].float()
        m = torch.full((b, h, block_q, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for ci in range((q0 + block_q - 1) // block_k + 1):
            k0 = ci * block_k
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k].float()
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            keep = (q0 + iq) >= (k0 + ik)
            if segments is not None:
                same = (segments[:, q0:q0 + block_q, None]
                        == segments[:, None, k0:k0 + block_k])
                keep = (keep[None] & same)[:, None]
            s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            m_sub = (torch.where(torch.isfinite(m_new), m_new, 0.0)
                     if segments is not None else m_new)
            p = torch.exp(s - m_sub)
            corr = torch.exp(m - m_sub)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            # p rounded to the input type, the products summed in f32
            acc = acc * corr + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vb)
            m = m_new
        outs.append((acc / l).to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=1)


def causal_attention_auto(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          segments: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The training forward's attention.  On CUDA tensors:
    ``scaled_dot_product_attention``, causal without segments and with the
    boolean causal & same-segment mask with them, no attention dropout;
    ``mask`` is that mask when the caller built it once for every layer
    (``segment_mask``), or any boolean (T, T) mask with a key in every
    row, on every device.  Elsewhere JAX's choice: the naive path for short
    sequences, blockwise tiles above 1024 positions when T divides by
    256."""
    t = q.shape[1]
    if q.is_cuda:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if segments is None and mask is None:
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        else:
            if mask is None:
                mask = segment_mask(t, segments, q.device)
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        return o.transpose(1, 2)
    if mask is not None:
        return causal_attention(q, k, v, mask=mask)
    if t > 1024 and t % 256 == 0:
        return flash_causal_attention(q, k, v, segments=segments)
    return causal_attention(q, k, v, segments=segments)
