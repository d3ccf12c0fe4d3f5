"""Streaming decode of the LLMVoX speech-token decoder.

Counterpart of the decode half of ``llmvox_tpu/models/decoder.py``
(``DecodeState``, ``init_decode_state``, ``_decode_one``, ``decode_block``,
and the multi-stream ``init_decode_state_batch``, ``_decode_one_batch``,
``decode_block_batch``):
a 4-layer GPT step per token over a persistent ``(L, S, C)`` KV cache,
fed with the L2-normalised concatenation of the text byte embedding and
the previous speech token's codebook feature; the next token is the
argmax over the 4096 codes, taken in f32.

A block is a Python loop of ``block`` steps whose state (``pos``,
``prev_token``, ``done``) stays in 0-d device tensors: nothing in it reads
a value back to the host, so the whole block is enqueued without a sync
and the caller can issue block i+1 before fetching block i's tokens, as
the JAX package does with one ``lax.scan`` program.  The caches are
written in place (the JAX state is immutable; here the state passed in
is consumed).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn, nn
from llmvox_tpu_torch.utils.config import DecoderConfig


class DecodeState(NamedTuple):
    """Per-stream decode state, reset at every sentence boundary."""

    k_cache: torch.Tensor     # (L, S, C)
    v_cache: torch.Tensor     # (L, S, C)
    pos: torch.Tensor         # 0-d int32, tokens generated so far
    prev_token: torch.Tensor  # 0-d int32
    done: torch.Tensor        # 0-d bool, EOA emitted


def init_decode_state(cfg: DecoderConfig, dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    l, s, c = cfg.n_layer, cfg.block_size, cfg.n_embd
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return DecodeState(
        k_cache=torch.zeros((l, s, c), dtype=dtype, device=device),
        v_cache=torch.zeros((l, s, c), dtype=dtype, device=device),
        pos=zero,
        prev_token=zero.clone(),
        done=torch.zeros((), dtype=torch.bool, device=device),
    )


def _decode_one(params: Dict, cfg: DecoderConfig, x: torch.Tensor,
                state: DecodeState, return_logits: bool = False):
    """One transformer step for one new position; x is (C,).

    Writes this position's k/v rows into the caches (in place) and returns
    the argmax token (0-d int32), plus the f32 logits when asked."""
    pos = state.pos
    # index ops take int64 indices; clamp keeps a read at capacity in
    # range as the JAX gather does
    row = pos.clamp(max=cfg.block_size - 1).long().reshape(1)
    x = x + params["wpe"].index_select(0, row)[0].to(x.dtype)
    h = params["h"]
    c = cfg.n_embd
    for layer in range(cfg.n_layer):
        p = {k: v[layer] for k, v in h.items()}
        hnorm = nn.layer_norm(x, p["ln1_s"], p.get("ln1_b"), cfg.ln_eps)
        qkv = nn.linear(hnorm[None], p["wqkv"], p.get("bqkv"))[0]
        q, k, v = qkv[:c], qkv[c:2 * c], qkv[2 * c:]
        kc, vc = state.k_cache[layer], state.v_cache[layer]
        kc.index_copy_(0, row, k[None].to(kc.dtype))
        vc.index_copy_(0, row, v[None].to(vc.dtype))
        a = cuda_attn.decode_attention(q.to(kc.dtype), kc, vc, pos,
                                       cfg.n_head)
        x = x + nn.linear(a[None].to(x.dtype), p["wo"], p.get("bo"))[0]
        hnorm = nn.layer_norm(x, p["ln2_s"], p.get("ln2_b"), cfg.ln_eps)
        m = nn.gelu_tanh(nn.linear(hnorm[None], p["wfc"], p.get("bfc")))
        x = x + nn.linear(m, p["wproj"], p.get("bproj"))[0]
    x = nn.layer_norm(x, params["lnf_s"], params.get("lnf_b"), cfg.ln_eps)
    # the head accumulates in f32 even under bf16 params (products of bf16
    # values are exact in f32), so the argmax matches an f32 softmax-argmax
    logits = x.float() @ params["head"].float()
    token = torch.argmax(logits).to(torch.int32)
    if return_logits:
        return token, logits
    return token


def decode_block(params: Dict, text_table: torch.Tensor,
                 codebook: torch.Tensor, state: DecodeState,
                 text_window: torch.Tensor, text_len: torch.Tensor,
                 limit: torch.Tensor, cfg: DecoderConfig, block: int = 32):
    """Generate up to ``block`` speech tokens without a host sync.

    Per step: the text id for position ``pos`` is ``text_window[i]`` while
    ``pos < text_len`` and PAD afterwards; the speech feature is the
    previous token's codebook row (zeros at position 0); both are
    concatenated, L2-normalised and run through one transformer step.
    Steps at ``i >= limit`` or after EOA are inactive: they still write
    the cache row at ``pos`` (the next active step overwrites it before
    anything attends to it) but advance nothing and emit -1.

    Args:
      text_table: (text_vocab, text_embed_dim) byte-embedding table.
      codebook: (vq_bins, speech_embed_dim) speech codebook.
      text_window: (block,) int32 — text ids for positions pos..pos+block.
      text_len: 0-d int32, the number of valid text ids (absolute).
      limit: 0-d int32, most tokens to generate in this call.
    Returns:
      (tokens (block,) int32 with -1 at inactive steps, n_generated, state)
    """
    compute_dtype = state.k_cache.dtype
    pos, prev, done = state.pos, state.prev_token, state.done
    outs = []
    # constants enter as Python scalars, never as host-made tensors: a
    # host-to-device copy would sync, and a CUDA graph cannot capture it
    for i in range(block):
        active = (limit > i) & ~done
        tid = torch.where(pos < text_len, text_window[i], cfg.pad_token_id)
        temb = text_table.index_select(0, tid.reshape(1))[0]
        sfeat = torch.where(pos == 0, 0.0,
                            codebook.index_select(0, prev.reshape(1))[0])
        x = nn.l2_normalize(torch.cat([temb, sfeat])).to(compute_dtype)
        token = _decode_one(params, cfg, x,
                            DecodeState(state.k_cache, state.v_cache, pos,
                                        prev, done))
        pos = torch.where(active, pos + 1, pos)
        prev = torch.where(active, token, prev)
        done = done | (active & (token == cfg.eoa_token_id))
        outs.append(torch.where(active, token, -1))
    tokens = torch.stack(outs)
    n = (tokens >= 0).sum(dtype=torch.int32)
    return tokens, n, DecodeState(state.k_cache, state.v_cache, pos, prev,
                                  done)


# ---------------------------------------------------------------------------
# multi-stream decode: B streams advance together, one weight read per step
# ---------------------------------------------------------------------------

def init_decode_state_batch(cfg: DecoderConfig, batch: int,
                            dtype=torch.bfloat16, device="cpu"
                            ) -> DecodeState:
    """Caches (L, B, S, C); ``pos``, ``prev_token``, ``done`` (B,)."""
    l, s, c = cfg.n_layer, cfg.block_size, cfg.n_embd
    zero = torch.zeros((batch,), dtype=torch.int32, device=device)
    return DecodeState(
        k_cache=torch.zeros((l, batch, s, c), dtype=dtype, device=device),
        v_cache=torch.zeros((l, batch, s, c), dtype=dtype, device=device),
        pos=zero,
        prev_token=zero.clone(),
        done=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _decode_one_batch(params: Dict, cfg: DecoderConfig, x: torch.Tensor,
                      state: DecodeState) -> torch.Tensor:
    """Batched transformer step: x (B, C), caches (L, B, S, C), pos (B,).

    Writes each stream's k/v row at its ``pos`` into the caches (in place)
    and returns the (B,) int32 argmax tokens.  A stream at ``pos >= S``
    reads the last ``wpe`` row and writes no cache row: the JAX step
    clamps the ``wpe`` gather and drops an out-of-range scatter."""
    b = x.shape[0]
    s = cfg.block_size
    pos = state.pos
    row = pos.clamp(max=s - 1).long()
    x = x + params["wpe"].index_select(0, row).to(x.dtype)
    in_range = (pos < s)[:, None]
    rows = (torch.arange(b, device=x.device), row)
    h = params["h"]
    c = cfg.n_embd
    for layer in range(cfg.n_layer):
        p = {k: v[layer] for k, v in h.items()}
        hnorm = nn.layer_norm(x, p["ln1_s"], p.get("ln1_b"), cfg.ln_eps)
        qkv = nn.linear(hnorm, p["wqkv"], p.get("bqkv"))
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
        kc, vc = state.k_cache[layer], state.v_cache[layer]
        kc.index_put_(rows, torch.where(in_range, k.to(kc.dtype), kc[rows]))
        vc.index_put_(rows, torch.where(in_range, v.to(vc.dtype), vc[rows]))
        a = cuda_batched_attn.batched_decode_attention(
            q.to(kc.dtype).contiguous(), kc, vc, pos, cfg.n_head)
        x = x + nn.linear(a.to(x.dtype), p["wo"], p.get("bo"))
        hnorm = nn.layer_norm(x, p["ln2_s"], p.get("ln2_b"), cfg.ln_eps)
        m = nn.gelu_tanh(nn.linear(hnorm, p["wfc"], p.get("bfc")))
        x = x + nn.linear(m, p["wproj"], p.get("bproj"))
    x = nn.layer_norm(x, params["lnf_s"], params.get("lnf_b"), cfg.ln_eps)
    logits = x.float() @ params["head"].float()
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_block_batch(params: Dict, text_table: torch.Tensor,
                       codebook: torch.Tensor, states: DecodeState,
                       text_windows: torch.Tensor, text_lens: torch.Tensor,
                       limits: torch.Tensor, cfg: DecoderConfig,
                       block: int = 32):
    """Multi-stream ``decode_block``: B independent streams advance
    together without a host sync, each with its own window, text length
    and limit; the per-stream rules are ``decode_block``'s.

    Args:
      states: batched DecodeState (caches (L, B, S, C); pos/prev/done (B,)).
      text_windows: (B, block) int32; text_lens, limits: (B,) int32.
    Returns:
      (tokens (B, block) int32 with -1 at inactive steps, n (B,), states)
    """
    compute_dtype = states.k_cache.dtype
    pos, prev, done = states.pos, states.prev_token, states.done
    outs = []
    for i in range(block):
        active = (limits > i) & ~done
        tid = torch.where(pos < text_lens, text_windows[:, i],
                          cfg.pad_token_id)
        temb = text_table.index_select(0, tid)
        sfeat = torch.where((pos == 0)[:, None], 0.0,
                            codebook.index_select(0, prev))
        x = nn.l2_normalize(torch.cat([temb, sfeat], dim=-1)).to(
            compute_dtype)
        tokens = _decode_one_batch(params, cfg, x,
                                   DecodeState(states.k_cache,
                                               states.v_cache, pos, prev,
                                               done))
        pos = torch.where(active, pos + 1, pos)
        prev = torch.where(active, tokens, prev)
        done = done | (active & (tokens == cfg.eoa_token_id))
        outs.append(torch.where(active, tokens, -1))
    tokens = torch.stack(outs, dim=1)
    n = (tokens >= 0).sum(dim=-1, dtype=torch.int32)
    return tokens, n, DecodeState(states.k_cache, states.v_cache, pos, prev,
                                  done)
