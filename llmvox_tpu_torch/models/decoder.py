"""The LLMVoX speech-token decoder: streaming decode and training.

Counterpart of ``llmvox_tpu/models/decoder.py``: the decode half
(``DecodeState``, ``init_decode_state``, ``_decode_one``, ``decode_block``,
``sample_block``, and the multi-stream ``init_decode_state_batch``,
``_decode_one_batch``, ``decode_block_batch``), and at the end of this
file the full-sequence half that training runs (``apply_decoder``,
``decoder_loss``, ``num_params``, ``crop_block_size``) with
``DecoderModel``, the ``nn.Module`` whose parameters are a params tree's
leaves.  The decode half is
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

Speculative decode (``decode_block_spec_batch``, ``decode_block_spec``;
the JAX functions of the same names) verifies ``k_draft`` drafted tokens
per stream in one ``k_draft + 1``-position forward whose attention is
kernel K3.  JAX runs it as a ``lax.while_loop`` that ends when no stream
is active; here the loop's stop test comes back to the host one
iteration late (``models/spec.py::run_spec_loop``), and an iteration is a
function of buffers it updates in place (``SpecBuffers``,
``spec_iteration``), so a served block replays one CUDA graph per
iteration.

Served blocks keep one static ``DecodeState`` per engine or pool and
write the next state into it (``assign_state``), so a CUDA graph can
capture a block (``utils/graphs.py``).

Quantized params (``ops/quant.py``, ``--quantize``) flow through every
path unchanged: ``v[layer]`` of a stacked container is that layer's 2-D
container, ``nn.linear`` dispatches on it (w4 through kernel K4), and the
head stays a weight-only int8 ``QuantizedTensor``.

Training runs on one rank's share of the work: its Megatron shard of the
params (``tp``), its dp shards gathered where they are used (``fsdp``),
and under sequence parallelism its share of the sequence (``seq_share``:
the rows' global positions index ``wpe`` and the dropout masks, and the
attention is the ring of ``ops/ring_attention.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn, \
    cuda_verify_attn, nn
from llmvox_tpu_torch.ops.attention import causal_attention_auto, \
    segment_mask
from llmvox_tpu_torch.models.spec import run_spec_loop
from llmvox_tpu_torch.ops.ring_attention import (check_seq, ring_attention,
                                                 zigzag_permutation)
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import tensor_parallel as tpar
from llmvox_tpu_torch.parallel.sharding import dp_rows
from llmvox_tpu_torch.utils.config import DecoderConfig
from llmvox_tpu_torch.utils.graphs import register_counter

# Speculative iterations issued since the last reset; each runs one verify
# forward, n_layer K3 launches on the card.  Engines issue from their own
# dispatch threads, so the count is taken under a lock.
SPEC_ITERATIONS = 0
# the draft heads' share of ``decoder_loss``: their mean loss times this
MTP_WEIGHT = 0.2
_spec_lock = threading.Lock()
register_counter(__name__, "SPEC_ITERATIONS", _spec_lock)


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


def _decode_logits(params: Dict, cfg: DecoderConfig, x: torch.Tensor,
                   state: DecodeState) -> torch.Tensor:
    """One transformer step for one new position; x is (C,).

    Writes this position's k/v rows into the caches (in place) and returns
    the (vocab,) f32 logits."""
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
    # values are exact in f32), so the argmax matches an f32 softmax-argmax;
    # a quantized head dequantizes in x's dtype first, as JAX's does
    return x.float() @ nn.dense_weight(params["head"], x.dtype).float()


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits).to(torch.int32)


def _decode_one(params: Dict, cfg: DecoderConfig, x: torch.Tensor,
                state: DecodeState, return_logits: bool = False):
    """``_decode_logits`` and the argmax token (0-d int32), plus the f32
    logits when asked."""
    logits = _decode_logits(params, cfg, x, state)
    token = _argmax(logits)
    if return_logits:
        return token, logits
    return token


def _step_block(params: Dict, text_table: torch.Tensor,
                codebook: torch.Tensor, state: DecodeState,
                text_window: torch.Tensor, text_len: torch.Tensor,
                limit: torch.Tensor, cfg: DecoderConfig, block: int,
                choose):
    """The loop of ``decode_block`` and ``sample_block``: step i's token is
    ``choose(i, logits)`` of its (vocab,) f32 logits."""
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
        token = choose(i, _decode_logits(
            params, cfg, x,
            DecodeState(state.k_cache, state.v_cache, pos, prev, done)))
        pos = torch.where(active, pos + 1, pos)
        prev = torch.where(active, token, prev)
        done = done | (active & (token == cfg.eoa_token_id))
        outs.append(torch.where(active, token, -1))
    tokens = torch.stack(outs)
    n = (tokens >= 0).sum(dtype=torch.int32)
    return tokens, n, DecodeState(state.k_cache, state.v_cache, pos, prev,
                                  done)


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
    return _step_block(params, text_table, codebook, state, text_window,
                       text_len, limit, cfg, block,
                       lambda i, logits: _argmax(logits))


def sample_block(params: Dict, text_table: torch.Tensor,
                 codebook: torch.Tensor, state: DecodeState,
                 text_window: torch.Tensor, text_len: torch.Tensor,
                 limit: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, cfg: DecoderConfig, block: int = 32,
                 top_k: Optional[int] = None,
                 gumbel: Optional[torch.Tensor] = None):
    """``decode_block`` with temperature and top-k sampling in place of the
    argmax: each step draws the argmax of its filtered f32 logits plus
    Gumbel noise (``jax.random.categorical``'s method) from ``generator``,
    or from ``gumbel`` (block, vocab) when given.  JAX draws its noise from
    its own PRNG, so the two agree in distribution, and token for token
    for the same noise.  Attention is K1 on the card, as in
    ``decode_block``."""
    def choose(i: int, logits: torch.Tensor) -> torch.Tensor:
        logits = logits / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.topk(logits, top_k).values[-1]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if gumbel is None:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device, dtype=torch.float32)
            noise = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(torch.float32).tiny)))
        else:
            noise = gumbel[i]
        return _argmax(logits + noise)

    return _step_block(params, text_table, codebook, state, text_window,
                       text_len, limit, cfg, block, choose)


def assign_state(dst: DecodeState, src: DecodeState) -> None:
    """Copy ``src``'s pos, prev_token and done into ``dst``'s tensors (the
    caches are the same tensors): the in-place form of a block's state
    update, which keeps a static DecodeState static for a CUDA graph."""
    dst.pos.copy_(src.pos)
    dst.prev_token.copy_(src.prev_token)
    dst.done.copy_(src.done)


def masked_reset(states: DecodeState, mask: torch.Tensor) -> DecodeState:
    """Zero ``pos``/``prev_token``/``done`` where the bool device ``mask``
    (the shape of ``pos``) is set: a fixed-shape select, no host sync.
    Resetting these suffices: cache rows beyond pos are never attended
    and are overwritten before they are read."""
    return states._replace(
        pos=torch.where(mask, 0, states.pos),
        prev_token=torch.where(mask, 0, states.prev_token),
        done=torch.where(mask, False, states.done))


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
                      state: DecodeState):
    """Batched transformer step: x (B, C), caches (L, B, S, C), pos (B,).

    Writes each stream's k/v row at its ``pos`` into the caches (in place)
    and returns the (B,) int32 argmax tokens and the (B, vocab) f32
    logits.  A stream at ``pos >= S``
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
    logits = x.float() @ nn.dense_weight(params["head"], x.dtype).float()
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def decode_block_batch(params: Dict, text_table: torch.Tensor,
                       codebook: torch.Tensor, states: DecodeState,
                       text_windows: torch.Tensor, text_lens: torch.Tensor,
                       limits: torch.Tensor, cfg: DecoderConfig,
                       block: int = 32, return_logits: bool = False):
    """Multi-stream ``decode_block``: B independent streams advance
    together without a host sync, each with its own window, text length
    and limit; the per-stream rules are ``decode_block``'s.

    Args:
      states: batched DecodeState (caches (L, B, S, C); pos/prev/done (B,)).
      text_windows: (B, block) int32; text_lens, limits: (B,) int32.
    Returns:
      (tokens (B, block) int32 with -1 at inactive steps, n (B,), states),
      and with ``return_logits`` each step's f32 logits (B, block, vocab)
    """
    compute_dtype = states.k_cache.dtype
    pos, prev, done = states.pos, states.prev_token, states.done
    outs, step_logits = [], []
    for i in range(block):
        active = (limits > i) & ~done
        tid = torch.where(pos < text_lens, text_windows[:, i],
                          cfg.pad_token_id)
        temb = text_table.index_select(0, tid)
        sfeat = torch.where((pos == 0)[:, None], 0.0,
                            codebook.index_select(0, prev))
        x = nn.l2_normalize(torch.cat([temb, sfeat], dim=-1)).to(
            compute_dtype)
        tokens, logits = _decode_one_batch(
            params, cfg, x,
            DecodeState(states.k_cache, states.v_cache, pos, prev, done))
        if return_logits:
            step_logits.append(logits)
        pos = torch.where(active, pos + 1, pos)
        prev = torch.where(active, tokens, prev)
        done = done | (active & (tokens == cfg.eoa_token_id))
        outs.append(torch.where(active, tokens, -1))
    tokens = torch.stack(outs, dim=1)
    n = (tokens >= 0).sum(dim=-1, dtype=torch.int32)
    states = DecodeState(states.k_cache, states.v_cache, pos, prev, done)
    if return_logits:
        return tokens, n, states, torch.stack(step_logits, dim=1)
    return tokens, n, states


# ---------------------------------------------------------------------------
# speculative decode: k_draft drafts per stream verified in one forward
# ---------------------------------------------------------------------------

def _decode_many_batch(params: Dict, cfg: DecoderConfig, xs: torch.Tensor,
                       states: DecodeState, n: int):
    """Batched teacher-forced verify forward: stream b at positions
    ``pos[b]..pos[b]+n-1`` in one pass; xs (B, n, C), caches (L, B, S, C)
    written in place.  Returns (argmax tokens (B, n) int32, final hidden
    (B, n, C)).

    A query at a position >= S reads the last ``wpe`` row and writes no
    cache row, as JAX's batched scatter drops it.  Its clamped row index
    is S-1, which the stream's in-range query at S-1 may also write, so
    every query past the cache writes what that query writes there (or
    the old row when none does): duplicate indices then agree."""
    b = xs.shape[0]
    s, c = cfg.block_size, cfg.n_embd
    pos = states.pos
    offs = torch.arange(n, dtype=torch.int32, device=xs.device)
    posn = pos[:, None] + offs[None]                              # (B, n)
    x = xs + params["wpe"].index_select(
        0, posn.clamp(max=s - 1).reshape(-1)).view(b, n, c).to(xs.dtype)
    src = torch.minimum(offs[None], (s - 1 - pos).clamp(0, n - 1)[:, None])
    dst = pos[:, None] + src
    keep = (dst < s)[..., None]
    rows = (torch.arange(b, device=xs.device)[:, None].expand(b, n),
            dst.clamp(max=s - 1).long())
    gather = src.long()[..., None].expand(b, n, c)
    h = params["h"]
    for layer in range(cfg.n_layer):
        p = {k: v[layer] for k, v in h.items()}
        hnorm = nn.layer_norm(x, p["ln1_s"], p.get("ln1_b"), cfg.ln_eps)
        qkv = nn.linear(hnorm, p["wqkv"], p.get("bqkv"))          # (B, n, 3C)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        kc, vc = states.k_cache[layer], states.v_cache[layer]
        kc.index_put_(rows, torch.where(
            keep, k.gather(1, gather).to(kc.dtype), kc[rows]))
        vc.index_put_(rows, torch.where(
            keep, v.gather(1, gather).to(vc.dtype), vc[rows]))
        a = cuda_verify_attn.verify_attention(
            q.to(kc.dtype).contiguous(), kc, vc, pos, cfg.n_head)
        x = x + nn.linear(a.to(x.dtype), p["wo"], p.get("bo"))
        hnorm = nn.layer_norm(x, p["ln2_s"], p.get("ln2_b"), cfg.ln_eps)
        m = nn.gelu_tanh(nn.linear(hnorm, p["wfc"], p.get("bfc")))
        x = x + nn.linear(m, p["wproj"], p.get("bproj"))
    x = nn.layer_norm(x, params["lnf_s"], params.get("lnf_b"), cfg.ln_eps)
    logits = x.float() @ nn.dense_weight(params["head"], x.dtype).float()
    return torch.argmax(logits, dim=-1).to(torch.int32), x


class SpecBuffers(NamedTuple):
    """What a speculative block carries from one iteration to the next,
    beside the DecodeState: B streams, ``block`` tokens, k drafts.  Every
    iteration reads and writes these tensors in place, so a block is one
    start and then iterations over the same buffers (one CUDA graph each
    when served, ``serve/engine.py``, ``serve/pool.py``)."""

    wpad: torch.Tensor    # (B, block + k + 1) int32: windows, then PAD
    limits: torch.Tensor  # (B,) int32, clamped to block
    d: torch.Tensor       # (B, k) int32: drafts for the next iteration
    out: torch.Tensor     # (B, block + k + 1) int32: commits, else -1
    count: torch.Tensor   # (B,) int32: tokens committed
    iters: torch.Tensor   # (B,) int32: active iterations
    flag: torch.Tensor    # () bool: is any stream still active
    dpad: Optional[torch.Tensor]  # (B, block + k + 1) explicit drafts


def spec_buffers(batch: int, block: int, k_draft: int, device,
                 drafts: bool = False) -> SpecBuffers:
    """Buffers of a speculative block; ``drafts`` for explicit drafts
    instead of the draft heads."""
    i32 = dict(dtype=torch.int32, device=device)
    w = block + k_draft + 1
    return SpecBuffers(
        wpad=torch.zeros((batch, w), **i32),
        limits=torch.zeros((batch,), **i32),
        d=torch.zeros((batch, k_draft), **i32),
        out=torch.full((batch, w), -1, **i32),
        count=torch.zeros((batch,), **i32),
        iters=torch.zeros((batch,), **i32),
        flag=torch.zeros((), dtype=torch.bool, device=device),
        dpad=torch.zeros((batch, w), **i32) if drafts else None)


def spec_start(states: DecodeState, bufs: SpecBuffers,
               text_windows: torch.Tensor, limits: torch.Tensor,
               cfg: DecoderConfig,
               draft_tokens: Optional[torch.Tensor] = None) -> None:
    """Begin a speculative block in ``bufs``, in place: the windows padded
    by k + 1 PAD ids, limits clamped to the block, no drafts (or the
    first explicit ones), nothing committed, and the flag of the streams
    active before the first iteration."""
    kd = bufs.d.shape[1]
    block = bufs.out.shape[1] - kd - 1
    bufs.limits.copy_(limits.clamp(max=block))
    bufs.wpad[:, :block].copy_(text_windows)
    bufs.wpad[:, block:].fill_(cfg.pad_token_id)
    if bufs.dpad is not None:
        bufs.dpad[:, :block].copy_(draft_tokens.clamp_min(0))
        bufs.dpad[:, block:].zero_()
        bufs.d.copy_(bufs.dpad[:, :kd])
    else:
        bufs.d.zero_()
    bufs.out.fill_(-1)
    bufs.count.zero_()
    bufs.iters.zero_()
    bufs.flag.copy_(((bufs.count < bufs.limits) & ~states.done).any())


def spec_iteration(params: Dict, text_table: torch.Tensor,
                   codebook: torch.Tensor, states: DecodeState,
                   bufs: SpecBuffers, text_lens: torch.Tensor,
                   cfg: DecoderConfig,
                   heads: Optional[torch.Tensor] = None) -> None:
    """One iteration of a speculative block, in place on ``states`` and
    ``bufs``: ONE forward over ``k + 1`` positions per stream; each active
    stream commits slot 0 and its matching draft prefix, up to its limit
    and its EOA, and drafts again from its last committed slot (with the
    f32 draft ``heads`` (k, C, vocab), or from ``bufs.dpad``).  A stream
    that is not active commits nothing and keeps its state; its forward
    writes only cache rows at and above its ``pos``.  Ends with the flag
    of the streams still active."""
    global SPEC_ITERATIONS
    dev = states.pos.device
    compute_dtype = states.k_cache.dtype
    bsz, kd = bufs.d.shape
    pad, eoa = cfg.pad_token_id, cfg.eoa_token_id
    offs1 = torch.arange(kd + 1, dtype=torch.int32, device=dev)
    count, limits, d = bufs.count, bufs.limits, bufs.d
    pos, prev, done = states.pos, states.prev_token, states.done
    active = (count < limits) & ~done
    prevs = torch.cat([prev[:, None], d], dim=1)                  # (B, kd+1)
    tseg = bufs.wpad.gather(1, (count[:, None] + offs1).long())
    post = pos[:, None] + offs1
    tids = torch.where(post < text_lens[:, None], tseg, pad)
    tembs = text_table.index_select(0, tids.reshape(-1)).view(
        bsz, kd + 1, -1)
    sfeats = torch.where(
        (post == 0)[..., None], 0.0,
        codebook.index_select(0, prevs.reshape(-1)).view(bsz, kd + 1, -1))
    xs = nn.l2_normalize(torch.cat([tembs, sfeats], dim=-1)).to(
        compute_dtype)
    a, hidden = _decode_many_batch(params, cfg, xs, states, kd + 1)

    # each stream commits slot 0 and its matching draft prefix
    prefix_ok = torch.cat([
        torch.ones((bsz, 1), dtype=torch.bool, device=dev),
        torch.cumprod((d == a[:, :kd]).to(torch.int32), dim=1).bool()],
        dim=1)
    eoa_before = torch.cat([
        torch.zeros((bsz, 1), dtype=torch.bool, device=dev),
        torch.cumsum((a == eoa).to(torch.int32), dim=1)[:, :-1] > 0],
        dim=1)
    commit = (active[:, None] & prefix_ok
              & (count[:, None] + offs1 < limits[:, None]) & ~eoa_before)
    m = commit.sum(dim=1, dtype=torch.int32)
    sel = (m - 1).clamp_min(0).long()[:, None]
    last = torch.where(m > 0, a.gather(1, sel)[:, 0], prev)
    new_done = done | (commit & (a == eoa)).any(dim=1)

    # the next drafts, from each stream's last committed slot
    if bufs.dpad is not None:
        new_d = bufs.dpad.gather(1, ((count + m)[:, None]
                                     + offs1[:kd]).long())
    else:
        h_last = hidden.gather(
            1, sel[..., None].expand(bsz, 1, hidden.shape[-1]))[:, 0]
        new_d = torch.einsum("bc,kcv->bkv", h_last.float(), heads).argmax(
            dim=-1).to(torch.int32)

    # a frozen stream writes -1 at [count..count+kd], where out is -1
    bufs.out.scatter_(1, (count[:, None] + offs1).long(),
                      torch.where(commit, a, -1))
    pos.add_(m)
    prev.copy_(last)
    done.copy_(new_done)
    count.add_(m)
    bufs.iters.add_(active.to(torch.int32))
    d.copy_(new_d)
    bufs.flag.copy_(((count < limits) & ~done).any())
    with _spec_lock:
        SPEC_ITERATIONS += 1


def decode_block_spec_batch(params: Dict, text_table: torch.Tensor,
                            codebook: torch.Tensor, states: DecodeState,
                            text_windows: torch.Tensor,
                            text_lens: torch.Tensor, limits: torch.Tensor,
                            cfg: DecoderConfig, block: int = 32,
                            k_draft: int = 4,
                            draft_tokens: Optional[torch.Tensor] = None):
    """Speculative ``decode_block_batch``: the same tokens for any drafts,
    in fewer iterations when drafts are good.

    Each iteration (``spec_iteration``) runs ONE forward over
    ``k_draft + 1`` positions per stream: slot 0 conditioned on the
    stream's committed previous token (always exact), slots 1..k on the
    drafts carried from the previous iteration (``params["draft_heads"]``
    on the hidden state at the stream's last committed slot, or the
    explicit ``draft_tokens`` (B, block) stream).  Each active stream
    commits slot 0 plus the prefix whose drafts matched, up to its limit
    and its EOA; rejected slots' cache rows lie above ``pos`` and are
    overwritten before anything attends to them.  Limits above ``block``
    count as ``block``.  The loop is ``run_spec_loop``'s, one iteration
    ahead of the card; ``SPEC_ITERATIONS`` counts the iterations issued.
    The caches are written in place; ``states``' pos, prev_token and
    done are not (the returned state holds new ones).

    Returns (tokens (B, block) int32 with -1 at inactive slots, n (B,),
    states, iters (B,): each stream's active iterations, as JAX counts
    them)."""
    bufs = spec_buffers(states.pos.shape[0], block, k_draft,
                        states.pos.device, drafts=draft_tokens is not None)
    heads = (None if draft_tokens is not None
             else params["draft_heads"][:k_draft].float())
    st = DecodeState(states.k_cache, states.v_cache, states.pos.clone(),
                     states.prev_token.clone(), states.done.clone())
    run_spec_loop(
        lambda: spec_start(st, bufs, text_windows, limits, cfg,
                           draft_tokens),
        lambda: spec_iteration(params, text_table, codebook, st, bufs,
                               text_lens, cfg, heads),
        bufs.flag, block)
    return bufs.out[:, :block], bufs.count, st, bufs.iters


def decode_block_spec(params: Dict, text_table: torch.Tensor,
                      codebook: torch.Tensor, state: DecodeState,
                      text_window: torch.Tensor, text_len: torch.Tensor,
                      limit: torch.Tensor, cfg: DecoderConfig,
                      block: int = 32, k_draft: int = 4,
                      draft_tokens: Optional[torch.Tensor] = None):
    """Speculative ``decode_block`` for one stream: the same tokens as
    ``decode_block`` for any drafts.  It runs ``decode_block_spec_batch``
    on the (L, 1, S, C) view of the (L, S, C) caches, so attention goes
    through K3 and the cache writes land in this state's caches.  Near the
    cache's end it follows the batched rule (a query past S writes
    nothing, ``wpe`` clamps per query), not JAX's B=1 window, which slides
    down to fit.

    Returns (tokens (block,) with -1 at inactive steps, n_generated (0-d),
    state, iters (0-d))."""
    batched = DecodeState(state.k_cache.unsqueeze(1),
                          state.v_cache.unsqueeze(1), state.pos.reshape(1),
                          state.prev_token.reshape(1), state.done.reshape(1))
    toks, n, st, iters = decode_block_spec_batch(
        params, text_table, codebook, batched, text_window.reshape(1, -1),
        text_len.reshape(1), limit.reshape(1), cfg, block=block,
        k_draft=k_draft,
        draft_tokens=(None if draft_tokens is None
                      else draft_tokens.reshape(1, -1)))
    return toks[0], n[0], DecodeState(state.k_cache, state.v_cache,
                                      st.pos[0], st.prev_token[0],
                                      st.done[0]), iters[0]


# ---------------------------------------------------------------------------
# full-sequence forward and loss (training, eval)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def num_params(params: Dict, non_embedding: bool = True) -> int:
    n = sum(int(np.prod(x.shape)) for x in _leaves(params))
    if non_embedding:
        n -= int(np.prod(params["wpe"].shape))
    return n


def _drop(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - p), 0.0)


def _block(x: torch.Tensor, p: Dict, cfg: DecoderConfig,
           keep: Optional[Tuple[torch.Tensor, torch.Tensor]], attn,
           tp=None, fsdp=None) -> torch.Tensor:
    """One pre-LN transformer block over (B, T, C); ``keep`` holds the
    block's two residual dropout masks, drawn by the caller, and ``attn``
    the (B, T, H, D) q/k/v -> (B, T, H, D) attention the caller chose
    (``_attention``).  ``tp``: a tensor-parallel group over which ``p`` is
    this rank's shard (``parallel/sharding.py::shard_decoder``): its heads
    of the fused QKV (column-parallel, cut by heads) and of ``wo``
    (row-parallel), its columns of ``wfc`` and rows of ``wproj``; the
    row-parallel products are summed over the group before their biases,
    which are added once.  ``fsdp`` (``parallel/sharding.py::FSDP``):
    ``p``'s matrices are this rank's dp shards, gathered here, in the
    block, so that a block recomputed in the backward pass gathers them
    again."""
    if fsdp is not None:
        p = fsdp.layer(p)
    b, t, _ = x.shape
    hnorm = tpar.copy_to_tp(nn.layer_norm(x, p["ln1_s"], p.get("ln1_b"),
                                          cfg.ln_eps), tp)
    qkv = nn.linear(hnorm, p["wqkv"], p.get("bqkv"))
    shape = (b, t, -1, cfg.head_dim)
    q, k, v = (z.reshape(shape) for z in qkv.split(qkv.shape[-1] // 3,
                                                      dim=-1))
    a = attn(q, k, v).reshape(b, t, -1)
    a = _row_parallel(a, p["wo"], p.get("bo"), tp)
    if keep is not None:
        a = _drop(a, keep[0], cfg.dropout)
    x = x + a
    hnorm = tpar.copy_to_tp(nn.layer_norm(x, p["ln2_s"], p.get("ln2_b"),
                                          cfg.ln_eps), tp)
    m = nn.gelu_tanh(nn.linear(hnorm, p["wfc"], p.get("bfc")))
    m = _row_parallel(m, p["wproj"], p.get("bproj"), tp)
    if keep is not None:
        m = _drop(m, keep[1], cfg.dropout)
    return x + m


class SeqShare(NamedTuple):
    """This rank's share of the sequence axis (``seq_share``): ``rows``
    (Tc,) the global positions of its rows, in its order; ``t`` the
    global width; ``group`` the sequence-parallel group whose ring runs
    the attention (None: one process holding every row, permuted, the
    attention masked causally on ``rows``); ``layout`` "ring" or
    "zigzag"."""
    rows: torch.Tensor
    t: int
    group: object
    layout: str


def seq_share(t: int, device, sp=None, layout: str = "ring",
              perm=None) -> SeqShare:
    """The rows of a T-wide sequence this rank holds: block i of
    ``perm``'s order (the identity by default; ``zigzag_permutation(t,
    n)`` under the zigzag layout) on sp index i of ``sp``, as JAX's
    ``P(dp, sp)`` splits the permuted sequence (``parallel/sharding.py::
    batch_seq_sharding``).  T must divide as JAX's ring requires."""
    n = tpar.size(sp)
    check_seq(t, n, layout)
    if perm is None and layout == "zigzag":
        perm = zigzag_permutation(t, n)[0]
    order = (torch.arange(t) if perm is None
             else torch.as_tensor(np.asarray(perm), dtype=torch.long))
    i = pmesh.group_rank(sp) if n > 1 else 0
    return SeqShare(order[dp_rows(t, i, n)].to(device), t,
                    sp if n > 1 else None, layout)


def _attention(share: Optional[SeqShare], segments, mask):
    """The blocks' attention: the ring over ``share``'s group, attention
    causal on its global positions for one process holding permuted rows,
    else ``causal_attention_auto`` (packed batches through ``segments``,
    ``mask`` their SDPA mask on the card)."""
    if share is not None and share.group is not None:
        return functools.partial(ring_attention, group=share.group,
                                 layout=share.layout)
    if share is not None:
        mask = share.rows[:, None] >= share.rows[None, :]
    return functools.partial(causal_attention_auto, segments=segments,
                             mask=mask)


def _row_parallel(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], tp) -> torch.Tensor:
    """``nn.linear(x, w, b)`` with ``w``'s rows split over ``tp``: the
    partial products summed over the group, then the bias once."""
    if not tpar.active(tp):
        return nn.linear(x, w, b)
    y = tpar.reduce_from_tp(nn.linear(x, w), tp)
    return y if b is None else y + b.to(y.dtype)


def apply_decoder(params: Dict, emb: torch.Tensor, cfg: DecoderConfig, *,
                  generator: Optional[torch.Generator] = None,
                  train: bool = False, return_hidden: bool = False,
                  positions: Optional[torch.Tensor] = None,
                  segments: Optional[torch.Tensor] = None, tp=None,
                  share: Optional[SeqShare] = None, fsdp=None):
    """(B, T, C) fused input embeddings -> (B, T, vocab) f32 logits, causal.

    The compute dtype is ``emb``'s: f32 params are cast into each product.
    ``return_hidden`` also returns the final hidden states (the draft
    heads' input).  Packed batches (``train/data.py::collate_packed``):
    ``positions`` (B, T) index ``wpe`` per sentence, and ``segments``
    (B, T) make attention block-diagonal-causal.

    Dropout (``train`` with ``cfg.dropout > 0`` and a ``generator``) at
    JAX's three sites: the embedding and each block's two residual
    branches; none on the attention matrix.  Every mask is drawn here,
    before the layers, so that ``cfg.remat_layers`` (each block recomputed
    in the backward pass by ``torch.utils.checkpoint``) replays the
    forward's masks, as JAX passes each layer its key.

    ``tp``: a tensor-parallel group over which ``params`` is this rank's
    shard (``_block``); the embeddings, norms, head and draft heads are
    whole on every rank, and so are the activations between blocks, so
    the ranks of a group draw the same dropout masks from generators
    seeded alike.  ``share`` (``seq_share``): ``emb`` holds this rank's
    rows of a longer sequence; ``wpe`` is indexed by their global
    positions, each dropout mask is drawn for the whole sequence and cut
    to them (so the ranks of one sequence drop what one process would),
    and the attention is the ring over its group.  ``fsdp``
    (``parallel/sharding.py::FSDP``): the matrices are this rank's dp
    shards, each gathered where it is used."""
    b, t, c = emb.shape
    use_dropout = train and cfg.dropout > 0.0 and generator is not None
    wpe = params["wpe"] if fsdp is None else fsdp.leaf("wpe", params["wpe"])
    if share is not None:
        wpe = wpe[share.rows]
    else:
        wpe = wpe[:t] if positions is None else wpe[positions.long()]
    x = emb + wpe.to(emb.dtype)
    keeps: List = [None] * cfg.n_layer
    if use_dropout:
        def draw():
            keep = torch.rand((b, t if share is None else share.t, c),
                              generator=generator,
                              device=emb.device) < 1.0 - cfg.dropout
            return keep if share is None else keep[:, share.rows]
        x = _drop(x, draw(), cfg.dropout)
        keeps = [(draw(), draw()) for _ in range(cfg.n_layer)]
    # SDPA's boolean mask of a packed batch, (B, 1, T, T): built once here,
    # not in every layer and every recomputed block
    mask = (segment_mask(t, segments, emb.device)
            if segments is not None and emb.is_cuda else None)
    attn = _attention(share, segments, mask)
    h = params["h"]
    for layer in range(cfg.n_layer):
        p = {k: v[layer] for k, v in h.items()}
        if cfg.remat_layers and torch.is_grad_enabled():
            x = checkpoint(_block, x, p, cfg, keeps[layer], attn, tp, fsdp,
                           use_reentrant=False)
        else:
            x = _block(x, p, cfg, keeps[layer], attn, tp, fsdp)
    x = nn.layer_norm(x, params["lnf_s"], params.get("lnf_b"), cfg.ln_eps)
    head = (params["head"] if fsdp is None
            else fsdp.leaf("head", params["head"]))
    logits = nn.linear(x, head).float()
    if return_hidden:
        return logits, x
    return logits


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the targets that are not ``ignore_index``
    (0 when there are none); ``count`` replaces their number as the
    divisor (the whole batch's, when these targets are one rank's
    rows)."""
    n = (targets != ignore_index).sum() if count is None else count
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1).long(),
                            ignore_index=ignore_index, reduction="sum")
    return total / n.clamp_min(1)


def _shifted_targets(targets: torch.Tensor, cfg: DecoderConfig,
                     n_heads: int, segments: Optional[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Draft head j's targets: j+1 further ahead, ignored past the row's
    end and, in packed batches, in another sentence."""
    shifted = []
    for j in range(n_heads):
        shift = j + 1
        tgt = F.pad(targets[:, shift:], (0, shift), value=cfg.ignore_index)
        if segments is not None:
            seg = F.pad(segments[:, shift:], (0, shift), value=0)
            tgt = torch.where(seg == segments, tgt, cfg.ignore_index)
        shifted.append(tgt)
    return shifted


def loss_counts(targets: torch.Tensor, cfg: DecoderConfig, n_heads: int,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 + n_heads,) int64: the valid targets of the loss and of each
    draft head's term.  Data-parallel ranks sum theirs and pass the sums
    to ``decoder_loss(counts=...)``, so each term is the whole batch's
    masked mean, as JAX's is over the global batch."""
    ts = [targets] + _shifted_targets(targets, cfg, n_heads, segments)
    return torch.stack([(t != cfg.ignore_index).sum() for t in ts])


def decoder_loss(params: Dict, emb: torch.Tensor, targets: torch.Tensor,
                 cfg: DecoderConfig, *,
                 generator: Optional[torch.Generator] = None,
                 train: bool = True,
                 positions: Optional[torch.Tensor] = None,
                 segments: Optional[torch.Tensor] = None,
                 counts: Optional[torch.Tensor] = None,
                 perm=None, tp=None, sp=None, sp_layout: str = "ring",
                 fsdp=None) -> torch.Tensor:
    """Cross-entropy with ``ignore_index``; with draft heads
    (``params["draft_heads"]``) plus ``MTP_WEIGHT`` times their mean loss,
    head j predicting the target j+1 further ahead from the same hidden
    state.  In packed batches a shifted target in another sentence is
    ignored.  ``counts`` (``loss_counts`` summed over data-parallel ranks)
    divides each term in place of this batch's own counts.  ``tp``: a
    tensor-parallel group over which ``params`` is this rank's shard
    (``apply_decoder``); ``fsdp``: the matrices are dp shards.

    Sequence parallelism: ``emb`` and ``targets`` hold the whole
    sequence; ``sp`` (a group) runs the model on this rank's share of it
    (``seq_share``: its contiguous block under ``sp_layout`` "ring", its
    block of the zigzag permutation under "zigzag") with the ring
    attention, and the loss is this rank's share of the terms (pass the
    whole batch's ``counts``).  ``perm`` (JAX's ``decoder_loss(perm=)``)
    reorders the sequence first; on one process (no ``sp``) the rows run
    permuted with the attention causal on their original positions,
    which gives the unpermuted loss.  Either way the draft heads' shifted
    targets are built in the original order before any permutation or
    cut (``t + shift`` means the adjacent original position), as JAX's
    are.  Packed batches are refused there, as JAX asserts
    (``llmvox_tpu/models/decoder.py:120-121, 241``)."""
    n_heads = (params["draft_heads"].shape[0]
               if "draft_heads" in params else 0)
    shifted = _shifted_targets(targets, cfg, n_heads, segments)
    share = None
    if perm is not None or tpar.active(sp):
        if segments is not None or positions is not None:
            raise ValueError(
                "packed batches (segments, positions) do not compose with "
                "sequence parallelism or the zigzag perm: JAX asserts "
                "'packed segments need the default attention' and 'zigzag "
                "perm is not composable with packed batches' "
                "(llmvox_tpu/models/decoder.py:120-121, 241)")
        share = seq_share(targets.shape[1], emb.device, sp, sp_layout, perm)
        emb = emb[:, share.rows]
        targets, *shifted = (z[:, share.rows] for z in [targets] + shifted)
    cnt = [None] * (1 + n_heads) if counts is None else list(counts)
    kw = dict(generator=generator, train=train, positions=positions,
              segments=segments, tp=tp, share=share, fsdp=fsdp)
    if n_heads == 0:
        logits = apply_decoder(params, emb, cfg, **kw)
        return _masked_ce(logits, targets, cfg.ignore_index, cnt[0])
    logits, hidden = apply_decoder(params, emb, cfg, return_hidden=True,
                                   **kw)
    loss = _masked_ce(logits, targets, cfg.ignore_index, cnt[0])
    heads = (params["draft_heads"] if fsdp is None
             else fsdp.leaf("draft_heads", params["draft_heads"]))
    aux = 0.0
    for j in range(n_heads):
        lj = nn.linear(hidden, heads[j]).float()
        aux = aux + _masked_ce(lj, shifted[j], cfg.ignore_index, cnt[1 + j])
    return loss + MTP_WEIGHT * aux / n_heads


def crop_block_size(params: Dict, cfg: DecoderConfig, new_block: int
                    ) -> Tuple[Dict, DecoderConfig]:
    """Shrink a model's context window: ``wpe`` cropped to ``new_block``
    rows."""
    assert new_block <= cfg.block_size
    params = dict(params)
    params["wpe"] = params["wpe"][:new_block]
    return params, dataclasses.replace(cfg, block_size=new_block)


def _parameter(v, device) -> torch.nn.Parameter:
    t = (v.detach() if isinstance(v, torch.Tensor)
         else torch.from_numpy(np.array(v, np.float32)))
    return torch.nn.Parameter(t.to(device=device, dtype=torch.float32,
                                    copy=True))


class DecoderModel(torch.nn.Module):
    """The trainable decoder.  Its parameters (f32) are the leaves of a
    params tree in the JAX layout (stacked ``h``, Linear ``(Cin, Cout)``);
    ``tree()`` returns that tree of parameters, which ``decoder_loss`` and
    the serving functions (``decode_block``, ``sample_block``) take as
    they take any params tree.  ``tp``: a tensor-parallel group over which
    ``params`` is this rank's shard, ``fsdp`` the FSDP gather of its dp
    shards (``decoder_loss``)."""

    def __init__(self, params: Dict, cfg: DecoderConfig, device="cpu",
                 tp=None, fsdp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.fsdp = fsdp
        self.top = torch.nn.ParameterDict(
            {k: _parameter(v, device) for k, v in params.items()
             if k != "h"})
        self.h = torch.nn.ParameterDict(
            {k: _parameter(v, device) for k, v in params["h"].items()})

    def tree(self) -> Dict:
        return {**dict(self.top.items()), "h": dict(self.h.items())}

    def forward(self, emb: torch.Tensor, targets: torch.Tensor, **kw
                ) -> torch.Tensor:
        return decoder_loss(self.tree(), emb, targets, self.cfg, tp=self.tp,
                            fsdp=self.fsdp, **kw)
