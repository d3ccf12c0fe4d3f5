"""Llama-family causal LM: the dense decode subset, in PyTorch.

Counterpart of ``llmvox_tpu/models/llama.py`` with the same names,
parameter tree and numerics: RMSNorm, rotary embeddings (with HF's llama3
frequency rescaling), grouped-query attention against a fixed-capacity KV
cache without repeating the KV heads, and a SwiGLU MLP.  Parameters keep
the JAX layout: ``tok_emb (V, C)``; ``h.{ln1_s, wq, wk, wv, wo, ln2_s,
wgate, wup, wdown}`` stacked on the layer axis, Linear weights
``(Cin, Cout)``; ``lnf_s``; ``head (C, V)`` unless the embeddings are tied.
Linears go through ``ops/nn.py::linear``, so a quantized tree
(``ops/quant.py::quantize_llama_params``) runs as JAX's does, w4 through
kernel K4.

The JAX package computes attention and everything else here in XLA, no
Pallas kernel, so the port computes it with plain torch ops.

As in the speech decoder (``models/decoder.py``), a decode block is a
Python loop whose ``pos`` and token stay in device tensors: nothing in it
reads a value back to the host, so a block is enqueued without a sync and
can be captured in a CUDA graph (``streams/llm.py``).  The caches are
written in place (the JAX state is immutable; here the state passed in is
consumed) and each function returns the state with its new ``pos``.

Ported: ``apply_llama``, ``prefill``, ``prefill_padded`` and the B=1
``decode_block``, dense only.  Mixture-of-experts layers
(``n_experts > 0``), draft heads (``n_draft_heads > 0``) and the pooled and
speculative programs raise, naming ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from llmvox_tpu_torch.ops import nn

_NOT_PORTED = ("LlamaPoolState", "init_llama_pool_state", "prefix_kv",
               "prefill_slots", "prefill_slots_continue",
               "decode_block_pooled", "decode_block_spec_pooled",
               "llama_loss")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The same fields as the JAX ``LlamaConfig``: a checkpoint's meta
    carries them (``streams/llm.py::build_llama_stream``)."""
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8            # GQA; == n_head -> MHA
    n_embd: int = 4096
    intermediate_size: int = 11008
    max_seq_len: int = 4096       # KV-cache capacity
    rope_theta: float = 10000.0
    # llama3-type RoPE scaling (Llama 3.1/3.2 checkpoints): factor 0
    # disables it; otherwise HF's rope_type="llama3" frequency rescaling
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # mixture-of-experts FFN and draft heads: not ported (check_dense)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    moe_group_size: int = 0
    n_draft_heads: int = 0

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    @property
    def q_per_kv(self) -> int:
        assert self.n_head % self.n_kv_head == 0
        return self.n_head // self.n_kv_head


def check_dense(cfg: LlamaConfig) -> None:
    """Raise for the configurations the port does not run yet."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"n_experts={cfg.n_experts}: mixture-of-experts Llama layers "
            "(llmvox_tpu/ops/moe.py) are not ported to llmvox_tpu_torch yet "
            "(ROADMAP queue 1 item 6)")
    if cfg.n_draft_heads > 0:
        raise NotImplementedError(
            f"n_draft_heads={cfg.n_draft_heads}: the Llama draft heads and "
            "speculative decode are not ported to llmvox_tpu_torch yet "
            "(ROADMAP queue 1 item 6)")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"llama.{name} (the pooled, speculative or training programs of "
            "llmvox_tpu/models/llama.py) is not ported to llmvox_tpu_torch "
            "yet (ROADMAP queue 1 item 6)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def attn_window_ladder(max_seq_len: int, min_window: int = 128
                       ) -> Tuple[int, ...]:
    """Power-of-two attention-window buckets (128, 256, ... capacity) for
    the ``attn_len`` of the decode paths: one captured program per rung,
    each reading only its window of the KV cache."""
    ladder = []
    b = min_window
    while b < max_seq_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_seq_len)
    return tuple(ladder)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """LlamaRMSNorm: x / sqrt(mean(x^2) + eps) * scale, stats in f32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _inv_freq(cfg: LlamaConfig, hd: int, device=None) -> torch.Tensor:
    """Rotary inverse frequencies in f32, as JAX computes them, with HF's
    llama3 rescaling when ``rope_scaling_factor`` is set: long-wavelength
    bands divide by the factor, short ones stay, the middle
    interpolates."""
    half = hd // 2
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(half, dtype=torch.float32,
                                                 device=device) * 2.0 / hd))
    if not cfg.rope_scaling_factor:
        return inv
    lo_wav = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    hi_wav = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / inv
    smooth = ((cfg.rope_original_max_position / wavelen
               - cfg.rope_low_freq_factor)
              / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
    interp = ((1.0 - smooth) * inv / cfg.rope_scaling_factor
              + smooth * inv)
    out = torch.where(wavelen > lo_wav, inv / cfg.rope_scaling_factor, inv)
    mid = (wavelen <= lo_wav) & (wavelen >= hi_wav)
    return torch.where(mid, interp, out)


def _rope_tables(positions: torch.Tensor, cfg: LlamaConfig, hd: int):
    """cos and sin of the angles ``positions * inv_freq``, taken in f32 as
    JAX takes them (float64 angles would differ from JAX's at large
    positions), shaped (..., T, 1, hd // 2) to broadcast over heads.  The
    decode paths make them once per step, for every layer."""
    inv_freq = _inv_freq(cfg, hd, positions.device)
    ang = positions.float()[..., None] * inv_freq          # (..., T, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         cfg: LlamaConfig) -> torch.Tensor:
    """HF-convention rotary embedding on (..., T, n_head, head_dim): the
    head dim splits in two contiguous halves, x' = x * cos + [-x2, x1] *
    sin (``_rope_tables``)."""
    return _apply_rope(x, *_rope_tables(positions, cfg, x.shape[-1]))


def _gqa_cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid: torch.Tensor,
                         cfg: LlamaConfig) -> torch.Tensor:
    """Grouped-query attention against a KV cache without repeating the
    KV heads: query head h uses KV head h // q_per_kv (HF repeat_kv's
    layout), so the group axis folds into the product.

    q: (B, T, H, hd); k_cache/v_cache: (B, S, KV, hd); valid: (T, S) or
    (B, T, S) bool.  The scores are exact f32 products of the inputs
    (JAX: ``preferred_element_type=f32``), the softmax is f32, and the
    probabilities take q's dtype for the value product.  Returns
    (B, T, H, hd)."""
    b, t, h, hd = q.shape
    kv, g = cfg.n_kv_head, cfg.q_per_kv
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    # the group folds into the query rows, (B, KV, g*T, hd), so the KV
    # views below are multiplied as they lie in the cache, not copied per
    # group
    qg = q.reshape(b, t, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kv, g * t, hd)
    kt = k_cache.permute(0, 2, 3, 1)                       # (B, KV, hd, S)
    logits = torch.matmul(qg.float(), kt.float()) * scale
    logits = logits.view(b, kv, g, t, s)
    if valid.dim() == 2:
        valid = valid[None]
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype).view(b, kv, g * t, s)
    att = torch.matmul(w, v_cache.permute(0, 2, 1, 3))     # (B, KV, g*T, hd)
    return att.view(b, kv, g, t, hd).permute(0, 3, 1, 2, 4).reshape(
        b, t, h, hd)


def _mlp(lp: Dict, h: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU: wdown(silu(wgate h) * wup h), the silu in f32."""
    gate = nn.linear(h, lp["wgate"])
    up = nn.linear(h, lp["wup"])
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return nn.linear(act, lp["wdown"])


def _layer_params(params: Dict, layer: int) -> Dict:
    return {k: v[layer] for k, v in params["h"].items()}


def _head(params: Dict):
    head = params.get("head")
    return params["tok_emb"].t() if head is None else head


def apply_llama(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: (B, T) int -> (B, T, V) logits."""
    check_dense(cfg)
    b, t = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :]
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    cos, sin = _rope_tables(positions, cfg, hd)
    x = params["tok_emb"][tokens]
    for layer in range(cfg.n_layer):
        lp = _layer_params(params, layer)
        h = rms_norm(x, lp["ln1_s"], cfg.rms_eps)
        q = nn.linear(h, lp["wq"]).reshape(b, t, cfg.n_head, hd)
        k = nn.linear(h, lp["wk"]).reshape(b, t, cfg.n_kv_head, hd)
        v = nn.linear(h, lp["wv"]).reshape(b, t, cfg.n_kv_head, hd)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        att = _gqa_cache_attention(q, k, v, causal, cfg)
        x = x + nn.linear(att.reshape(b, t, cfg.n_head * hd), lp["wo"])
        h = rms_norm(x, lp["ln2_s"], cfg.rms_eps)
        x = x + _mlp(lp, h)
    x = rms_norm(x, params["lnf_s"], cfg.rms_eps)
    return nn.linear(x, _head(params))


class LlamaDecodeState(NamedTuple):
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor      # 0-d int32: tokens cached so far


def init_llama_decode_state(cfg: LlamaConfig, batch: int = 1,
                            dtype=torch.float32, device="cpu"
                            ) -> LlamaDecodeState:
    shape = (cfg.n_layer, batch, cfg.max_seq_len, cfg.n_kv_head,
             cfg.head_dim)
    return LlamaDecodeState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


class _StepTables(NamedTuple):
    """What every layer of one step shares: the rotary cos and sin, the
    cache rows the new tokens write, and the attention mask."""
    cos: torch.Tensor
    sin: torch.Tensor
    rows: torch.Tensor
    valid: torch.Tensor


def _step_tables(pos: torch.Tensor, t: int, s_cap: int,
                 attn_len: Optional[int], cfg: LlamaConfig,
                 device) -> _StepTables:
    """For T new tokens at positions pos..pos+T-1 of a cache of ``s_cap``
    rows: their rows, from a start clamped to s_cap - T as JAX's
    ``dynamic_update_slice`` clamps it; key j valid for query i iff
    j <= pos + i, over the first ``attn_len`` rows (a Python int: exact
    iff pos + T <= attn_len)."""
    steps = torch.arange(t, device=device, dtype=torch.int32)
    cos, sin = _rope_tables((pos + steps)[None, :], cfg, cfg.head_dim)
    rows = (pos.clamp(max=s_cap - t) + steps).long()
    s = s_cap if attn_len is None else min(attn_len, s_cap)
    jpos = torch.arange(s, device=device, dtype=torch.int32)[None, :]
    return _StepTables(cos, sin, rows, jpos <= (pos + steps)[:, None])


def _layer_step(lp: Dict, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, tables: _StepTables,
                cfg: LlamaConfig) -> torch.Tensor:
    """One layer for T new tokens, the cache (B, S, KV, hd) already
    holding the tokens before them: writes their K and V rows in place
    and attends the window ``tables`` describes (``_step_tables``, made
    once a step for every layer).  Returns x."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, lp["ln1_s"], cfg.rms_eps)
    q = nn.linear(h, lp["wq"]).reshape(b, t, cfg.n_head, hd)
    k = nn.linear(h, lp["wk"]).reshape(b, t, cfg.n_kv_head, hd)
    v = nn.linear(h, lp["wv"]).reshape(b, t, cfg.n_kv_head, hd)
    q = _apply_rope(q, tables.cos, tables.sin)
    k = _apply_rope(k, tables.cos, tables.sin)
    k_cache.index_copy_(1, tables.rows, k.to(k_cache.dtype))
    v_cache.index_copy_(1, tables.rows, v.to(v_cache.dtype))
    s = tables.valid.shape[-1]
    att = _gqa_cache_attention(q, k_cache[:, :s], v_cache[:, :s],
                               tables.valid, cfg)
    x = x + nn.linear(att.reshape(b, t, cfg.n_head * hd), lp["wo"])
    h = rms_norm(x, lp["ln2_s"], cfg.rms_eps)
    return x + _mlp(lp, h)


def _layers(params: Dict, tokens: torch.Tensor, state: LlamaDecodeState,
            cfg: LlamaConfig, attn_len: Optional[int] = None
            ) -> torch.Tensor:
    """Every layer over (B, T) new tokens; returns the last hidden x."""
    check_dense(cfg)
    x = params["tok_emb"][tokens]
    tables = _step_tables(state.pos, tokens.shape[1], state.k.shape[2],
                          attn_len, cfg, x.device)
    for layer in range(cfg.n_layer):
        x = _layer_step(_layer_params(params, layer), x, state.k[layer],
                        state.v[layer], tables, cfg)
    return x


def _forward_cached(params: Dict, tokens: torch.Tensor,
                    state: LlamaDecodeState, cfg: LlamaConfig,
                    attn_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """(B, T) new tokens -> (B, V) logits of the last position; cache
    extended.  The final norm and head run on the last position only."""
    x = _layers(params, tokens, state, cfg, attn_len)
    x = rms_norm(x[:, -1], params["lnf_s"], cfg.rms_eps)
    logits = nn.linear(x, _head(params))
    return logits, state._replace(pos=state.pos + tokens.shape[1])


def _filtered_logits(logits: torch.Tensor, temperature: float,
                     top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled f32 logits with top-k, then nucleus (top-p)
    filtering applied (filtered entries -inf), as JAX filters them.
    temperature > 0."""
    logits = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        # HF semantics: keep the smallest prefix of descending-prob tokens
        # whose cumulative probability exceeds top_p (the first token
        # crossing the threshold is kept)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            top_p: float = 1.0, generator: Optional[torch.Generator] = None,
            gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy when temperature == 0, else a draw from the filtered
    distribution: the argmax of the filtered logits plus Gumbel noise
    (``jax.random.categorical``'s method), the noise from ``generator``
    unless ``gumbel`` gives it.  JAX's PRNG draws other numbers, so the
    two agree in distribution, and exactly for the same noise."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _filtered_logits(logits, temperature, top_k, top_p)
    if gumbel is None:
        # -log(-log(u)), u uniform in [tiny, 1), as jax.random.gumbel
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def prefill(params: Dict, tokens: torch.Tensor, state: LlamaDecodeState,
            cfg: LlamaConfig) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """Cache the prompt; returns (last-position logits (B, V), state)."""
    return _forward_cached(params, tokens, state, cfg)


def prefill_padded(params: Dict, tokens: torch.Tensor, valid_len,
                   state: LlamaDecodeState, cfg: LlamaConfig,
                   attn_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """Bucketed prefill: ``tokens`` (B, Tpad) right-padded, the first
    ``valid_len`` (an int or a 0-d device tensor, uniform across the
    batch) positions real.  Pad positions write cache rows >= valid_len,
    which the causal mask hides until decode overwrites them in order.
    Returns the logits at the last valid position and the state with
    ``pos + valid_len``.  JAX computes the head at every position and
    takes that one; the port computes it at that position only.

    ``attn_len``: attention window bound, exact iff pos + Tpad <=
    attn_len (a fresh state may pass ``attn_len=Tpad``)."""
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32,
                                device=tokens.device)
    x = _layers(params, tokens, state, cfg, attn_len)
    last = (valid_len - 1).long().reshape(1)
    x = rms_norm(x.index_select(1, last)[:, 0], params["lnf_s"], cfg.rms_eps)
    logits = nn.linear(x, _head(params))
    return logits, state._replace(pos=state.pos + valid_len)


def decode_block(params: Dict, first_token: torch.Tensor,
                 state: LlamaDecodeState, cfg: LlamaConfig, block: int = 16,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, attn_len: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """Generate ``block`` tokens on the device from ``first_token`` (B,)
    (the token sampled from the prefill's logits).  Returns the tokens
    generated after it, (B, block) int32, and the state.  EOS handling is
    the caller's (``streams/llm.py``).  ``attn_len``: the caller
    guarantees pos + block <= attn_len; None attends the whole cache.
    Sampled blocks draw their noise from ``generator``."""
    tok = first_token
    out = []
    for _ in range(block):
        logits, state = _forward_cached(params, tok[:, None], state, cfg,
                                        attn_len)
        tok = _sample(logits, temperature, top_k, top_p, generator)
        out.append(tok)
    return torch.stack(out, dim=1), state
