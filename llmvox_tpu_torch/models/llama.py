"""Llama-family causal LM in PyTorch: dense and mixture-of-experts
layers, draft heads, the B=1 and pooled decode programs, the pooled
speculative block and the training loss.

Counterpart of ``llmvox_tpu/models/llama.py`` with the same names,
parameter tree and numerics: RMSNorm, rotary embeddings (with HF's llama3
frequency rescaling), grouped-query attention against a fixed-capacity KV
cache without repeating the KV heads, and a SwiGLU MLP, or top-k routed
SwiGLU experts (``ops/moe.py``) when ``n_experts > 0``.  Parameters keep
the JAX layout: ``tok_emb (V, C)``; ``h.{ln1_s, wq, wk, wv, wo, ln2_s,
wgate, wup, wdown}`` (or ``h.{router (C, E), moe_wgate, moe_wup (E, C,
I), moe_wdown (E, I, C)}``) stacked on the layer axis, Linear weights
``(Cin, Cout)``; ``lnf_s``; ``head (C, V)`` unless the embeddings are
tied; ``draft_heads (n, C, V)`` when the checkpoint has them.  Linears go
through ``ops/nn.py::linear``, so a quantized tree
(``ops/quant.py::quantize_llama_params``) runs as JAX's does, w4 through
kernel K4 (the experts too, ``ops/moe.py::expert_matmul``).

The JAX package computes attention and everything else here in XLA, no
Pallas kernel, so the port computes it with plain torch ops.  Every
inference path routes its experts drop-free, with padding and inactive
rows masked out of routing, as JAX's do.

As in the speech decoder (``models/decoder.py``), a decode block is a
Python loop whose ``pos`` and token stay in device tensors: nothing in it
reads a value back to the host, so a block is enqueued without a sync and
can be captured in a CUDA graph (``streams/llm.py``).  The caches are
written in place (the JAX state is immutable; here the state passed in is
consumed) and each function returns the state with its new ``pos``.  The
speculative block's ``lax.while_loop`` is a start and an iteration over
buffers updated in place (``SpecBuffers``), issued by
``models/spec.py::run_spec_loop`` one iteration ahead of the card.

The pooled programs differ from JAX's in work, not in results:
- JAX sends an arrival batch's padding rows to slot index ``capacity``
  and XLA drops those writes (``mode="drop"``).  Torch has no such
  scatter: an index out of bounds is a device-side assert, and padding
  rows sent to a real slot would race the arrival that lands there.
  Here each row writes its slot in turn, and a padding row writes back
  what is there, so it changes nothing.
- JAX computes the head at every prefill position and takes the last
  valid one; the port computes it at the gathered last positions only.
- JAX's continuation gathers each slot's first ``attn_len`` rows, runs
  the chunk on that copy and scatters the whole window back; the port
  writes back the chunk's rows only (the rest of the window is
  unchanged).
- JAX's draft logits are one f32 einsum over every head and the whole
  vocab; the port takes the same f32 products per head and vocab chunk
  (``_draft_logits``), so bf16 heads are not copied whole to f32.
- The speculative block issues one iteration more than JAX's loop runs
  (``run_spec_loop``); it is masked and commits nothing.

Tensor parallelism: ``apply_llama``, the B=1 ``prefill`` /
``prefill_padded`` / ``decode_block`` and the pooled ``prefix_kv`` /
``prefill_slots`` / ``decode_block_pooled`` take ``tp``, a process group
over which ``params`` is this rank's Megatron shard
(``parallel/sharding.py::shard_llama``, JAX's ``llama_param_shardings``):
its contiguous blocks of n_head/tp query heads and n_kv_head/tp KV heads
(so each query head's KV head is on its rank), of the MLP's or each
expert's hidden columns, and the matching rows of ``wo`` and ``wdown``,
whose products are summed over the group (``parallel/
tensor_parallel.py``); norms, embeddings and the head are whole on every
rank.  The caches (``init_llama_decode_state`` / ``init_llama_pool_state``
with ``tp``) hold the local KV heads, which is how tp cuts a card's KV
bytes.  Every rank of a group holds the same logits, so greedy tokens
agree, and sampled ones do where the ranks' generators are seeded alike.
The head counts a function uses are read from the weights' and caches'
shapes.  ``prefill_slots_continue`` and the speculative pooled block
take ``tp`` too.

Expert parallelism: every function that takes ``tp`` takes ``ep``, a
group over which a mixture-of-experts tree holds this rank's contiguous
block of E/ep experts (``shard_llama(..., ep=)``, JAX's
``P(None, "ep", None, "tp")``); the tokens are the same on every rank of
it, each rank runs its experts' share of the slots and the outputs are
summed over the group (``ops/moe.py::moe_ffn``).  ``apply_llama`` and
``llama_loss`` also take ``fsdp`` (``parallel/sharding.py::llama_fsdp``:
the leaves are dp shards, gathered where the forward uses them, and the
batch's rows are split over the same group, the experts routing the
whole batch as one, as GSPMD keeps it).  The pipeline over layers is
``models/llama_pp.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from llmvox_tpu_torch.models.spec import run_spec_loop
from llmvox_tpu_torch.ops import moe, nn
from llmvox_tpu_torch.parallel import tensor_parallel as tpar


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
    # mixture-of-experts FFN (ops/moe.py): n_experts > 0 replaces the dense
    # SwiGLU with top-k routed experts
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    moe_group_size: int = 0
    # speculative decoding: head j predicts the token at t+2+j from
    # position t's final (post-norm) hidden state
    n_draft_heads: int = 0

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    @property
    def q_per_kv(self) -> int:
        assert self.n_head % self.n_kv_head == 0
        return self.n_head // self.n_kv_head


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

    q: (B, T, H, hd); k_cache/v_cache: (B, S, KV, hd), H a multiple of KV
    (a tensor-parallel rank's heads are a block of each); valid: (T, S)
    or (B, T, S) bool.  The scores are exact f32 products of the inputs
    (JAX: ``preferred_element_type=f32``), the softmax is f32, and the
    probabilities take q's dtype for the value product.  Returns
    (B, T, H, hd)."""
    b, t, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
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
    vt = v_cache.permute(0, 2, 1, 3)
    if vt.dtype != w.dtype:
        # a cache in another dtype than the activations (the pool's f32
        # cache under bf16 params): JAX's einsum promotes both
        rt = torch.promote_types(w.dtype, vt.dtype)
        w, vt = w.to(rt), vt.to(rt)
    att = torch.matmul(w, vt)                              # (B, KV, g*T, hd)
    return att.view(b, kv, g, t, hd).permute(0, 3, 1, 2, 4).reshape(
        b, t, h, hd)


def _mlp(lp: Dict, h: torch.Tensor, cfg: LlamaConfig,
         token_mask: Optional[torch.Tensor] = None,
         drop_free: bool = False, tp=None, ep=None, dp=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN half of a layer: the dense SwiGLU wdown(silu(wgate h) *
    wup h), the silu in f32, or top-k routed experts when
    ``cfg.n_experts > 0`` (``ops/moe.py::moe_ffn``).  Returns ``(out,
    aux)``: aux is the experts' load-balancing statistic (None for the
    dense FFN).  ``token_mask`` (bool, h's shape without the channel
    axis) marks the real tokens: padding and inactive rows are kept out
    of routing.  ``drop_free`` (every inference path) gives the experts
    room for every token, so no token drops.  ``tp``: the group over which
    the hidden columns are split (the products summed over it); ``ep``:
    the group over which the experts are split; ``dp``: the group over
    which the batch's rows are split, whose tokens route as one batch."""
    if cfg.n_experts:
        return moe.moe_ffn(h, lp["router"], lp["moe_wgate"], lp["moe_wup"],
                           lp["moe_wdown"], cfg.moe_top_k,
                           cfg.moe_capacity_factor, token_mask=token_mask,
                           group_size=cfg.moe_group_size,
                           drop_free=drop_free, tp_group=tp, ep_group=ep,
                           dp_group=dp)
    h = tpar.copy_to_tp(h, tp)
    gate = nn.linear(h, lp["wgate"])
    up = nn.linear(h, lp["wup"])
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return tpar.reduce_from_tp(nn.linear(act, lp["wdown"]), tp), None


def _attention_in(lp: Dict, x: torch.Tensor, cfg: LlamaConfig, cos, sin,
                  tp) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The normed x's rotated q (B, T, H, hd) and k and v (B, T, KV, hd),
    H and KV this rank's heads under ``tp``."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = tpar.copy_to_tp(rms_norm(x, lp["ln1_s"], cfg.rms_eps), tp)
    q = nn.linear(h, lp["wq"]).reshape(b, t, -1, hd)
    k = nn.linear(h, lp["wk"]).reshape(b, t, -1, hd)
    v = nn.linear(h, lp["wv"]).reshape(b, t, -1, hd)
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def _attention_out(lp: Dict, att: torch.Tensor, tp) -> torch.Tensor:
    """``wo`` over the (B, T, H, hd) attention, summed over ``tp``."""
    b, t = att.shape[:2]
    return tpar.reduce_from_tp(nn.linear(att.reshape(b, t, -1), lp["wo"]),
                               tp)


def local_kv_heads(cfg: LlamaConfig, tp=None) -> int:
    """The KV heads a rank of ``tp`` holds (all of them without one)."""
    n = tpar.size(tp)
    if cfg.n_kv_head % n or cfg.n_head % n:
        raise ValueError(f"n_head={cfg.n_head}, n_kv_head={cfg.n_kv_head} "
                         f"do not split over tp={n}")
    return cfg.n_kv_head // n


def _layer_params(params: Dict, layer: int) -> Dict:
    return {k: v[layer] for k, v in params["h"].items()}


def _head(params: Dict, fsdp=None):
    head = params.get("head")
    if head is None:
        return _leaf(params, "tok_emb", fsdp).t()
    return _leaf(params, "head", fsdp)


def _leaf(params: Dict, name: str, fsdp=None) -> torch.Tensor:
    """A top-level leaf, gathered over dp under ``fsdp``."""
    return params[name] if fsdp is None else fsdp.leaf(name, params[name])


def _dp_group(fsdp):
    """The group of the batch's rows: FSDP's (every rank when its group
    is None), None without FSDP."""
    if fsdp is None:
        return None
    return fsdp.group if fsdp.group is not None else dist.group.WORLD


def apply_llama(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False, return_moe_aux: bool = False,
                tp=None, ep=None, fsdp=None):
    """Teacher-forced forward: (B, T) int -> (B, T, V) logits.
    ``return_hidden=True`` also returns the post-final-norm hidden states
    (the draft heads' input); ``return_moe_aux=True`` appends the mean
    over layers of the experts' load-balancing statistic (0 for a dense
    config).  The experts route as JAX's training forward routes them:
    at ``moe_capacity_factor``, in ``moe_group_size`` groups, tokens
    past an expert's capacity dropped for it.  ``tp`` / ``ep``: the
    groups over which ``params`` is this rank's shard (the module's
    docstring).  ``fsdp``: the leaves are this rank's dp shards and
    ``tokens`` this rank's block of rows of a batch split over the same
    group, the experts routing the whole batch."""
    b, t = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    dp = _dp_group(fsdp)
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :]
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    cos, sin = _rope_tables(positions, cfg, hd)
    x = _leaf(params, "tok_emb", fsdp)[tokens]
    auxs = []
    for layer in range(cfg.n_layer):
        lp = _layer_params(params, layer)
        if fsdp is not None:
            lp = fsdp.layer(lp)
        q, k, v = _attention_in(lp, x, cfg, cos, sin, tp)
        att = _gqa_cache_attention(q, k, v, causal, cfg)
        x = x + _attention_out(lp, att, tp)
        h = rms_norm(x, lp["ln2_s"], cfg.rms_eps)
        y, aux = _mlp(lp, h, cfg, tp=tp, ep=ep, dp=dp)
        x = x + y
        auxs.append(aux)
    x = rms_norm(x, params["lnf_s"], cfg.rms_eps)
    logits = nn.linear(x, _head(params, fsdp))
    out = (logits,)
    if return_hidden:
        out = out + (x,)
    if return_moe_aux:
        out = out + (torch.stack(auxs).mean() if cfg.n_experts
                     else torch.zeros((), device=x.device),)
    return out if len(out) > 1 else logits


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def llama_loss(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
               mtp_weight: float = 0.2, ep=None,
               fsdp=None) -> torch.Tensor:
    """Next-token cross-entropy over ``tokens`` (B, T): position t's
    hidden predicts tokens[t+1].  With draft heads in ``params`` it adds
    the multi-token-prediction terms: head j predicts tokens[t+2+j] from
    the same hidden state (the shift ``decode_block_spec_pooled``
    consumes), their mean weighted by ``mtp_weight``.  A
    mixture-of-experts config adds its load-balancing statistic (the mean
    over layers) weighted by ``cfg.moe_aux_weight``.  A forward function:
    autograd differentiates it (JAX has no Llama trainer; a step composes
    it with ``train/optim.py::AdamW``).

    ``ep`` / ``fsdp``: as ``apply_llama``.  Under ``fsdp`` ``tokens``
    are this rank's equal block of the batch's rows and the loss is this
    rank's share: its terms over the whole batch's count, and 1/dp of the
    aux term (whole on every rank) in value with the whole term's
    gradient (its statistics' all-reduce passes the gradient to each
    rank's own tokens only), so the shares and their gradients, summed
    over the ranks, are the batch's."""
    n_dp = tpar.size(_dp_group(fsdp))
    heads = params.get("draft_heads")
    logits, hidden, moe_aux = apply_llama(params, tokens[:, :-1], cfg,
                                          return_hidden=True,
                                          return_moe_aux=True, ep=ep,
                                          fsdp=fsdp)
    aux_term = cfg.moe_aux_weight * moe_aux
    if n_dp > 1:
        aux_term = aux_term - aux_term.detach() * (n_dp - 1) / n_dp
    loss = _ce(logits, tokens[:, 1:]) / n_dp + aux_term
    if heads is None:
        return loss
    if fsdp is not None:
        heads = fsdp.leaf("draft_heads", heads)
    n_heads = heads.shape[0]
    aux = 0.0
    for j in range(n_heads):
        shift = j + 2                     # hidden t -> tokens[t + shift]
        t_use = tokens.shape[1] - shift   # positions with a valid target
        if t_use <= 0:
            continue
        lj = nn.linear(hidden[:, :t_use], heads[j])
        aux = aux + _ce(lj, tokens[:, shift:])
    return loss + mtp_weight * aux / n_heads / n_dp


class LlamaDecodeState(NamedTuple):
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor      # 0-d int32: tokens cached so far


def init_llama_decode_state(cfg: LlamaConfig, batch: int = 1,
                            dtype=torch.float32, device="cpu", tp=None
                            ) -> LlamaDecodeState:
    """Zero caches of the KV heads a rank of ``tp`` holds."""
    shape = (cfg.n_layer, batch, cfg.max_seq_len, local_kv_heads(cfg, tp),
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
                cfg: LlamaConfig,
                token_mask: Optional[torch.Tensor] = None,
                tp=None, ep=None) -> torch.Tensor:
    """One layer for T new tokens, the cache (B, S, KV, hd) already
    holding the tokens before them: writes their K and V rows in place
    and attends the window ``tables`` describes (``_step_tables``, made
    once a step for every layer).  ``token_mask`` (B, T) marks the real
    tokens for expert routing.  Returns x."""
    q, k, v = _attention_in(lp, x, cfg, tables.cos, tables.sin, tp)
    k_cache.index_copy_(1, tables.rows, k.to(k_cache.dtype))
    v_cache.index_copy_(1, tables.rows, v.to(v_cache.dtype))
    s = tables.valid.shape[-1]
    att = _gqa_cache_attention(q, k_cache[:, :s], v_cache[:, :s],
                               tables.valid, cfg)
    x = x + _attention_out(lp, att, tp)
    h = rms_norm(x, lp["ln2_s"], cfg.rms_eps)
    return x + _mlp(lp, h, cfg, token_mask, drop_free=True, tp=tp, ep=ep)[0]


def _layers(params: Dict, tokens: torch.Tensor, state: LlamaDecodeState,
            cfg: LlamaConfig, attn_len: Optional[int] = None,
            token_mask: Optional[torch.Tensor] = None,
            tp=None, ep=None) -> torch.Tensor:
    """Every layer over (B, T) new tokens; returns the last hidden x."""
    x = params["tok_emb"][tokens]
    tables = _step_tables(state.pos, tokens.shape[1], state.k.shape[2],
                          attn_len, cfg, x.device)
    for layer in range(cfg.n_layer):
        x = _layer_step(_layer_params(params, layer), x, state.k[layer],
                        state.v[layer], tables, cfg, token_mask, tp, ep)
    return x


def _forward_cached(params: Dict, tokens: torch.Tensor,
                    state: LlamaDecodeState, cfg: LlamaConfig,
                    attn_len: Optional[int] = None, tp=None, ep=None
                    ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """(B, T) new tokens -> (B, V) logits of the last position; cache
    extended.  The final norm and head run on the last position only."""
    x = _layers(params, tokens, state, cfg, attn_len, tp=tp, ep=ep)
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
        gumbel = _gumbel(logits, generator)
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def _gumbel(logits: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel noise of ``logits``' shape: -log(-log(u)), u uniform in
    [tiny, 1), as ``jax.random.gumbel`` draws it."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny)))


def prefill(params: Dict, tokens: torch.Tensor, state: LlamaDecodeState,
            cfg: LlamaConfig, tp=None, ep=None
            ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """Cache the prompt; returns (last-position logits (B, V), state)."""
    return _forward_cached(params, tokens, state, cfg, tp=tp, ep=ep)


def prefill_padded(params: Dict, tokens: torch.Tensor, valid_len,
                   state: LlamaDecodeState, cfg: LlamaConfig,
                   attn_len: Optional[int] = None, tp=None, ep=None
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
    valid_mask = (torch.arange(tokens.shape[1], device=tokens.device)
                  < valid_len).expand(tokens.shape)
    x = _layers(params, tokens, state, cfg, attn_len, valid_mask, tp, ep)
    last = (valid_len - 1).long().reshape(1)
    x = rms_norm(x.index_select(1, last)[:, 0], params["lnf_s"], cfg.rms_eps)
    logits = nn.linear(x, _head(params))
    return logits, state._replace(pos=state.pos + valid_len)


def decode_block(params: Dict, first_token: torch.Tensor,
                 state: LlamaDecodeState, cfg: LlamaConfig, block: int = 16,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, attn_len: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, tp=None,
                 ep=None) -> Tuple[torch.Tensor, LlamaDecodeState]:
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
                                        attn_len, tp, ep)
        tok = _sample(logits, temperature, top_k, top_p, generator)
        out.append(tok)
    return torch.stack(out, dim=1), state


# ---------------------------------------------------------------------------
# Per-row sampling: every pooled row carries its own (temperature, top_k,
# top_p), so one captured program serves any mix of request configs.
# ---------------------------------------------------------------------------


def _filtered_logits_rows(logits: torch.Tensor, t: torch.Tensor,
                          k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row-vectorized ``_filtered_logits``: ``logits`` (..., B, V),
    ``t``/``k``/``p`` (B,).  Rows with t <= 0 are clamped to a temperature
    so small that the filtered distribution is one-hot at the argmax.
    k <= 0 or k >= V disables top-k for that row; p outside (0, 1)
    disables top-p, as the static path skips them."""
    v = logits.shape[-1]
    dev = logits.device
    t = t.float().clamp_min(1e-6)
    x = logits.float() / t[..., None]
    kk = torch.where((k > 0) & (k < v), k,
                     torch.full_like(k, v)).long()
    srt = torch.sort(x, dim=-1).values                        # ascending
    kth = torch.gather(srt, -1, (v - kk)[..., None].expand(
        *srt.shape[:-1], 1))                                  # (..., B, 1)
    x = x.masked_fill(x < kth, float("-inf"))
    # nucleus on the already top-k-filtered rows (the static path's order)
    desc = srt.flip(-1)
    desc = desc.masked_fill(torch.arange(v, device=dev) >= kk[..., None],
                            float("-inf"))
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p.float()[..., None]
    cutoff = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
    cutoff = cutoff.masked_fill(~((p > 0.0) & (p < 1.0))[..., None],
                                float("-inf"))
    return x.masked_fill(x < cutoff, float("-inf"))


def _sample_rows(logits: torch.Tensor, t: torch.Tensor, k: torch.Tensor,
                 p: torch.Tensor, generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-vectorized ``_sample``: a Gumbel-max draw from each row's
    filtered distribution (noise from ``generator`` unless ``gumbel``
    gives it); greedy rows (t <= 0) take the argmax exactly."""
    filt = _filtered_logits_rows(logits, t, k, p)
    if gumbel is None:
        gumbel = _gumbel(filt, generator)
    out = torch.argmax(filt + gumbel, dim=-1).to(torch.int32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(t <= 0.0, greedy, out)


def _sample_maybe_rows(logits, temperature, top_k, top_p, rows,
                       generator=None, gumbel=None):
    """``rows`` (t, k, p) vectors override the static scalars when set."""
    if rows is None:
        return _sample(logits, temperature, top_k, top_p, generator, gumbel)
    return _sample_rows(logits, *rows, generator=generator, gumbel=gumbel)


# ---------------------------------------------------------------------------
# Pooled continuous-batching decode (serve/llm_pool.py): one batched state
# with per-row positions, so every in-flight request advances in one
# program per block.
# ---------------------------------------------------------------------------


class LlamaPoolState(NamedTuple):
    """Batched decode state with per-row progress: every row has its own
    ``pos``, and ``tok`` carries each row's last sampled token on the
    device, so a block takes no token from the host."""
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor      # (B,) int32: tokens cached per row
    tok: torch.Tensor      # (B,) int32: last sampled token per row


def init_llama_pool_state(cfg: LlamaConfig, batch: int,
                          dtype=torch.float32, device="cpu", tp=None
                          ) -> LlamaPoolState:
    """Zero caches of the KV heads a rank of ``tp`` holds."""
    shape = (cfg.n_layer, batch, cfg.max_seq_len, local_kv_heads(cfg, tp),
             cfg.head_dim)
    return LlamaPoolState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def _row_tables(pos_vec: torch.Tensor, t: int, s_cap: int,
                attn_len: Optional[int], cfg: LlamaConfig,
                device) -> _StepTables:
    """``_step_tables`` with a position per row: row b's T new tokens sit
    at pos_vec[b]..pos_vec[b]+T-1 and write the cache rows from a start
    clamped to s_cap - T (JAX's vmapped ``dynamic_update_slice`` clamps
    it), (B, T); key j is valid for row b's query i iff
    j <= pos_vec[b] + i, (B, T, S)."""
    steps = torch.arange(t, device=device, dtype=torch.int32)
    positions = pos_vec[:, None] + steps[None, :]              # (B, T)
    cos, sin = _rope_tables(positions, cfg, cfg.head_dim)
    rows = (pos_vec.clamp(0, s_cap - t)[:, None] + steps[None]).long()
    s = s_cap if attn_len is None else min(attn_len, s_cap)
    jpos = torch.arange(s, device=device, dtype=torch.int32)
    return _StepTables(cos, sin, rows,
                       jpos[None, None, :] <= positions[:, :, None])


def _layer_step_rows(lp: Dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, tables: _StepTables,
                     cfg: LlamaConfig,
                     token_mask: Optional[torch.Tensor] = None, tp=None,
                     ep=None) -> torch.Tensor:
    """One layer for T new tokens per row, each row at its own position
    (``_row_tables``): writes their K and V rows of the cache (B, S, KV,
    hd) in place, attends the window with the per-row causal mask, and
    returns x.  The attention takes x's dtype back when the cache has
    another (the residual stream keeps x's dtype).  ``token_mask`` (B, T)
    marks the real tokens for expert routing."""
    b, t, _ = x.shape
    q, k, v = _attention_in(lp, x, cfg, tables.cos, tables.sin, tp)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, t)
    k_cache.index_put_((bidx, tables.rows), k.to(k_cache.dtype))
    v_cache.index_put_((bidx, tables.rows), v.to(v_cache.dtype))
    s = tables.valid.shape[-1]
    att = _gqa_cache_attention(q, k_cache[:, :s], v_cache[:, :s],
                               tables.valid, cfg).to(x.dtype)
    x = x + _attention_out(lp, att, tp)
    h = rms_norm(x, lp["ln2_s"], cfg.rms_eps)
    return x + _mlp(lp, h, cfg, token_mask, drop_free=True, tp=tp, ep=ep)[0]


def _scan_layers_rows(params: Dict, tokens: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, pos_vec: torch.Tensor,
                      cfg: LlamaConfig, attn_len: Optional[int] = None,
                      token_mask: Optional[torch.Tensor] = None, tp=None,
                      ep=None) -> torch.Tensor:
    """Every layer over (B, T) new tokens at per-row positions, the caches
    k/v (L, B, S, KV, hd) written in place; returns the last hidden x.
    ``token_mask`` (B, T) marks the real tokens for expert routing."""
    x = params["tok_emb"][tokens]
    tables = _row_tables(pos_vec, tokens.shape[1], k.shape[2], attn_len,
                         cfg, x.device)
    for layer in range(cfg.n_layer):
        x = _layer_step_rows(_layer_params(params, layer), x, k[layer],
                             v[layer], tables, cfg, token_mask, tp, ep)
    return x


def _head_rows(params: Dict, x: torch.Tensor, valid_lens: torch.Tensor,
               cfg: LlamaConfig) -> torch.Tensor:
    """The final norm and the head at each row's last valid position of x
    (N, T, C): (N, V) logits.  (JAX computes the head at every position
    and takes that one.)"""
    last = (valid_lens.long() - 1).clamp_min(0)
    x = x[torch.arange(x.shape[0], device=x.device), last]
    return nn.linear(rms_norm(x, params["lnf_s"], cfg.rms_eps),
                     _head(params))


def _write_slot_rows(cache: torch.Tensor, slots: torch.Tensor,
                     active: torch.Tensor, new: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> None:
    """Row n of ``new`` into slot ``slots[n]`` of ``cache`` (B, S, ...),
    at cache rows ``rows[n]`` ((N, T); None: the first new.shape[1] rows),
    where ``active[n]``.  The rows write in turn, and an inactive one
    writes back what its slot holds, so it changes nothing, whichever
    slot it names (the counterpart of JAX's dropped scatter)."""
    for n in range(new.shape[0]):
        s = slots[n:n + 1]
        if rows is None:
            view = cache[:, :new.shape[1]]
            old = view.index_select(0, s)
            view.index_copy_(0, s, torch.where(active[n], new[n:n + 1], old))
        else:
            idx = (s.expand_as(rows[n]), rows[n])
            cache.index_put_(idx, torch.where(active[n], new[n],
                                              cache[idx]))


def _write_slot_values(vec: torch.Tensor, slots: torch.Tensor,
                       active: torch.Tensor, values: torch.Tensor
                       ) -> torch.Tensor:
    """A copy of the per-slot vector ``vec`` (B,) with ``values[n]`` at
    ``slots[n]`` where ``active[n]`` (``_write_slot_rows``' rule)."""
    vec = vec.clone()
    for n in range(values.shape[0]):
        s = slots[n:n + 1]
        vec.index_copy_(0, s, torch.where(active[n], values[n:n + 1].to(
            vec.dtype), vec.index_select(0, s)))
    return vec


def prefix_kv(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
              tp=None, ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced KV rows of a shared prompt prefix: ``tokens`` (1, P)
    -> (k, v) each (L, P, KV, hd), in the params' dtype.  Computed once,
    they seed every slot whose prompt starts with the prefix
    (``prefill_slots``).  Under ``tp``, this rank's KV heads."""
    p = tokens.shape[1]
    shape = (cfg.n_layer, 1, p, local_kv_heads(cfg, tp), cfg.head_dim)
    dtype, dev = params["tok_emb"].dtype, tokens.device
    k = torch.zeros(shape, dtype=dtype, device=dev)
    v = torch.zeros(shape, dtype=dtype, device=dev)
    _scan_layers_rows(params, tokens, k, v,
                      torch.zeros((1,), dtype=torch.int32, device=dev), cfg,
                      tp=tp, ep=ep)
    return k[:, 0], v[:, 0]


def prefill_slots(params: Dict, tokens: torch.Tensor,
                  valid_lens: torch.Tensor, state: LlamaPoolState,
                  slots: torch.Tensor, active: torch.Tensor,
                  cfg: LlamaConfig, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  prefix_k: Optional[torch.Tensor] = None,
                  prefix_v: Optional[torch.Tensor] = None,
                  rows: Optional[Tuple] = None,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None, tp=None, ep=None
                  ) -> Tuple[torch.Tensor, LlamaPoolState]:
    """Prefill N mixed-length prompts into pool slots in one program.

    ``tokens`` (N, Tpad) right-padded, ``valid_lens`` (N,).  Row n runs on
    a fresh cache of its own (the prefix rows first when given), and its
    rows 0..P+Tpad-1 land in slot ``slots[n]`` of ``state``; its first
    token is sampled at its last valid position, returned (N,) int32 and
    stored in the slot's ``tok``, and the slot's ``pos`` becomes
    ``P + valid_lens[n]``.  Rows with ``active[n]`` False are padding of
    the arrival batch and write nothing (``_write_slot_rows``).

    With ``prefix_k``/``prefix_v`` ((L, P, KV, hd), ``prefix_kv``) the
    tokens are the suffix after a shared P-token prefix: rows start at
    position P and attend the prefix rows.  The caches are written in
    place; the returned state has the new ``pos`` and ``tok``."""
    n, tpad = tokens.shape
    dev = tokens.device
    p = 0 if prefix_k is None else prefix_k.shape[1]
    cap, s_cap = state.k.shape[1], state.k.shape[2]
    dtype = state.k.dtype
    width = min(p + tpad, s_cap)
    valid_lens = valid_lens.to(torch.int32)
    act = active.bool()
    slot_ids = slots.long().clamp(0, cap - 1)
    tok_mask = ((torch.arange(tpad, device=dev)[None] < valid_lens[:, None])
                & act[:, None])
    x = params["tok_emb"][tokens]
    tables = _row_tables(torch.full((n,), p, dtype=torch.int32, device=dev),
                         tpad, p + tpad, None, cfg, dev)
    shape = (n, p + tpad, state.k.shape[3], cfg.head_dim)
    for layer in range(cfg.n_layer):
        kc = torch.zeros(shape, dtype=dtype, device=dev)
        vc = torch.zeros(shape, dtype=dtype, device=dev)
        if p:
            kc[:, :p] = prefix_k[layer].to(dtype)
            vc[:, :p] = prefix_v[layer].to(dtype)
        x = _layer_step_rows(_layer_params(params, layer), x, kc, vc,
                             tables, cfg, tok_mask, tp, ep)
        _write_slot_rows(state.k[layer], slot_ids, act, kc[:, :width])
        _write_slot_rows(state.v[layer], slot_ids, act, vc[:, :width])
    logits = _head_rows(params, x, valid_lens, cfg)
    first = _sample_maybe_rows(logits, temperature, top_k, top_p, rows,
                               generator, gumbel)
    return first, state._replace(
        pos=_write_slot_values(state.pos, slot_ids, act, p + valid_lens),
        tok=_write_slot_values(state.tok, slot_ids, act, first))


def prefill_slots_continue(params: Dict, tokens: torch.Tensor,
                           valid_lens: torch.Tensor, state: LlamaPoolState,
                           slots: torch.Tensor, active: torch.Tensor,
                           pos0: torch.Tensor, cfg: LlamaConfig,
                           final: bool = True, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 1.0,
                           attn_len: Optional[int] = None,
                           rows: Optional[Tuple] = None,
                           generator: Optional[torch.Generator] = None,
                           gumbel: Optional[torch.Tensor] = None, tp=None,
                           ep=None) -> Tuple[torch.Tensor, LlamaPoolState]:
    """Continue a chunked prefill: ``tokens`` (N, Tpad) extend prompts
    already cached, row n's slot holding ``pos0[n]`` tokens; the chunk
    lands at pos0..pos0+Tpad-1.  Each row runs on a copy of its slot's
    first ``attn_len`` rows (the chunk written into it at the clamped
    offset, as JAX writes it), so its queries attend the whole cached
    prompt in one softmax; then the chunk's rows alone are written back,
    for active rows (``_write_slot_rows``).  The caller guarantees
    pos0 + Tpad <= attn_len.

    ``final=False`` (middle chunks) skips the head and returns zeros;
    ``final=True`` samples each row's first token at its last valid
    position and stores it in the slot's ``tok``.  ``tp`` / ``ep``: as
    ``prefill_slots``."""
    n, tpad = tokens.shape
    dev = tokens.device
    cap, s = state.k.shape[1], state.k.shape[2]
    if attn_len is not None and attn_len < s:
        s = attn_len
    valid_lens = valid_lens.to(torch.int32)
    act = active.bool()
    slot_ids = slots.long().clamp(0, cap - 1)
    pos0 = pos0.to(torch.int32)
    tok_mask = ((torch.arange(tpad, device=dev)[None] < valid_lens[:, None])
                & act[:, None])
    x = params["tok_emb"][tokens]
    tables = _row_tables(pos0, tpad, s, None, cfg, dev)
    ridx = torch.arange(n, device=dev)[:, None]
    for layer in range(cfg.n_layer):
        kc = state.k[layer][:, :s].index_select(0, slot_ids)
        vc = state.v[layer][:, :s].index_select(0, slot_ids)
        x = _layer_step_rows(_layer_params(params, layer), x, kc, vc,
                             tables, cfg, tok_mask, tp, ep)
        _write_slot_rows(state.k[layer], slot_ids, act,
                         kc[ridx, tables.rows], tables.rows)
        _write_slot_rows(state.v[layer], slot_ids, act,
                         vc[ridx, tables.rows], tables.rows)
    pos = _write_slot_values(state.pos, slot_ids, act, pos0 + valid_lens)
    if not final:
        return (torch.zeros((n,), dtype=torch.int32, device=dev),
                state._replace(pos=pos))
    logits = _head_rows(params, x, valid_lens, cfg)
    first = _sample_maybe_rows(logits, temperature, top_k, top_p, rows,
                               generator, gumbel)
    return first, state._replace(
        pos=pos, tok=_write_slot_values(state.tok, slot_ids, act, first))


def decode_block_pooled(params: Dict, state: LlamaPoolState,
                        active: torch.Tensor, cfg: LlamaConfig,
                        block: int = 16, temperature: float = 0.0,
                        top_k: int = 0, top_p: float = 1.0,
                        attn_len: Optional[int] = None,
                        rows: Optional[Tuple] = None,
                        generator: Optional[torch.Generator] = None,
                        gumbel: Optional[torch.Tensor] = None, tp=None,
                        ep=None) -> Tuple[torch.Tensor, LlamaPoolState]:
    """Advance every active row ``block`` tokens in one program.

    Each row continues from its own ``tok`` and ``pos``; inactive rows
    ride along (they write their cache row at their frozen ``pos``, as
    JAX's do, but their ``pos`` and ``tok`` stay).  Returns the (B, block)
    tokens generated after each row's ``tok`` and the state with the new
    ``pos`` and ``tok`` (the caches written in place).  ``attn_len``:
    every active row satisfies pos + block <= attn_len.  Sampled steps
    draw their noise from ``generator``, or step i from ``gumbel[i]``."""
    act = active.bool()
    tok, pos = state.tok, state.pos
    out = []
    for i in range(block):
        x = _scan_layers_rows(params, tok[:, None], state.k, state.v, pos,
                              cfg, attn_len, token_mask=act[:, None], tp=tp,
                              ep=ep)
        logits = nn.linear(rms_norm(x[:, -1], params["lnf_s"], cfg.rms_eps),
                           _head(params))
        nxt = _sample_maybe_rows(logits, temperature, top_k, top_p, rows,
                                 generator,
                                 None if gumbel is None else gumbel[i])
        tok = torch.where(act, nxt, tok)
        pos = pos + act.to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1), state._replace(pos=pos, tok=tok)


# ---------------------------------------------------------------------------
# Pooled speculative decode: B pooled rows advance ``block`` tokens each in
# fewer sequential iterations when the drafts accept.  JAX's
# ``lax.while_loop`` is here a start and an iteration over buffers that
# each updates in place (one CUDA graph each when served), issued by the
# host one iteration ahead of the card (``run_spec_loop``).
# ---------------------------------------------------------------------------

# the vocabulary columns of one f32 draft-logit product (``_draft_logits``)
DRAFT_CHUNK = 8192


def _hidden_logits(params: Dict, x: torch.Tensor, cfg: LlamaConfig):
    """Final norm + lm head on (B, [T,] C) hidden states: (h, logits)."""
    h = rms_norm(x, params["lnf_s"], cfg.rms_eps)
    return h, nn.linear(h, _head(params))


def _draft_logits(hidden: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """The draft heads' f32 logits ``einsum("bc,kcv->bkv", hidden.f32,
    heads.f32)`` (JAX's product) taken per head and per ``DRAFT_CHUNK``
    vocabulary columns, so only one chunk of a bf16 head is in f32 at a
    time (4 heads of Llama-3.1-8B's vocab are 4.2 GB in bf16).  The
    products are JAX's; each dot is summed in f32 in its own order."""
    b, (kd, _, v) = hidden.shape[0], heads.shape
    h32 = hidden.float()
    out = torch.empty((b, kd, v), dtype=torch.float32, device=hidden.device)
    for j in range(kd):
        for v0 in range(0, v, DRAFT_CHUNK):
            v1 = min(v, v0 + DRAFT_CHUNK)
            out[:, j, v0:v1] = h32 @ heads[j, :, v0:v1].float()
    return out


class SpecBuffers(NamedTuple):
    """What a pooled speculative block carries from one iteration to the
    next, beside the pool state: B rows, ``block`` tokens, k drafts."""

    limits: torch.Tensor  # (B,) int32: block for active rows, else 0
    out: torch.Tensor     # (B, block + k + 1) int32: emitted, else -1
    count: torch.Tensor   # (B,) int32: tokens emitted
    iters: torch.Tensor   # (B,) int32: active iterations
    flag: torch.Tensor    # () bool: is any row still active
    dpad: Optional[torch.Tensor]  # (B, block + k + 1): explicit drafts


def spec_buffers(batch: int, block: int, k_draft: int, device,
                 drafts: bool = False) -> SpecBuffers:
    """Buffers of a speculative block; ``drafts`` for explicit drafts
    instead of the draft heads."""
    i32 = dict(dtype=torch.int32, device=device)
    w = block + k_draft + 1
    return SpecBuffers(
        limits=torch.zeros((batch,), **i32),
        out=torch.full((batch, w), -1, **i32),
        count=torch.zeros((batch,), **i32),
        iters=torch.zeros((batch,), **i32),
        flag=torch.zeros((), dtype=torch.bool, device=device),
        dpad=torch.zeros((batch, w), **i32) if drafts else None)


def spec_start(bufs: SpecBuffers, active: torch.Tensor, block: int,
               draft_tokens: Optional[torch.Tensor] = None) -> None:
    """Begin a speculative block of ``block`` tokens in ``bufs``, in place:
    active rows' limit is the block, nothing is emitted, the explicit
    drafts (B, block) are clamped at 0 and padded with zeros, and the flag
    holds whether any row is active before the first iteration."""
    bufs.limits.copy_(torch.where(active.bool(), block, 0))
    if bufs.dpad is not None:
        bufs.dpad[:, :block].copy_(draft_tokens.clamp_min(0))
        bufs.dpad[:, block:].zero_()
    bufs.out.fill_(-1)
    bufs.count.zero_()
    bufs.iters.zero_()
    bufs.flag.copy_((bufs.count < bufs.limits).any())


def spec_iteration(params: Dict, state: LlamaPoolState, bufs: SpecBuffers,
                   cfg: LlamaConfig, k_draft: int,
                   attn_len: Optional[int] = None,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0, rows: Optional[Tuple] = None,
                   generator: Optional[torch.Generator] = None, tp=None,
                   ep=None) -> None:
    """One iteration of JAX's speculative loop body, in place on the
    caches, ``state.pos``/``state.tok`` and ``bufs``.

    Each active row (count < limit) takes ONE step from its last token,
    which also gives the post-norm hidden state the draft heads read;
    then k drafts for the next positions (head j guesses position +2+j,
    or the explicit drafts); then ONE batched teacher-forced verify
    forward over every row's drafts (T = k, per-row positions and causal
    masks).  A row emits the step's token, its accepted draft prefix and
    the verifier's first correction, up to its limit.  Greedy
    (``temperature == 0`` and no ``rows``): a draft is accepted iff it is
    the verifier's argmax.  Sampled: rejection sampling (accept d with
    probability p(d)/q(d), else a correction from norm(max(p - q, 0))),
    so every token has the plain sampler's law; per-row ``rows`` (t, k,
    p) with t <= 0 take the exact argmax test.  The noise comes from
    ``generator``.  Rows that are not active write cache rows at and
    above their ``pos`` and commit nothing.  Ends with the flag of the
    rows still active."""
    kd = int(k_draft)
    dev = state.pos.device
    k, v, pos, tok = state.k, state.v, state.pos, state.tok
    count, limits = bufs.count, bufs.limits
    bsz = pos.shape[0]
    sampling = temperature > 0.0 or rows is not None
    offs = torch.arange(kd, dtype=torch.int32, device=dev)
    active_it = count < limits

    # ---- one batched step from each row's last token -------------------
    x = _scan_layers_rows(params, tok[:, None], k, v, pos, cfg, attn_len,
                          token_mask=active_it[:, None], tp=tp, ep=ep)
    hidden, logits = _hidden_logits(params, x[:, -1], cfg)
    if rows is not None:
        token1 = _sample_rows(logits, *rows, generator=generator)
    elif sampling:
        token1 = _sample(logits, temperature, top_k, top_p, generator)
    else:
        token1 = torch.argmax(logits, dim=-1).to(torch.int32)
    pos1 = pos + active_it.to(torch.int32)
    tok1 = torch.where(active_it, token1, tok)

    # ---- per-row drafts for the next k positions -----------------------
    qf = None
    if bufs.dpad is not None:
        d = bufs.dpad.gather(1, (count[:, None] + 1 + offs[None]).long())
    else:
        dlogits = _draft_logits(hidden, params["draft_heads"][:kd])
        if rows is not None:
            qf = _filtered_logits_rows(dlogits, rows[0][:, None],
                                       rows[1][:, None], rows[2][:, None])
        elif sampling:
            qf = _filtered_logits(dlogits, temperature, top_k, top_p)
        if qf is None:
            d = torch.argmax(dlogits, dim=-1).to(torch.int32)
        else:
            d = torch.argmax(qf + _gumbel(qf, generator),
                             dim=-1).to(torch.int32)

    # ---- one batched verify forward for every row's drafts -------------
    prevs = torch.cat([token1[:, None], d[:, :-1]], dim=1)
    xs = _scan_layers_rows(params, prevs, k, v, pos1, cfg, attn_len,
                           token_mask=active_it[:, None].expand(bsz, kd),
                           tp=tp, ep=ep)
    _, vlogits = _hidden_logits(params, xs, cfg)                # (B, kd, V)

    if sampling:
        if rows is not None:
            pf = _filtered_logits_rows(vlogits, rows[0][:, None],
                                       rows[1][:, None], rows[2][:, None])
        else:
            pf = _filtered_logits(vlogits, temperature, top_k, top_p)
        pp = torch.softmax(pf, dim=-1)                          # target
        if qf is None:                                          # one-hot
            qp = torch.nn.functional.one_hot(
                d.long(), pp.shape[-1]).to(torch.float32)
        else:
            qp = torch.softmax(qf, dim=-1)                      # proposal
        p_d = pp.gather(-1, d.long()[..., None])[..., 0]
        q_d = qp.gather(-1, d.long()[..., None])[..., 0]
        u = torch.rand(d.shape, generator=generator, device=dev,
                       dtype=torch.float32)
        accept = u * q_d < p_d                                  # (B, kd)
        resid = (pp - qp).clamp_min(0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        # p == q: rejection has probability 0; keep the (never
        # committed) correction's distribution valid
        resid = torch.where(rsum > 0, resid, pp)
        lr = torch.log(resid.clamp_min(1e-30))
        corr = torch.argmax(lr + _gumbel(lr, generator),
                            dim=-1).to(torch.int32)
        vals = torch.where(accept, d, corr)
        if rows is not None:
            # greedy rows: the exact argmax test
            g = (rows[0] <= 0.0)[:, None]
            a_greedy = torch.argmax(vlogits, dim=-1).to(torch.int32)
            accept = torch.where(g, d == a_greedy, accept)
            vals = torch.where(g, a_greedy, vals)
    else:
        vals = torch.argmax(vlogits, dim=-1).to(torch.int32)   # (B, kd)
        accept = d == vals

    # ---- each row commits its accepted prefix + first correction -------
    prefix_ok = torch.cat([
        torch.ones((bsz, 1), dtype=torch.bool, device=dev),
        torch.cumprod(accept[:, :-1].to(torch.int32), dim=1).bool()],
        dim=1)
    commit = (active_it[:, None] & prefix_ok
              & (count[:, None] + 1 + offs[None] < limits[:, None]))
    n_commit = commit.sum(dim=1, dtype=torch.int32)
    last_v = vals.gather(1, (n_commit - 1).clamp_min(0).long()[:, None])[:, 0]
    tok.copy_(torch.where(n_commit > 0, last_v, tok1))
    pos.copy_(pos1 + n_commit)
    emitted = torch.where(
        torch.cat([active_it[:, None], commit], dim=1),
        torch.cat([token1[:, None], vals], dim=1), -1)
    # a frozen row writes -1 at [count..count+kd], at or past its final
    # count, where out is still -1 (commits are prefix-shaped)
    bufs.out.scatter_(1, (count[:, None] + torch.arange(
        kd + 1, device=dev)[None]).long(), emitted)
    count.add_(active_it.to(torch.int32) + n_commit)
    bufs.iters.add_(active_it.to(torch.int32))
    bufs.flag.copy_((count < limits).any())


def decode_block_spec_pooled(params: Dict, state: LlamaPoolState,
                             active: torch.Tensor, cfg: LlamaConfig,
                             block: int = 16, k_draft: int = 4,
                             attn_len: Optional[int] = None,
                             draft_tokens: Optional[torch.Tensor] = None,
                             temperature: float = 0.0, top_k: int = 0,
                             top_p: float = 1.0,
                             rows: Optional[Tuple] = None,
                             generator: Optional[torch.Generator] = None,
                             tp=None, ep=None
                             ) -> Tuple[torch.Tensor, LlamaPoolState,
                                        torch.Tensor]:
    """Speculative ``decode_block_pooled``: every active row advances
    ``block`` tokens in fewer sequential iterations when the drafts
    accept (``spec_iteration``).  Greedy output equals the plain pooled
    block's for any drafts; sampled output has its law.  The drafts are
    ``params["draft_heads"]``'s (head j guesses position +2+j), or the
    explicit ``draft_tokens`` (B, block) stream.  Inactive rows ride
    along frozen.  Mis-speculated cache rows lie above ``pos`` and are
    overwritten before any later query attends them.

    ``attn_len``: every active row satisfies pos + block + k_draft + 1 <=
    attn_len (the verifier probes up to k_draft rows past the last
    committed token).  The caches are written in place; the returned
    state holds new ``pos`` and ``tok``.

    Returns (tokens (B, block), state, iters (B,): each row's active
    iterations, as JAX counts them).  ``tp`` / ``ep``: as
    ``decode_block_pooled``; the draft heads are whole on every rank and
    read the hidden state after the row-parallel sums, the same on each."""
    bufs = spec_buffers(state.pos.shape[0], block, k_draft,
                        state.pos.device, drafts=draft_tokens is not None)
    st = state._replace(pos=state.pos.clone(), tok=state.tok.clone())
    run_spec_loop(
        lambda: spec_start(bufs, active, block, draft_tokens),
        lambda: spec_iteration(params, st, bufs, cfg, k_draft, attn_len,
                               temperature, top_k, top_p, rows, generator,
                               tp, ep),
        bufs.flag, block)
    return bufs.out[:, :block], st, bufs.iters
