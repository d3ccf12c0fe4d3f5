"""Mixture-of-experts FFN with GShard-style static-capacity dispatch.

Counterpart of ``llmvox_tpu/ops/moe.py`` (``expert_matmul``,
``moe_capacity``, ``moe_ffn``), with the same function: top-k routing
over the router's f32 logits (the Mixtral convention: softmax over the
chosen k logits only), each expert a SwiGLU over the rows dispatched to
it, a fixed ``capacity`` of rows per expert and group, the
earlier-token-wins priority, ``token_mask`` keeping padding and inactive
rows out of routing, and the load-balancing statistic.  Dispatch and
combine are dense one-hot tensors in the activations' dtype, contracted
with einsums, as JAX contracts them; the combine weights are rounded to
that dtype first, as JAX rounds them.

Two choices JAX makes implicitly are explicit here:
- top-k ties go to the lower expert index (``jax.lax.top_k``'s rule;
  ``torch.topk`` promises no order), by a stable descending sort;
- ``w4`` expert weights (``Int4Tensor`` stacks) run each expert's matmul
  through kernel K4 (``ops/cuda_int4_mm.py``), E launches a matrix at M
  equal to the expert's rows, on the card and (its plain version) on the
  CPU alike, so the stored nibbles stay the HBM traffic.  JAX's CPU and
  TPU route is a group-batched einsum (its Pallas kernel is 2-D only);
  ``expert_matmul_einsum`` is that formulation, kept as the reference
  the K4 route is held to (the sum order and the bf16 rounding of the
  dequantized weights differ, as for the dense ``w4`` path).

Under Megatron tensor parallelism (``tp_group``, ep = 1: the split
``llama_param_shardings`` gives every expert) each rank holds its block
of every expert's hidden columns (``moe_wgate`` / ``moe_wup``) and the
matching rows of ``moe_wdown``; the router is whole on every rank, so
routing, dispatch and the statistic are the same on each, and one
all-reduce after the combine sums the ranks' partial outputs.  The
expert-parallel ``moe_ffn_a2a`` / ``make_moe_a2a`` (ep > 1, an
all-to-all) are not ported: ROADMAP queue 1 item 10.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from llmvox_tpu_torch.ops import cuda_int4_mm, nn, quant
from llmvox_tpu_torch.parallel import tensor_parallel as tpar


def _experts(w) -> int:
    return (w.q if isinstance(w, quant.QUANTIZED) else w).shape[0]


def expert_matmul_einsum(x: torch.Tensor, w: quant.Int4Tensor
                         ) -> torch.Tensor:
    """JAX's ``w4`` expert matmul (``llmvox_tpu/ops/moe.py:109-125``):
    the even and odd logical rows (the low and high nibbles) contracted
    against the activations' even and odd columns per scale group in
    the operand dtype (bf16 for bf16 x, else f32) with f32 sums, each
    group's partial sum scaled in f32, the groups summed, cast to x's
    dtype.  The reference the K4 route of ``expert_matmul`` is held to."""
    q, s = w.q, w.s                       # (E, Cin/2, C), (E, G, 1, C)
    e, p, c = q.shape
    g = s.shape[-3]
    gp = p // g
    op = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    qi = q.to(torch.int32)
    lo = ((qi << 28) >> 28).reshape(e, g, gp, c)
    hi = (qi >> 4).reshape(e, g, gp, c)
    r = x.shape[-2]
    xe = x[..., 0::2].reshape(e, r, g, gp).to(op)
    xo = x[..., 1::2].reshape(e, r, g, gp).to(op)
    # products of bf16 values are exact in f32: contracting them in f32
    # is the bf16 dot with an f32 result
    ye = torch.einsum("ergk,egkc->ergc", xe.float(), lo.float())
    yo = torch.einsum("ergk,egkc->ergc", xo.float(), hi.float())
    y = ((ye + yo) * s[:, None, :, 0, :].float()).sum(dim=-2)
    return y.to(x.dtype)


def expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert batched matmul ``(E, R, Cin) @ (E, Cin, Cout)`` for
    dense and quantized expert stacks (``ops/quant.py``'s containers), as
    JAX's ``expert_matmul`` dispatches:
    - ``QuantizedTensor`` (w8): the int8 weight in the operand dtype (bf16
      for bf16 x, else f32), an f32 product, the per-(expert, channel)
      scale applied to it, cast to x's dtype;
    - ``Int8Linear`` (w8a8): x quantized per (expert, row), each expert's
      int8 product summed exactly in int32 (``quant._int_mm``, which
      handles the card's shape limits), both scales applied in f32;
    - ``Int4Tensor`` (w4): each expert through K4 (see the module's
      docstring);
    - dense: the product in x's dtype."""
    if isinstance(w, quant.QuantizedTensor):
        op = x.dtype if x.dtype == torch.bfloat16 else torch.float32
        # bf16 x bf16 products are exact in f32, so an f32 product of the
        # operands is the bf16 dot with JAX's f32 result
        y = torch.matmul(x.to(op).float(), w.q.to(op).float())
        return (y * w.s.float()).to(x.dtype)
    if isinstance(w, quant.Int8Linear):
        x32 = x.float()
        sx = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        qx = torch.round(x32 / sx).clamp(-127, 127).to(torch.int8)
        y = torch.stack([quant._int_mm(qx[e].contiguous(), w.q[e])
                         for e in range(qx.shape[0])])
        return (y.float() * (sx * w.s.float())).to(x.dtype)
    if isinstance(w, quant.Int4Tensor):
        return torch.stack([cuda_int4_mm.int4_matmul(x[e], w.q[e], w.s[e])
                            for e in range(x.shape[0])])
    return torch.matmul(x, w.to(x.dtype))


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-expert token capacity: ceil(N * K / E * factor), clamped
    to [1, N]."""
    cap = math.ceil(n_tokens * top_k / n_experts * capacity_factor)
    return max(1, min(n_tokens, cap))


def top_k_lower_index(logits: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their indices, equal
    values in index order (``jax.lax.top_k``'s tie rule): a stable
    descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wgate, wup, wdown,
            top_k: int, capacity_factor: float = 2.0,
            token_mask: Optional[torch.Tensor] = None,
            group_size: int = 0, drop_free: bool = False,
            tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts over ``x`` (..., C).

    ``router_w`` (C, E); ``wgate``/``wup`` (E, C, I); ``wdown`` (E, I, C),
    dense or quantized.  Returns ``(y, aux)``: ``y`` shaped like ``x``,
    ``aux`` the load-balancing statistic E * sum_e f_e * P_e over the
    masked-in tokens (1.0 at perfect balance).

    ``token_mask`` (bool, x's shape without the channel axis): False rows
    take no capacity, add nothing to the statistic and get a zero output.
    ``group_size``: dispatch in groups of G tokens (0: one group).
    ``drop_free=True`` makes the capacity the group size, so no token can
    overflow; every inference path passes it.  ``tp_group``: the experts'
    hidden columns are this rank's block (the module's docstring), and
    ``y`` is summed over the group."""
    orig_shape = x.shape
    c = orig_shape[-1]
    e = router_w.shape[-1]
    dev = x.device
    xf = x.reshape(-1, c)
    n = xf.shape[0]
    mask = (torch.ones((n,), dtype=torch.bool, device=dev)
            if token_mask is None else token_mask.reshape(-1).bool())
    g = int(group_size) if group_size else n
    g = max(1, min(g, n))
    ng = -(-n // g)
    npad = ng * g
    if npad != n:
        xf = torch.cat([xf, xf.new_zeros((npad - n, c))])
        mask = torch.cat([mask, mask.new_zeros((npad - n,))])
    cap = g if drop_free else moe_capacity(g, e, top_k, capacity_factor)

    logits = nn.linear(xf, router_w).float()                     # (Np, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k_lower_index(logits, top_k)                # (Np, K)
    w = torch.softmax(topv, dim=-1)

    # position in expert within each group: the masked-in routes before
    # this one (token-major, k-minor) to the same expert
    eids = torch.arange(e, device=dev)
    onehot_e = ((topi[..., None] == eids).to(torch.int32)
                * mask[:, None, None].to(torch.int32))           # (Np, K, E)
    flat = onehot_e.reshape(ng, g * top_k, e)
    pos_f = torch.cumsum(flat, dim=1) - flat
    pos = (pos_f.reshape(npad, top_k, e) * onehot_e).sum(dim=-1)  # (Np, K)
    keep = (pos < cap) & mask[:, None]

    dtype = x.dtype
    slots = torch.arange(cap, device=dev)
    dispatch = torch.zeros((npad, e, cap), dtype=dtype, device=dev)
    combine = torch.zeros((npad, e, cap), dtype=dtype, device=dev)
    for k in range(top_k):
        # a position past the capacity is no slot: an all-zero row, as
        # jax.nn.one_hot gives
        hot = ((topi[:, k, None] == eids).to(dtype)[:, :, None]
               * (pos[:, k, None] == slots).to(dtype)[:, None, :]
               * keep[:, k, None, None].to(dtype))
        dispatch = dispatch + hot
        combine = combine + hot * w[:, k, None, None].to(dtype)

    dg = dispatch.reshape(ng, g, e, cap)
    cg = combine.reshape(ng, g, e, cap)
    xg = xf.reshape(ng, g, c)
    xin = torch.einsum("gnec,gnd->egcd", dg, xg).reshape(e, ng * cap, c)
    gate = expert_matmul(xin, wgate)
    up = expert_matmul(xin, wup)
    h = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    xout = expert_matmul(h, wdown).reshape(e, ng, cap, c)
    y = torch.einsum("gnec,egcd->gnd", cg, xout.to(dtype))
    y = tpar.reduce_from_tp(y.reshape(npad, c)[:n], tp_group)

    # the statistic over masked-in tokens only
    m32 = mask.float()
    denom = m32.sum().clamp_min(1.0)
    f = onehot_e.sum(dim=1).float().sum(dim=0) / denom
    pmean = (probs * m32[:, None]).sum(dim=0) / denom
    aux = e * ((f / top_k) * pmean).sum()
    return y.reshape(orig_shape), aux
