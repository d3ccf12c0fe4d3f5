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

Parallel layouts, each what GSPMD makes of JAX's shardings:
- Megatron tensor parallelism (``tp_group``) splits each expert's hidden
  columns (``moe_wgate`` / ``moe_wup``) and the matching rows of
  ``moe_wdown``; experts over ``ep_group`` (``llama_param_shardings``'
  ``P(None, "ep", None, "tp")``) give each rank a contiguous block of
  E/ep experts.  The tokens are the same on every rank of both groups,
  and so is the router: each rank routes every token alike and runs its
  experts' (or columns') share of the slots, and an all-reduce over each
  group sums the partial outputs (``reduce_from_tp``).  The routing
  weights and the rows dispatched pass ``copy_to_tp`` on the way in, so
  their gradients (hence the router's and the input's) are whole and
  equal on every rank; the statistic, computed alike on each, is not
  summed.
- Tokens split over ``dp_group`` keep the whole batch's routing: the
  positions of one routing group spanning the ranks follow the earlier
  ranks' routes (an exclusive prefix over the all-gathered (E,) counts),
  and the statistic sums the ranks' tokens.
- ``moe_ffn_a2a`` / ``make_moe_a2a``: the tokens and the experts both
  split over ep, one hand-written ``all_to_all`` each way
  (``parallel/mesh.py::all_to_all``).
A statistic summed over ranks is an all-reduce whose backward passes the
gradient through: every rank holds the whole batch's aux, and the
gradient each rank takes of it reaches its own tokens only, so the
ranks' gradients summed count it once (JAX's global loss counts it once).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from llmvox_tpu_torch.ops import cuda_int4_mm, nn, quant
from llmvox_tpu_torch.parallel import mesh as pmesh
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


def _groups(*groups):
    return [g for g in groups if tpar.active(g)]


def _copy(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        x = tpar.copy_to_tp(x, g)
    return x


def _reduce(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        x = tpar.reduce_from_tp(x, g)
    return x


def _ep_block(e: int, wgate, ep_group) -> Tuple[int, int]:
    """(this rank's first expert, its expert count): ``wgate`` holds the
    rank's contiguous block of the E experts, one block a rank of
    ``ep_group`` in its rank order."""
    e_loc = _experts(wgate)
    n_ep = tpar.size(ep_group)
    if e_loc * n_ep != e:
        raise ValueError(f"{e_loc} local experts x ep={n_ep} are not the "
                         f"router's {e}")
    return (pmesh.group_rank(ep_group) if n_ep > 1 else 0) * e_loc, e_loc


def _routing(xf: torch.Tensor, router_w: torch.Tensor, top_k: int,
             mask: torch.Tensor):
    """The router's f32 logits, softmax and top-k softmax weights, and
    the (N, K, E) int32 one-hot routes of the masked-in tokens."""
    e = router_w.shape[-1]
    logits = nn.linear(xf, router_w).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k_lower_index(logits, top_k)
    w = torch.softmax(topv, dim=-1)
    eids = torch.arange(e, device=xf.device)
    onehot_e = ((topi[..., None] == eids).to(torch.int32)
                * mask[:, None, None].to(torch.int32))
    return probs, topi, w, onehot_e


def _slots(topi, w, slot, keep, experts, cap: int, dtype):
    """The dense (N, len(experts), cap) dispatch and combine one-hots of
    the kept routes to ``experts``, route k of token n in slot
    ``slot[n, k]``; the combine weights rounded to ``dtype`` first, as
    JAX rounds them."""
    slots = torch.arange(cap, device=topi.device)
    n = topi.shape[0]
    dispatch = torch.zeros((n, experts.numel(), cap), dtype=dtype,
                           device=topi.device)
    combine = torch.zeros_like(dispatch)
    for k in range(topi.shape[1]):
        # a slot past the capacity is no slot: an all-zero row, as
        # jax.nn.one_hot gives
        hot = ((topi[:, k, None] == experts).to(dtype)[:, :, None]
               * (slot[:, k, None] == slots).to(dtype)[:, None, :]
               * keep[:, k, None, None].to(dtype))
        dispatch = dispatch + hot
        combine = combine + hot * w[:, k, None, None].to(dtype)
    return dispatch, combine


def _swiglu(xin: torch.Tensor, wgate, wup, wdown) -> torch.Tensor:
    gate = expert_matmul(xin, wgate)
    up = expert_matmul(xin, wup)
    h = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return expert_matmul(h, wdown)


def _aux(onehot_e, probs, mask, top_k: int, group=None) -> torch.Tensor:
    """E * sum_e f_e * P_e over the masked-in tokens, the sums taken over
    ``group``'s ranks' tokens too: an all-reduce whose backward passes the
    gradient through (``reduce_from_tp``), so each rank's aux is the whole
    batch's value and its gradient reaches this rank's tokens only (the
    ranks' gradients summed count the term once)."""
    e = probs.shape[-1]
    m32 = mask.float()
    sums = torch.cat([m32.sum()[None],
                      onehot_e.sum(dim=1).float().sum(dim=0)]).detach()
    sums = tpar.reduce_from_tp(sums, group)
    psum = tpar.reduce_from_tp((probs * m32[:, None]).sum(dim=0), group)
    denom = sums[0].clamp_min(1.0)
    f = sums[1:] / denom
    pmean = psum / denom
    return e * ((f / top_k) * pmean).sum()


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wgate, wup, wdown,
            top_k: int, capacity_factor: float = 2.0,
            token_mask: Optional[torch.Tensor] = None,
            group_size: int = 0, drop_free: bool = False,
            tp_group=None, ep_group=None, dp_group=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts over ``x`` (..., C).

    ``router_w`` (C, E); ``wgate``/``wup`` (E, C, I); ``wdown`` (E, I, C),
    dense or quantized.  Returns ``(y, aux)``: ``y`` shaped like ``x``,
    ``aux`` the load-balancing statistic E * sum_e f_e * P_e over the
    masked-in tokens (1.0 at perfect balance).

    ``token_mask`` (bool, x's shape without the channel axis): False rows
    take no capacity, add nothing to the statistic and get a zero output.
    ``group_size``: dispatch in groups of G tokens (0: one group).
    ``drop_free=True`` makes the capacity the group size, so no token can
    overflow; every inference path passes it.

    Parallel layouts (the module's docstring): ``tp_group``, the experts'
    hidden columns are this rank's block; ``ep_group``, the weights are
    this rank's contiguous block of E/ep experts (the router whole); ``y``
    is summed over both.  ``dp_group``: ``x`` is this rank's block of
    rows of a batch split over the group in its rank order (equal blocks),
    and routing is the whole batch's: one group (``group_size`` 0) spans
    the ranks, a rank's positions in each expert following the earlier
    ranks' routes, and the statistic sums every rank's tokens."""
    orig_shape = x.shape
    c = orig_shape[-1]
    e = router_w.shape[-1]
    dev = x.device
    e0, e_loc = _ep_block(e, wgate, ep_group)
    xf = x.reshape(-1, c)
    n = xf.shape[0]
    mask = (torch.ones((n,), dtype=torch.bool, device=dev)
            if token_mask is None else token_mask.reshape(-1).bool())
    n_dp = tpar.size(dp_group)
    n_all = n * n_dp
    g = int(group_size) if group_size else n_all
    g = max(1, min(g, n_all))
    # one routing group over the dp ranks' rows, or groups inside a rank's
    shared = g > n
    if n_dp > 1 and ((shared and g != n_all) or (not shared and n % g)):
        raise ValueError(f"moe_group_size={group_size} groups straddle the "
                         f"dp ranks' blocks of {n} tokens")
    gl = n if shared else g
    ng = -(-n // gl)
    npad = ng * gl
    if npad != n:
        xf = torch.cat([xf, xf.new_zeros((npad - n, c))])
        mask = torch.cat([mask, mask.new_zeros((npad - n,))])
    cap = g if drop_free else moe_capacity(g, e, top_k, capacity_factor)

    probs, topi, w, onehot_e = _routing(xf, router_w, top_k, mask)
    # position in expert within each group: the masked-in routes before
    # this one (token-major, k-minor) to the same expert, the earlier dp
    # ranks' routes first when the group spans them
    flat = onehot_e.reshape(ng, gl * top_k, e)
    pos_f = torch.cumsum(flat, dim=1) - flat
    slot_f = pos_f
    if shared:
        counts = pmesh.gather_rows(flat.sum(dim=1), dp_group)   # (dp, E)
        before = counts[:pmesh.group_rank(dp_group)].sum(dim=0)
        pos_f = pos_f + before
    pos = (pos_f.reshape(npad, top_k, e) * onehot_e).sum(dim=-1)  # (Np, K)
    keep = (pos < cap) & mask[:, None]
    # a rank's slots hold its own tokens only: each expert's first free
    # slot is its first one here (rows are independent in the experts)
    slot = (slot_f.reshape(npad, top_k, e) * onehot_e).sum(dim=-1)
    cap_loc = min(cap, gl) if shared else cap

    groups = _groups(tp_group, ep_group)
    experts = torch.arange(e0, e0 + e_loc, device=dev)
    dispatch, combine = _slots(topi, _copy(w, groups), slot, keep, experts,
                               cap_loc, x.dtype)
    dg = dispatch.reshape(ng, gl, e_loc, cap_loc)
    cg = combine.reshape(ng, gl, e_loc, cap_loc)
    xg = _copy(xf, groups).reshape(ng, gl, c)
    xin = torch.einsum("gnec,gnd->egcd", dg, xg).reshape(
        e_loc, ng * cap_loc, c)
    xout = _swiglu(xin, wgate, wup, wdown).reshape(e_loc, ng, cap_loc, c)
    y = torch.einsum("gnec,egcd->gnd", cg, xout.to(x.dtype))
    y = _reduce(y.reshape(npad, c)[:n], groups)
    aux = _aux(onehot_e, probs, mask, top_k,
               dp_group if n_dp > 1 else None)
    return y.reshape(orig_shape), aux


def moe_ffn_a2a(x: torch.Tensor, router_w: torch.Tensor, wgate, wup, wdown,
                top_k: int, group, capacity_factor: float = 2.0,
                token_mask: Optional[torch.Tensor] = None,
                drop_free: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's hand-written expert-parallel MoE (``moe_ffn_a2a``): the token
    rows and the experts both split over ``group`` (ep).  ``x`` is this
    rank's (n, C) rows, ``wgate``/``wup``/``wdown`` its (E/ep, ...) block
    of experts, ``router_w`` (C, E) whole.  The rank routes its rows
    against every expert, packs them into (E, cap, C) slots (``cap`` =
    ``moe_capacity(n, ...)``, or n drop-free; earlier tokens first, masked
    ones taking none), sends each expert's slots to the rank that holds
    it in one ``all_to_all``, runs its experts over every rank's slots,
    sends the outputs home in the inverse exchange, and combines them.
    It equals ``moe_ffn`` with ``group_size = n`` over the ranks' rows in
    rank order.  ``aux`` sums the masked-in count, the routes and the
    probabilities over the group (``_aux``): the whole batch's value on
    every rank, whose gradient reaches this rank's tokens only."""
    orig_shape = x.shape
    c = orig_shape[-1]
    e = router_w.shape[-1]
    _, e_loc = _ep_block(e, wgate, group)
    n_ep = e // e_loc
    dev = x.device
    xf = x.reshape(-1, c)
    n = xf.shape[0]
    mask = (torch.ones((n,), dtype=torch.bool, device=dev)
            if token_mask is None else token_mask.reshape(-1).bool())
    cap = n if drop_free else moe_capacity(n, e, top_k, capacity_factor)
    probs, topi, w, onehot_e = _routing(xf, router_w, top_k, mask)
    flat = onehot_e.reshape(1, n * top_k, e)
    pos_f = torch.cumsum(flat, dim=1) - flat
    pos = (pos_f.reshape(n, top_k, e) * onehot_e).sum(dim=-1)
    keep = (pos < cap) & mask[:, None]
    dispatch, combine = _slots(topi, w, pos, keep,
                               torch.arange(e, device=dev), cap, x.dtype)
    xin = torch.einsum("nec,nd->ecd", dispatch, xf)            # (E, cap, C)
    # one exchange: the blocks of E/ep experts go to their ranks, which
    # receive them ordered by source rank, (src, E/ep, cap, C)
    xin = pmesh.all_to_all(xin, group)
    xin = (xin.reshape(n_ep, e_loc, cap, c).transpose(0, 1)
           .reshape(e_loc, n_ep * cap, c))
    xout = _swiglu(xin, wgate, wup, wdown).to(x.dtype)
    # the inverse exchange: the outputs go home, axis 0 the expert again
    xout = (xout.reshape(e_loc, n_ep, cap, c).transpose(0, 1)
            .reshape(e, cap, c))
    xout = pmesh.all_to_all(xout, group)
    y = torch.einsum("nec,ecd->nd", combine, xout)
    aux = _aux(onehot_e, probs, mask, top_k, group)
    return y.reshape(orig_shape), aux


def make_moe_a2a(group, top_k: int, capacity_factor: float = 2.0,
                 drop_free: bool = False):
    """JAX's ``make_moe_a2a`` over ``group`` (ep): ``moe(x, router_w,
    wgate, wup, wdown, token_mask=None) -> (y, aux)`` on the GLOBAL (N,
    C) rows, (E, ...) expert stacks and (N,) mask, every rank passing the
    same; this rank runs ``moe_ffn_a2a`` on its block of the rows and of
    the experts and returns ``y`` for its rows (block ``group_rank`` of
    N/ep) and the global ``aux``.  The gradients of the global arguments
    are this rank's share: summed over the ranks (with every rank's loss
    adding ``aux`` once, ``_aux``), they are the single program's.  N
    must divide by ep (JAX's ValueError)."""
    n_ep = pmesh.group_size(group)
    i = pmesh.group_rank(group)

    def moe(x, rw, wg, wu, wd, token_mask=None):
        if x.shape[0] % n_ep:
            raise ValueError(f"N={x.shape[0]} not divisible by ep={n_ep}")
        rows = slice(i * (x.shape[0] // n_ep), (i + 1) * (x.shape[0] // n_ep))
        e_loc = _experts(wg) // n_ep
        ex = slice(i * e_loc, (i + 1) * e_loc)
        return moe_ffn_a2a(
            x[rows], rw, wg[ex], wu[ex], wd[ex], top_k, group,
            capacity_factor=capacity_factor,
            token_mask=None if token_mask is None else token_mask[rows],
            drop_free=drop_free)

    return moe
