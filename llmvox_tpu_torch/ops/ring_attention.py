"""Ring attention: causal self-attention with the sequence axis split over
the ranks of a sequence-parallel group.

Counterpart of ``llmvox_tpu/ops/ring_attention.py`` (XLA einsums under
``shard_map``, not a Pallas kernel).  Each rank holds a T/n share of q, k
and v; the (k, v) shares travel around the group's ring (``rotate``, JAX's
``ppermute``), and every rank accumulates its queries' attention with the
online softmax of ``ops/attention.py``: products of the inputs in f32
(TF32 off), the running max, sum and output in f32, the probabilities
rounded to the inputs' dtype before the product with v, as JAX's
``p.astype(q.dtype)`` does, and the causal mask on GLOBAL positions.

Two layouts, JAX's:

- ``ring``: rank i holds contiguous chunk i.  At ring step s it holds the
  keys of chunk ``(i - s) % n``; a tile wholly above the diagonal (a
  later chunk) is skipped.
- ``zigzag``: T is cut into 2n chunks and rank i holds chunks i and
  2n-1-i (its rows are ``x[:, perm]``'s block i, ``zigzag_permutation``),
  so every rank computes 3 sub-tiles at step 0 and 2 at every other step:
  (q_hi, k_lo) always, (q_lo, k_lo) iff the keys' rank is not after this
  one, (q_hi, k_hi) iff it is not before it, (q_lo, k_hi) never.

Both follow from one rule, the skip of a tile with no query at or after
any of its keys, which ``_tiles`` applies.

The whole ring is one ``torch.autograd.Function``.  Its backward
recomputes each step's tiles from the step's saved running state (JAX's
``jax.checkpoint`` on each step: no (Tc, Tc) probability tile is kept)
and sends the keys' gradient around the ring the other way (the
transpose of the rotation).  One Function, not autograd over
``torch.utils.checkpoint`` and ``mesh.ppermute``: a rank whose later
steps are all skipped would leave the rotations that feed them out of its
backward graph, and its ranks would call different collectives.  Here
every rank rotates n - 1 times each way, whatever it skips, so the
ranks' autograd graphs are the same node for node and call every
collective (this group's and the tp and dp groups' around it) in one
order.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.parallel import mesh as pmesh

NEG_INF = float("-inf")
LAYOUTS = ("ring", "zigzag")


def zigzag_permutation(t: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The global T-permutation of the zigzag layout: ``x[:, perm]`` puts
    original chunks i and 2n-1-i (T/2n rows each) in contiguous block i
    of T/n rows; ``inv`` undoes it (``perm[inv[p]] == p``).  int32, as
    JAX's."""
    check_seq(t, n, "zigzag")
    tz = t // (2 * n)
    parts = []
    for i in range(n):
        parts.append(np.arange(i * tz, (i + 1) * tz))
        parts.append(np.arange((2 * n - 1 - i) * tz, (2 * n - i) * tz))
    perm = np.concatenate(parts).astype(np.int32)
    return perm, np.argsort(perm).astype(np.int32)


def check_seq(t: int, n: int, layout: str) -> None:
    """JAX's refusals: T not divisible by sp (ring), by 2*sp (zigzag), and
    a layout that is neither."""
    if layout not in LAYOUTS:
        raise ValueError(f"sp_layout {layout!r} is not one of {LAYOUTS}")
    if layout == "ring" and t % n:
        raise ValueError(f"T={t} not divisible by sp={n}")
    if layout == "zigzag" and t % (2 * n):
        raise ValueError(f"T={t} not divisible by 2*sp={2 * n}")


class _Part(NamedTuple):
    rows: slice       # the local rows
    offset: int       # the global position of the first
    size: int


def _parts(layout: str, i: int, n: int, tc: int) -> List[_Part]:
    """Rank i's row blocks with their global offsets."""
    if layout == "ring":
        return [_Part(slice(0, tc), i * tc, tc)]
    tz = tc // 2
    return [_Part(slice(0, tz), i * tz, tz),
            _Part(slice(tz, tc), (2 * n - 1 - i) * tz, tz)]


def _tiles(qp: Sequence[_Part], kp: Sequence[_Part]):
    """The (query part, key part) pairs with a query at or after one of
    the keys, in JAX's order of update (later query blocks first)."""
    return [(a, b) for a in reversed(range(len(qp)))
            for b in range(len(kp))
            if qp[a].offset + qp[a].size - 1 >= kp[b].offset]


def _tile(carry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          qp: _Part, kp: _Part, scale: float, dtype):
    """One online-softmax update of ``carry`` = (m, l, acc) by the tile of
    ``q``'s rows (B, tq, H, D) against ``k``/``v`` (B, tk, H, D), all f32.
    A row with no visible key yet keeps m = -inf and subtracts 0 instead,
    so its sums stay exact zeros (never NaN)."""
    m, l, acc = carry
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if qp.offset < kp.offset + kp.size - 1:     # the tile meets the diagonal
        iq = torch.arange(qp.size, device=q.device)[:, None] + qp.offset
        ik = torch.arange(kp.size, device=q.device)[None, :] + kp.offset
        logits = logits.masked_fill(iq < ik, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    m_sub = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(logits - m_sub)
    corr = torch.exp(m - m_sub)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd",
                                    p.to(dtype).float(), v)
    return m_new, l, acc


def _step(q, kv, carries, tiles, qp, kp, scale, dtype):
    """One ring step: every tile's update of its query part's carry;
    returns the carries (those of parts no tile touched as they were)."""
    out = list(carries)
    for a, b in tiles:
        out[a] = _tile(out[a], q[:, qp[a].rows], kv[0][:, kp[b].rows],
                       kv[1][:, kp[b].rows], qp[a], kp[b], scale, dtype)
    return out


def _finish(carries, dtype) -> torch.Tensor:
    out = torch.cat([acc / l for _, l, acc in carries], dim=2)
    return out.transpose(1, 2).to(dtype)


def _grad(outputs, inputs, grads):
    got = torch.autograd.grad(outputs, inputs, grads, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, layout):
        n, i = pmesh.group_size(group), pmesh.group_rank(group)
        b, tc, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qp = _parts(layout, i, n, tc)
        q32 = q.float()
        kv = torch.stack([k, v])
        carries = [(torch.full((b, h, p.size, 1), NEG_INF,
                               dtype=torch.float32, device=q.device),
                    q.new_zeros((b, h, p.size, 1), dtype=torch.float32),
                    q.new_zeros((b, h, p.size, d), dtype=torch.float32))
                   for p in qp]
        saved_kv, saved = [], []
        for s in range(n):
            kp = _parts(layout, (i - s) % n, n, tc)
            saved_kv.append(kv)
            saved.append(carries)
            carries = _step(q32, kv.float(), carries, _tiles(qp, kp), qp,
                            kp, scale, q.dtype)
            if s < n - 1:
                kv = pmesh.rotate(kv, group, 1)
        saved.append(carries)
        ctx.meta = (group, layout, n, i, scale, q.dtype, k.dtype, len(qp))
        flat = [t for c in saved for part in c for t in part]
        ctx.save_for_backward(q, *saved_kv, *flat)
        return _finish(carries, q.dtype)

    @staticmethod
    def backward(ctx, dout):
        group, layout, n, i, scale, qdt, kdt, nparts = ctx.meta
        q, *rest = ctx.saved_tensors
        saved_kv, flat = rest[:n], rest[n:]
        per = 3 * nparts
        saved = [[tuple(flat[s * per + 3 * a:s * per + 3 * a + 3])
                  for a in range(nparts)] for s in range(n + 1)]
        tc = q.shape[1]
        qp = _parts(layout, i, n, tc)
        with torch.enable_grad():
            final = [tuple(t.detach().requires_grad_() for t in c)
                     for c in saved[n]]
            dcarry = _grad([_finish(final, qdt)],
                           [t for c in final for t in c], [dout])
        dcarry = [tuple(dcarry[3 * a:3 * a + 3]) for a in range(nparts)]
        q32 = q.detach().float()
        dq = torch.zeros_like(q32)
        dkv = None
        for s in reversed(range(n)):
            if dkv is not None:
                dkv = pmesh.rotate(dkv, group, -1)
            kp = _parts(layout, (i - s) % n, n, tc)
            tiles = _tiles(qp, kp)
            kv32 = saved_kv[s].detach().float()
            if not tiles:
                dkv = torch.zeros_like(kv32) if dkv is None else dkv
                continue
            touched = sorted({a for a, _ in tiles})
            with torch.enable_grad():
                qg = q32.detach().requires_grad_()
                kvg = kv32.requires_grad_()
                cin = [tuple(t.detach().requires_grad_() for t in c)
                       for c in saved[s]]
                cout = _step(qg, kvg, cin, tiles, qp, kp, scale, qdt)
                ins = [qg, kvg] + [t for a in touched for t in cin[a]]
                got = _grad([t for a in touched for t in cout[a]], ins,
                            [t for a in touched for t in dcarry[a]])
            dq += got[0]
            dkv = got[1] if dkv is None else dkv + got[1]
            for j, a in enumerate(touched):
                dcarry[a] = tuple(got[2 + 3 * j:5 + 3 * j])
        return dq.to(qdt), dkv[0].to(kdt), dkv[1].to(kdt), None, None


def ring_causal_attention_local(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, group) -> torch.Tensor:
    """(B, Tc, H, D) local q/k/v of this rank's contiguous chunk of T ->
    its (B, Tc, H, D) causal attention over the whole sequence, the ring
    over ``group`` (sp ranks in chunk order)."""
    return _Ring.apply(q, k, v, group, "ring")


def zigzag_ring_attention_local(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, group) -> torch.Tensor:
    """Like ``ring_causal_attention_local`` with the zigzag layout: this
    rank's rows are original chunks i and 2n-1-i (Tc = 2 * T/2n)."""
    n = pmesh.group_size(group)
    if q.shape[1] % 2:
        raise ValueError(f"T={q.shape[1] * n} not divisible by "
                         f"2*sp={2 * n}")
    return _Ring.apply(q, k, v, group, "zigzag")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, layout: str = "ring") -> torch.Tensor:
    """The counterpart of JAX's ``make_ring_attention(mesh)`` and
    ``make_zigzag_ring_attention(mesh)`` for one rank: its local q/k/v
    in ``layout`` over the sp ``group`` (a group of one rank is plain
    causal attention)."""
    check_seq(q.shape[1] * pmesh.group_size(group),
              pmesh.group_size(group), layout)
    fn = (zigzag_ring_attention_local if layout == "zigzag"
          else ring_causal_attention_local)
    return fn(q, k, v, group)
