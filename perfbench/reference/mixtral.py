"""Mixtral's decoder (mistralai/Mixtral-8x7B, as ``MixtralForCausalLM``
computes it), one full causal forward in float32, a layer at a time.

RMSNorm; rotary embeddings on the two halves of each head (HF's
``rotate_half``), inverse frequencies 1 / theta^(2i/hd); grouped-query
attention (query head h reads KV head h // (H / KV)); a router over the
experts, the top-k of its logits, their softmax as weights (the Mixtral
convention), each chosen expert's SwiGLU w2(silu(w1 x) * w3 x) summed
with those weights; a final RMSNorm and the head.  Weights in the
converted layout: Linear (Cin, Cout), experts (E, C, I) and (E, I, C)
stacked on a layer axis.  Each layer's weights are cast to float32 when
the layer runs, so the bfloat16 tree is read as it is served.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


def _rms(x, s, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * s


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(params: Dict, cfg, seqs: Sequence[Sequence[int]],
           ats: Sequence[Sequence[int]],
           weight_fn: Optional[Callable] = None) -> List[torch.Tensor]:
    """For each sequence of ids, the (len(at), vocab) float32 logits at
    its positions ``at``.  The sequences run a layer at a time together,
    so each layer's weights are cast (and rounded by ``weight_fn``) once."""
    wf = weight_fn or (lambda w: w)
    dev = params["tok_emb"].device
    c, nh, kvh = cfg.n_embd, cfg.n_head, cfg.n_kv_head
    hd = c // nh
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        hd // 2, dtype=torch.float32, device=dev) * 2.0 / hd))
    xs = [params["tok_emb"][torch.as_tensor(list(ids), dtype=torch.long,
                                            device=dev)].float()
          for ids in seqs]
    h = params["h"]
    for l in range(cfg.n_layer):
        w = {k: wf(h[k][l].float()) for k in ("wq", "wk", "wv", "wo",
                                              "router")}
        experts = [[wf(h[k][l][e].float()) for k in
                    ("moe_wgate", "moe_wup", "moe_wdown")]
                   for e in range(cfg.n_experts)]
        for j, x in enumerate(xs):
            n = x.shape[0]
            ang = torch.arange(n, dtype=torch.float32, device=dev)[:, None] * inv
            cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
            a = _rms(x, h["ln1_s"][l].float(), cfg.rms_eps)
            q = _rope((a @ w["wq"]).view(n, nh, hd), cos, sin)
            k = _rope((a @ w["wk"]).view(n, kvh, hd), cos, sin)
            v = (a @ w["wv"]).view(n, kvh, hd)
            k = k.repeat_interleave(nh // kvh, dim=1)
            v = v.repeat_interleave(nh // kvh, dim=1)
            mask = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
            sc = torch.einsum("qhd,khd->hqk", q, k) / hd ** 0.5
            sc = sc.masked_fill(~mask, float("-inf")).softmax(-1)
            o = torch.einsum("hqk,khd->qhd", sc, v).reshape(n, c)
            x = x + o @ w["wo"]
            a = _rms(x, h["ln2_s"][l].float(), cfg.rms_eps)
            top_v, top_i = (a @ w["router"]).topk(cfg.moe_top_k, dim=-1)
            gate = top_v.softmax(-1)
            out = torch.zeros_like(x)
            for e, (wg, wu, wd) in enumerate(experts):
                rows, slot = (top_i == e).nonzero(as_tuple=True)
                if len(rows):
                    xe = a[rows]
                    y = (F.silu(xe @ wg) * (xe @ wu)) @ wd
                    out.index_add_(0, rows, gate[rows, slot, None] * y)
            xs[j] = x + out
        del w, experts
    head = wf(params["head"].float())
    out = []
    for x, at in zip(xs, ats):
        idx = torch.as_tensor(list(at), dtype=torch.long, device=dev)
        out.append(_rms(x[idx], params["lnf_s"].float(), cfg.rms_eps) @ head)
    return out
