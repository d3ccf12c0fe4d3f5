"""LLMVoX's speech decoder (arXiv 2503.04724), one full causal forward.

At position p the input is the L2-normalised concatenation of the text
byte embedding (the sentence's text id at p, or PAD past the text) and the
codebook feature of the speech token at p - 1 (zeros at p = 0), plus the
learned position embedding; then a pre-LayerNorm GPT (tanh GELU, no
biases) and a linear head over the speech codes.  Teacher-forced on the
served tokens, its logits at p are what the served token at p was chosen
from.

``weight_fn`` maps every matmul weight before use: the identity for the
reference, a rounding through a lower precision for the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


def _ln(x, s, eps):
    return F.layer_norm(x, (x.shape[-1],), s, None, eps)


def logits(params: Dict, text_table: torch.Tensor, codebook: torch.Tensor,
           cfg, text_ids: Sequence[int], tokens: Sequence[int],
           weight_fn: Optional[Callable] = None) -> torch.Tensor:
    """(n, vocab) float32 logits at positions 0..n-1 of one sentence."""
    wf = weight_fn or (lambda w: w)
    dev = text_table.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32)  # noqa: E731
    n, c, nh = len(tokens), cfg.n_embd, cfg.n_head
    tid = torch.full((n,), cfg.pad_token_id, dtype=torch.long)
    m = min(n, len(text_ids))
    tid[:m] = torch.as_tensor(list(text_ids[:m]), dtype=torch.long)
    prev = torch.as_tensor([0] + list(tokens[:-1]), dtype=torch.long)
    temb = f32(text_table)[tid.to(dev)]
    feat = f32(codebook)[prev.to(dev)]
    feat[0] = 0.0
    x = torch.cat([temb, feat], dim=-1)
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    x = x + f32(params["wpe"])[:n]
    h = params["h"]
    mask = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    for l in range(cfg.n_layer):
        a = _ln(x, f32(h["ln1_s"][l]), cfg.ln_eps)
        q, k, v = (a @ wf(f32(h["wqkv"][l]))).split(c, dim=-1)
        q, k, v = (t.view(n, nh, c // nh).transpose(0, 1) for t in (q, k, v))
        s = (q @ k.transpose(1, 2)) / math.sqrt(c // nh)
        s = s.masked_fill(~mask, float("-inf"))
        o = (s.softmax(-1) @ v).transpose(0, 1).reshape(n, c)
        x = x + o @ wf(f32(h["wo"][l]))
        a = _ln(x, f32(h["ln2_s"][l]), cfg.ln_eps)
        x = x + F.gelu(a @ wf(f32(h["wfc"][l])), approximate="tanh") @ wf(
            f32(h["wproj"][l]))
    x = _ln(x, f32(params["lnf_s"]), cfg.ln_eps)
    return x @ wf(f32(params["head"]))
