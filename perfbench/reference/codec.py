"""WavTokenizer's decode path (``large-speech-320-24k``): codes -> 24 kHz
audio, for one chunk at its exact length.

Codebook features -> Conv1d k7 embed -> pos_net (ResnetBlock x2, single-head
self-attention, ResnetBlock x2, GroupNorm) -> AdaLayerNorm (bandwidth 0)
-> ConvNeXt blocks (depthwise k7, AdaLayerNorm, pointwise 4x..., exact GELU,
layer scale) -> LayerNorm -> ISTFT head (log-magnitude clipped at exp 1e2,
phase; "same" padding: periodic Hann, overlap-add, window-envelope
normalisation, (n_fft - hop) / 2 samples trimmed a side).  Weights in the
converted layout: convolutions (K, Cin, Cout), linears (Cin, Cout).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


def _conv(x, w, b, pad, groups=1):
    """(L, Cin) -> (L, Cout); ``w`` (K, Cin/groups, Cout)."""
    y = F.conv1d(x.t()[None], w.permute(2, 1, 0), b, padding=pad,
                 groups=groups)
    return y[0].t()


def _gn(x, s, b, groups, eps):
    return F.group_norm(x.t()[None], groups, s, b, eps)[0].t()


def _swish(x):
    return x * torch.sigmoid(x)


def _resnet(p, x, cfg, wf):
    h = _swish(_gn(x, p["norm1_s"], p["norm1_b"], cfg.groupnorm_groups,
                   cfg.groupnorm_eps))
    h = _conv(h, wf(p["conv1_w"]), p["conv1_b"], 1)
    h = _swish(_gn(h, p["norm2_s"], p["norm2_b"], cfg.groupnorm_groups,
                   cfg.groupnorm_eps))
    return x + _conv(h, wf(p["conv2_w"]), p["conv2_b"], 1)


def _attn(p, x, cfg, wf):
    h = _gn(x, p["norm_s"], p["norm_b"], cfg.groupnorm_groups,
            cfg.groupnorm_eps)
    q, k, v = (h @ wf(p[f"{n}_w"]) + p[f"{n}_b"] for n in "qkv")
    w = ((q @ k.t()) / math.sqrt(x.shape[-1])).softmax(-1)
    return x + (w @ v) @ wf(p["proj_w"]) + p["proj_b"]


def _ada_ln(x, scale, shift, eps):
    return F.layer_norm(x, (x.shape[-1],), None, None, eps) * scale + shift


def istft_same(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(T, n_fft/2 + 1) complex -> (hop * T,) samples."""
    t = spec.shape[0]
    n = torch.arange(n_fft, device=spec.device, dtype=torch.float64)
    win = (0.5 * (1.0 - torch.cos(2.0 * math.pi * n / n_fft))).float()
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    total = (t - 1) * hop + n_fft

    def overlap_add(f):     # (T, n_fft) -> (total,)
        return F.fold(f.t()[None], (1, total), (1, n_fft),
                      stride=(1, hop)).reshape(total)

    y = overlap_add(frames)
    env = overlap_add((win * win).expand(t, n_fft))
    pad = (n_fft - hop) // 2
    return y[pad:total - pad] / env[pad:total - pad]


def decode(params: Dict, cfg, codes: Sequence[int],
           weight_fn: Optional[Callable] = None) -> torch.Tensor:
    """One chunk's codes -> its ``hop * len(codes)`` samples (f32)."""
    wf = weight_fn or (lambda w: w)
    bb = params["backbone"]
    idx = torch.as_tensor(list(codes), dtype=torch.long,
                          device=params["codebooks"].device)
    x = params["codebooks"][:, idx].sum(0)
    x = _conv(x, wf(bb["embed"]["w"]), bb["embed"]["b"], 3)
    pn = bb["pos_net"]
    x = _resnet(pn["res0"], x, cfg, wf)
    x = _resnet(pn["res1"], x, cfg, wf)
    x = _attn(pn["attn"], x, cfg, wf)
    x = _resnet(pn["res2"], x, cfg, wf)
    x = _resnet(pn["res3"], x, cfg, wf)
    x = _gn(x, pn["gn_s"], pn["gn_b"], cfg.groupnorm_groups,
            cfg.groupnorm_eps)
    x = _ada_ln(x, bb["adanorm"]["scale"][0], bb["adanorm"]["shift"][0],
                cfg.ln_eps)
    cn = bb["convnext"]
    for l in range(cn["gamma"].shape[0]):
        h = _conv(x, cn["dwconv_w"][l], cn["dwconv_b"][l], 3,
                  groups=x.shape[-1])
        h = _ada_ln(h, cn["norm_scale"][l][0], cn["norm_shift"][l][0],
                    cfg.ln_eps)
        h = F.gelu(h @ wf(cn["pw1_w"][l]) + cn["pw1_b"][l])
        x = x + cn["gamma"][l] * (h @ wf(cn["pw2_w"][l]) + cn["pw2_b"][l])
    x = F.layer_norm(x, (x.shape[-1],), bb["final_ln"]["s"],
                     bb["final_ln"]["b"], cfg.ln_eps)
    h = x @ wf(params["head"]["w"]) + params["head"]["b"]
    nb = cfg.n_fft // 2 + 1
    spec = torch.polar(torch.exp(h[:, :nb]).clamp(max=1e2), h[:, nb:])
    return istft_same(spec, cfg.n_fft, cfg.hop_length)
