"""ConvNeXt vocoder backbone (WavTokenizer's VocosBackbone), decode only.

Counterpart of ``llmvox_tpu/codec/backbone.py::apply_backbone``: embed
Conv1d(512->768, k7) -> pos_net [ResnetBlock x2, AttnBlock, ResnetBlock
x2, GroupNorm] -> AdaLayerNorm -> 12 ConvNeXt blocks -> final LayerNorm,
channel-last throughout.  With ``valid_len`` every global op (GroupNorm
statistics, attention keys, conv paddings) ignores frames at index >=
valid_len, so the valid frames equal a run at the exact length: ragged
chunks decode at a few padded bucket lengths.  ``apply_resnet_backbone``
is the reference's alternative VocosResNetBackbone (HiFi-GAN ResBlock1
stacks of weight-norm convs).
"""
from __future__ import annotations

from typing import Dict

import torch

from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.ops.nn import valid_mask
from llmvox_tpu_torch.utils.config import CodecConfig


def _resnet_block(p: Dict, x: torch.Tensor, cfg: CodecConfig,
                  valid_len=None, mask=None) -> torch.Tensor:
    """GroupNorm -> swish -> conv3 -> GroupNorm -> swish -> conv3, residual.
    With a mask, every conv input holds exact zeros at padded frames."""
    h = nn.group_norm(x, p["norm1_s"], p["norm1_b"], cfg.groupnorm_groups,
                      cfg.groupnorm_eps, valid_len)
    h = nn.swish(h)
    h = nn.conv1d(h, p["conv1_w"], p["conv1_b"], padding=[(1, 1)])
    if mask is not None:
        h = h * mask
    h = nn.group_norm(h, p["norm2_s"], p["norm2_b"], cfg.groupnorm_groups,
                      cfg.groupnorm_eps, valid_len)
    h = nn.swish(h)
    h = nn.conv1d(h, p["conv2_w"], p["conv2_b"], padding=[(1, 1)])
    out = x + h
    if mask is not None:
        out = out * mask
    return out


def _attn_block(p: Dict, x: torch.Tensor, cfg: CodecConfig,
                valid_len=None, mask=None) -> torch.Tensor:
    """Single-head full attention over frames, softmax in f32."""
    c = x.shape[-1]
    h = nn.group_norm(x, p["norm_s"], p["norm_b"], cfg.groupnorm_groups,
                      cfg.groupnorm_eps, valid_len)
    q = nn.linear(h, p["q_w"], p["q_b"])
    k = nn.linear(h, p["k_w"], p["k_b"])
    v = nn.linear(h, p["v_w"], p["v_b"])
    logits = torch.einsum("blc,bmc->blm", nn.wide(q), nn.wide(k)) * (c ** -0.5)
    if valid_len is not None:
        kmask = valid_mask(x.shape[1], valid_len, x.device)[:, None, :]
        logits = logits.masked_fill(kmask == 0, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("blm,bmc->blc", w, v)
    out = nn.linear(out, p["proj_w"], p["proj_b"])
    out = x + out
    if mask is not None:
        out = out * mask
    return out


def _ada_layer_norm(scale_emb, shift_emb, x, cond_id: int, eps: float):
    """LayerNorm without affine, then the condition's scale and shift."""
    y = nn.layer_norm(x, None, None, eps)
    return y * scale_emb[cond_id].to(y.dtype) + shift_emb[cond_id].to(y.dtype)


def _convnext_block(p: Dict, x: torch.Tensor, cond_id: int, eps: float,
                    mask=None) -> torch.Tensor:
    """Depthwise k7 -> AdaLN -> pw1 -> GELU(exact) -> pw2 -> gamma,
    residual."""
    dim = x.shape[-1]
    h = nn.conv1d(x, p["dwconv_w"], p["dwconv_b"], padding=[(3, 3)],
                  groups=dim)
    h = _ada_layer_norm(p["norm_scale"], p["norm_shift"], h, cond_id, eps)
    h = nn.linear(h, p["pw1_w"], p["pw1_b"])
    h = nn.gelu_exact(h)
    h = nn.linear(h, p["pw2_w"], p["pw2_b"])
    out = x + p["gamma"].to(h.dtype) * h
    if mask is not None:
        out = out * mask
    return out


def apply_backbone(params: Dict, features: torch.Tensor, bandwidth_id: int,
                   cfg: CodecConfig, valid_len=None) -> torch.Tensor:
    """(B, L, 512) features -> (B, L, 768) hidden states."""
    eps = cfg.ln_eps
    mask = None
    if valid_len is not None:
        mask = valid_mask(features.shape[1], valid_len,
                          features.device)[:, :, None].to(features.dtype)
        features = features * mask
    x = nn.conv1d(features, params["embed"]["w"], params["embed"]["b"],
                  padding=[(3, 3)])
    if mask is not None:
        x = x * mask
    pn = params["pos_net"]
    x = _resnet_block(pn["res0"], x, cfg, valid_len, mask)
    x = _resnet_block(pn["res1"], x, cfg, valid_len, mask)
    x = _attn_block(pn["attn"], x, cfg, valid_len, mask)
    x = _resnet_block(pn["res2"], x, cfg, valid_len, mask)
    x = _resnet_block(pn["res3"], x, cfg, valid_len, mask)
    x = nn.group_norm(x, pn["gn_s"], pn["gn_b"], cfg.groupnorm_groups,
                      cfg.groupnorm_eps, valid_len)
    x = _ada_layer_norm(params["adanorm"]["scale"],
                        params["adanorm"]["shift"], x, bandwidth_id, eps)
    if mask is not None:
        x = x * mask
    cn = params["convnext"]
    for layer in range(cn["gamma"].shape[0]):
        x = _convnext_block({k: v[layer] for k, v in cn.items()}, x,
                            bandwidth_id, eps, mask)
    return nn.layer_norm(x, params["final_ln"]["s"], params["final_ln"]["b"],
                         eps)


# ---------------------------------------------------------------------------
# VocosResNetBackbone, the reference's shipped alternative backbone
# (decoder/models.py:238-264 with ResBlock1, decoder/modules.py:89-191);
# its initialiser is ``utils/params.py::init_resnet_backbone``
# ---------------------------------------------------------------------------

def _resblock1(p: Dict, x: torch.Tensor, lrelu_slope: float = 0.1,
               dilations=(1, 3, 5)) -> torch.Tensor:
    """HiFi-GAN V1 ResBlock without upsampling (modules.py:172-181)."""
    for c1, c2, gamma, dil in zip(p["convs1"], p["convs2"], p["gamma"],
                                  dilations):
        xt = nn.leaky_relu(x, lrelu_slope)
        pad = (3 * dil - dil) // 2
        xt = nn.conv1d(xt, nn.effective_weight(c1), c1["b"],
                       padding=[(pad, pad)], dilation=dil)
        xt = nn.leaky_relu(xt, lrelu_slope)
        xt = nn.conv1d(xt, nn.effective_weight(c2), c2["b"],
                       padding=[(1, 1)])
        if gamma is not None:
            xt = gamma.to(xt.dtype) * xt
        x = xt + x
    return x


def apply_resnet_backbone(params: Dict, features: torch.Tensor,
                          **_) -> torch.Tensor:
    """(B, L, Cin) -> (B, L, dim); VocosResNetBackbone.forward
    (models.py:260-264)."""
    x = nn.conv1d(features, nn.effective_weight(params["embed"]),
                  params["embed"]["b"], padding=[(1, 1)])
    for block in params["blocks"]:
        x = _resblock1(block, x)
    return x
