"""Small neural-net ops shared by the decoder and the codec.

Counterparts of ``llmvox_tpu/ops/nn.py`` with the same layouts: tensors
are channel-last ``(B, L, C)``, Linear weights ``(Cin, Cout)`` applied as
``x @ w``, conv kernels ``(K, Cin/groups, Cout)`` (permuted here for
``F.conv1d``).  Norms compute their statistics in f32 and return the
input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from llmvox_tpu_torch.ops import cuda_int4_mm, quant


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def valid_mask(length: int, valid_len, device) -> torch.Tensor:
    """(B or 1, length) f32 mask of positions < valid_len; ``valid_len`` is
    a Python int, a 0-d tensor or a per-batch (B,) tensor."""
    idx = torch.arange(length, device=device)
    if isinstance(valid_len, torch.Tensor):
        vl = valid_len.to(device).reshape(-1, 1)
    else:
        vl = int(valid_len)
    return (idx[None, :] < vl).float()


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, valid_len=None) -> torch.Tensor:
    """GroupNorm for (B, L, C): stats over (L, channels-in-group).

    With ``valid_len`` the statistics cover positions [0, valid_len) only
    and padding positions are zeroed, so the valid positions equal a run
    at the exact length (``F.group_norm`` cannot mask, hence the formula).
    """
    b, l, c = x.shape
    g = num_groups
    x32 = x.float().reshape(b, l, g, c // g)
    mask = None
    if valid_len is None:
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        mask = valid_mask(l, valid_len, x.device)[:, :, None, None]
        if isinstance(valid_len, torch.Tensor):
            vl = valid_len.to(x.device).float().reshape(-1, 1, 1, 1)
        else:
            vl = float(valid_len)
        denom = vl * (c // g)
        x32 = x32 * mask
        mean = x32.sum(dim=(1, 3), keepdim=True) / denom
        xc = (x32 - mean) * mask
        var = xc.square().sum(dim=(1, 3), keepdim=True) / denom
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, l, c)
    y = y * scale.float() + bias.float()
    if mask is not None:
        y = y * mask.reshape(mask.shape[0], l, 1)
    return y.to(x.dtype)


Padding = Union[int, Sequence[Tuple[int, int]]]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: Padding = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution on (B, L, C) with kernel (K, Cin/groups, Cout).

    ``padding`` is an int (both sides) or ``[(lo, hi)]`` explicit zero
    padding, as the JAX op takes it."""
    if isinstance(padding, int):
        lo = hi = padding
    else:
        (lo, hi), = padding
    xt = x.transpose(1, 2)
    if lo or hi:
        xt = F.pad(xt, (lo, hi))
    y = F.conv1d(xt, w.to(x.dtype).permute(2, 1, 0), stride=stride,
                 dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def dense_weight(w, dtype) -> torch.Tensor:
    """A matmul weight at ``dtype``: plain tensors cast, quantized
    containers (``ops/quant.py``) dequantize in ``dtype``."""
    if isinstance(w, quant.QUANTIZED):
        return quant.dequantize(w, dtype)
    return w.to(dtype)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Dense layer, ``w`` is (Cin, Cout).  The product takes x's dtype
    (bf16 in gives bf16 out, accumulated in f32 by the matmul).

    ``w`` may be quantized, as JAX's ``linear`` dispatches: an
    ``Int8Linear`` runs ``int8_matmul``, a 2-D ``Int4Tensor`` kernel K4 (its
    plain version on CPU tensors), and a ``QuantizedTensor`` dequantizes
    into the matmul operand in x's dtype."""
    if isinstance(w, quant.Int8Linear):
        y = quant.int8_matmul(x, w)
    elif isinstance(w, quant.Int4Tensor) and w.q.dim() == 2:
        y = cuda_int4_mm.int4_matmul(x, w.q, w.s)
    else:
        y = x @ dense_weight(w, x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU, computed in f32 (the decoder activation)."""
    x32 = x.float()
    c = math.sqrt(2.0 / math.pi)
    y = 0.5 * x32 * (1.0 + torch.tanh(c * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the codec ConvNeXt activation."""
    return F.gelu(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid in f32 (the codec pos_net activation)."""
    return x * torch.sigmoid(x.float()).to(x.dtype)


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / max(||x||_2, eps) over the last axis, computed in f32."""
    x32 = x.float()
    norm = x32.square().sum(dim=-1, keepdim=True).sqrt()
    return (x32 / norm.clamp_min(eps)).to(x.dtype)
