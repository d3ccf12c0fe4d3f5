"""Small neural-net ops shared by the decoder and the codec.

Counterparts of ``llmvox_tpu/ops/nn.py`` with the same layouts: tensors
are channel-last ``(B, L, C)`` or ``(B, H, W, C)``, Linear weights
``(Cin, Cout)`` applied as ``x @ w``, conv kernels ``(K, Cin/groups,
Cout)`` and ``(KH, KW, Cin/groups, Cout)``, transposed-conv kernels ``(K,
Cout, Cin)``, each permuted where it is called for torch's channel-first
ops.  Weight norm is ``{g, v}`` with the norm over every axis but the last
(the output channels).  Norms compute their statistics in f32 and return
the input's dtype (f64 inputs keep f64: ``wide``).

f64 runs exist for checks: a trainer in f64 is the reference that f32
rounding is measured against.  So an op that computes in f32 whatever its
input casts with ``wide`` (or builds its constants in ``wide_dtype``),
never with ``.float()``; ``tests/test_torch_codec_train.py``'s
``test_f64_step_makes_no_f32_tensor`` fails on a codec training step that
makes an f32 tensor from f64 inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from llmvox_tpu_torch.ops import cuda_int4_mm, quant


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 for f64, else f32: the dtype an op's statistics and activations
    are computed in (f64 runs exist for checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in ``wide_dtype(x.dtype)``."""
    return x if x.dtype == torch.float64 else x.float()


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance)."""
    x32 = wide(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * wide(scale)
    if bias is not None:
        y = y + wide(bias)
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
    x32 = wide(x).reshape(b, l, g, c // g)
    mask = None
    if valid_len is None:
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        mask = valid_mask(l, valid_len, x.device)[:, :, None, None]
        if isinstance(valid_len, torch.Tensor):
            vl = valid_len.to(x.device).to(x32.dtype).reshape(-1, 1, 1, 1)
        else:
            vl = float(valid_len)
        denom = vl * (c // g)
        x32 = x32 * mask
        mean = x32.sum(dim=(1, 3), keepdim=True) / denom
        xc = (x32 - mean) * mask
        var = xc.square().sum(dim=(1, 3), keepdim=True) / denom
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, l, c)
    y = y * wide(scale) + wide(bias)
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


def conv1d_transpose(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     stride: int = 1) -> torch.Tensor:
    """Transposed 1-D convolution on (B, L, Cin) with JAX's kernel layout
    (K, Cout, Cin) (``lax.conv_transpose`` with ``transpose_kernel=True``,
    padding VALID): torch's ConvTranspose1d with padding 0, whose weight
    (Cin, Cout, K) is this kernel permuted.  (B, (L - 1) * stride + K,
    Cout) out; the caller trims."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
                           stride=stride).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


Pads2d = Union[Tuple[int, int], Sequence[Tuple[int, int]]]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride=(1, 1), padding: Pads2d = (0, 0), groups: int = 1,
           rhs_dilation=(1, 1)) -> torch.Tensor:
    """2-D convolution on (B, H, W, C) with kernel (KH, KW, Cin/groups,
    Cout), as ``lax.conv_general_dilated`` with NHWC/HWIO/NHWC: explicit
    zero ``padding`` ``(ph, pw)`` (both sides) or ``[(lo, hi), (lo, hi)]``,
    ``rhs_dilation`` the kernel's dilation.  The NHWC input permuted to
    NCHW is a view in torch's channels-last layout."""
    if isinstance(padding[0], int):
        (hl, hh), (wl, wh) = (padding[0],) * 2, (padding[1],) * 2
    else:
        (hl, hh), (wl, wh) = padding
    xt = x.permute(0, 3, 1, 2)
    if hl == hh and wl == wh:
        pad = (hl, wl)
    else:
        xt, pad = F.pad(xt, (wl, wh, hl, hh)), (0, 0)
    y = F.conv2d(xt, w.to(x.dtype).permute(3, 2, 0, 1).contiguous(),
                 stride=tuple(stride),
                 padding=pad, dilation=tuple(rhs_dilation), groups=groups)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def weight_norm_init(w: torch.Tensor) -> dict:
    """A kernel as weight-norm params {g, v}, w = g * v / ||v||, the norm
    over every axis but the last (torch's ``weight_norm(dim=0)`` on the
    channel-first kernel)."""
    axes = tuple(range(w.dim() - 1))
    return {"g": w.square().sum(dim=axes, keepdim=True).sqrt(), "v": w}


def effective_weight(p: dict) -> torch.Tensor:
    """The kernel of weight-norm params {g, v} (the norm clamped at 1e-12)
    or of folded params {w}."""
    if "v" in p:
        v = p["v"]
        axes = tuple(range(v.dim() - 1))
        norm = v.square().sum(dim=axes, keepdim=True).sqrt()
        return p["g"] * v / norm.clamp_min(1e-12)
    return p["w"]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """x where x >= 0, else slope * x (JAX's form: the gradient at 0 is 1)."""
    return torch.where(x >= 0, x, negative_slope * x)


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
    x32 = wide(x)
    c = math.sqrt(2.0 / math.pi)
    y = 0.5 * x32 * (1.0 + torch.tanh(c * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the codec ConvNeXt activation."""
    return F.gelu(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid in f32 (the codec pos_net activation)."""
    return x * torch.sigmoid(wide(x)).to(x.dtype)


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / max(||x||_2, eps) over the last axis, computed in f32."""
    x32 = wide(x)
    norm = x32.square().sum(dim=-1, keepdim=True).sqrt()
    return (x32 / norm.clamp_min(eps)).to(x.dtype)
