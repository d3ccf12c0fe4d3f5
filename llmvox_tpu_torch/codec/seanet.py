"""SEANet encoder and decoder: the codec's analysis network.

Counterpart of ``llmvox_tpu/codec/seanet.py`` (Encodec's SEANet as
WavTokenizer configures it): Conv k7 -> per ratio (2, 4, 5, 8) a residual
block, ELU and a strided downsampling conv of kernel 2 * ratio, channels
32 -> 512 -> a 2-layer LSTM with a skip -> ELU -> Conv k7 to 512, 320x
down in all.  Tensors are channel-last (B, L, C); conv params are folded
``{w, b}`` (inference) or weight-norm ``{g, v, b}`` (training), kernels
(K, Cin, Cout).  The reflect padding follows Encodec's asymmetric rule,
computed from the static shapes.  The initialisers draw uniform(
-1/sqrt(fan_in), 1/sqrt(fan_in)) kernels and LSTM weights (bound
1/sqrt(H)) with numpy: JAX's keys, shapes and distributions, not its
values.

The LSTM runs as torch's LSTM op (cuDNN's on the card, a native loop on
the CPU) with JAX's ``(H, 4H)`` weights passed transposed, gate order i,
f, g, o as both use: one call a layer instead of ~10 launches per frame
in a Python loop (225 frames a layer at 3 s), and autograd through it.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.utils.config import CodecConfig


# ---------------------------------------------------------------------------
# init (numpy, seeded)
# ---------------------------------------------------------------------------

def wn_init(w: np.ndarray) -> Dict:
    """Weight-norm params {g, v, b} of a numpy kernel (the norm over every
    axis but the last), zero bias."""
    axes = tuple(range(w.ndim - 1))
    g = np.sqrt(np.sum(np.square(w), axis=axes, keepdims=True))
    return {"g": g.astype(np.float32), "v": w,
            "b": np.zeros((w.shape[-1],), np.float32)}


def _conv(rng: np.random.Generator, k: int, cin: int, cout: int,
          weight_norm: bool) -> Dict:
    bound = math.sqrt(1.0 / (k * cin))
    w = rng.uniform(-bound, bound, (k, cin, cout)).astype(np.float32)
    if weight_norm:
        return wn_init(w)
    return {"w": w, "b": np.zeros((cout,), np.float32)}


def _lstm(rng: np.random.Generator, h: int, n: int) -> List[Dict]:
    bound = math.sqrt(1.0 / h)
    return [{"wi": rng.uniform(-bound, bound, (h, 4 * h)).astype(np.float32),
             "wh": rng.uniform(-bound, bound, (h, 4 * h)).astype(np.float32),
             "bi": np.zeros((4 * h,), np.float32),
             "bh": np.zeros((4 * h,), np.float32)} for _ in range(n)]


def init_seanet_encoder(seed: int, cfg: CodecConfig,
                        weight_norm: bool = False) -> Dict:
    rng = np.random.default_rng(seed)
    nf = cfg.n_filters
    params: Dict = {"conv_in": _conv(rng, cfg.seanet_kernel_size, 1, nf,
                                     weight_norm)}
    stages, mult = [], 1
    for ratio in reversed(cfg.downsamples):
        ch = mult * nf
        hidden = ch // cfg.seanet_compress
        res = [{"conv1": _conv(rng, cfg.seanet_residual_kernel_size, ch,
                               hidden, weight_norm),
                "conv2": _conv(rng, 1, hidden, ch, weight_norm),
                "shortcut": _conv(rng, 1, ch, ch, weight_norm)}
               for _ in range(cfg.seanet_n_residual_layers)]
        stages.append({"res": res, "down": _conv(rng, ratio * 2, ch, ch * 2,
                                                 weight_norm)})
        mult *= 2
    params["stages"] = stages
    params["lstm"] = _lstm(rng, mult * nf, cfg.seanet_lstm_layers)
    params["conv_out"] = _conv(rng, cfg.seanet_last_kernel_size, mult * nf,
                               cfg.seanet_dimension, weight_norm)
    return params


def init_seanet_decoder(seed: int, cfg: CodecConfig,
                        weight_norm: bool = False) -> Dict:
    """The decoder's params; each transposed-conv kernel is (K, Cout,
    Cin) with its fan-in taken as K * Cout, as JAX's."""
    rng = np.random.default_rng(seed)
    nf = cfg.n_filters
    mult = 2 ** len(cfg.downsamples)
    params: Dict = {"conv_in": _conv(rng, cfg.seanet_kernel_size,
                                     cfg.seanet_dimension, mult * nf,
                                     weight_norm)}
    params["lstm"] = _lstm(rng, mult * nf, cfg.seanet_lstm_layers)
    stages = []
    for ratio in cfg.downsamples:
        ch = mult * nf
        out = ch // 2
        hidden = out // cfg.seanet_compress
        up = {**_conv(rng, ratio * 2, out, ch, weight_norm),
              "b": np.zeros((out,), np.float32)}
        res = [{"conv1": _conv(rng, cfg.seanet_residual_kernel_size, out,
                               hidden, weight_norm),
                "conv2": _conv(rng, 1, hidden, out, weight_norm),
                "shortcut": _conv(rng, 1, out, out, weight_norm)}
               for _ in range(cfg.seanet_n_residual_layers)]
        stages.append({"up": up, "res": res})
        mult //= 2
    params["stages"] = stages
    params["conv_out"] = _conv(rng, cfg.seanet_last_kernel_size, nf, 1,
                               weight_norm)
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def pad_reflect(x: torch.Tensor, left: int, right: int,
                dim: int = 1) -> torch.Tensor:
    """Reflect-pad axis ``dim`` of x (``jnp.pad(mode="reflect")``).  The
    axis is moved last for ``F.pad``, which reflects only trailing dims
    and needs each pad below the axis' length; a longer pad reflects
    again in chunks of the original length less one, as numpy's does."""
    if left == 0 and right == 0:
        return x
    x = x.movedim(dim, -1)
    shape = x.shape
    flat = x.reshape(-1, 1, shape[-1])
    n = shape[-1] - 1
    while left or right:
        lo, hi = min(left, n), min(right, n)
        flat = F.pad(flat, (lo, hi), mode="reflect")
        left, right = left - lo, right - hi
    return flat.reshape(*shape[:-1], flat.shape[-1]).movedim(-1, dim)


def sconv_padding(length: int, kernel: int, stride: int, dilation: int = 1):
    """Encodec's SConv1d padding: (left, right) for a length."""
    keff = (kernel - 1) * dilation + 1
    pt = keff - stride
    n_frames = (length - keff + pt) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (keff - pt)
    extra = ideal - length
    right = pt // 2
    left = pt - right
    return left, right + extra


def sconv1d(x: torch.Tensor, p: Dict, *, stride: int = 1,
            dilation: int = 1) -> torch.Tensor:
    """SConv1d: reflect "same-style" padding, then a valid conv."""
    w = nn.effective_weight(p)
    left, right = sconv_padding(x.shape[1], w.shape[0], stride, dilation)
    return nn.conv1d(pad_reflect(x, left, right), w, p["b"], stride=stride,
                     dilation=dilation)


def lstm_layer(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over (B, L, H) from zero state; weights ``wi``,
    ``wh`` (H, 4H) and biases ``bi``, ``bh`` (4H,), gates i, f, g, o."""
    b = x.shape[0]
    h = p["wh"].shape[0]
    h0 = x.new_zeros((1, b, h))
    # cuDNN's RNN takes dense inputs and (4H, H) weights, copied into its
    # own buffer at each call (8 MB a layer at H 512), and keeps what its
    # backward needs only in training mode (dropout is 0 either way)
    weights = [p["wi"].t().contiguous(), p["wh"].t().contiguous(), p["bi"],
               p["bh"]]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "RNN module weights")
        y, _, _ = torch.lstm(x.contiguous(), (h0, h0), weights, True, 1,
                             0.0, torch.is_grad_enabled(), False, True)
    return y


def _residual(x: torch.Tensor, res: Dict, dilation: int) -> torch.Tensor:
    h = F.elu(x)
    h = sconv1d(h, res["conv1"], dilation=dilation)
    h = F.elu(h)
    h = sconv1d(h, res["conv2"])
    return sconv1d(x, res["shortcut"]) + h


def apply_seanet_encoder(params: Dict, wav: torch.Tensor,
                         cfg: CodecConfig) -> torch.Tensor:
    """(B, T) waveform -> (B, ceil(T / 320), dim) embeddings."""
    ratios = list(reversed(cfg.downsamples))
    x = sconv1d(wav[..., None], params["conv_in"])
    for ratio, stage in zip(ratios, params["stages"]):
        for j, res in enumerate(stage["res"]):
            x = _residual(x, res, cfg.seanet_dilation_base ** j)
        x = sconv1d(F.elu(x), stage["down"], stride=ratio)
    lstm_in = x
    for layer in params["lstm"]:
        x = lstm_layer(layer, x)
    x = F.elu(x + lstm_in)
    return sconv1d(x, params["conv_out"])


def apply_seanet_decoder(params: Dict, z: torch.Tensor,
                         cfg: CodecConfig) -> torch.Tensor:
    """(B, L, dim) features -> (B, ~L * 320) waveform: Conv k7 -> LSTM ->
    per ratio (8, 5, 4, 2) ELU, a transposed conv (kernel 2r, stride r,
    kernel (K, Cout, Cin)) trimmed asymmetrically and a residual block ->
    ELU -> Conv k7 to one channel."""
    x = sconv1d(z, params["conv_in"])
    lstm_in = x
    for layer in params["lstm"]:
        x = lstm_layer(layer, x)
    x = x + lstm_in
    for ratio, stage in zip(cfg.downsamples, params["stages"]):
        y = nn.conv1d_transpose(F.elu(x), nn.effective_weight(stage["up"]),
                                stage["up"]["b"], stride=ratio)
        right = ratio // 2
        left = ratio - right
        x = y[:, left: y.shape[1] - right]
        for j, res in enumerate(stage["res"]):
            x = _residual(x, res, cfg.seanet_dilation_base ** j)
    return sconv1d(F.elu(x), params["conv_out"])[..., 0]
