"""UTMOS MOS predictor (wav2vec2 SSL encoder + listener-conditioned head).

Counterpart of ``llmvox_tpu/codec/utmos.py`` (the reference's automatic
MOS scorer, WavTokenizer/metrics/UTMOS.py:1-223): a fairseq wav2vec2-base
feature encoder, a domain embedding, a judge-conditioned BiLSTM and a
2-layer projection head; the clip score is the frame-score mean * 2 + 3.

Channel-last (B, T, C) throughout, the params in the converted-checkpoint
layout (``tools/convert.py::convert_utmos_state_dict``, the 12 encoder
layers stacked on a leading axis): seven VALID strided convs (the first
with a per-channel GroupNorm), each followed by exact GELU; the feature
projection; the grouped positional conv (padding K/2, the last frame
dropped for an even kernel); 12 post-norm layers with the attention in
f32 (f64 for f64 inputs); the BiLSTM as torch's LSTM op (cuDNN's on the
card) with JAX's ``(in, 4H)`` weights and gate order i, f, g, o, the
backward direction over the reversed sequence.  ``register`` activates
the ``"utmos"`` metric plug-in (``codec/metrics.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.seanet import lstm_layer
from llmvox_tpu_torch.ops import nn as ops
from llmvox_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class UTMOSConfig:
    """Defaults = wav2vec2-base ("wav2vec_small.pt") + the UTMOS head."""
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 3, 2), (512, 2, 2), (512, 2, 2))       # (dim, kernel, stride)
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    encoder_ffn: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    n_domains: int = 3
    domain_dim: int = 128
    num_judges: int = 3000
    judge_dim: int = 128
    lstm_hidden: int = 512
    proj_hidden: int = 2048
    ln_eps: float = 1e-5
    # the reference scores with domain 0 and judge 288 (UTMOS.py:45-49)
    domain_id: int = 0
    judge_id: int = 288


def lstm_direction(p: Dict, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction of the BiLSTM over (B, L, in) from zero state;
    ``reverse`` runs it from the last frame to the first (outputs kept in
    frame order)."""
    if reverse:
        return lstm_layer(p, x.flip(1)).flip(1)
    return lstm_layer(p, x)


def encoder_features(params: Dict, wav: torch.Tensor,
                     cfg: UTMOSConfig) -> torch.Tensor:
    """wav (B, T) -> wav2vec2 encoder output (B, T', encoder_dim)."""
    x = wav[..., None]                                  # (B, T, 1)
    for i, (dim, _, stride) in enumerate(cfg.conv_layers):
        x = ops.conv1d(x, params["conv"][i]["w"], stride=stride)
        if i == 0:
            # fairseq GroupNorm(dim, dim): per-channel instance norm
            x = ops.group_norm(x, params["conv0_gn"]["s"],
                               params["conv0_gn"]["b"], dim, cfg.ln_eps)
        x = ops.gelu_exact(x)
    x = ops.layer_norm(x, params["fp_ln"]["s"], params["fp_ln"]["b"],
                       cfg.ln_eps)
    x = ops.linear(x, params["fp_w"], params["fp_b"])

    # the convolutional positional embedding: K // 2 a side, the last
    # output dropped for an even kernel (fairseq's SamePad), exact GELU
    pos = ops.conv1d(x, params["pos_conv"]["w"], params["pos_conv"]["b"],
                     padding=cfg.pos_conv_kernel // 2,
                     groups=cfg.pos_conv_groups)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :-1]
    x = x + ops.gelu_exact(pos)
    x = ops.layer_norm(x, params["enc_ln"]["s"], params["enc_ln"]["b"],
                       cfg.ln_eps)

    b, t, e = x.shape
    nh = cfg.encoder_heads
    hd = e // nh
    scale = 1.0 / math.sqrt(hd)
    lp = params["layers"]
    for i in range(lp["wq"].shape[0]):
        def lin(name):
            return ops.linear(x, lp["w" + name][i], lp["b" + name][i])
        q = (lin("q") * scale).reshape(b, t, nh, hd)
        k = lin("k").reshape(b, t, nh, hd)
        v = lin("v").reshape(b, t, nh, hd)
        logits = torch.einsum("bthd,bshd->bhts", ops.wide(q), ops.wide(k))
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        att = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, e)
        x = x + ops.linear(att, lp["wo"][i], lp["bo"][i])
        x = ops.layer_norm(x, lp["ln1_s"][i], lp["ln1_b"][i], cfg.ln_eps)
        h = ops.gelu_exact(ops.linear(x, lp["w1"][i], lp["b1"][i]))
        x = x + ops.linear(h, lp["w2"][i], lp["b2"][i])
        x = ops.layer_norm(x, lp["ln2_s"][i], lp["ln2_b"][i], cfg.ln_eps)
    return x


def frame_scores(params: Dict, wav: torch.Tensor,
                 cfg: UTMOSConfig) -> torch.Tensor:
    """(B, T) waveform -> (B, T') per-frame scores of the head."""
    x = encoder_features(params, wav, cfg)
    b, t, _ = x.shape
    dom = params["domain_emb"][cfg.domain_id].to(x.dtype)
    judge = params["judge_emb"][cfg.judge_id].to(x.dtype)
    cond = torch.cat([x, dom.expand(b, t, -1), judge.expand(b, t, -1)],
                     dim=-1)
    h = torch.cat([lstm_direction(params["lstm_fwd"], cond, False),
                   lstm_direction(params["lstm_bwd"], cond, True)], dim=-1)
    h = torch.relu(ops.linear(h, params["proj1_w"], params["proj1_b"]))
    return ops.linear(h, params["proj2_w"], params["proj2_b"])[..., 0]


def apply_utmos(params: Dict, wav: torch.Tensor,
                cfg: UTMOSConfig) -> torch.Tensor:
    """(B, T) waveform -> (B,) MOS scores (frame mean * 2 + 3)."""
    return frame_scores(params, wav, cfg).mean(dim=1) * 2.0 + 3.0


def make_scorer(params: Dict, cfg: UTMOSConfig, exact: bool = False,
                grid: int = 4000, device="cuda"):
    """A (wav, sr) -> float scorer in the metrics plug-in signature, on
    ``device`` in f32.

    Zero padding would change the score (the encoder's attention is
    bidirectional and the head averages over every frame), so a clip
    longer than ``grid`` samples is TRIMMED to a multiple of it, as JAX's
    scorer does to keep one compiled program per rung (at most 0.25 s of
    tail dropped at 16 kHz).  ``exact=True`` scores the untouched clip."""
    from llmvox_tpu_torch.utils.params import to_torch
    dev = resolve_device(device)
    tparams = to_torch(params, dev)

    @torch.no_grad()
    def score(wav, sr: int = 16000) -> float:
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        if not exact and wav.shape[1] > grid:
            wav = wav[:, : wav.shape[1] // grid * grid]
        x = torch.from_numpy(wav).to(dev)
        return float(apply_utmos(tparams, x, cfg)[0])

    return score


def register(params: Dict, cfg: UTMOSConfig = UTMOSConfig(),
             device="cuda") -> None:
    """Activate the ``"utmos"`` metric plug-in with converted weights."""
    from llmvox_tpu_torch.codec import metrics
    metrics.register_plugin("utmos", make_scorer(params, cfg, device=device))
