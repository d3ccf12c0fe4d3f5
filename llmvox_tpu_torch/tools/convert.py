"""Checkpoint conversion: HF / PyTorch state dicts to the port's trees.

A copy of what ``llmvox_tpu/tools/convert.py`` needs for Whisper:
``convert_whisper_state_dict`` and its helpers.  The trees keep the JAX
layout (stacked layers, Linear weights ``(Cin, Cout)``, conv kernels
``(K, Cin, Cout)``) as numpy float32 arrays; ``utils/params.py::to_torch``
moves them to a device.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def strip_prefix(sd: Mapping, prefix: str = "_orig_mod.") -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def _conv_w(w) -> np.ndarray:
    """torch Conv1d (Cout, Cin, K) -> (K, Cin, Cout)."""
    return np.transpose(_np(w), (2, 1, 0))


def _lin_w(w) -> np.ndarray:
    """torch Linear (Cout, Cin) -> (Cin, Cout)."""
    return _np(w).T


def convert_whisper_state_dict(sd: Mapping, enc_layers: int,
                               dec_layers: int) -> Dict:
    """HF ``WhisperForConditionalGeneration`` state dict ->
    ``models/whisper.py`` params (stacked-layer layout, Linear weights
    transposed to (Cin, Cout), conv kernels to (K, Cin, Cout))."""
    sd = strip_prefix(dict(sd))
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}

    def stack(fmt: str, n: int, f=_lin_w):
        return np.stack([f(sd[fmt.format(i)]) for i in range(n)])

    def attn_block(t: str, n: int, prefix: str = "") -> Dict:
        # k_proj has no bias in every Whisper attention block
        return {
            prefix + "wq": stack(t + ".q_proj.weight", n),
            prefix + "bq": stack(t + ".q_proj.bias", n, _np),
            prefix + "wk": stack(t + ".k_proj.weight", n),
            prefix + "wv": stack(t + ".v_proj.weight", n),
            prefix + "bv": stack(t + ".v_proj.bias", n, _np),
            prefix + "wo": stack(t + ".out_proj.weight", n),
            prefix + "bo": stack(t + ".out_proj.bias", n, _np),
        }

    def common(t: str, n: int) -> Dict:
        return {
            "ln1_s": stack(t + "self_attn_layer_norm.weight", n, _np),
            "ln1_b": stack(t + "self_attn_layer_norm.bias", n, _np),
            "ln2_s": stack(t + "final_layer_norm.weight", n, _np),
            "ln2_b": stack(t + "final_layer_norm.bias", n, _np),
            "fc1_w": stack(t + "fc1.weight", n),
            "fc1_b": stack(t + "fc1.bias", n, _np),
            "fc2_w": stack(t + "fc2.weight", n),
            "fc2_b": stack(t + "fc2.bias", n, _np),
        }

    te = "encoder.layers.{}."
    td = "decoder.layers.{}."
    enc_h = common(te, enc_layers)
    enc_h.update(attn_block(te + "self_attn", enc_layers))
    dec_h = common(td, dec_layers)
    dec_h.update(attn_block(td + "self_attn", dec_layers))
    dec_h.update(attn_block(td + "encoder_attn", dec_layers, prefix="x"))
    dec_h.update({
        "lnx_s": stack(td + "encoder_attn_layer_norm.weight", dec_layers,
                       _np),
        "lnx_b": stack(td + "encoder_attn_layer_norm.bias", dec_layers,
                       _np),
    })
    return {
        "enc": {
            "conv1_w": _conv_w(sd["encoder.conv1.weight"]),
            "conv1_b": _np(sd["encoder.conv1.bias"]),
            "conv2_w": _conv_w(sd["encoder.conv2.weight"]),
            "conv2_b": _np(sd["encoder.conv2.bias"]),
            "pos": _np(sd["encoder.embed_positions.weight"]),
            "h": enc_h,
            "lnf_s": _np(sd["encoder.layer_norm.weight"]),
            "lnf_b": _np(sd["encoder.layer_norm.bias"]),
        },
        "dec": {
            "tok_emb": _np(sd["decoder.embed_tokens.weight"]),
            "pos": _np(sd["decoder.embed_positions.weight"]),
            "h": dec_h,
            "lnf_s": _np(sd["decoder.layer_norm.weight"]),
            "lnf_b": _np(sd["decoder.layer_norm.bias"]),
        },
    }
