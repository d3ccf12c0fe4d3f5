"""The weight bridge: parameter files, pytrees and initialisers, numpy only.

Parameters are plain nested dicts (and lists) keyed exactly as in the JAX
package, with the same layouts.  ``load_params_npz`` reads the flat
``.npz`` files that ``llmvox_tpu.train.checkpoint.save_params_npz`` writes
(keys are ``/``-joined pytree paths, list indices encoded as ``#i``);
``to_torch`` turns such a tree (or a JAX pytree after ``jax.device_get``,
quantized containers included) into tensors on a device.

``init_decoder_params`` and ``init_codec_params`` draw random weights with
the keys, shapes and distributions of the JAX initialisers
(``llmvox_tpu/models/decoder.py::init_decoder_params``,
``llmvox_tpu/codec/codec.py::init_codec_params``) from a numpy generator,
so full-width weights can be made without JAX.  They are not the JAX
initialisers' values: ``jax.random`` and numpy draw different numbers.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from llmvox_tpu_torch.ops import quant
from llmvox_tpu_torch.utils.config import CodecConfig, DecoderConfig


def load_params_npz(path: str):
    """Load a flat npz back into a nested dict/list tree of numpy arrays."""
    with np.load(path) as data:
        tree: Dict[str, Any] = {}
        for key in data.files:
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return _listify(tree)


def _listify(node):
    """Convert {'#0': ..., '#1': ...} dicts back into lists."""
    if isinstance(node, dict):
        conv = {k: _listify(v) for k, v in node.items()}
        if conv and all(k.startswith("#") for k in conv):
            return [conv[f"#{i}"] for i in range(len(conv))]
        return conv
    return node


def load_meta(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)


def _quantized_class(node):
    """The port's container class for a quantized weight: one of the
    port's own, or the JAX package's NamedTuple of the same name (from
    ``jax.device_get`` of a quantized tree), known by its name and its
    ``q`` and ``s`` fields since the port cannot import it."""
    cls = quant.CONTAINERS.get(type(node).__name__)
    if cls is not None and hasattr(node, "q") and hasattr(node, "s"):
        return cls
    return None


def to_torch(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict/list of arrays -> the same structure of tensors on
    ``device``.  ``dtype`` casts floating leaves only; integer leaves keep
    their type.  Quantized containers (``ops/quant.py``, or the JAX
    package's) become the port's, their ``q`` kept int8 and their scales
    ``s`` cast, as JAX's engines cast a quantized tree."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    cls = _quantized_class(tree)
    if cls is not None:
        return cls(q=to_torch(tree.q, device, dtype),
                   s=to_torch(tree.s, device, dtype))
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        t = torch.tensor(np.asarray(tree))   # a copy: leaves may be read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _trunc_normal(rng: np.random.Generator, shape, std: float = 0.02
                  ) -> np.ndarray:
    """std * normal truncated to [-2, 2] (jax.random.truncated_normal)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (std * x).astype(np.float32)


def init_decoder_params(seed: int, cfg: DecoderConfig) -> Dict:
    """GPT-2-style init: normal(0.02), residual projections scaled by
    1/sqrt(2*n_layer), ones for LayerNorm scales, zeros for biases."""
    rng = np.random.default_rng(seed)
    l, c = cfg.n_layer, cfg.n_embd
    resid_std = 0.02 / math.sqrt(2 * l)
    h = {
        "ln1_s": np.ones((l, c), np.float32),
        "wqkv": _normal(rng, (l, c, 3 * c), 0.02),
        "wo": _normal(rng, (l, c, c), resid_std),
        "ln2_s": np.ones((l, c), np.float32),
        "wfc": _normal(rng, (l, c, 4 * c), 0.02),
        "wproj": _normal(rng, (l, 4 * c, c), resid_std),
    }
    if cfg.bias:
        z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
        h.update({"ln1_b": z(l, c), "bqkv": z(l, 3 * c), "bo": z(l, c),
                  "ln2_b": z(l, c), "bfc": z(l, 4 * c), "bproj": z(l, c)})
    params = {
        "wpe": _normal(rng, (cfg.block_size, c), 0.02),
        "h": h,
        "lnf_s": np.ones((c,), np.float32),
        "head": _normal(rng, (c, cfg.vocab_size), 0.02),
    }
    if cfg.bias:
        params["lnf_b"] = np.zeros((c,), np.float32)
    if cfg.n_draft_heads > 0:
        # drawn last, so the other weights do not depend on the head count
        params["draft_heads"] = _normal(
            rng, (cfg.n_draft_heads, c, cfg.vocab_size), 0.02)
    return params


def _init_resnet_block(rng, dim: int) -> Dict:
    return {
        "norm1_s": np.ones((dim,), np.float32),
        "norm1_b": np.zeros((dim,), np.float32),
        "conv1_w": _trunc_normal(rng, (3, dim, dim)),
        "conv1_b": np.zeros((dim,), np.float32),
        "norm2_s": np.ones((dim,), np.float32),
        "norm2_b": np.zeros((dim,), np.float32),
        "conv2_w": _trunc_normal(rng, (3, dim, dim)),
        "conv2_b": np.zeros((dim,), np.float32),
    }


def _init_attn_block(rng, dim: int) -> Dict:
    p = {"norm_s": np.ones((dim,), np.float32),
         "norm_b": np.zeros((dim,), np.float32)}
    for name in ("q", "k", "v", "proj"):
        p[f"{name}_w"] = _trunc_normal(rng, (dim, dim))
        p[f"{name}_b"] = np.zeros((dim,), np.float32)
    return p


def init_codec_params(seed: int, cfg: CodecConfig) -> Dict:
    """Codebooks (normal), ConvNeXt backbone and ISTFT head (truncated
    normal 0.02, zero biases, unit norms, layer-scale 1/num_layers): the
    decode path's parameters, as ``codec.codec.init_codec_params`` builds
    them without encoder or SEANet decoder."""
    rng = np.random.default_rng(seed)
    dim = cfg.backbone_dim
    inter = cfg.backbone_intermediate_dim
    nl = cfg.backbone_num_layers
    nemb = cfg.adanorm_num_embeddings
    codebooks = rng.standard_normal(
        (cfg.num_quantizers, cfg.vq_bins, cfg.vq_dim)).astype(np.float32)
    convnext = {
        "dwconv_w": _trunc_normal(rng, (nl, 7, 1, dim)),
        "dwconv_b": np.zeros((nl, dim), np.float32),
        "norm_scale": np.ones((nl, nemb, dim), np.float32),
        "norm_shift": np.zeros((nl, nemb, dim), np.float32),
        "pw1_w": _trunc_normal(rng, (nl, dim, inter)),
        "pw1_b": np.zeros((nl, inter), np.float32),
        "pw2_w": _trunc_normal(rng, (nl, inter, dim)),
        "pw2_b": np.zeros((nl, dim), np.float32),
        "gamma": np.full((nl, dim), 1.0 / nl, np.float32),
    }
    backbone = {
        "embed": {"w": _trunc_normal(
            rng, (7, cfg.backbone_input_channels, dim)),
                  "b": np.zeros((dim,), np.float32)},
        "pos_net": {
            "res0": _init_resnet_block(rng, dim),
            "res1": _init_resnet_block(rng, dim),
            "attn": _init_attn_block(rng, dim),
            "res2": _init_resnet_block(rng, dim),
            "res3": _init_resnet_block(rng, dim),
            "gn_s": np.ones((dim,), np.float32),
            "gn_b": np.zeros((dim,), np.float32),
        },
        "adanorm": {"scale": np.ones((nemb, dim), np.float32),
                    "shift": np.zeros((nemb, dim), np.float32)},
        "convnext": convnext,
        "final_ln": {"s": np.ones((dim,), np.float32),
                     "b": np.zeros((dim,), np.float32)},
    }
    out_dim = cfg.n_fft + 2
    head = {"w": _trunc_normal(rng, (dim, out_dim)),
            "b": np.zeros((out_dim,), np.float32)}
    return {"codebooks": codebooks, "backbone": backbone, "head": head}


def random_text_table(seed: int, cfg: DecoderConfig) -> np.ndarray:
    """A random (text_vocab_size, text_embed_dim) ByT5 byte-embedding
    table, standing in for the converted ByT5 encoder's embeddings."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (cfg.text_vocab_size, cfg.text_embed_dim)).astype(np.float32)
