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
so full-width weights can be made without JAX; ``init_llama_params`` does
the same for ``llmvox_tpu/models/llama.py::init_llama_params`` from a
torch generator on the target device (an 8B tree is drawn on the card in
well under a second, where numpy would take minutes), and
``init_whisper_params`` for ``llmvox_tpu/models/whisper.py::
init_whisper_params``; ``init_utmos_params``, ``init_lm_params``,
``init_imdct_symexp_head``, ``init_imdct_cos_head`` and
``init_resnet_backbone`` draw the codec scorer's, the Encodec LM's and
the alternative heads' and backbone's trees with numpy.  They are not the
JAX initialisers' values: ``jax.random``, numpy and torch draw different
numbers.

The codec trainer's state crosses the same way: ``codec_train_trees``
turns a ``CodecTrainState`` (JAX's after ``jax.device_get``, or the
port's) into numpy trees, the generator's and discriminators' params
(weight norms as ``{g, v, b}``) and the VQ state as the dict JAX's
checkpoint writes (``embed``, ``embed_avg``, ``cluster_size``,
``inited``): the port's ``CodecTrainer`` takes them as they are, and
JAX's state is rebuilt from them (``vq_from_numpy`` makes the port's
``VQState``).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from llmvox_tpu_torch.models.llama import LlamaConfig
from llmvox_tpu_torch.models.whisper import WhisperConfig
from llmvox_tpu_torch.ops import quant
from llmvox_tpu_torch.train.vq_train import VQState
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


def init_llama_params(seed: int, cfg: LlamaConfig, device="cpu",
                      dtype: torch.dtype = torch.float32,
                      experts: bool = True) -> Dict:
    """A Llama tree in the converted-checkpoint layout (HF init:
    normal(0.02) matrices, RMSNorm scales 1), drawn in ``dtype`` on
    ``device`` from a ``torch.Generator`` seeded with ``seed``, in a fixed
    order, so a seed gives the same tree on every call on one device.

    The keys and shapes are JAX's ``init_llama_params``' (its PRNG cannot
    be reproduced): with ``n_experts`` the dense ``wgate/wup/wdown`` give
    way to ``router (C, E)`` and ``moe_wgate``, ``moe_wup`` (E, C, I) and
    ``moe_wdown`` (E, I, C); with ``n_draft_heads`` the tree gains
    ``draft_heads (n, C, V)``.  In the spirit of JAX's fixed key
    positions, the draw order keeps a dense tree the same for a seed
    whatever the draft heads (drawn last), and an MoE tree's embedding
    and attention weights those of the dense tree (the experts come from
    generators of their own, ``draw_llama_experts``; the head follows
    the attention).

    ``experts=False`` leaves the expert weights out, for a caller that
    draws and quantizes them a layer at a time (``draw_llama_experts``:
    a Mixtral-8x7B tree is 93 GB in bf16)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    l, c, hd = cfg.n_layer, cfg.n_embd, cfg.head_dim
    kvd, inter = cfg.n_kv_head * hd, cfg.intermediate_size

    def norm(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    params = {
        "tok_emb": norm(cfg.vocab_size, c),
        "h": {
            "ln1_s": ones(l, c),
            "wq": norm(l, c, cfg.n_head * hd),
            "wk": norm(l, c, kvd),
            "wv": norm(l, c, kvd),
            "wo": norm(l, cfg.n_head * hd, c),
            "ln2_s": ones(l, c),
        },
        "lnf_s": ones(c),
    }
    if not cfg.n_experts:
        params["h"].update(wgate=norm(l, c, inter), wup=norm(l, c, inter),
                           wdown=norm(l, inter, c))
    if not cfg.tie_embeddings:
        params["head"] = norm(c, cfg.vocab_size)
    if cfg.n_draft_heads > 0:
        params["draft_heads"] = norm(cfg.n_draft_heads, c, cfg.vocab_size)
    if cfg.n_experts and experts:
        params["h"].update(draw_llama_experts(seed + 1, cfg, range(l),
                                              device, dtype))
    return params


def draw_llama_experts(seed: int, cfg: LlamaConfig, layers: Sequence[int],
                       device="cpu", dtype: torch.dtype = torch.float32
                       ) -> Dict:
    """The expert weights of ``layers`` of an MoE Llama, stacked on a
    layer axis: ``router``, ``moe_wgate``, ``moe_wup``, ``moe_wdown``.
    Layer i is drawn from its own generator (``seed`` * 1000003 + i), so
    a layer's weights are the same whichever layers are drawn with it."""
    c, e, inter = cfg.n_embd, cfg.n_experts, cfg.intermediate_size
    shapes = {"router": (c, e), "moe_wgate": (e, c, inter),
              "moe_wup": (e, c, inter), "moe_wdown": (e, inter, c)}
    out = {k: [] for k in shapes}
    for i in layers:
        gen = torch.Generator(device=device).manual_seed(
            seed * 1000003 + int(i))
        for k, shape in shapes.items():
            out[k].append(torch.randn(shape, generator=gen, device=device,
                                      dtype=dtype).mul_(0.02))
    return {k: torch.stack(v) for k, v in out.items()}


def init_whisper_params(seed: int, cfg: WhisperConfig, device="cpu",
                        dtype: torch.dtype = torch.float32) -> Dict:
    """A Whisper tree in the converted-checkpoint layout (HF init:
    normal(0.02) matrices, embeddings and positions, zero biases, LayerNorm
    scales 1), drawn in ``dtype`` on ``device`` from a ``torch.Generator``
    seeded with ``seed``, in a fixed order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model

    def norm(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def attn(n: int, prefix: str = "") -> Dict:
        return {prefix + "wq": norm(n, d, d), prefix + "bq": zeros(n, d),
                prefix + "wk": norm(n, d, d),
                prefix + "wv": norm(n, d, d), prefix + "bv": zeros(n, d),
                prefix + "wo": norm(n, d, d), prefix + "bo": zeros(n, d)}

    def common(n: int, ffn: int) -> Dict:
        return {"ln1_s": ones(n, d), "ln1_b": zeros(n, d),
                "ln2_s": ones(n, d), "ln2_b": zeros(n, d),
                "fc1_w": norm(n, d, ffn), "fc1_b": zeros(n, ffn),
                "fc2_w": norm(n, ffn, d), "fc2_b": zeros(n, d)}

    enc_h = {**common(cfg.enc_layers, cfg.enc_ffn), **attn(cfg.enc_layers)}
    dec_h = {**common(cfg.dec_layers, cfg.dec_ffn), **attn(cfg.dec_layers),
             **attn(cfg.dec_layers, "x"),
             "lnx_s": ones(cfg.dec_layers, d),
             "lnx_b": zeros(cfg.dec_layers, d)}
    return {
        "enc": {"conv1_w": norm(3, cfg.n_mels, d), "conv1_b": zeros(d),
                "conv2_w": norm(3, d, d), "conv2_b": zeros(d),
                "pos": norm(cfg.max_source_positions, d), "h": enc_h,
                "lnf_s": ones(d), "lnf_b": zeros(d)},
        "dec": {"tok_emb": norm(cfg.vocab_size, d),
                "pos": norm(cfg.max_target_positions, d), "h": dec_h,
                "lnf_s": ones(d), "lnf_b": zeros(d)},
    }


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


def _uniform(rng: np.random.Generator, shape, bound: float) -> np.ndarray:
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _zeros(*shape) -> np.ndarray:
    return np.zeros(shape, np.float32)


def _ones(*shape) -> np.ndarray:
    return np.ones(shape, np.float32)


def init_utmos_params(seed: int, cfg) -> Dict:
    """The UTMOS scorer's tree (``codec/utmos.py``, a ``UTMOSConfig``) as
    ``llmvox_tpu/codec/utmos.py::init_utmos_params`` builds it: normal
    0.02 kernels and embeddings, unit norms, zero biases, LSTM weights
    uniform in +-1/sqrt(H)."""
    rng = np.random.default_rng(seed)
    convs, cin = [], 1
    for dim, kernel, _ in cfg.conv_layers:
        convs.append({"w": _normal(rng, (kernel, cin, dim), 0.02)})
        cin = dim
    d, e, nl = cfg.conv_layers[-1][0], cfg.encoder_dim, cfg.encoder_layers
    f = cfg.encoder_ffn
    d0 = cfg.conv_layers[0][0]
    params = {
        "conv": convs,
        "conv0_gn": {"s": _ones(d0), "b": _zeros(d0)},
        "fp_ln": {"s": _ones(d), "b": _zeros(d)},
        "fp_w": _normal(rng, (d, e), 0.02), "fp_b": _zeros(e),
        "pos_conv": {"w": _normal(rng, (cfg.pos_conv_kernel,
                                        e // cfg.pos_conv_groups, e), 0.02),
                     "b": _zeros(e)},
        "enc_ln": {"s": _ones(e), "b": _zeros(e)},
        "layers": {
            "wq": _normal(rng, (nl, e, e), 0.02), "bq": _zeros(nl, e),
            "wk": _normal(rng, (nl, e, e), 0.02), "bk": _zeros(nl, e),
            "wv": _normal(rng, (nl, e, e), 0.02), "bv": _zeros(nl, e),
            "wo": _normal(rng, (nl, e, e), 0.02), "bo": _zeros(nl, e),
            "ln1_s": _ones(nl, e), "ln1_b": _zeros(nl, e),
            "w1": _normal(rng, (nl, e, f), 0.02), "b1": _zeros(nl, f),
            "w2": _normal(rng, (nl, f, e), 0.02), "b2": _zeros(nl, e),
            "ln2_s": _ones(nl, e), "ln2_b": _zeros(nl, e),
        },
        "domain_emb": _normal(rng, (cfg.n_domains, cfg.domain_dim), 0.02),
        "judge_emb": _normal(rng, (cfg.num_judges, cfg.judge_dim), 0.02),
    }
    lstm_in = e + cfg.domain_dim + cfg.judge_dim
    h = cfg.lstm_hidden
    bound = math.sqrt(1.0 / h)
    for direction in ("fwd", "bwd"):
        params[f"lstm_{direction}"] = {
            "wi": _uniform(rng, (lstm_in, 4 * h), bound),
            "wh": _uniform(rng, (h, 4 * h), bound),
            "bi": _zeros(4 * h), "bh": _zeros(4 * h)}
    params["proj1_w"] = _normal(rng, (2 * h, cfg.proj_hidden), 0.02)
    params["proj1_b"] = _zeros(cfg.proj_hidden)
    params["proj2_w"] = _normal(rng, (cfg.proj_hidden, 1), 0.02)
    params["proj2_b"] = _zeros(1)
    return params


def _lm_linear(rng: np.random.Generator, fan_in: int, fan_out: int) -> Dict:
    """torch.nn.Linear's default init: U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return {"w": _uniform(rng, (fan_in, fan_out), bound),
            "b": _uniform(rng, (fan_out,), bound)}


def init_lm_params(seed: int, cfg) -> Dict:
    """The Encodec LM's tree (``codec/lm.py``, an ``LMConfig``) as
    ``llmvox_tpu/codec/lm.py::init_lm`` builds it: N(0, 1) embeddings of
    ``card + 1`` rows per codebook, Linear-default heads, and per layer a
    Xavier-uniform ``qkv`` with zero bias, a Linear-default out projection
    with zero bias, Linear-default feed-forward, unit norms; layers and
    heads stacked on a leading axis."""
    rng = np.random.default_rng(seed)
    d, h, nl = cfg.dim, cfg.hidden_dim, cfg.num_layers
    emb = rng.standard_normal((cfg.n_q, cfg.card + 1, d)).astype(np.float32)
    heads = [_lm_linear(rng, d, cfg.card) for _ in range(cfg.n_q)]
    layers = []
    limit = math.sqrt(6.0 / (d + 3 * d))
    for _ in range(nl):
        layers.append({
            "qkv": {"w": _uniform(rng, (d, 3 * d), limit),
                    "b": _zeros(3 * d)},
            "out": {"w": _lm_linear(rng, d, d)["w"], "b": _zeros(d)},
            "ff1": _lm_linear(rng, d, h),
            "ff2": _lm_linear(rng, h, d),
            "norm1": {"scale": _ones(d), "bias": _zeros(d)},
            "norm2": {"scale": _ones(d), "bias": _zeros(d)}})

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)
    transformer = {"layers": stack(layers)}
    if cfg.norm_in:
        transformer["norm_in"] = {"scale": _ones(d), "bias": _zeros(d)}
    return {"emb": emb, "heads": stack(heads), "transformer": transformer}


def init_imdct_symexp_head(seed: int, dim: int, mdct_frame_len: int,
                           sample_rate: Optional[int] = None) -> Dict:
    """IMDCTSymExpHead's Linear(dim -> N/2) (``codec/heads.py``):
    truncated-normal 0.02, each output column scaled down along the mel
    scale when ``sample_rate`` is given, as JAX's initialiser does."""
    out_dim = mdct_frame_len // 2
    w = _trunc_normal(np.random.default_rng(seed), (dim, out_dim))
    if sample_rate is not None:
        m_max = 2595.0 * np.log10(1.0 + (sample_rate // 2) / 700.0)
        m_pts = np.linspace(0, m_max, out_dim)
        f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
        w = (w * (1.0 - f_pts / f_pts.max())[None, :]).astype(np.float32)
    return {"w": w, "b": _zeros(out_dim)}


def init_imdct_cos_head(seed: int, dim: int, mdct_frame_len: int) -> Dict:
    """IMDCTCosHead's Linear(dim -> N), truncated-normal 0.02."""
    return {"w": _trunc_normal(np.random.default_rng(seed),
                               (dim, mdct_frame_len)),
            "b": _zeros(mdct_frame_len)}


def init_resnet_backbone(seed: int, input_channels: int, dim: int,
                         num_blocks: int,
                         layer_scale_init_value: Optional[float] = None
                         ) -> Dict:
    """VocosResNetBackbone's tree (``codec/backbone.py``): weight-norm
    k3 convs ``{b, g, v}`` (truncated-normal 0.02 kernels), per block 3
    + 3 convs and 3 layer scales of ``layer_scale_init_value`` (default
    1 / num_blocks / 3)."""
    rng = np.random.default_rng(seed)
    gamma0 = layer_scale_init_value or 1.0 / num_blocks / 3.0

    def wn_conv(cin, cout):
        w = _trunc_normal(rng, (3, cin, cout))
        return {"b": _zeros(cout),
                "g": np.sqrt(np.sum(np.square(w), axis=(0, 1),
                                    keepdims=True)).astype(np.float32),
                "v": w}
    blocks = [{"convs1": [wn_conv(dim, dim) for _ in range(3)],
               "convs2": [wn_conv(dim, dim) for _ in range(3)],
               "gamma": [np.full((dim,), gamma0, np.float32)
                         for _ in range(3)]} for _ in range(num_blocks)]
    return {"embed": wn_conv(input_channels, dim), "blocks": blocks}


def random_text_table(seed: int, cfg: DecoderConfig) -> np.ndarray:
    """A random (text_vocab_size, text_embed_dim) ByT5 byte-embedding
    table, standing in for the converted ByT5 encoder's embeddings."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (cfg.text_vocab_size, cfg.text_embed_dim)).astype(np.float32)


def vq_to_numpy(vq) -> Dict[str, np.ndarray]:
    """A VQ state (the port's, JAX's or a dict) -> JAX's dict of arrays."""
    d = vq._asdict() if hasattr(vq, "_asdict") else dict(vq)
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in d.items()}


def vq_from_numpy(vq, device) -> VQState:
    """A VQ state (the port's, JAX's or a dict) -> the port's on
    ``device``."""
    d = vq_to_numpy(vq)
    return VQState(**{k: torch.as_tensor(np.array(d[k])).to(device)
                      for k in VQState._fields})


def to_numpy(tree):
    """Nested dict/list of tensors or arrays -> the same of numpy arrays
    (``to_torch``'s inverse)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def codec_train_trees(state) -> Dict[str, Any]:
    """A codec ``CodecTrainState`` (either package's) -> numpy
    ``gen_params``, ``disc_params`` and ``vq_state`` (a dict), the
    keywords ``CodecTrainer`` takes."""
    return {"gen_params": to_numpy(state.gen_params),
            "disc_params": to_numpy(state.disc_params),
            "vq_state": vq_to_numpy(state.vq_state)}
