"""Encodec language model over RVQ codes, the compression-rate booster.

Counterpart of ``llmvox_tpu/codec/lm.py`` (the reference's ``LMModel`` +
``StreamingTransformerEncoder``, WavTokenizer/encoder/model.py:27-66,
encoder/modules/transformer.py:16-119), with its layout: layer params
stacked on a leading axis, the streaming state a FIXED-SIZE right-aligned
buffer of the last ``past_context`` inputs of each layer, the masks
computed from (chunk length, frames buffered) on the device.

Semantics (held against JAX's by ``tests/test_torch_codec_lm.py``):
- the reference seeds each layer's state with ONE zero frame whose
  projected key and value biases are attended, so the buffer starts with
  one valid zero frame (``length`` 1);
- layers are post-norm (torch ``TransformerEncoderLayer``'s default),
  the activation exact GELU;
- the attention window is ``0 <= query_pos - key_pos <= past_context``.

``LMStepper`` is the T=1 step that both directions of
``codec/compress.py`` drive: one body over static buffers (the previous
codes in, the pdfs out, the state updated in place), captured once as a
CUDA graph on a card and replayed for every frame, so the encoder and the
decoder evaluate bit-identical pdfs, as JAX's one jitted ``lm_step`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.ops import nn as ops
from llmvox_tpu_torch.utils.config import CodecConfig
from llmvox_tpu_torch.utils.device import Fetch, resolve_device
from llmvox_tpu_torch.utils.graphs import StepGraph, fill, use_graphs
from llmvox_tpu_torch.utils.params import to_torch


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Mirror of ``LMModel(n_q, card, dim, **transformer_kwargs)``
    (encoder/model.py:37-43, get_lm_model at model.py:199-217)."""
    n_q: int = 32
    card: int = 1024
    dim: int = 200
    num_layers: int = 5
    num_heads: int = 8
    hidden_scale: float = 4.0
    past_context: int = 262          # int(3.5 * frame_rate) for 24 kHz
    max_period: float = 10000.0
    norm_in: bool = True
    eps: float = 1e-5

    @property
    def hidden_dim(self) -> int:
        return int(self.dim * self.hidden_scale)

    @property
    def head_dim(self) -> int:
        assert self.dim % self.num_heads == 0
        return self.dim // self.num_heads


def lm_config_for(codec_cfg: CodecConfig) -> LMConfig:
    """The LM the reference attaches to a codec (model.py:199-205):
    ``LMModel(n_q, bins, num_layers=5, dim=200,
    past_context=int(3.5 * frame_rate))``."""
    hop = 1
    for d in codec_cfg.downsamples:
        hop *= d
    frame_rate = math.ceil(codec_cfg.sample_rate / hop)
    return LMConfig(n_q=codec_cfg.num_quantizers, card=codec_cfg.vq_bins,
                    past_context=int(3.5 * frame_rate))


def sin_embedding(positions: torch.Tensor, dim: int,
                  max_period: float = 10000.0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``create_sin_embedding`` (transformer.py:16-27): cos half then sin
    half, period exponent ``idx / (half_dim - 1)``."""
    assert dim % 2 == 0
    half = dim // 2
    adim = torch.arange(half, dtype=dtype, device=positions.device)
    phase = positions[..., None].to(dtype) / torch.pow(max_period,
                                                       adim / (half - 1))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def init_stream_state(cfg: LMConfig, batch: int, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Dict:
    """Fixed-shape streaming state: ``bufs[l]`` holds the last
    ``past_context`` inputs of layer ``l``, right-aligned (newest last);
    ``length`` counts valid buffered frames and starts at 1 (the
    reference's one zero frame); ``offset`` is the absolute position of
    the next input frame.  ``length`` and ``offset`` are 0-d device
    tensors, so a step reads them without a host sync."""
    return {
        "bufs": torch.zeros((cfg.num_layers, batch, cfg.past_context,
                             cfg.dim), dtype=dtype, device=device),
        "length": torch.ones((), dtype=torch.int64, device=device),
        "offset": torch.zeros((), dtype=torch.int64, device=device),
    }


def _streaming_attention(lp: Dict, x: torch.Tensor, buf: torch.Tensor,
                         length: torch.Tensor, cfg: LMConfig
                         ) -> torch.Tensor:
    """Windowed causal attention of the T current frames over (buffered
    ``length`` frames ++ current frames).  Buffer slot ``j`` is ``H - j``
    frames in the past, so ``delta = i + H - j`` for query ``i``; in-chunk
    keys have ``delta = i - k``.  Valid iff ``0 <= delta <= past_context``
    and the slot holds a real frame (``j >= H - length``)."""
    b, t, d = x.shape
    h = cfg.past_context
    nh, hd = cfg.num_heads, cfg.head_dim
    keys_src = torch.cat([buf, x], dim=1)                 # (B, H+T, D)
    qkv_w, qkv_b = lp["qkv"]["w"], lp["qkv"]["b"]
    q = ops.linear(x, qkv_w[:, :d], qkv_b[:d])
    kv = ops.linear(keys_src, qkv_w[:, d:], qkv_b[d:])
    k, v = kv[..., :d], kv[..., d:]
    q = q.reshape(b, t, nh, hd).transpose(1, 2)           # (B, nh, T, hd)
    k = k.reshape(b, h + t, nh, hd).transpose(1, 2)
    v = v.reshape(b, h + t, nh, hd).transpose(1, 2)

    qpos = torch.arange(t, device=x.device)[:, None]
    kidx = torch.arange(h + t, device=x.device)[None, :]
    delta = torch.where(kidx < h, qpos + h - kidx, qpos - (kidx - h))
    valid = (delta >= 0) & (delta <= cfg.past_context) & (kidx >= h - length)

    scores = torch.einsum("bnqh,bnkh->bnqk", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~valid, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqk,bnkh->bnqh", attn, v)
    out = out.transpose(1, 2).reshape(b, t, d)
    return ops.linear(out, lp["out"]["w"], lp["out"]["b"])


def apply_transformer(params: Dict, x: torch.Tensor, state: Dict,
                      cfg: LMConfig) -> Tuple[torch.Tensor, Dict]:
    """``StreamingTransformerEncoder.forward`` (transformer.py:101-119):
    norm_in -> + sin positions -> post-norm layers, each buffering its
    INPUT as the state."""
    b, t, _ = x.shape
    if cfg.norm_in:
        ni = params["norm_in"]
        x = ops.layer_norm(x, ni["scale"], ni["bias"], cfg.eps)
    positions = torch.arange(t, device=x.device)[None, :] + state["offset"]
    x = x + sin_embedding(positions, cfg.dim, cfg.max_period,
                          ops.wide_dtype(x.dtype)).to(x.dtype)
    length = state["length"]
    lp_all = params["layers"]
    new_bufs = []
    for i in range(state["bufs"].shape[0]):
        lp = {name: {k: v[i] for k, v in sub.items()}
              for name, sub in lp_all.items()}
        buf = state["bufs"][i]
        sa_input = x
        x = x + _streaming_attention(lp, x, buf, length, cfg)
        x = ops.layer_norm(x, lp["norm1"]["scale"], lp["norm1"]["bias"],
                           cfg.eps)
        ff = ops.linear(ops.gelu_exact(
            ops.linear(x, lp["ff1"]["w"], lp["ff1"]["b"])),
            lp["ff2"]["w"], lp["ff2"]["b"])
        x = ops.layer_norm(x + ff, lp["norm2"]["scale"], lp["norm2"]["bias"],
                           cfg.eps)
        # roll the fixed buffer left by T and append this layer's input
        new_bufs.append(torch.cat([buf, sa_input], dim=1)[:, -buf.shape[1]:])
    new_state = {"bufs": torch.stack(new_bufs),
                 "length": torch.clamp(length + t, max=cfg.past_context),
                 "offset": state["offset"] + t}
    return x, new_state


def apply_lm(params: Dict, indices: torch.Tensor, state: Dict,
             cfg: LMConfig) -> Tuple[torch.Tensor, Dict]:
    """``LMModel.forward`` (model.py:46-66).  ``indices``: (B, n_q, T) of
    the PREVIOUS step's codes + 1 (0 = missing, the first step).  Returns
    (probabilities (B, card, n_q, T), the new streaming state)."""
    emb = params["emb"]                                    # (K, card+1, D)
    indices = indices.long()
    x = torch.stack([emb[q][indices[:, q]]
                     for q in range(indices.shape[1])]).sum(0)
    out, new_state = apply_transformer(params["transformer"], x, state, cfg)
    logits = torch.einsum("btd,kdc->btkc", out,
                          params["heads"]["w"].to(out.dtype))
    logits = logits + params["heads"]["b"].to(out.dtype)[None, None]
    probs = torch.softmax(logits, dim=-1)                  # over card
    return probs.permute(0, 3, 2, 1), new_state            # (B, card, K, T)


class LMStepper:
    """One T=1 streaming LM step over static buffers, B = 1: ``step(prev)``
    takes the previous frame's codes + 1 ((n_q,) ints, 0 = none) and
    returns the (card, n_q) pdf as float64 on the host; ``reset()`` starts
    a new stream.  On a card the step is one CUDA graph, captured here
    and replayed (on the CPU it runs eagerly); the same object drives the
    compressor and the decompressor, so both see the same pdfs.  The
    params tree is ``utils/params.py::init_lm_params``'s or
    ``tools/convert.py::convert_lm_state_dict``'s."""

    def __init__(self, params: Dict, cfg: LMConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device, dtype)
        self.state = init_stream_state(cfg, 1, self.device, dtype)
        self.prev = torch.zeros((cfg.n_q,), dtype=torch.int64,
                                device=self.device)
        self.probs = torch.empty((cfg.card, cfg.n_q), dtype=dtype,
                                 device=self.device)
        self.graph = StepGraph(self._body, self.probs, self.device,
                               use_graphs(self.device, None), "lm step")
        self.graph.capture()
        self.reset()

    @torch.no_grad()
    def _body(self) -> None:
        probs, new = apply_lm(self.params, self.prev.view(1, -1, 1),
                              self.state, self.cfg)
        self.probs.copy_(probs[0, :, :, 0])
        for k, v in new.items():
            self.state[k].copy_(v)

    def reset(self) -> None:
        """A fresh stream: the buffers zero, one valid frame, offset 0."""
        with torch.no_grad():
            self.state["bufs"].zero_()
            self.state["length"].fill_(1)
            self.state["offset"].zero_()

    def step(self, prev: np.ndarray) -> np.ndarray:
        fill(self.prev, np.asarray(prev, np.int64).reshape(-1))
        return Fetch(self.graph()).get().astype(np.float64)
