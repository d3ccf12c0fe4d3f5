"""Peaks of the card and the work of the models, counted from shapes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the
tensor cores (the port serves f32 with TF32 off), 3.35 TB/s of HBM3.  The
work of a step is what the model's equations need for the tokens served,
whatever kernel does it; each input byte is counted once.  The K1 and K2
bounds are ``chip_smoke.py``'s ``k1_bound_ms`` and ``k2_bound_ms``, copied.
"""
from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4}


def decoder_token_flops(dcfg, pos: int) -> float:
    """One speech token at position ``pos`` (attending pos + 1 rows): the
    four matmuls of each layer (24 C^2), QK and PV (4 (pos+1) C), the head
    (2 C V)."""
    c = dcfg.n_embd
    return (dcfg.n_layer * (24 * c * c + 4 * (pos + 1) * c)
            + 2 * c * dcfg.vocab_size)


def decoder_flops(dcfg, blocks: Iterable[Tuple[int, int]]) -> float:
    """Every token of blocks given as (n tokens, first position)."""
    total = 0.0
    c = dcfg.n_embd
    per = dcfg.n_layer * 24 * c * c + 2 * c * dcfg.vocab_size
    for n, p in blocks:
        # sum over pos = p .. p+n-1 of 4 L c (pos + 1)
        rows = n * p + n * (n + 1) / 2
        total += n * per + 4 * dcfg.n_layer * c * rows
    return total


def codec_frame_flops(ccfg, chunk: int) -> float:
    """One frame of a ``chunk``-frame decode: the embed conv, the pos_net's
    eight k3 convs and its attention (projections, and QK and PV over the
    chunk), each ConvNeXt layer's depthwise conv and two pointwise
    matmuls, the head.  The inverse FFT is left out."""
    d, i = ccfg.backbone_dim, ccfg.backbone_intermediate_dim
    return (2 * 7 * ccfg.backbone_input_channels * d
            + 8 * 2 * 3 * d * d
            + 4 * 2 * d * d + 4 * chunk * d
            + ccfg.backbone_num_layers * (2 * 7 * d + 4 * d * i)
            + 2 * d * (ccfg.n_fft + 2))


def attention_bound_s(rows: Iterable[int], c: int, dtype: str) -> float:
    """Least time of decode attention over streams that attend ``rows``
    cache rows each (a layer): K and V rows read once, q read and the
    output written once, the position read; or 4 rows C flops at the
    dtype's peak; the larger (``chip_smoke.k2_bound_ms``)."""
    es = BYTES[dtype]
    n_rows = b = 0
    for r in rows:
        n_rows += r
        b += 1
    nbytes = 2 * n_rows * c * es + 2 * b * c * es + 4 * b
    return max(nbytes / HBM_BYTES_PER_S, 4 * n_rows * c / PEAK_FLOPS[dtype])


def tts_rows(dcfg, blocks: Iterable[Tuple[int, int]]):
    """The cache rows each token of the blocks attends, once a layer."""
    for n, p in blocks:
        for pos in range(p, p + n):
            for _ in range(dcfg.n_layer):
                yield pos + 1


def llm_token_flops(lcfg, pos: int) -> float:
    """One token of a Mixtral-family Llama at position ``pos``: per layer
    the q, k, v and o projections, the router, the top-k experts' three
    matmuls (only the experts it is routed to), QK and PV over pos + 1
    rows (4 (pos+1) C); then the head."""
    c, i = lcfg.n_embd, lcfg.intermediate_size
    kvd = lcfg.n_kv_head * (c // lcfg.n_head)
    per_layer = (2 * (2 * c * c + 2 * c * kvd) + 2 * c * lcfg.n_experts
                 + lcfg.moe_top_k * 3 * 2 * c * i + 4 * (pos + 1) * c)
    return lcfg.n_layer * per_layer + 2 * c * lcfg.vocab_size


def llm_flops(lcfg, blocks) -> float:
    """The forwards that made blocks given as (tokens, first position p,
    prompt tokens prefilled for them): the token at p comes from the
    forward at p - 1, so a block of n costs the forwards at p - 1 ..
    p + n - 2, and a prefill of ``pre`` tokens those at p - pre .. p - 1
    (the last one giving the first token)."""
    total = 0.0
    for n, p, pre in blocks:
        for pos in range(p - max(pre, 1), p + n - 1):
            total += llm_token_flops(lcfg, pos)
    return total
