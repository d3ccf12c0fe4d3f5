"""LM-entropy-coded compression of RVQ code streams.

Counterpart of ``llmvox_tpu/codec/compress.py``, with its wire format
(little-endian):
    u8  n_q        number of codebooks
    u32 T          number of frames
    u8  pad        reserved (0)
    AC bitstream   n_q symbols per frame, frame-major

An arithmetic coder spends bits according to the LM's per-step
predictive distribution instead of ``log2(card)`` raw bits a code.
Arithmetic decoding needs the decoder's pdf to be bit-identical to the
encoder's, so both directions drive ONE ``codec.lm.LMStepper`` (the same
T=1 step program, B=1, on one device; a CUDA graph on a card) frame by
frame (``compress_codes`` and ``decompress_codes`` take it, and reset
it); only the bit IO runs on the host.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from llmvox_tpu_torch.codec.entropy import (ArithmeticCoder,
                                            ArithmeticDecoder, quantized_cdf)
from llmvox_tpu_torch.codec.lm import LMStepper


def compress_codes(lm: LMStepper, codes: np.ndarray) -> bytes:
    """Entropy-code ``codes`` (n_q, T) ints in [0, card)."""
    cfg = lm.cfg
    codes = np.asarray(codes, np.int64)
    k, t = codes.shape
    if k != cfg.n_q:
        raise ValueError(f"codes have {k} codebooks, LM expects {cfg.n_q}")
    if codes.size and (codes.min() < 0 or codes.max() >= cfg.card):
        raise ValueError(
            f"code values must lie in [0, {cfg.card}); got "
            f"[{codes.min()}, {codes.max()}]")
    lm.reset()
    fo = io.BytesIO()
    fo.write(struct.pack("<BIB", k, t, 0))
    coder = ArithmeticCoder(fo)
    # the LM input at frame i is frame i-1's codes + 1; 0 means no history
    prev = np.zeros((k,), np.int64)
    for i in range(t):
        pdf = lm.step(prev)                                # (card, n_q)
        for q in range(k):
            coder.push(int(codes[q, i]), quantized_cdf(pdf[:, q]))
        prev = codes[:, i] + 1
    coder.flush()
    return fo.getvalue()


def decompress_codes(lm: LMStepper, data: bytes) -> np.ndarray:
    """Inverse of :func:`compress_codes`; returns (n_q, T) int32 codes."""
    cfg = lm.cfg
    fo = io.BytesIO(data)
    k, t, _ = struct.unpack("<BIB", fo.read(6))
    if k != cfg.n_q:
        raise ValueError(f"stream has {k} codebooks, LM expects {cfg.n_q}")
    lm.reset()
    decoder = ArithmeticDecoder(fo)
    prev = np.zeros((k,), np.int64)
    out = np.zeros((k, t), np.int32)
    for i in range(t):
        pdf = lm.step(prev)
        for q in range(k):
            sym = decoder.pull(quantized_cdf(pdf[:, q]))
            if sym is None:
                raise ValueError("compressed stream ended early")
            out[q, i] = sym
        prev = out[:, i].astype(np.int64) + 1
    return out
