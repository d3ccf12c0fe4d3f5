"""WavCodec: the WavTokenizer-compatible codec's decode path.

Counterpart of ``llmvox_tpu/codec/codec.py`` (``DEFAULT_BUCKETS``,
``_decode_codes``, and ``WavCodec``'s decode surface, the pool's ragged
batched decode included).  Chunks are decoded
at a few bucket lengths: a ragged chunk is zero-padded to the next bucket,
the ``valid_len`` masking inside the backbone and the ISTFT keeps the
kept samples equal to an exact-length decode, and the tail is trimmed.
(Eager PyTorch compiles nothing per shape, but the buckets keep the
kernel shapes, and so the timings, to a small fixed set.)
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llmvox_tpu_torch.codec import backbone as bb
from llmvox_tpu_torch.codec import heads, vq
from llmvox_tpu_torch.utils.config import CodecConfig
from llmvox_tpu_torch.utils.device import resolve_device
from llmvox_tpu_torch.utils.params import (init_codec_params,
                                           load_params_npz, to_torch)

DEFAULT_BUCKETS = (16, 32, 96, 288, 512, 896, 1280)


def _decode_codes(params: Dict, codes: torch.Tensor, bandwidth_id: int,
                  valid_len, cfg: CodecConfig) -> torch.Tensor:
    """(B, L) codes -> (B, hop*L) waveform on the codes' device."""
    feats = vq.codes_to_features(params["codebooks"], codes)
    h = bb.apply_backbone(params["backbone"], feats, bandwidth_id, cfg,
                          valid_len)
    return heads.apply_istft_head(params["head"], h, cfg, valid_len)


class WavCodec:
    """Codec parameters (f32) on one device, decoded at bucket lengths."""

    def __init__(self, params: Dict, cfg: Optional[CodecConfig] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 device="cuda"):
        self.cfg = cfg or CodecConfig()
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device)
        self.buckets = sorted(buckets)

    @classmethod
    def from_random(cls, seed: int = 0, cfg: Optional[CodecConfig] = None,
                    **kw) -> "WavCodec":
        cfg = cfg or CodecConfig()
        return cls(init_codec_params(seed, cfg), cfg, **kw)

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[CodecConfig] = None,
                        **kw) -> "WavCodec":
        """Load converted parameters (an .npz of the JAX layout)."""
        return cls(load_params_npz(path), cfg, **kw)

    def bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[i] if i < len(self.buckets) else self.buckets[-1]

    def decode_codes(self, codes: np.ndarray, bandwidth_id: int = 0,
                     pad_to_bucket: bool = True) -> np.ndarray:
        """(B, L) int codes -> (B, hop*L) float32 waveform (host numpy)."""
        codes = np.asarray(codes, dtype=np.int32)
        b, l = codes.shape
        lpad = self.bucket_for(l) if pad_to_bucket else l
        if lpad > l:
            codes = np.concatenate(
                [codes, np.zeros((b, lpad - l), np.int32)], axis=1)
        wav = _decode_codes(self.params,
                            torch.from_numpy(codes).to(self.device),
                            bandwidth_id, l, self.cfg)
        return wav.cpu().numpy()[:, : l * self.cfg.hop_length]

    def decode_codes_ragged(self, codes: np.ndarray, lengths: np.ndarray,
                            bandwidth_id: int = 0) -> List[np.ndarray]:
        """Batched ragged decode: (B, Lmax) zero-padded codes with per-row
        valid ``lengths`` -> B waveforms, row i ``lengths[i] * hop``
        samples long.  The batch is padded (or cut) to the bucket of the
        longest row, and per-row ``valid_len`` masking keeps each row
        equal to an exact-length decode: one call vocodes the chunks of
        many streams."""
        codes = np.asarray(codes, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        b, l = codes.shape
        lpad = self.bucket_for(int(lengths.max()))
        if lpad > l:
            codes = np.concatenate(
                [codes, np.zeros((b, lpad - l), np.int32)], axis=1)
        else:
            codes = codes[:, :lpad]
        wav = _decode_codes(self.params,
                            torch.from_numpy(codes).to(self.device),
                            bandwidth_id,
                            torch.from_numpy(lengths).to(self.device),
                            self.cfg).cpu().numpy()
        hop = self.cfg.hop_length
        return [wav[i, : int(lengths[i]) * hop] for i in range(b)]

    def decode_codes_device(self, codes: torch.Tensor, lengths,
                            bandwidth_id: int = 0) -> torch.Tensor:
        """(B, bucket) device codes, already padded to a bucket, with valid
        ``lengths`` (int or (B,) tensor) -> (B, bucket*hop) device
        waveform; no host transfer, so callers chain it on other device
        work and fetch once."""
        return _decode_codes(self.params, codes, bandwidth_id, lengths,
                             self.cfg)

    def warmup(self, batch_size: int = 1) -> None:
        """Decode once at every bucket (allocator and library handles)."""
        for n in self.buckets:
            self.decode_codes(np.zeros((batch_size, n), np.int32),
                              pad_to_bucket=False)
