"""WavCodec: the WavTokenizer-compatible codec's decode path and encoder.

Counterpart of ``llmvox_tpu/codec/codec.py`` (``DEFAULT_BUCKETS``,
``_decode_codes``, and ``WavCodec``'s decode surface, the pool's ragged
batched decode included, and ``encode_infer``, eager, for the offline
tools).  Chunks are decoded
at a few bucket lengths: a ragged chunk is zero-padded to the next bucket,
the ``valid_len`` masking inside the backbone and the ISTFT keeps the
kept samples equal to an exact-length decode, and the tail is trimmed.

Each (batch, bucket) is one body over static buffers (the codes and the
valid lengths, a device tensor, in one int32 buffer; the waveform out),
captured as a CUDA graph at warmup on a card (``utils/graphs.py``): batch
1 serves ``decode_codes`` and the engines' ``synthesize``, the pool's
``SYNTH_BATCH`` serves ``decode_codes_ragged``.  A (batch, length) that
warmup did not capture raises on the card, for example a decode longer
than the largest bucket.  ``decode_codes_eager`` decodes outside the
graphs, at any length, for the offline paths.  The valid length stays a
tensor: a Python int would be baked into the graph.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec import backbone as bb
from llmvox_tpu_torch.codec import heads, seanet, vq
from llmvox_tpu_torch.utils import trace as tracing
from llmvox_tpu_torch.utils.config import CodecConfig
from llmvox_tpu_torch.utils.device import Fetch, resolve_device
from llmvox_tpu_torch.utils.graphs import GraphSet, fill, use_graphs
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
    """Codec parameters (f32) on one device, decoded at bucket lengths.
    ``graphs`` (None: on for a card) serves every bucket through a CUDA
    graph captured by ``warmup``; ``graphs=False`` runs eagerly.
    ``dtype=torch.float64`` keeps the params in f64 for the eager encode
    and the segmented paths, the reference that f32 is checked against."""

    def __init__(self, params: Dict, cfg: Optional[CodecConfig] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 device="cuda", graphs: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg or CodecConfig()
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device, dtype)
        self.buckets = sorted(buckets)
        self._graphs = GraphSet("codec", self.device,
                                use_graphs(self.device, graphs), self._make)
        # the synthesis threads of two replicas or of the pool may share a
        # codec: a bucket's fill, replay and fetch go together
        self._lock = threading.Lock()

    def copy_to(self, device) -> "WavCodec":
        """The same codec on ``device`` (its params copied there, its
        graphs its own), serving through graphs as this one does."""
        return WavCodec(self.params, self.cfg, self.buckets, device=device,
                        graphs=self._graphs.enabled,
                        dtype=self.params["codebooks"].dtype)

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

    def _make(self, key: Tuple[int, int, int]):
        """Static buffers and body of one (batch, length, bandwidth)."""
        b, n, bandwidth_id = key
        inp = torch.ones((b * n + b,), dtype=torch.int32, device=self.device)
        codes, lens = inp[:b * n].view(b, n), inp[b * n:]
        out = torch.empty((b, n * self.cfg.hop_length), dtype=torch.float32,
                          device=self.device)

        def body():
            out.copy_(_decode_codes(self.params, codes, bandwidth_id, lens,
                                    self.cfg))
        return body, (inp, out)

    def _decode(self, codes: np.ndarray, lengths: np.ndarray,
                bandwidth_id: int) -> np.ndarray:
        """(B, L) codes, L a captured length, (B,) valid lengths -> the
        (B, L*hop) waveform on the host: one copy in, one replay, one
        copy out (a ``codec.decode`` span with spans on)."""
        with tracing.span("codec.decode"):
            g = self._graphs.get((*codes.shape, bandwidth_id))
            inp, out = g.out
            with self._lock:
                fill(inp, np.concatenate([codes.ravel(), lengths]).astype(
                    np.int32))
                g()
                fetch = Fetch(out)
            return fetch.get()

    def decode_codes(self, codes: np.ndarray, bandwidth_id: int = 0,
                     pad_to_bucket: bool = True) -> np.ndarray:
        """(B, L) int codes -> (B, hop*L) float32 waveform (host numpy)."""
        codes = np.asarray(codes, dtype=np.int32)
        b, l = codes.shape
        lpad = self.bucket_for(l) if pad_to_bucket else l
        if lpad > l:
            codes = np.concatenate(
                [codes, np.zeros((b, lpad - l), np.int32)], axis=1)
        wav = self._decode(codes, np.full((b,), l, np.int32), bandwidth_id)
        return wav[:, : l * self.cfg.hop_length]

    def decode_codes_eager(self, codes: np.ndarray,
                           bandwidth_id: int = 0) -> np.ndarray:
        """``decode_codes`` run eagerly on the device, outside the
        captured buckets, for the offline paths: (B, L) codes padded to
        L's bucket, or, past the largest bucket, at L itself (where JAX
        compiles that length) -> (B, hop*L) float32 waveform."""
        codes = np.asarray(codes, dtype=np.int32)
        b, l = codes.shape
        codes = np.pad(codes, ((0, 0), (0, max(self.bucket_for(l), l) - l)))
        lens = torch.full((b,), l, dtype=torch.int32, device=self.device)
        wav = _decode_codes(self.params,
                            torch.from_numpy(codes).to(self.device),
                            bandwidth_id, lens, self.cfg)
        return wav[:, : l * self.cfg.hop_length].cpu().numpy()

    def pad_ragged(self, codes: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
        """(B, Lmax) codes padded (or cut) to the bucket of the longest
        valid length."""
        codes = np.asarray(codes, dtype=np.int32)
        b, l = codes.shape
        lpad = self.bucket_for(int(np.max(lengths)))
        if lpad > l:
            return np.concatenate(
                [codes, np.zeros((b, lpad - l), np.int32)], axis=1)
        return codes[:, :lpad]

    def decode_codes_ragged(self, codes: np.ndarray, lengths: np.ndarray,
                            bandwidth_id: int = 0) -> List[np.ndarray]:
        """Batched ragged decode: (B, Lmax) zero-padded codes with per-row
        valid ``lengths`` -> B waveforms, row i ``lengths[i] * hop``
        samples long.  The batch is padded (or cut) to the bucket of the
        longest row, and per-row ``valid_len`` masking keeps each row
        equal to an exact-length decode: one call vocodes the chunks of
        many streams."""
        lengths = np.asarray(lengths, dtype=np.int32)
        wav = self._decode(self.pad_ragged(codes, lengths), lengths,
                           bandwidth_id)
        hop = self.cfg.hop_length
        return [wav[i, : int(lengths[i]) * hop] for i in range(len(wav))]

    def decode_codes_device(self, codes: torch.Tensor, lengths,
                            bandwidth_id: int = 0) -> torch.Tensor:
        """(B, bucket) device codes, already padded to a bucket, with valid
        ``lengths`` (int or (B,) tensor) -> (B, bucket*hop) device
        waveform; no host transfer, so callers chain it on other device
        work (or inside a graph's body) and fetch once."""
        return _decode_codes(self.params, codes, bandwidth_id, lengths,
                             self.cfg)

    @torch.no_grad()
    def encode_infer(self, wav) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T) waveform -> ((B, L, dim) features, (B, L) int32 codes)
        on the host: the SEANet encoder, the nearest code of the first
        codebook and its features, eagerly in the params' dtype."""
        if "encoder" not in self.params:
            raise ValueError("codec params have no SEANet encoder weights")
        wav = torch.as_tensor(np.asarray(wav, np.float32)).to(
            self.device, self.params["codebooks"].dtype)
        emb = seanet.apply_seanet_encoder(self.params["encoder"], wav,
                                          self.cfg)
        codes = vq.nearest_code(self.params["codebooks"][0], emb)
        feats = vq.codes_to_features(self.params["codebooks"], codes)
        return feats.cpu().numpy(), codes.cpu().numpy()

    def warmup(self, batch_size: int = 1) -> None:
        """Capture every bucket at ``batch_size`` (a CUDA graph each, on
        a card; without graphs one eager decode each)."""
        for n in self.buckets:
            self._graphs.capture((batch_size, n, 0))

    # -- Encodec frame segmentation (encoder/model.py:126-188) -------------
    def segment_geometry(self, segment_s: Optional[float],
                         overlap: float = 0.01):
        """(segment_length, stride) in samples; (None, None) = the whole
        signal (the deployed config, encoder/model.py:112-123)."""
        if segment_s is None:
            return None, None
        seg = int(segment_s * self.cfg.sample_rate)
        return seg, max(1, int((1 - overlap) * seg))

    def encode_frames(self, wav, segment_s: Optional[float] = None,
                      overlap: float = 0.01, normalize: bool = False
                      ) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Segmented encode (EncodecModel.encode, encoder/model.py:126-163):
        (B, T) audio sliced into segment_length windows every stride
        samples, each optionally volume-normalised (scale = 1e-8 + rms)
        and then encoded (``encode_infer``).  A list of (codes (B, L),
        scale (B, 1) or None) frames."""
        wav = np.asarray(wav, np.float32)
        b, length = wav.shape
        seg, stride = self.segment_geometry(segment_s, overlap)
        if seg is None:
            seg = stride = length
        frames = []
        for off in range(0, length, stride):
            x = wav[:, off: off + seg]
            scale = None
            if normalize:
                volume = np.sqrt(np.mean(x ** 2, axis=-1, keepdims=True))
                scale = 1e-8 + volume
                x = x / scale
            _, codes = self.encode_infer(x)
            frames.append((codes, scale))
        return frames

    @torch.no_grad()
    def decode_frames(self, frames, segment_s: Optional[float] = None,
                      overlap: float = 0.01) -> np.ndarray:
        """Segmented decode (EncodecModel.decode, encoder/model.py:166-188):
        each frame's codes through the SEANet DECODER (Encodec's
        reconstruction path; serving uses the ConvNeXt/ISTFT head), scaled
        back if normalised, merged by linear overlap-add.  The output may
        be longer than the input; the caller trims (model.py:189-191)."""
        if "seanet_decoder" not in self.params:
            raise ValueError("codec params have no SEANet decoder weights")
        _, stride = self.segment_geometry(segment_s, overlap)
        outs = []
        for codes, scale in frames:
            feats = vq.codes_to_features(
                self.params["codebooks"],
                torch.tensor(np.asarray(codes, np.int32)).to(
                    self.device))
            wav = _seanet_decode(self.params, feats, self.cfg).cpu().numpy()
            if scale is not None:
                wav = wav * np.asarray(scale)
            outs.append(wav)
        if stride is None:
            assert len(outs) == 1
            return outs[0]
        return linear_overlap_add(outs, stride)


def _seanet_decode(params: Dict, feats: torch.Tensor,
                   cfg: CodecConfig) -> torch.Tensor:
    return seanet.apply_seanet_decoder(params["seanet_decoder"], feats, cfg)


def linear_overlap_add(frames, stride: int) -> np.ndarray:
    """Triangle-weighted overlap-add (encoder/utils.py:16-60
    ``_linear_overlap_add``): each frame is weighted by a triangle peaking
    at its middle and the sum normalised by the total weight per position,
    so a one-frame region is unchanged and a two-frame overlap is the
    exact linear crossfade."""
    assert len(frames)
    frames = [np.asarray(f, np.float32) for f in frames]
    shape = frames[0].shape[:-1]
    total = stride * (len(frames) - 1) + frames[-1].shape[-1]
    frame_length = frames[0].shape[-1]
    t = np.linspace(0, 1, frame_length + 2, dtype=np.float32)[1:-1]
    weight = 0.5 - np.abs(t - 0.5)
    sum_weight = np.zeros((total,), np.float32)
    out = np.zeros(shape + (total,), np.float32)
    offset = 0
    for frame in frames:
        n = frame.shape[-1]
        out[..., offset: offset + n] += weight[:n] * frame
        sum_weight[offset: offset + n] += weight[:n]
        offset += stride
    assert sum_weight.min() > 0
    return out / sum_weight
