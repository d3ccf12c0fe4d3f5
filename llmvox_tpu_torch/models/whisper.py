"""Whisper speech recognition in PyTorch: the in-framework ASR's model.

Counterpart of ``llmvox_tpu/models/whisper.py`` with the same names,
parameter tree and numerics:
- the log-mel frontend (HF ``WhisperFeatureExtractor``: slaney-scale,
  slaney-normalised mel filters, Hann STFT, log10 clamped at 1e-10, the
  per-clip floor at max - 8, then (x + 4) / 4);
- the encoder: two convolutions (the second strided) with exact GELU, the
  learned positions, pre-norm transformer layers and a final LayerNorm;
- the decoder: a fixed-capacity self-attention cache, cross-attention K/V
  made once per utterance (``make_cross_kv``), the tied head, and greedy
  block decode with EOS rows frozen on the device.

Parameters keep the JAX layout (``tools/convert.py::
convert_whisper_state_dict``): stacked layers, Linear weights
``(Cin, Cout)``, conv kernels ``(K, Cin, Cout)``.  The JAX package runs
all of this in XLA (attention in ``_mha`` with ``jnp.einsum``), no Pallas
kernel, so the port uses plain torch ops.

As in ``models/llama.py``, ``pos`` and ``done`` stay in 0-d and (B,)
device tensors and the caches are written in place (the state passed in
is consumed): nothing reads a value back to the host, so a block is
enqueued with no sync and can be captured in a CUDA graph
(``streams/asr.py``).  The device constants the functions need (mel
filters, the Hann window, the suppressed ids) are made once per device,
so a capture never copies from the host.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.mel import stft
from llmvox_tpu_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """The same fields as the JAX ``WhisperConfig`` (an npz's meta carries
    them); the mel and frame geometry is fixed across the family."""
    vocab_size: int = 51865
    n_mels: int = 80
    d_model: int = 384
    enc_layers: int = 4
    dec_layers: int = 4
    enc_heads: int = 6
    dec_heads: int = 6
    enc_ffn: int = 1536
    dec_ffn: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # audio frontend (constant across the Whisper family)
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    # special ids (from the checkpoint's generation config)
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257

    @property
    def enc_head_dim(self) -> int:
        assert self.d_model % self.enc_heads == 0
        return self.d_model // self.enc_heads

    @property
    def dec_head_dim(self) -> int:
        assert self.d_model % self.dec_heads == 0
        return self.d_model // self.dec_heads

    @property
    def n_audio_frames(self) -> int:
        """Mel frames in the fixed 30 s window (HF pads/truncates here)."""
        return 2 * self.max_source_positions


# device constants, made once per key: a copy from pageable host memory
# would sync the stream, and a CUDA graph cannot capture it
_constants: Dict[tuple, torch.Tensor] = {}
_constants_lock = threading.Lock()


def _constant(key: tuple, device, make) -> torch.Tensor:
    key = (*key, torch.device(device))
    with _constants_lock:
        t = _constants.get(key)
        if t is None:
            t = _constants[key] = make().to(key[-1])
        return t


# ---------------------------------------------------------------------------
# log-mel frontend (HF WhisperFeatureExtractor numerics)
# ---------------------------------------------------------------------------


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10)
                                               / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def whisper_mel_filters(sample_rate: int = 16000, n_fft: int = 400,
                        n_mels: int = 80) -> np.ndarray:
    """(n_freqs, n_mels) slaney-scale, slaney-normalised triangular bank:
    HF ``mel_filter_bank(..., norm="slaney", mel_scale="slaney")``, the
    filters every Whisper checkpoint was trained with."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(0.0),
                        _hz_to_mel_slaney(sample_rate / 2.0), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


def log_mel(audio: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """(B, n_samples) float32 in [-1, 1], already padded or trimmed
    (``pad_or_trim``) -> (B, n_frames, n_mels) f32 log-mel features: power
    spectrogram (HF drops the last frame), slaney mel bank, log10 clamped
    at 1e-10, the per-clip floor at max - 8, then (x + 4) / 4."""
    spec = stft(audio, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                center=True)
    power = spec.abs().square()[:, :-1]
    fb = _constant(("mel", cfg.sample_rate, cfg.n_fft, cfg.n_mels),
                   audio.device, lambda: torch.from_numpy(whisper_mel_filters(
                       cfg.sample_rate, cfg.n_fft, cfg.n_mels)))
    logspec = torch.log10(torch.matmul(power, fb).clamp_min(1e-10))
    floor = logspec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(logspec, floor) + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, cfg: WhisperConfig,
                n_frames: Optional[int] = None) -> np.ndarray:
    """(T,) or (B, T) -> (B, window) zero-padded or truncated on the host.

    ``n_frames`` replaces the 30 s window with a shorter mel-frame count
    (whisper.cpp's ``audio_ctx``): the encoder slices its positional table
    to the length, so a short utterance runs in a cheaper window.  Callers
    take ``n_frames`` from a bucket ladder (``streams/asr.py::_pick_ctx``)."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    n = (n_frames or cfg.n_audio_frames) * cfg.hop_length
    if audio.shape[1] >= n:
        return audio[:, :n]
    return np.pad(audio, ((0, 0), (0, n - audio.shape[1])))


# ---------------------------------------------------------------------------
# attention (HF WhisperAttention numerics: q scaled by hd^-0.5, f32 softmax)
# ---------------------------------------------------------------------------


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, T, H, hd); k/v: (B, S, H, hd); mask (T, S) or (B, T, S) bool
    (True = attend).  The scores are exact f32 products of the inputs (JAX:
    ``preferred_element_type=f32``), the softmax is f32, and the
    probabilities take q's dtype for the value product.  Returns
    (B, T, H, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float().transpose(1, 2),
                          k.float().permute(0, 2, 3, 1)) * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v.transpose(1, 2)).transpose(1, 2)


def _layer(lp: Dict, layer: int) -> Dict:
    return {k: v[layer] for k, v in lp.items()}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params: Dict, mel: torch.Tensor,
           cfg: WhisperConfig) -> torch.Tensor:
    """(B, n_frames, n_mels) log-mel -> (B, S = n_frames / 2, d) encoder
    states, in the parameters' dtype (``log_mel`` returns f32; under bf16
    the encoder, and the cross-KV it feeds, stay bf16)."""
    p = params["enc"]
    b = mel.shape[0]
    mel = mel.to(p["conv1_w"].dtype)
    x = nn.gelu_exact(nn.conv1d(mel, p["conv1_w"], p["conv1_b"], padding=1))
    x = nn.gelu_exact(nn.conv1d(x, p["conv2_w"], p["conv2_b"], stride=2,
                                padding=1))
    s = x.shape[1]
    x = x + p["pos"][:s].to(x.dtype)
    hd = cfg.enc_head_dim
    for layer in range(cfg.enc_layers):
        lp = _layer(p["h"], layer)
        h = nn.layer_norm(x, lp["ln1_s"], lp["ln1_b"], 1e-5)
        q = nn.linear(h, lp["wq"], lp["bq"]).reshape(b, s, cfg.enc_heads, hd)
        k = nn.linear(h, lp["wk"]).reshape(b, s, cfg.enc_heads, hd)
        v = nn.linear(h, lp["wv"], lp["bv"]).reshape(b, s, cfg.enc_heads, hd)
        att = _mha(q, k, v)
        x = x + nn.linear(att.reshape(b, s, cfg.d_model), lp["wo"],
                          lp["bo"])
        h = nn.layer_norm(x, lp["ln2_s"], lp["ln2_b"], 1e-5)
        h = nn.gelu_exact(nn.linear(h, lp["fc1_w"], lp["fc1_b"]))
        x = x + nn.linear(h, lp["fc2_w"], lp["fc2_b"])
    return nn.layer_norm(x, p["lnf_s"], p["lnf_b"], 1e-5)


# ---------------------------------------------------------------------------
# decoder with a KV cache and cross-attention K/V made once
# ---------------------------------------------------------------------------


class CrossKV(NamedTuple):
    k: torch.Tensor        # (L, B, S, H, hd)
    v: torch.Tensor


class WhisperDecodeState(NamedTuple):
    k: torch.Tensor        # (L, B, cap, H, hd) self-attention cache
    v: torch.Tensor
    pos: torch.Tensor      # 0-d int32: tokens cached so far
    done: torch.Tensor     # (B,) bool: the row emitted EOS (sticky)


def init_whisper_decode_state(cfg: WhisperConfig, batch: int = 1,
                              dtype=torch.float32, device="cpu"
                              ) -> WhisperDecodeState:
    shape = (cfg.dec_layers, batch, cfg.max_target_positions,
             cfg.dec_heads, cfg.dec_head_dim)
    return WhisperDecodeState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.bool, device=device))


def make_cross_kv(params: Dict, enc_out: torch.Tensor,
                  cfg: WhisperConfig) -> CrossKV:
    """Every decoder layer's cross-attention K/V from the encoder output,
    made once per utterance and read by every decode step."""
    b, s, _ = enc_out.shape
    hh = params["dec"]["h"]
    layers = range(cfg.dec_layers)
    k = torch.stack([enc_out @ hh["xwk"][i] for i in layers])  # (L, B, S, d)
    v = torch.stack([enc_out @ hh["xwv"][i] for i in layers])
    v = v + hh["xbv"][:, None, None, :]
    shape = (cfg.dec_layers, b, s, cfg.dec_heads, cfg.dec_head_dim)
    return CrossKV(k.reshape(shape), v.reshape(shape))


def _decoder_layer(lp: Dict, x: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                   rows: torch.Tensor, valid: torch.Tensor,
                   cfg: WhisperConfig) -> torch.Tensor:
    """One decoder layer for T new tokens: their K/V written in place at
    cache ``rows``, self-attention over the keys ``valid`` allows, then
    cross-attention over (xk, xv).  Returns x."""
    b, t, _ = x.shape
    hd = cfg.dec_head_dim
    h = nn.layer_norm(x, lp["ln1_s"], lp["ln1_b"], 1e-5)
    q = nn.linear(h, lp["wq"], lp["bq"]).reshape(b, t, cfg.dec_heads, hd)
    k = nn.linear(h, lp["wk"]).reshape(b, t, cfg.dec_heads, hd)
    v = nn.linear(h, lp["wv"], lp["bv"]).reshape(b, t, cfg.dec_heads, hd)
    k_cache.index_copy_(1, rows, k.to(k_cache.dtype))
    v_cache.index_copy_(1, rows, v.to(v_cache.dtype))
    # the cache's dtype may differ from the activations': cast after the
    # value product so the residual keeps x's dtype
    att = _mha(q, k_cache, v_cache, valid).to(x.dtype)
    x = x + nn.linear(att.reshape(b, t, cfg.d_model), lp["wo"], lp["bo"])
    h = nn.layer_norm(x, lp["lnx_s"], lp["lnx_b"], 1e-5)
    q = nn.linear(h, lp["xwq"], lp["xbq"]).reshape(b, t, cfg.dec_heads, hd)
    att = _mha(q, xk, xv).to(x.dtype)
    x = x + nn.linear(att.reshape(b, t, cfg.d_model), lp["xwo"], lp["xbo"])
    h = nn.layer_norm(x, lp["ln2_s"], lp["ln2_b"], 1e-5)
    h = nn.gelu_exact(nn.linear(h, lp["fc1_w"], lp["fc1_b"]))
    return x + nn.linear(h, lp["fc2_w"], lp["fc2_b"])


def _decoder_forward(params: Dict, tokens: torch.Tensor,
                     state: WhisperDecodeState, cross: CrossKV,
                     cfg: WhisperConfig
                     ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """(B, T) new tokens -> (B, T, d) final hidden states; cache extended.

    The tokens at positions pos..pos+T-1 write cache rows from a start
    clamped to cap - T, as JAX's ``dynamic_update_slice`` clamps it; key j
    is valid for query i iff j <= pos + i; the position table is read
    clamped to its last row, as JAX's gather reads it."""
    p = params["dec"]
    t = tokens.shape[1]
    cap = state.k.shape[2]
    steps = torch.arange(t, device=tokens.device, dtype=torch.int32)
    positions = state.pos + steps
    rows = (state.pos.clamp(max=cap - t) + steps).long()
    jpos = torch.arange(cap, device=tokens.device, dtype=torch.int32)
    valid = jpos[None, :] <= positions[:, None]
    x = (p["tok_emb"][tokens]
         + p["pos"][positions.clamp(max=p["pos"].shape[0] - 1).long()][None])
    for layer in range(cfg.dec_layers):
        x = _decoder_layer(_layer(p["h"], layer), x, state.k[layer],
                           state.v[layer], cross.k[layer], cross.v[layer],
                           rows, valid, cfg)
    x = nn.layer_norm(x, p["lnf_s"], p["lnf_b"], 1e-5)
    return x, state._replace(pos=state.pos + t)


def _logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: hidden -> vocab (HF proj_out = embed_tokens)."""
    return nn.linear(x, params["dec"]["tok_emb"].t())


def prefill(params: Dict, tokens: torch.Tensor, state: WhisperDecodeState,
            cross: CrossKV, cfg: WhisperConfig
            ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """The forced prompt (B, Tf) through the decoder; returns (B, Tf, V)
    logits at every position (language detection reads the <|sot|>
    position, generation the last) and the extended state."""
    x, state = _decoder_forward(params, tokens, state, cross, cfg)
    return _logits(params, x), state


def _suppress(logits: torch.Tensor, suppress: Tuple[int, ...]
              ) -> torch.Tensor:
    """``logits`` with the ids of ``suppress`` set to -inf (their index
    tensor made once per device)."""
    if not suppress:
        return logits
    idx = _constant(("suppress", suppress), logits.device,
                    lambda: torch.tensor(suppress, dtype=torch.long))
    return logits.index_fill(-1, idx, float("-inf"))


def decode_block(params: Dict, first_token: torch.Tensor,
                 state: WhisperDecodeState, cross: CrossKV,
                 cfg: WhisperConfig, block: int = 16,
                 suppress: Tuple[int, ...] = ()
                 ) -> Tuple[torch.Tensor, WhisperDecodeState]:
    """Greedy-generate ``block`` tokens on the device from ``first_token``
    (B,) int32.  A row that emits EOS freezes (sticky ``state.done``; a
    frozen row keeps emitting EOS, as HF generate pads after the end).
    ``suppress`` masks token ids to -inf before the argmax (the generation
    config's ``suppress_tokens``).  Returns the tokens generated after
    ``first_token``, (B, block) int32, and the state."""
    eos = cfg.eos_token_id
    tok, done = first_token, state.done
    out = []
    for _ in range(block):
        x, state = _decoder_forward(params, tok[:, None], state, cross, cfg)
        logits = _suppress(_logits(params, x[:, -1]), suppress)
        tok = torch.argmax(logits, dim=-1).to(torch.int32).masked_fill(done,
                                                                       eos)
        done = done | (tok == eos)
        out.append(tok)
    return torch.stack(out, dim=1), state._replace(done=done)
