"""Typed configuration for the PyTorch port.

Field for field the same as ``llmvox_tpu/utils/config.py`` (DecoderConfig,
CodecConfig, ServeConfig) minus the TPU-only decoder knobs
(``use_pallas_attention``, ``unroll_layers``, ``remat_layers``): the port
picks the attention kernel by the tensor's device, not by a flag.  CLI
overrides follow the same rule: only flags the user passed override the
defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import List, Tuple


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


@dataclass(frozen=True)
class DecoderConfig:
    """The GPT-style speech-token decoder (deployed: 4 layers, 8 heads,
    width 768, block 8192, no biases, 4096 speech codes)."""

    n_layer: int = 4
    n_head: int = 8
    n_embd: int = 768
    block_size: int = 8192
    vocab_size: int = 4096
    dropout: float = 0.0
    bias: bool = False

    # input embedding: concat(text byte-embedding, speech feature), then
    # L2-normalised
    text_embed_dim: int = 256
    speech_embed_dim: int = 512

    text_vocab_size: int = 386   # 384 byte/special ids + [PAD]=384 + EOS=385
    pad_token_id: int = 384
    text_eos_id: int = 385
    eoa_token_id: int = 453
    ignore_index: int = -1000

    ln_eps: float = 1e-5

    # speculative decode: head j drafts the token j+1 positions past the
    # next one from a position's final hidden state; 0 = no draft heads
    n_draft_heads: int = 0

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head


@dataclass(frozen=True)
class CodecConfig:
    """WavTokenizer codec architecture (deployed: large-speech-320-24k)."""

    sample_rate: int = 24000
    # SEANet encoder (not used by the decode path; kept for checkpoints)
    downsamples: Tuple[int, ...] = (8, 5, 4, 2)
    n_filters: int = 32
    seanet_dimension: int = 512
    seanet_kernel_size: int = 7
    seanet_last_kernel_size: int = 7
    seanet_residual_kernel_size: int = 3
    seanet_dilation_base: int = 2
    seanet_n_residual_layers: int = 1
    seanet_lstm_layers: int = 2
    seanet_compress: int = 2
    # vector quantizer
    vq_bins: int = 4096
    vq_dim: int = 512
    num_quantizers: int = 1
    vq_kmeans_iters: int = 200
    vq_decay: float = 0.99
    # ConvNeXt backbone
    backbone_input_channels: int = 512
    backbone_dim: int = 768
    backbone_intermediate_dim: int = 2304
    backbone_num_layers: int = 12
    adanorm_num_embeddings: int = 4
    # ISTFT head
    n_fft: int = 1280
    hop_length: int = 320
    padding: str = "same"

    ln_eps: float = 1e-6
    groupnorm_groups: int = 32
    groupnorm_eps: float = 1e-6

    @property
    def total_downsample(self) -> int:
        out = 1
        for r in self.downsamples:
            out *= r
        return out

    @property
    def samples_per_token(self) -> int:
        return self.hop_length


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs.  The same flags as the JAX server; the port serves
    ``/tts`` on the dedicated dual replicas or through the pool, with or
    without speculative decode and quantization, from a scripted reply or
    the B=1 LLM text stream (``llm_backend`` "jax": the in-framework Llama
    on the card; "hf": transformers on the host).  The pooled LLM's knobs
    (``llm_pool_capacity`` > 0 raises; ``llm_first_block``,
    ``llm_prefill_buckets``, ``llm_chunked_prefill``,
    ``llm_prefill_merge``, ``llm_spec_k``, ``llm_spec_ladder``,
    ``llm_per_request_sampling``, ``llm_prefix_cache``) and the ASR knobs
    are parsed but not yet used."""

    chat_type: str = "text"  # ['text','voice','multimodal','visual_speech']

    wav_config_path: str = ""
    wav_model_path: str = ""
    encoder_model_path: str = "charsiu/g2p_multilingual_byT5_tiny_16_layers_100"
    tokenizer_path: str = "google/byt5-small"
    llmvox_checkpoint_path: str = ""

    # non-empty: answer every request with this text through a
    # ScriptedStream (demo / smoke-test mode, no LLM)
    scripted_reply: str = ""

    llm_checkpoint: str = "meta-llama/Llama-3.1-8B-Instruct"
    llm_device: str = "cpu"
    llm_max_tokens: int = 1000
    llm_temperature: float = 0.7
    llm_top_p: float = 0.95
    llm_top_k: int = 40
    llm_backend: str = "hf"
    llm_jax_params: str = ""
    llm_block: int = 32
    llm_first_block: int = 16
    llm_pool_capacity: int = 0
    llm_prefill_buckets: tuple = (32, 64, 128, 256, 512)
    llm_chunked_prefill: bool = True
    llm_prefill_merge: bool = True
    llm_spec_k: int = 0
    llm_spec_ladder: Tuple[int, ...] = ()
    llm_per_request_sampling: bool = False
    llm_prefix_cache: bool = True

    # TTS replica placement: CUDA device indices
    tts_device_1: int = 0
    tts_device_2: int = 0

    # streaming scheduler knobs
    system_prompt: str = (
        "You are a friendly voicebot that answers questions in a concise way "
        "and do not use abbreviation.Give short responses"
    )
    initial_dump_size_1: int = 10
    initial_dump_size_2: int = 160
    max_dump_size: int = 1280
    max_audio_length: int = 8000
    dump_growth_factor: int = 3

    eos_token: str = "<|eot_id|>"
    pad_token_id: int = 384
    eoa_token_id: int = 453

    api_host: str = "0.0.0.0"
    api_port: int = 5003

    asr_model: str = "small"
    asr_device: str = "cpu"
    asr_backend: str = "hf"
    asr_sample_rate: float = 16000.0
    asr_max_audio_length: int = 60
    asr_default_language: str = "english"
    asr_enable_translation: bool = False
    s2s_overlap: bool = True
    asr_ctx_buckets: tuple = (600, 1200, 3000)
    asr_ctx_verify: bool = False

    # decode block sizes: tokens per dispatched block; a larger block once
    # a sentence has ``decode_block_switch`` tokens; a smaller first block
    decode_block: int = 32
    decode_block_large: int = 128
    decode_block_switch: int = 192
    first_decode_block: int = 16
    # decode the sentence's first block and synthesize its first chunk in
    # one dispatch with one fetch
    fused_first_chunk: bool = True
    compute_dtype: str = "bfloat16"
    chunk_buckets: Tuple[int, ...] = (16, 32, 96, 288, 512, 896, 1280)
    spec_decode: bool = False
    spec_k_draft: int = 4
    spec_k_ladder: Tuple[int, ...] = ()
    # Quantization of the serving models' matmul weights (the port serves
    # the speech decoder's).  "" = off; "w8" = weight-only (weights store
    # int8 + per-output-channel scales, dequantized into the matmul
    # operand); "w8a8" = int8 x int8 compute with dynamic per-token
    # activation quantization (lm heads stay weight-only); "w4" =
    # weight-only int4 with group-wise scales (two 4-bit weights per byte,
    # 4x fewer weight bytes than bf16; lm heads stay w8).  ops/quant.py.
    quantize: str = ""

    pool_capacity: int = 0        # 0: dedicated replicas
    pool_ladder: Tuple[int, ...] = ()
    pool_mesh_dp: int = 1
    pool_decode_block: int = 32
    pool_merge_blocks: bool = True
    pool_pipeline_depth: int = 2

    def dump_size_ladder(self, initial: int) -> List[int]:
        """The x3-growth chunk schedule."""
        sizes, d = [], initial
        while True:
            sizes.append(d)
            if d >= self.max_dump_size:
                break
            d = min(d * self.dump_growth_factor, self.max_dump_size)
        return sizes


_SIMPLE_TYPES = (int, float, str, bool)


def add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    """Register one optional CLI flag per dataclass field (default None, so
    only flags the user passed override the config)."""
    taken = {a.dest for a in parser._actions}
    for f in dataclasses.fields(cls):
        if f.name in taken:
            continue
        if f.type in ("bool", bool) or isinstance(f.default, bool):
            parser.add_argument(f"--{f.name}", type=_str2bool, default=None)
        elif isinstance(f.default, _SIMPLE_TYPES):
            parser.add_argument(f"--{f.name}", type=type(f.default), default=None)
        elif isinstance(f.default, tuple) or (
            f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
        ):
            parser.add_argument(f"--{f.name}", type=json.loads, default=None)


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def apply_cli_overrides(config, args: argparse.Namespace):
    """Return a copy of ``config`` with non-None CLI args applied."""
    updates = {}
    for f in dataclasses.fields(config):
        v = getattr(args, f.name, None)
        if v is not None:
            if isinstance(f.default, tuple) and isinstance(v, list):
                v = _deep_tuple(v)
            updates[f.name] = v
    return dataclasses.replace(config, **updates)
