"""Typed configuration for the PyTorch port.

Field for field the same as ``llmvox_tpu/utils/config.py`` (DecoderConfig,
CodecConfig, ServeConfig, TrainConfig, CodecTrainConfig) minus the TPU-only decoder knobs
(``use_pallas_attention``, ``unroll_layers``): the port picks the
attention kernel by the tensor's device, not by a flag.  CLI
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

    # training: recompute each transformer block in the backward pass
    # instead of keeping its activations (torch.utils.checkpoint)
    remat_layers: bool = False

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
    every endpoint on the dedicated dual replicas or through the pool,
    with or without speculative decode and quantization, from a scripted
    reply, the LLM text stream (``llm_backend`` "jax": the in-framework
    Llama on the card, B=1, or pooled with ``llm_pool_capacity`` > 0 and
    the pool's knobs ``llm_first_block``, ``llm_prefill_buckets``,
    ``llm_chunked_prefill``, ``llm_prefill_merge``,
    ``llm_per_request_sampling`` and ``llm_prefix_cache``; "hf":
    transformers on the host) or the HF multimodal streams, with the ASR
    of ``asr_backend`` ("jax": the in-framework Whisper on the card; "hf":
    the host pipeline).  ``llm_spec_k`` and ``llm_spec_ladder`` make the
    pool speculate with the Llama's draft heads (the plain pooled block
    without them, as JAX's); ``asr_enable_translation`` is parsed but not
    used (JAX does not use it either)."""

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


@dataclass(frozen=True)
class TrainConfig:
    """Decoder-training knobs, the same fields and defaults as the JAX
    package's TrainConfig.  The port's ``train/trainer.py::Trainer`` trains
    over the ranks of a ``torchrun`` launch, split into ``dp_size`` x
    ``sp_size`` x ``tp_size`` in JAX's mesh order (tp innermost):
    ``dp_size`` -1 (the default) is the launch's world over ``sp_size *
    tp_size``, one rank without ``torchrun``, and any other value must
    make the world."""

    # System
    dtype: str = "bfloat16"
    seed: int = 1337

    # Model init
    init_from: str = "scratch"  # ['scratch','resume','gpt2',...]
    out_dir: str = "results"
    checkpoint_filename: str = "ckpt"

    # Paths
    encoder_model_path: str = "charsiu/g2p_multilingual_byT5_tiny_16_layers_100"
    tokenizer_path: str = "google/byt5-small"
    wav_config_path: str = ""
    wav_model_path: str = ""
    data_path: str = ""
    speech_data_folder: str = ""

    # Control
    eval_interval: int = 100
    log_interval: int = 1
    eval_iters: int = 1
    eval_only: bool = False
    always_save_checkpoint: bool = False

    # Logging
    wandb_log: bool = False
    wandb_project: str = "llmvox_tpu"
    wandb_run_name: str = "run"

    # Hyperparameters
    gradient_accumulation_steps: int = 4
    batch_size: int = 2
    learning_rate: float = 3e-4
    max_iters: int = 2_600_000
    weight_decay: float = 1e-1
    beta1: float = 0.9
    beta2: float = 0.95
    adam_eps: float = 1e-5
    grad_clip: float = 1.0

    # LR schedule
    decay_lr: bool = True
    warmup_iters: int = 500
    lr_decay_iters: int = 2_600_000
    min_lr: float = 3e-6

    # Parallelism: data-parallel size -1 means "the world over sp_size x
    # tp_size"; tp_size splits each replica over that many ranks
    # (Megatron); sp_size splits each sequence over that many ranks (ring
    # attention, sp_layout "ring" or the balanced "zigzag"); fsdp keeps
    # 1/dp of every matrix and of its AdamW moments on each rank (ZeRO-3)
    dp_size: int = -1
    tp_size: int = 1
    sp_size: int = 1
    sp_layout: str = "ring"
    fsdp: bool = False


@dataclass(frozen=True)
class CodecTrainConfig:
    """WavTokenizer GAN-training knobs, the same fields and defaults as the
    JAX package's CodecTrainConfig.  The port's
    ``train/codec_trainer.py::CodecTrainer`` runs one eager step for every
    ``step_impl`` (JAX's three values only size its compiled programs) and
    trains data-parallel over the ranks of a ``torchrun`` launch
    (``dp_size`` -1 is the world size, as for ``TrainConfig``)."""

    sample_rate: int = 24000
    initial_learning_rate: float = 2e-4
    mel_loss_coeff: float = 45.0
    mrd_loss_coeff: float = 1.0
    commit_loss_coeff: float = 1000.0
    num_warmup_steps: int = 0
    pretrain_mel_steps: int = 0
    max_steps: int = 20_000_000
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # data
    filelist_train: str = ""
    filelist_val: str = ""
    num_samples: int = 72000     # 3 s crops at 24 kHz
    batch_size: int = 40
    val_batch_size: int = 5
    train_gain_db_range: Tuple[float, float] = (-6.0, -1.0)
    val_gain_db: float = -3.0

    # discriminator families (the full reference sets by default)
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    mrd_resolutions: Tuple[Tuple[int, int, int], ...] = (
        (1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
    dac_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    dac_fft_sizes: Tuple[int, ...] = (2048, 1024, 512)

    # VQ
    vq_decay: float = 0.99
    vq_kmeans_iters: int = 200
    vq_threshold_dead: float = 2.0

    # eval toggles
    evaluate_utmos: bool = False
    evaluate_pesq: bool = False
    evaluate_periodicity: bool = False

    # "fused", "split" or "micro": one eager step in the port
    step_impl: str = "split"

    seed: int = 3407
    out_dir: str = "results_codec"
    log_interval: int = 100
    val_interval: int = 10000
    use_wandb: bool = False
    use_tensorboard: bool = False
    dp_size: int = -1


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
