"""Serving CLI: ``python -m llmvox_tpu_torch.serve --flags``.

The same flags as ``python -m llmvox_tpu.serve``: converted checkpoints
(``--llmvox_checkpoint_path``, ``--wav_model_path``, ``--byt5_table``),
the ServeConfig and CodecConfig fields, and the two TTS replicas on the
CUDA devices ``--tts_device_1`` / ``--tts_device_2`` (clamped to the last
card, as the JAX CLI does, so both replicas share card 0 on a one-card
host).  Two flags are the
port's own: ``--device`` (``cuda`` by default; ``cpu`` runs the plain
path) and ``--random_seed N``, which serves full-width random weights
made from seed N instead of checkpoints (for smoke runs; the audio is
noise).  Only ``/tts`` with ``--scripted_reply`` is served so far.
``--pool_capacity N`` serves concurrent requests through a
continuous-batching pool of N slots, ``--pool_ladder "[8,16]"`` through a
ladder of pools; either lies on ``--tts_device_1``.  ``--spec_decode``
speculates with the checkpoint's draft heads (``--spec_k_draft`` drafts,
or the adaptive rungs of ``--spec_k_ladder "[0,2,4]"`` in the pool); with
``--random_seed`` the random decoder then carries random draft heads.
``--quantize w8 | w8a8 | w4`` quantizes the speech decoder's matmul
weights after loading (random ones too), before the replicas and the pool
are built; w4 runs its matmuls through kernel K4.  On a card, warmup
captures a CUDA graph for every decode block, pool step, speculative
iteration and codec bucket that serving can reach, and prints how many,
in how many seconds, and the graph pool's bytes, before the port listens.

    python -m llmvox_tpu_torch.serve --random_seed 0 \\
        --scripted_reply "Hello there. How are you?" [--pool_capacity 16] \\
        [--spec_decode true] [--quantize w4]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from llmvox_tpu_torch.utils.config import (
    CodecConfig, DecoderConfig, ServeConfig, add_dataclass_args,
    apply_cli_overrides)


def replica_devices(device: str, cfg: ServeConfig) -> list:
    """The two replicas' devices: on ``cuda``, cards ``--tts_device_1`` and
    ``--tts_device_2``, each clamped to the last card present
    (``llmvox_tpu/serve/__main__.py`` takes ``devices[min(i, n - 1)]``)."""
    if device != "cuda":
        return [device, device]
    last = torch.cuda.device_count() - 1
    return [f"cuda:{max(0, min(i, last))}"
            for i in (cfg.tts_device_1, cfg.tts_device_2)]


def main(argv=None) -> None:
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.serve.engine import TTSEngine
    from llmvox_tpu_torch.serve.pool import DecodePool, PoolLadder
    from llmvox_tpu_torch.serve.server import build_server
    from llmvox_tpu_torch.utils import graphs
    from llmvox_tpu_torch.utils import params as P

    parser = argparse.ArgumentParser(
        description="LLMVoX streaming TTS server (PyTorch/CUDA)")
    add_dataclass_args(parser, ServeConfig)
    add_dataclass_args(parser, CodecConfig)
    parser.add_argument("--byt5_table", type=str, required=False)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--random_seed", type=int, default=None)
    args = parser.parse_args(argv)
    cfg = apply_cli_overrides(ServeConfig(), args)
    ccfg = apply_cli_overrides(CodecConfig(), args)
    if cfg.quantize:
        try:
            quant._mode_cls(cfg.quantize)
        except ValueError as e:
            parser.error(str(e))
    if cfg.pool_mesh_dp > 1:
        parser.error("--pool_mesh_dp > 1 is not ported to llmvox_tpu_torch "
                     "yet: the multi-device pool is ROADMAP queue 1 item 10")

    if args.random_seed is not None:
        dcfg = DecoderConfig()
        if cfg.spec_decode:
            # random draft heads, so that the speculative path engages
            dcfg = dataclasses.replace(dcfg, n_draft_heads=max(
                (cfg.spec_k_draft, *cfg.spec_k_ladder)))
        dec_params = P.init_decoder_params(args.random_seed, dcfg)
        codec_params = P.init_codec_params(args.random_seed + 1, ccfg)
        table = P.random_text_table(args.random_seed + 2, dcfg)
    else:
        dec_params = P.load_params_npz(cfg.llmvox_checkpoint_path)
        margs = P.load_meta(cfg.llmvox_checkpoint_path).get("model_args", {})
        dcfg = DecoderConfig(**{k: v for k, v in margs.items()
                                if k in DecoderConfig.__dataclass_fields__})
        table = np.load(args.byt5_table)["table"]
        codec_params = P.load_params_npz(cfg.wav_model_path)
    if cfg.quantize:
        dec_params = quant.quantize_decoder_params(dec_params, cfg.quantize)
        print(f"quantization ({cfg.quantize}): speech decoder, "
              f"{quant.quantized_bytes(dec_params)} bytes", flush=True)

    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    devices = replica_devices(args.device, cfg)
    engines = []
    for dev in devices:
        codec = WavCodec(codec_params, ccfg, buckets=cfg.chunk_buckets,
                         device=dev)
        engines.append(TTSEngine(dec_params, table, codec, dcfg, cfg,
                                 device=dev, cache_dtype=dtype))
    print("warming up (kernel build; a CUDA graph per decode block, fused "
          "first chunk, speculative iteration and synthesis bucket)...",
          flush=True)
    for e in engines:
        e.warmup()

    pool = None
    if cfg.pool_ladder:
        pool = PoolLadder([
            DecodePool(dec_params, table, engines[0].codec, capacity=c,
                       dcfg=dcfg, scfg=cfg, device=devices[0],
                       cache_dtype=dtype)
            for c in sorted(cfg.pool_ladder)])
        print(f"continuous-batching pool ladder: {sorted(cfg.pool_ladder)}",
              flush=True)
    elif cfg.pool_capacity > 0:
        pool = DecodePool(dec_params, table, engines[0].codec,
                          capacity=cfg.pool_capacity, dcfg=dcfg, scfg=cfg,
                          device=devices[0], cache_dtype=dtype)
        print(f"continuous-batching pool: {cfg.pool_capacity} slots",
              flush=True)
    # build_server warms the pool (step widths and rungs, synthesis
    # buckets); every capture happens before the port listens
    server = build_server(cfg, engines, pool=pool)
    print(graphs.summary(), flush=True)
    server.run()


if __name__ == "__main__":
    main()
