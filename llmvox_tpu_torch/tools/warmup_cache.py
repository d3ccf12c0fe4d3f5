"""CLI: build every kernel, then capture every serving CUDA graph once.

  python -m llmvox_tpu_torch.tools.warmup_cache                # deployed
  python -m llmvox_tpu_torch.tools.warmup_cache --pool_capacity 16
  python -m llmvox_tpu_torch.tools.warmup_cache --batch_streams 4
  python -m llmvox_tpu_torch.tools.warmup_cache --llm_pool_capacity 8 \
      --llm_jax_params llama.npz --llm_checkpoint byte

The port's counterpart of ``llmvox_tpu/tools/warmup_cache.py``, with the
same flags (the ServeConfig, DecoderConfig and CodecConfig fields) and
random weights: what is built and captured depends on shapes and config
only.  Two parts:

- the persistent part: every kernel library of ``llmvox_tpu_torch/csrc``
  is compiled by nvcc into the git-ignored build directory
  (``ops/build.py``), where every later process loads it instead of
  compiling; this is what the XLA cache is to the JAX package;
- the capture: the dedicated engine's graphs (each block length, each
  fused first-chunk variant, the speculative start and iteration under
  ``--spec_decode``, each codec bucket) and, with ``--pool_capacity > 0``
  or ``--pool_ladder``, each pool's (each width and rung, the fused
  vocodes, the ragged synthesis buckets; with ``--pool_mesh_dp D`` each
  of the pool's D shards on its card, as the server shards it) are
  captured at the given shapes and reported: counts, seconds and the graph pool's bytes (None where
  the allocator does not name a segment's pool); with
  ``--llm_pool_capacity > 0``, the pooled LLM's (``serve/llm_pool.py``:
  each prefill bucket, arrival size and prefix variant, each
  continuation rung, each decode block rung and width, and with draft
  heads in the meta and ``--llm_spec_k`` or ``--llm_spec_ladder`` each
  speculative rung's start and iterations), at the geometry
  of ``--llm_jax_params``' meta (only its ``.json`` is read; the weights
  are random, drawn on the device), its system-prompt prefix from
  ``--llm_checkpoint``'s tokenizer.  CUDA graphs,
  unlike XLA executables, do not outlive the process: every server
  captures its own at warmup, so these are discarded, and the run shows
  that every capture succeeds on this card and what it costs.

The offline batch path (``serve/batch.py::BatchTTS``) is warmed as the
JAX tool compiles it: ``--batch_streams`` (default 8) streams synthesize
``"warmup."`` with blocks of 128 and a 128-token cap.  It runs eagerly
(no graph is captured for it yet: ROADMAP §2 item 1), so this run shows
that it works at that many streams on this card and what it takes.
``--device cpu`` runs the same warmup eagerly, with nothing built or
captured.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> None:
    import torch

    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.ops import build, quant
    from llmvox_tpu_torch.serve.batch import BatchTTS
    from llmvox_tpu_torch.serve.__main__ import pool_mesh
    from llmvox_tpu_torch.serve.engine import TTSEngine
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.utils import graphs
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import (
        CodecConfig, DecoderConfig, ServeConfig, add_dataclass_args,
        apply_cli_overrides)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_dataclass_args(parser, ServeConfig)
    add_dataclass_args(parser, DecoderConfig)
    add_dataclass_args(parser, CodecConfig)
    parser.add_argument("--batch_streams", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    scfg = apply_cli_overrides(ServeConfig(), args)
    dcfg = apply_cli_overrides(DecoderConfig(), args)
    ccfg = apply_cli_overrides(CodecConfig(), args)
    mesh = None
    if scfg.pool_mesh_dp > 1:
        if scfg.pool_ladder or scfg.pool_capacity % scfg.pool_mesh_dp:
            parser.error(f"--pool_mesh_dp {scfg.pool_mesh_dp} shards one "
                         "pool of a --pool_capacity it divides")
        mesh = pool_mesh(scfg.pool_mesh_dp, args.device)

    if torch.device(args.device).type == "cuda":
        t0 = time.perf_counter()
        built = build.build_all()
        print(f"kernels: {sorted(built) or 'all cached'} in "
              f"{time.perf_counter() - t0:.2f} s ({build.BUILD_DIR})",
              flush=True)
    if scfg.spec_decode:
        dcfg = dataclasses.replace(dcfg, n_draft_heads=max(
            (scfg.spec_k_draft, *scfg.spec_k_ladder)))
    params = P.init_decoder_params(0, dcfg)
    if scfg.quantize:
        params = quant.quantize_decoder_params(params, scfg.quantize)
    table = P.random_text_table(2, dcfg)
    codec = WavCodec(P.init_codec_params(1, ccfg), ccfg,
                     buckets=scfg.chunk_buckets, device=args.device)
    dtype = (torch.bfloat16 if scfg.compute_dtype == "bfloat16"
             else torch.float32)

    def report(what: str, before: dict, t0: float) -> None:
        now = graphs.stats()
        print(f"{what}: {now['graphs'] - before['graphs']} graphs in "
              f"{time.perf_counter() - t0:.2f} s; graph pool "
              f"{now['pool_bytes']} bytes in all", flush=True)

    before, t0 = graphs.stats(), time.perf_counter()
    engine = TTSEngine(params, table, codec, dcfg, scfg, device=args.device,
                       cache_dtype=dtype)
    engine.warmup()
    report(f"engine (blocks {engine.block_lengths()}, fused "
           f"{engine.fused_variants()}, buckets {codec.buckets})", before,
           t0)
    del engine
    t0 = time.perf_counter()
    btts = BatchTTS(params, table, codec, max_streams=args.batch_streams,
                    dcfg=dcfg, scfg=scfg, device=args.device,
                    cache_dtype=dtype, block=128)
    btts.tts_batch(["warmup."] * args.batch_streams, max_tokens=128)
    print(f"batch of {btts.B} streams (block {btts.block}; eager): "
          f"{btts.decode_steps} decode steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del btts
    caps = sorted(scfg.pool_ladder) or (
        [scfg.pool_capacity] if scfg.pool_capacity > 0 else [])
    for cap in caps:
        before, t0 = graphs.stats(), time.perf_counter()
        pool = DecodePool(params, table, codec, capacity=cap, dcfg=dcfg,
                          scfg=scfg, device=args.device, cache_dtype=dtype,
                          mesh=mesh)
        pool.warmup()
        shards = pool.shards or [pool]
        report(f"pool of {cap} (steps {sorted(shards[0]._decode_fns)}"
               + (f", {len(shards)} shards of {shards[0].B} on "
                  f"{[str(p.device) for p in shards]}" if pool.shards
                  else "") + ")", before, t0)
        del pool
    if scfg.llm_pool_capacity > 0:
        from llmvox_tpu_torch.streams.llm import (build_llama_stream,
                                                  llama_config_of)
        before, t0 = graphs.stats(), time.perf_counter()
        lcfg = llama_config_of(scfg.llm_jax_params)
        # quantized under --quantize by the factory, as the server's is
        model = build_llama_stream(
            scfg, device=args.device,
            params=P.init_llama_params(3, lcfg, device=args.device,
                                       dtype=dtype))
        model.warmup()
        pool = model.pool
        widths = sorted({k[2] for k in pool.warmup_keys()
                         if k[0] in ("block", "spec_iter")})
        report(f"LLM pool of {pool.B} ({len(pool.warmup_keys())} programs: "
               f"prefill buckets {pool.buckets}, prefix buckets "
               f"{pool._prefix_buckets}, attn rungs {pool.attn_buckets}, "
               f"widths {widths}"
               + (f", spec rungs {list(pool._spec_rungs)}" if pool.use_spec
                  else "") + ")", before, t0)
        del model, pool
    print(graphs.summary() + "; every serving graph captured, and "
          "discarded with this process", flush=True)


if __name__ == "__main__":
    main()
