"""CLI: build every kernel, then capture every serving CUDA graph once.

  python -m llmvox_tpu_torch.tools.warmup_cache                # deployed
  python -m llmvox_tpu_torch.tools.warmup_cache --pool_capacity 16

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
  vocodes, the ragged synthesis buckets) are captured at the given shapes
  and reported: counts, seconds and the graph pool's bytes (None where
  the allocator does not name a segment's pool).  CUDA graphs,
  unlike XLA executables, do not outlive the process: every server
  captures its own at warmup, so these are discarded, and the run shows
  that every capture succeeds on this card and what it costs.

The offline batch path (``serve/batch.py::BatchTTS``), which the JAX tool
also compiles, runs eagerly and is not covered.  ``--device cpu`` runs
the same warmup eagerly, with nothing built or captured.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> None:
    import torch

    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.ops import build, quant
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
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    scfg = apply_cli_overrides(ServeConfig(), args)
    dcfg = apply_cli_overrides(DecoderConfig(), args)
    ccfg = apply_cli_overrides(CodecConfig(), args)

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
    caps = sorted(scfg.pool_ladder) or (
        [scfg.pool_capacity] if scfg.pool_capacity > 0 else [])
    for cap in caps:
        before, t0 = graphs.stats(), time.perf_counter()
        pool = DecodePool(params, table, codec, capacity=cap, dcfg=dcfg,
                          scfg=scfg, device=args.device, cache_dtype=dtype)
        pool.warmup()
        report(f"pool of {cap} (steps {sorted(pool._decode_fns)})", before,
               t0)
        del pool
    print(graphs.summary() + "; every serving graph captured, and "
          "discarded with this process", flush=True)


if __name__ == "__main__":
    main()
