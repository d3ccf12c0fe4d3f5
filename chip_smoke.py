#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels    # phases 1, 2, 5, 8 and 11 only
    python3 chip_smoke.py --block-graphs [--root DIR]
        # a measurement aid, checked by nothing: the B=1 dense and w4 graph
        # blocks only, of the package in DIR (to compare two checkouts)
    python3 chip_smoke.py --k23-times [--root DIR]
        # a measurement aid, checked by nothing: K2's and K3's device times
        # at every shape phases 5 and 8 time, of the package in DIR
    python3 chip_smoke.py --dispatch-ab
        # a measurement aid, checked by nothing: phase 4's requests with the
        # blocks launched on the loop, a thread per replica or the card's
        # dispatch thread, in turns, with and without the lag ticker
    python3 chip_smoke.py --phase22
        # the build and phase 22 alone (data, tensor and sequence
        # parallelism and FSDP over every card up to 4: NCCL on a host
        # with four cards)

Phases, each of which raises on failure (exit code non-zero, no result):
  1. the card's name and power limit; build every kernel from the sources
     in ``llmvox_tpu_torch/csrc`` (ptxas's registers, shared memory and
     spills for each kernel are printed, and K1's cluster size);
  2. kernel K1 (decode attention) against its plain PyTorch version at the
     deployed decoder's width, every layer view of a (4, 8192, 768) cache,
     f32 and bf16, at the row partition's edges, twice (bitwise equal);
     then at head widths the deployed decoder does not use (rows that are
     not 16-byte aligned, heads over 128 f32 wide that take fewer warps);
     its bf16 times at pos 127, 511, 4095 and 8191, beside the byte bound
     and a library yardstick; with more than one card, K1 and K4 on each
     other card too (a kernel's shared-memory limit is set per device);
  3. the offline main path at full width with random seeded weights:
     ``TTSEngine.tts`` in bf16, f32 on the card against f32 on the CPU, the
     kernel's launch count on that path, decode and synthesis times.  From
     here on engines, pools and codecs serve through CUDA graphs, which
     each one's warmup captures (``utils/graphs.py``; a replay adds to the
     kernels' launch counts what its capture counted), and every phase
     asserts that nothing was captured after warmup; the engines that are
     only a check's reference run eagerly;
  4. the HTTP server on two replicas answering three sequential
     ``POST /tts``; each stream's chunk sizes against the dump ladder,
     time to first audio, real-time factor and the event loop's lag (both
     replicas' blocks launch on the device's dispatch thread).  K1's launch
     count in the JSON line is this phase's.
  5. kernel K2 (batched decode attention) against its plain version at
     the pool's full width, every layer view of (4, 16, 8192, 768) caches,
     f32 and bf16, twice (bitwise equal), at ragged and uniform positions,
     deep and at served depths (0..400), and at head widths off the
     deployed shape; its bf16 times beside the byte bound, the plain
     version and a library yardstick;
  6. the offline batched path: ``BatchTTS`` with 8 streams, f32 rows
     against the f32 B=1 engine token for token, bf16 waves finite; one
     B=16 batched block eagerly and as a CUDA graph;
  7. the HTTP server on the continuous-batching pool: one f32 round of
     concurrent ``POST /tts`` checked against the B=1 engine's chunk
     schedule, then 4 and 8 concurrent bf16 requests on a 16-slot pool
     (per-request first audio and RTF, aggregate throughput, the pool's
     counters, the host ms per step, now spent on the device's dispatch
     thread, and the event loop's lag).  K2's launch count in the JSON
     line is this phase's.
  8. kernel K3 (verify attention, speculative decode) against its plain
     version, every layer view of (4, 16, 8192, 768) caches, f32 and bf16,
     twice (bitwise equal), at 3, 5 and 13 queries per stream, ragged and
     uniform positions (one row whose later queries pass the cache), deep
     and at served depths, B=16 and B=1, and at head widths off the
     deployed shape; its bf16 times beside the byte bound, the plain
     version and a library yardstick;
  9. speculative decode offline at full width with 4 random draft heads:
     B=16 and B=1 blocks with oracle, garbage and draft-head drafts, f32
     tokens equal to greedy's, K3's launches per iteration issued, and the
     host ms per 64-token block of greedy against spec;
 10. the server with speculation: the f32 dedicated spec engines and an
     f32 spec pool against the greedy schedule, 4 and 8 concurrent bf16
     requests on a 16-slot spec pool, one round on the adaptive ladder
     (0, 2, 4), each with the event loop's lag.  K3's launch count in the
     JSON line is the bf16 spec pool rounds'.
 11. kernel K4 (the int4 weight matmul of ``--quantize w4``) against its
     plain version at every served M (1, 5, 16, 48, 80) and the deployed
     decoder's four weight shapes, f32 and bf16, twice (bitwise equal; in
     f32 each of the two held to the f64 product of the same bf16-rounded
     operands within sqrt(Cin) * 2^-24 * sum |x||w|, printed per M);
     its bf16 times with the weight copies cycled past L2, beside the
     byte bound, the plain version, a dense bf16 ``torch.matmul`` and,
     where the installed torch has it, ``torch._weight_int4pack_mm``;
 12. quantized serving at full width: for w8, w8a8 and w4, 64 f32 tokens
     from the B=1 engine on the card equal the CPU's (or part from it
     only at near ties, each checked, to the end), the bf16 32-token
     block's host and graph times beside the dense block's, the stored
     bytes; for w4, an f32 spec block at B=16, k=4 equal to greedy, and a
     4-way concurrent bf16 ``/tts`` round on a 16-slot w4 pool.  K4
     launches 4 * n_layer times per step or iteration issued; its count in
     the JSON line is the pool round's.
 13. serving through CUDA graphs against serving eagerly, in one process:
     f32 rounds on the dedicated replicas, a 16-slot pool, the spec pool
     on the (0, 2, 4) ladder and a w4 pool, each with graphs and eagerly
     (the same chunks and tokens, PCM max |diff| <= 1e-5, printed); then
     one bf16 turn with graphs and one eagerly, without the lag ticker:
     TTFA and RTF on the replicas, TTFA, aggregate and host ms per step
     at 4 and 8 concurrent requests on a 16-slot pool.
 14. ``/tts`` from the in-framework Llama (``streams/llm.py``) at the
     geometry of meta-llama/Llama-3.1-8B-Instruct (random seeded weights,
     the head's non-printable columns zeroed, the byte tokenizer, KV
     capacity 8192): 2 layers at full width in f32, the card's 64-token
     greedy chain (CUDA graph replays) against the CPU plain path's logits
     on it; BIG_DEPTH layers in bf16, the graph and eager chains equal, two
     replays of a sampled block from one state drawing different tokens,
     the prefill's times at buckets 16, 128 and 512 and a 32-token block's
     at attn_len 128, 1024 and 8192 (graph and eager) beside the byte
     bound, the captures and the peak memory; three ``/tts`` requests
     answered by the LLM on the dedicated replicas (first text delta,
     TTFA, RTF, the LLM's tokens/s, the loop's lag); then ``--quantize
     w4`` for the LLM and the decoder: the w4 block's time, one served
     request and K4's launches on the LLM's path.  Phase 11 holds K4 at
     the Llama's four weight shapes (M 1, 8, 16, 128, 512, 2048: the B=1
     stream, the pool's decode step and its burst prefill among them, in
     f32 and bf16) and times it at M 1, 8, 128 and 2048.
 15. ``/voicechat`` with the in-framework Whisper (``streams/asr.py``) at
     the geometry of openai/whisper-large-v3 (random seeded weights, a
     generation config that masks every id but the printable ones and
     EOS, the smoke's printable-id tokenizer): 2 + 2 layers at full width
     in f32, the card against the CPU's plain path (log_mel to 2e-4, the
     encoder and the prefill logits to 2e-5, two 16-token graph blocks
     teacher-forced, ``near_tie`` where they part) at the 1200-frame
     bucket with the language forced and at the full window with it
     detected; BIG_DEPTH + BIG_DEPTH layers in bf16 and in f32, the
     warmup's captures (per bucket 600, 1200 and 3000: the prep, the prep
     that detects the
     language, the decode block), the graph and eager chains equal, the
     prep's and the block's device times per bucket beside their bounds;
     three ``/voicechat`` requests (3, 6.5 and 10 s of speech-like audio)
     answered by the f32 ASR, phase 14's bf16 LLM and the dedicated
     replicas (the transcript's time, first text delta, TTFA, RTF, the
     loop's lag, no capture while serving, K1's launches);
     ``--quantize w4`` with the in-framework ASR refused; then three
     ``/voicechat`` through phase 16's bf16 LLM pool, overlapped (the
     ASR's partial transcripts stream into the pool's prefill) and then
     serial, in one process (the transcript's time, first text delta,
     TTFA).  It runs after phase 16.
 16. the continuous-batching LLM pool (``serve/llm_pool.py``) at phase
     14's geometry: 8 slots, blocks of 32, a first block of 16, prefill
     buckets 32..512, the system prompt's prefix cached, KV 8192.  2
     layers at full width in f32: ten rows (mixed lengths, staggered
     arrivals, reused slots, the prefix, a chunked prompt) through the
     captured pool against each prompt's B=1 chain (every divergence and
     every step held by ``near_tie`` against the chain teacher-forced on
     the card), and overlapped prompts equal to the serial replies.  Then
     phase 14's bf16 tree: the captures (a graph per prefill bucket,
     arrival size and prefix variant, per continuation rung and per
     decode block rung and width), each step's and each prefill's device
     time beside the byte bound, and ``/tts`` through the server with a
     16-slot bf16 TTS pool: one request and a burst of 8 whose prompts
     span the buckets (one chunked); per request the first text delta and
     TTFA, the LLM's tokens/s, the prefill programs, the loop's lag, 0
     captures while serving.  Then phase 14's w4 tree on a cut pool (KV
     1024, one bucket of 512): a burst of 8 and K4's launches on the
     pooled path (7 a layer per token step and per prefill program).
 17. the pooled speculative Llama (``decode_block_spec_pooled`` in
     ``LLMPool``) at phase 14's geometry with 4 random draft heads (4 x
     4096 x 128256), 8 slots, blocks of 32, a first block of 16, the
     ladder (0, 2, 4).  2 layers at full width in f32: speculative blocks
     at k 2 and 4 against the plain pooled blocks (equal, or held by
     ``near_tie``), oracle drafts in ceil(32 / (k + 1)) iterations,
     garbage drafts in 16, rows at the cache's last rows; the served
     path, 8 rows through a graph-captured pool pinned at k 2, against
     the plain pool (KV cut to 1024).  Phase 14's
     bf16 tree with bf16 heads: the captures (a block at rung 0, a start
     and an iteration at the others, per attention rung and width), the
     calibrated costs, an iteration's and a plain step's device time per
     rung at attn_len 128 and 8192 beside the byte bound, a burst of 8
     ``/tts`` through the server with a 16-slot TTS pool on the adaptive
     ladder (rung picks, first deltas, TTFA, LLM tokens/s, 0 captures
     while serving) and again with every block pinned at rung 2 (the
     speculative blocks and iterations issued), the peak memory.  It
     runs after phase 15, on phase 14's tree, once phases 14-16's
     streams and pools are freed.
 18. the mixture-of-experts Llama at mistralai/Mixtral-8x7B-Instruct-
     v0.1's published geometry (8 experts top-2 of 14336, random seeded
     weights, the head zeroed but for the printable ids, the byte
     tokenizer; cuts: KV 1024 of 32768, pool prefill bucket 128 only, no
     chunked prefill and no 16-token first block in the pool).  2
     layers at full width in f32: the card's chain against the CPU's
     plain path (``near_tie``), ``moe_ffn`` on the card against the CPU,
     w4 experts through K4 against JAX's group einsum on the card.  32
     layers under ``--quantize w4`` (drawn and quantized a layer at a
     time: 93 GB in bf16): the B=1 block's and an 8-row pooled step's
     device times beside the byte bound (every expert's packed bytes, as
     drop-free routing reads them) and, for B=1, the routed bound (the
     2 chosen experts' bytes a layer), one ``/tts`` on the B=1 stream
     and a burst of 4 on an 8-slot pool, K4's launches (28 a layer per
     token step and per prefill program), 0 captures while serving.
 19. decoder training (``llmvox_tpu_torch/train``), run right after phase
     3: (a) at the deployed width with 4 draft heads, B=2, T=512, in f32,
     the loss and every gradient of a bucketed and a packed batch on the
     card against the CPU's plain path, then 3 updates (k=2, clipping
     active, the first a no-op under warmup) with the params held to the
     CPU's, each tolerance printed beside its error; (b) bf16 at the
     deployed shape (``TrainConfig()``: batch 2, accumulation 4), bucketed
     at T=8192 and packed at pack_len 8192, remat off and on: ms a
     micro-step and an update, tokens/s, MFU against the H100's dense bf16
     peak, the bound (``estimate_mfu``'s FLOPs over that peak), peak
     memory, and (remat off) one micro-step under ``torch.profiler``: the
     device's busy share and its time by kernel class; the loss going
     down over 40 updates on one fixed batch; then, at T=8192 on the
     trained params, the bf16 loss of a bucketed and a packed batch
     against the f32 loss on the card, the packed loss against its
     unpacked twin (each sentence in a row of its own), and the bf16
     attention with and without the packed segments, forward and
     backward, against the port's plain f32 version (with the error a
     mask that leaked across sentences would show);
     (c) ``python -m llmvox_tpu_torch.train`` in a subprocess: 4
     micro-steps with a checkpoint, ``--init_from resume`` carrying
     ``iter_num``, and the checkpoint serving one offline ``tts``;
     (d) ``sample_block`` from the trained params: top-k 1 equal to
     ``decode_block``'s greedy tokens, two seeds at temperature 1 drawing
     different tokens, K1's launches (K1's ``train_launches``).
 20. codec training (``train/codec_trainer.py``), run right after phase
     19: (a) ``CodecConfig()``'s widths with every discriminator of
     ``CodecTrainConfig()``, 2 steps (the first on the uninitialised
     codebook, with the 200-iteration k-means init) of the card's f32
     trainer against the CPU's plain path on 2 x 0.4 s crops, from one
     seeded state with the same draws, each half from one state: every
     log, every gradient tensor, every param after each half and the
     codebook at their bounds, the nearest codes (each that differs a
     near tie), where a discriminator's leaky ReLU whose slope rounding
     flips is judged against the card's f64 trainer on the same batch;
     (b)
     the deployed shape (40 x 3 s), f32, remat off: a warm step, 3 steps
     timed half by half, one profiled (busy share, time by kernel class),
     one counted by ``FlopCounterMode`` for the bound (over the f32 rate
     of the card's SM count and max SM clock), the peak memory, every
     step's losses finite; (c) ``codec_main`` 2 steps with a validation
     pass on 4 seeded wav files (2 at 16 kHz), its export loaded into
     ``WavCodec``, ``copy_synthesis`` and ``prepare_data`` (read back by
     ``train/data.py``); every kernel's launches on the path (0: codec
     training reaches no TPU kernel's port).
 21. codec evaluation and compression, run right after phase 20, at full
     width with seeded numpy weights: (a) the UTMOS scorer at
     wav2vec2-base's geometry (``UTMOSConfig()``): a 3 s 16 kHz clip's
     score and frame scores in f32 against the card's f64, one f32 score
     of a 10 s clip timed, the peak memory; (b) the Encodec LM
     (``lm_config_for(CodecConfig())``) compressing and decompressing 750
     frames of ``encode_infer`` codes through one captured T=1 step,
     exactly, ms a step (with the coder, and the graph replay's device
     time), bytes a frame against the raw 12 bits, the f32 pdfs against
     the f64 step's over 64 frames; (c) ``encode_frames`` /
     ``decode_frames`` of 2 x 3 s at 1 s segments, overlap 0.01,
     normalised, f32 against f64 (a differing code a near tie); (d) the
     eval CLI in both modes over 4 seeded wav files (2 at 16 kHz) and
     ``validation_metrics(full=True)`` on 2 x 3 s, the UTMOS of (a)
     registered; every kernel's launches on the path (0).
 22. data parallelism, run last (``phase_dp``): (a) the ranks, NCCL over
     every card up to 4, or two gloo ranks sharing one card (``dp_layout``),
     spawned by ``parallel/launch.py::spawn``: the decoder trainer at
     ``DecoderConfig()`` with 4 draft heads, f32, a global batch of 2 x
     world rows at T=512 (bucketed and packed, the ranks' valid targets
     unequal), accumulation 2, two updates, and the codec trainer at
     ``CodecConfig()`` with every discriminator, f32, 2 x world crops of
     9600 samples, the k-means step and one more; every rank's params,
     moments (and the VQ) bitwise equal to rank 0's after every update
     (a broadcast and an exact compare); then rank 0, the group gone, runs
     both one-process on the same batches and draws and holds the dp run
     to them (decoder: losses 1e-5 relative, params 1e-5; codec: logs
     1e-3 relative, the f64 run refereeing a log the f32 one-process run
     is off, the codebook 1e-5, params rtol 2e-3 / atol 5e-5 with at most
     1 in 1000 outside); ms an update and a step at world N and world 1;
     then in the same ranks Megatron tensor parallelism (``_tp_rank``,
     ``_tp_one``): the decoder trainer at tp 2 (dp = world / 2) held to
     one process as above; Llama-3.1-8B's geometry at tp = world,
     ``BIG_DEPTH`` layers bf16 (a B=1 prefill and 16-token block, timed
     against one process; a pooled prefill of 4 rows and a block; tokens
     equal to one process's or within ``TP_TIE_ULPS`` bf16 ulps a tp rank
     of its picks teacher-forced on the tp chain) and 2 layers f32 (tokens
     identical); Mixtral-8x7B's at 2 layers in bf16 (reported where it
     parts, and held to one process forced onto the tp run's expert
     routes and teacher-forced on its chain: tokens its picks or within
     ``TP_TIE_ULPS``, every route it would have taken otherwise within
     ``TP_ROUTE_TIE_ULPS`` a tp rank of a router tie) and f32 (identical, and
     held so too); each rank's weight and KV bytes against
     one process's, the prefill logits' gap, every kernel's launches on
     the tp path (0);
     then in the same ranks sequence parallelism and FSDP (``_sp_rank``,
     ``_sp_one``; ``sp_layouts``): the decoder trainer at
     ``DecoderConfig()`` with 4 draft heads, f32, 2 rows at T=2048,
     accumulation 2, two updates, at sp 2 ring, sp 2 zigzag and FSDP at
     dp 2 on one card (two gloo ranks: the rotation, all-gather and
     reduce-scatter take the all-reduce route), or dp 2 x sp 2 with FSDP,
     sp 4 zigzag and sp 2 x tp 2 on four (NCCL: the native route), each
     held to one process as above, each rank's parameter and moment bytes
     beside one process's; then a bf16 update at T=8192, B=2 at sp = world
     (ring and zigzag on one card, zigzag on four), timed beside one
     process's (cuDNN's SDPA), each rank's peak device memory beside one
     process's; the route printed, every kernel's launches on the sp /
     fsdp path (0);
     (b) the dp-sharded ``DecodePool`` at ``DecoderConfig()``, 16 slots
     over the ranks' devices (the same card twice on one card), EOA off,
     a length cap of 96: three f32 ``/tts`` through ``build_server``, each
     chain identical to the one-card pool's; a bf16 round with ``pool_mesh_dp``, each chain's
     first 64 tokens held by ``check_chain`` against the bf16 B=1 engine,
     K2's launches per shard (``graphs.launch_scope``), K1, K3 and K4 0,
     no capture while serving.
Then a JSON line with phase 19's numbers (printed after it), one with
phase 20's, one with phase 21's, one with phase 14's, one with phase 16's, one with phase 15's, one with phase
17's, one with phase 18's, one with phase 22's, one with the kernels' numbers (each kernel's
launches on every served path, the new phases' among them), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TEXT = "Hello, this is a smoke test of the streaming speech decoder."
REPLY = ("Hello there, this is the first sentence of the reply. "
         "And here is the second one.")


def log(msg: str) -> None:
    print(msg, flush=True)


class Laps:
    """The script's clock: ``lap(name)`` logs the seconds since the last
    lap beside those since the start; ``total()`` the whole run's."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name}: {now - self.last:.1f} s "
            f"({now - self.start:.1f} s since the start)")
        self.last = now

    def total(self) -> None:
        log(f"[time] the script: {time.perf_counter() - self.start:.1f} s")


def eager_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    eager calls, by CUDA events (the host's launch cost included where
    the host is the slower side)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, per_graph: int = 16, replays: int = 20, reps: int = 5
             ) -> float:
    """Device time per call: ``per_graph`` calls captured in a CUDA graph,
    replayed; the median over ``reps`` of the mean per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * per_graph))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from llmvox_tpu_torch.ops import build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s, compiled "
        f"{sorted(built) or 'nothing (cached)'}")
    for src in build.sources():
        for line in build.build_log(src.stem).splitlines():
            if ("ptxas info" in line and ("registers" in line
                                          or "Compiling" in line)
                    or "spill" in line):
                log(f"[build] {line.strip()}")
    from llmvox_tpu_torch.ops import cuda_attn
    log(f"[build] K1 launches clusters of {cuda_attn.CLUSTER} blocks per "
        f"head")
    return card


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

# The kernels and their plain versions both compute in f32 and round the
# output once to the input type, so in bf16 they may differ by one bf16 ulp
# of the output (2^-7 of its value at most) and by f32 noise near zero.
K1_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}
# Held against the library yardstick (SDPA) only as a sanity check: its
# bf16 paths round the probabilities to bf16 before the value product.
LIBRARY_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
               torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def k1_bound_ms(pos: int, c: int, dtype) -> tuple:
    """Least time for one call: K and V rows 0..pos, q and out read or
    written once, over HBM's rate; or 4*(pos+1)*C flops over the peak
    rate of the inputs' type; whichever is longer."""
    es = torch.finfo(dtype).bits // 8
    n = pos + 1
    nbytes = 2 * n * c * es + 2 * c * es + 4
    flops = 4 * n * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# today's positions plus the edges of the row partition (NB-1, NB, NB+1 for
# NB = 8 blocks a head, the last and first pos past rank 0 alone (64 rows),
# pos+1 that no 8-row tile divides, the last row S-1)
K1_POS = (0, 1, 7, 8, 9, 63, 64, 99, 127, 255, 256, 511, 1000, 4095, 8191)
K1_TIMED = (127, 511, 4095, 8191)
# (dtype, width, heads) off the deployed shape, each on its own code path:
# bf16 head 100 (rows not 16-byte aligned: staged by plain loads), f32 head
# 256 (16 vectors a lane, 3 warps a block) and f32 head 130 (both: plain
# loads, 16 vectors a lane, 6 warps)
K1_ODD = ((torch.bfloat16, 800, 8), (torch.float32, 1024, 4),
          (torch.float32, 1040, 8))
K1_ODD_S = 2048


def k1_warps(d: int, itemsize: int) -> int:
    """Warps a K1 block runs for head width d (``n_warps_for`` in the
    kernel: 8, or as many as a 4-stage ring of 8-row K and V tiles a warp
    fits in 200 KiB)."""
    row = -(-d * itemsize // 16) * 16
    return min(8, 200 * 1024 // (4 * 2 * 8 * row))


def phase_k1() -> dict:
    from llmvox_tpu_torch.utils.config import DecoderConfig
    cfg = DecoderConfig()
    L, S, C, H = cfg.n_layer, cfg.block_size, cfg.n_embd, cfg.n_head
    D = C // H
    assert S - 1 in K1_POS
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    max_err = 0.0
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn(L, S, C, generator=gen).to(dev, dtype)
        v = torch.randn(L, S, C, generator=gen).to(dev, dtype)
        q = torch.randn(C, generator=gen).to(dev, dtype)
        for pos in K1_POS:
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            err = max(_k1_check(q, k[layer], v[layer], p, H, dtype,
                                (pos, layer)) for layer in range(L))
            max_err = max(max_err, err)
            log(f"[k1] {str(dtype):15s} pos {pos:5d} ok, bitwise "
                f"repeatable, max |err| over {L} layers {err:.3g}")
            if dtype is torch.bfloat16 and pos in K1_TIMED:
                timings[pos] = _time_k1(q, k, v, p, pos, H, D, dtype)
        del k, v
    for dtype, c, h in K1_ODD:
        w = k1_warps(c // h, torch.finfo(dtype).bits // 8)
        k = torch.randn(K1_ODD_S, c, generator=gen).to(dev, dtype)
        v = torch.randn(K1_ODD_S, c, generator=gen).to(dev, dtype)
        q = torch.randn(c, generator=gen).to(dev, dtype)
        at = (0, 8 * w - 1, 8 * w, 8 * w + 1, 1000, K1_ODD_S - 1)
        err = max(_k1_check(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                                  device=dev), h, dtype,
                            (c, h, pos)) for pos in at)
        max_err = max(max_err, err)
        log(f"[k1] {str(dtype):15s} width {c}, {h} heads of {c // h} ({w} "
            f"warps a block) ok at pos {at}, bitwise repeatable, max |err| "
            f"{err:.3g}")
    return {"max_abs_err": max_err, "timings": timings}


def _k1_check(q, k, v, p, H, dtype, what) -> float:
    """K1 twice against its plain version: bitwise equal, within K1_TOL;
    the largest error."""
    from llmvox_tpu_torch.ops import attention, cuda_attn
    ref = attention.decode_attention(q, k, v, p, n_head=H)
    got = cuda_attn.decode_attention(q, k, v, p, H)
    again = cuda_attn.decode_attention(q, k, v, p, H)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **K1_TOL[dtype])
    assert torch.equal(got, again), ("K1 not deterministic", dtype, what)
    return (got.float() - ref.float()).abs().max().item()


def phase_other_cards() -> None:
    """With more than one card: K1 (bf16, deployed width, pos 300) and K4
    (bf16, wfc at M=80) launched on card 0 and then on every other card,
    each against its plain version, as a second dedicated replica
    (``--tts_device_2``) launches them."""
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    from llmvox_tpu_torch.utils.config import DecoderConfig
    n = torch.cuda.device_count()
    if n < 2:
        log("[cards] one card: K1 and K4 on other cards not checked")
        return
    cfg = DecoderConfig()
    c, h = cfg.n_embd, cfg.n_head
    gen = torch.Generator().manual_seed(6)
    kv = [torch.randn(cfg.block_size, c, generator=gen) for _ in range(2)]
    q = torch.randn(c, generator=gen)
    w = quant.quantize_weight4(0.02 * torch.randn(*K4_SHAPES["wfc"],
                                                  generator=gen))
    x = torch.randn(80, K4_SHAPES["wfc"][0], generator=gen)
    bf = torch.bfloat16
    for i in range(n):
        dev = torch.device("cuda", i)
        k1 = _k1_check(q.to(dev, bf), kv[0].to(dev, bf), kv[1].to(dev, bf),
                       torch.tensor(300, dtype=torch.int32, device=dev), h,
                       bf, ("card", i))
        xs, qs, ss = x.to(dev, bf), w.q.to(dev), w.s.to(dev, bf)
        got = cuda_int4_mm.int4_matmul(xs, qs, ss)
        ref = cuda_int4_mm.plain_int4_matmul(xs, qs, ss)
        torch.cuda.synchronize(dev)
        torch.testing.assert_close(got.float(), ref.float(), **K4_TOL[bf])
        log(f"[cards] cuda:{i} {torch.cuda.get_device_name(i)}: K1 ok (max "
            f"|err| {k1:.3g}), K4 wfc M=80 ok (max |err| "
            f"{(got.float() - ref.float()).abs().max().item():.3g})")


def _time_k1(q, k, v, p, pos, H, D, dtype) -> dict:
    from llmvox_tpu_torch.ops import attention, cuda_attn
    L, _, C = k.shape
    li = [0]

    def nxt():
        li[0] = (li[0] + 1) % L   # cycle the layers: 4 x 25 MB > 50 MB L2
        return li[0]

    def run_kernel():
        i = nxt()
        cuda_attn.decode_attention(q, k[i], v[i], p, H)

    def run_plain():
        i = nxt()
        attention.decode_attention(q, k[i], v[i], p, n_head=H)

    n = pos + 1
    q4 = q.view(1, H, 1, D)
    kv = [(k[i, :n].view(n, H, D).transpose(0, 1)[None],
           v[i, :n].view(n, H, D).transpose(0, 1)[None]) for i in range(L)]

    def run_library():
        i = nxt()
        torch.nn.functional.scaled_dot_product_attention(q4, *kv[i])

    lib_out = torch.nn.functional.scaled_dot_product_attention(
        q4, *kv[0]).reshape(C)
    torch.testing.assert_close(
        lib_out.float(),
        cuda_attn.decode_attention(q, k[0], v[0], p, H).float(),
        **LIBRARY_TOL[dtype])
    bound, by = k1_bound_ms(pos, C, dtype)
    t = {"ms": graph_ms(run_kernel), "plain_ms": graph_ms(run_plain),
         "library_ms": graph_ms(run_library), "bound_ms": bound,
         "bound_by": by, "eager_ms": eager_ms(run_kernel),
         "eager_plain_ms": eager_ms(run_plain),
         "eager_library_ms": eager_ms(run_library)}
    log(f"[k1] bf16 pos {pos}: device time per call (CUDA graph) kernel "
        f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, sdpa "
        f"{t['library_ms'] * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}); "
        f"eager back-to-back kernel {t['eager_ms'] * 1e3:.1f} us, plain "
        f"{t['eager_plain_ms'] * 1e3:.1f} us, sdpa "
        f"{t['eager_library_ms'] * 1e3:.1f} us")
    return t


# ---------------------------------------------------------------------------
# phase 3: the offline main path at full width
# ---------------------------------------------------------------------------

def smoke_serve_config():
    """The deployed ServeConfig with a length cap of 200 tokens: a random
    chain need not emit EOA, and under the deployed cap (8000) such a
    sentence would run to the 8192-row KV capacity."""
    from llmvox_tpu_torch.utils.config import ServeConfig
    return ServeConfig(max_audio_length=200, scripted_reply=REPLY,
                       api_host="127.0.0.1")


def make_engine(weights, device, dtype, graphs=None, warm=False):
    """A replica and its codec; with ``warm`` on a card, its warmup (every
    CUDA graph it serves through) runs here.  ``graphs=False`` makes an
    eager engine, for the checks whose reference it is and the
    graph-against-eager phase."""
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.serve.engine import TTSEngine
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    codec = WavCodec(codec_p, ccfg, buckets=scfg.chunk_buckets,
                     device=device, graphs=graphs)
    eng = TTSEngine(dec_p, table, codec, dcfg, scfg, device=device,
                    cache_dtype=dtype, graphs=graphs)
    if warm and (torch.device(device).type == "cuda" or graphs):
        eng.warmup()
    return eng


def captures() -> int:
    """CUDA graphs captured so far in this process."""
    from llmvox_tpu_torch.utils import graphs
    return graphs.CAPTURES


def graphs_text() -> str:
    from llmvox_tpu_torch.utils import graphs
    return graphs.summary()


def uploads_text(*sets) -> str:
    """The first replays (graph uploads) of the given GraphSets, which
    warmup makes after each capture: the largest and the sum, in ms."""
    ts = [g.upload_s for gs in sets for g in gs.graphs.values()
          if g.upload_s is not None]
    if not ts:
        return "no graph uploads (eager)"
    return (f"first replays (graph uploads) at warmup: max "
            f"{max(ts) * 1e3:.1f} ms, {sum(ts) * 1e3:.1f} ms over {len(ts)}")


def synth_len(tokens, eoa) -> int:
    return len(tokens) - (1 if tokens and tokens[-1] == eoa else 0)


def block_times(eng, n_blocks: int = 8) -> list:
    """Host ms of each of ``n_blocks`` decode blocks of ``eng`` from
    position 0, each fetched before the next is issued (EOA off in the
    engine's config: the blocks must run full)."""
    ids = list(np.frombuffer(TEXT.encode(), np.uint8).astype(np.int32) + 3)
    buf = np.full(n_blocks * eng.block + len(ids), eng.dcfg.pad_token_id,
                  np.int32)
    buf[:len(ids)] = ids
    state = eng.new_state()
    times = []
    for i in range(n_blocks):
        t0 = time.perf_counter()
        got, state = eng.decode_block(
            state, buf[i * eng.block:(i + 1) * eng.block], len(ids),
            eng.block)
        times.append((time.perf_counter() - t0) * 1e3)
        assert len(got) == eng.block
    return times


def phase_offline(dcfg=None, ccfg=None, device="cuda") -> tuple:
    """The deployed configs by default; smaller ones and the CPU only to
    rehearse the script's control flow."""
    from llmvox_tpu_torch.ops import cuda_attn
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import CodecConfig, DecoderConfig
    dcfg, ccfg = dcfg or DecoderConfig(), ccfg or CodecConfig()
    scfg = smoke_serve_config()
    t0 = time.perf_counter()
    weights = (P.init_decoder_params(0, dcfg), P.init_codec_params(1, ccfg),
               P.random_text_table(2, dcfg), dcfg, ccfg, scfg)
    engines = [make_engine(weights, device, torch.bfloat16)
               for _ in range(2)]
    log(f"[offline] weights and two bf16 engines: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for e in engines:
        e.warmup()
    _sync(device)
    log(f"[offline] warmup of both engines: {time.perf_counter() - t0:.2f} s"
        f" (blocks {engines[0].block_lengths()}, fused "
        f"{engines[0].fused_variants()}, buckets {engines[0].codec.buckets});"
        f" {graphs_text()}; engine 0's "
        + uploads_text(engines[0]._blocks, engines[0]._fused,
                       engines[0].codec._graphs))

    eng = engines[0]
    cuda_attn.LAUNCHES = 0
    steps0 = eng.decode_steps
    t0 = time.perf_counter()
    wav, toks = eng.tts(TEXT, max_tokens=256)
    dt = time.perf_counter() - t0
    launches = cuda_attn.LAUNCHES
    steps = eng.decode_steps - steps0
    n = synth_len(toks, dcfg.eoa_token_id)
    assert n > 0, "no tokens"
    assert np.isfinite(wav).all(), "non-finite samples"
    assert len(wav) == ccfg.hop_length * n, (len(wav), n)
    assert launches == dcfg.n_layer * steps > 0, (launches, steps)
    log(f"[offline] bf16 tts: {len(toks)} tokens"
        f"{' (ended at EOA)' if n < len(toks) else ''}, {len(wav)} samples "
        f"in {dt * 1e3:.1f} ms; K1 launches {launches} = {dcfg.n_layer} "
        f"layers x {steps} steps")

    # Random weights reach EOA within a few dozen tokens, so the deeper
    # checks switch EOA off (an id outside the vocabulary): the greedy
    # chain then runs to the cap and the comparison covers every position.
    no_eoa = (*weights[:3], dataclasses.replace(dcfg, eoa_token_id=-1),
              *weights[4:])
    deep = make_engine(no_eoa, device, torch.bfloat16, warm=True)
    g32 = make_engine(no_eoa, device, torch.float32, warm=True)
    c32 = make_engine(no_eoa, "cpu", torch.float32)
    n_cap = captures()
    cuda_attn.LAUNCHES = 0
    wav, toks = deep.tts(TEXT, max_tokens=256)
    assert len(toks) == 256 and len(wav) == 256 * ccfg.hop_length
    assert np.isfinite(wav).all(), "non-finite samples"
    assert cuda_attn.LAUNCHES == dcfg.n_layer * deep.decode_steps > 0
    log(f"[offline] bf16 tts, EOA off: 256 tokens (pos 0..255), "
        f"{len(wav)} finite samples; K1 launches {cuda_attn.LAUNCHES}")
    # offline synthesis is eager: an utterance past the largest captured
    # bucket decodes at its own length
    n_long = deep.codec.buckets[-1] + 2 * deep.block
    wav, toks = deep.tts(TEXT, max_tokens=n_long)
    assert len(toks) == n_long and len(wav) == n_long * ccfg.hop_length
    assert np.isfinite(wav).all(), "non-finite samples"
    log(f"[offline] bf16 tts, EOA off: {n_long} tokens, past the largest "
        f"bucket ({deep.codec.buckets[-1]}), {len(wav)} finite samples")
    _, tg = g32.tts(TEXT, max_tokens=64)
    _, tc = c32.tts(TEXT, max_tokens=64)
    assert len(tg) == 64 and tg == tc, (tg, tc)
    log("[offline] f32 card (CUDA graphs) vs f32 CPU (plain path), EOA "
        "off: 64 tokens identical")
    del g32, c32

    block_ms = block_times(deep)
    log(f"[offline] decode ms per {deep.block}-token block (pos 0..255, "
        f"bf16, one CUDA graph replay, host clock, issue to fetch): "
        f"{', '.join(f'{x:.1f}' for x in block_ms)}; median "
        f"{statistics.median(block_ms):.1f}")
    del deep
    rng = np.random.default_rng(3)
    synth_ms = {}
    for b in eng.codec.buckets:
        codes = rng.integers(0, ccfg.vq_bins, (1, b)).astype(np.int32)
        eng.codec.decode_codes(codes)
        t0 = time.perf_counter()
        for _ in range(3):
            eng.codec.decode_codes(codes)
        synth_ms[b] = (time.perf_counter() - t0) / 3 * 1e3
    log("[offline] synthesis ms per bucket (f32, one CUDA graph replay, "
        "host to host): "
        + ", ".join(f"{b}: {ms:.1f}" for b, ms in synth_ms.items()))
    assert captures() == n_cap, "a CUDA graph was captured after warmup"
    return engines, weights


# ---------------------------------------------------------------------------
# phase 19: decoder training
# ---------------------------------------------------------------------------

TRAIN_CHECK_T = 512      # the f32 card-vs-CPU check's sequence width
TRAIN_HEADS = 4          # draft heads trained in the f32 check
TRAIN_LOSS_STEPS = 40    # micro-steps of the loss-goes-down run
# f32, TF32 off, against the CPU's plain path: the loss to 1e-5 relative;
# each gradient to 1e-4 of that tensor's largest |gradient| (sums over
# 1024 tokens in other orders, SDPA's f32 kernel against the naive
# softmax); the params after 3 updates at lr 1e-3 to 1e-5 (1% of a step)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
# bf16 at T=8192 against f32 on the card: the loss, a mean over ~16k
# targets in which the roundings (~4e-3 each) average out, to 1e-3
# relative, below what attention across the packed sentences moves it
# (which the phase asserts); the attention's output to 2e-2 (|o| up to ~3
# on N(0,1) inputs) and each input's gradient to 5e-2 of its largest
# |gradient|; a mask that leaked across sentences must miss the output by
# more than 10 times its tolerance
TRAIN_BF16_RTOL = 1e-3
ATTN_BF16_ATOL = 2e-2
ATTN_BF16_GRAD_RTOL = 5e-2


def synthetic_samples(n: int, seed: int, max_codes: int, cfg) -> list:
    """Sentences drawn from a seed: lengths up to ``max_codes`` (so at most
    ``max_codes + 1`` positions with the EOA), byte-range text ids about a
    fifth as many, and codes from a Zipf-like law over the vocabulary
    (p(i) ~ 1 / (i + 10), entropy 7.09 nats at 4096 codes against 8.32 for
    uniform ones), since a codec's codes are far from uniform."""
    from llmvox_tpu_torch.train.data import Sample
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(cfg.vocab_size) + 10.0)
    p /= p.sum()
    out = []
    for _ in range(n):
        m = int(rng.integers(max(1, max_codes // 16), max_codes + 1))
        out.append(Sample(
            text_ids=rng.integers(3, 259, max(1, m // 5)).astype(np.int32),
            codes=rng.choice(cfg.vocab_size, m, p=p).astype(np.int32)))
    return out


def _grads(tr, batch) -> tuple:
    """The loss and every gradient of one batch, without an update."""
    loss = tr.loss(batch, train=True)
    loss.backward()
    grads = {}
    for name, p in zip(tr.names, tr.opt.params):
        grads[name] = p.grad.detach().cpu().numpy()
        p.grad = None
    return float(loss.detach()), grads


def _train_f32_check(cfg, table, codebook, device, t: int) -> dict:
    """(a) f32 training on the card against the CPU's plain path on the
    same params and batches: loss and gradients of a bucketed and a packed
    batch, then 3 updates (k=2, clipping active, the first under warmup)."""
    from llmvox_tpu_torch.train.data import collate, collate_packed
    from llmvox_tpu_torch.train.trainer import Trainer
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import TrainConfig
    cfg = dataclasses.replace(cfg, n_draft_heads=TRAIN_HEADS)
    params = P.init_decoder_params(19, cfg)
    tcfg = TrainConfig(batch_size=2, gradient_accumulation_steps=2,
                       learning_rate=1e-3, warmup_iters=1, grad_clip=0.1)
    card = Trainer(tcfg, cfg, table, codebook, compute_dtype=torch.float32,
                   device=device, params=params)
    cpu = Trainer(tcfg, cfg, table, codebook, compute_dtype=torch.float32,
                  device="cpu", params=params)
    samples = synthetic_samples(16, 190, t - 1, cfg)
    longest = max(samples, key=lambda s: len(s.codes))
    batches = [collate([longest, samples[0]], cfg, bucket=t),
               collate_packed(samples, cfg, rows=2, seq_len=t)[:4]]
    assert batches[0][0].shape == batches[1][0].shape == (2, t)
    out = {}
    for name, batch in zip(("bucketed", "packed"), batches):
        lc, gc = _grads(card, batch)
        lp, gp = _grads(cpu, batch)
        rel = abs(lc - lp) / abs(lp)
        worst = max((np.abs(gc[k] - gp[k]).max() / max(np.abs(gp[k]).max(),
                                                      1e-30), k) for k in gp)
        norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in gp.values())))
        log(f"[train] f32 {name} (2 x {t}, {TRAIN_HEADS} draft heads), card "
            f"vs CPU: loss {lc:.6f} / {lp:.6f}, rel err {rel:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); gradients, worst max|err| / max|g| "
            f"{worst[0]:.2e} at {worst[1]} over {len(gp)} tensors (tol "
            f"{TRAIN_GRAD_RTOL:.0e}); gradient norm {norm:.3f} (clip "
            f"{tcfg.grad_clip})")
        assert rel <= TRAIN_LOSS_RTOL, (name, lc, lp)
        assert worst[0] <= TRAIN_GRAD_RTOL, (name, worst)
        assert norm > tcfg.grad_clip, "the clip would not be active"
        out[name] = {"loss_rel_err": rel, "grad_rel_err": float(worst[0]),
                     "grad_norm": norm}
    start = {n: p.detach().cpu().numpy().copy()
             for n, p in zip(cpu.names, cpu.opt.params)}
    losses = []
    for i in range(3 * tcfg.gradient_accumulation_steps):
        batch = batches[i % 2]
        losses.append((card.step(*batch), cpu.step(*batch)))
        if i == tcfg.gradient_accumulation_steps - 1:
            # the first update runs at lr_schedule(0) = 0 under warmup
            for n, p in zip(card.names, card.opt.params):
                assert np.array_equal(p.detach().cpu().numpy(), start[n]), n
    err = max(abs(a - b) / abs(b) for a, b in losses)
    perr = max((float(np.abs(pc.detach().cpu().numpy()
                              - pp.detach().numpy()).max()), n)
               for n, pc, pp in zip(card.names, card.opt.params,
                                    cpu.opt.params))
    moved = max(float(np.abs(pp.detach().numpy() - start[n]).max())
                for n, pp in zip(cpu.names, cpu.opt.params))
    log(f"[train] f32, 6 micro-steps (k=2: 3 updates, the first a no-op "
        f"under warmup, clip {tcfg.grad_clip}): losses' worst rel err "
        f"{err:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); params' max|err| "
        f"{perr[0]:.2e} at {perr[1]} (tol {TRAIN_PARAM_ATOL:.0e}; the params "
        f"moved up to {moved:.2e})")
    assert err <= TRAIN_LOSS_RTOL, losses
    assert perr[0] <= TRAIN_PARAM_ATOL, perr
    assert moved > 10 * TRAIN_PARAM_ATOL, moved
    out.update(step_loss_rel_err=err, param_abs_err=perr[0],
               param_moved=moved)
    return out


def _train_times(cfg, table, codebook, device, t: int, params,
                 work: str) -> dict:
    """(b) bf16 training at the deployed shape: TrainConfig()'s batch 2 and
    accumulation 4, bucketed at T=t and packed at pack_len t, remat off
    and on, on a dataset that ``save_prepared`` wrote; per configuration
    one update of warmup, then two updates timed micro-step by micro-step
    (host clock, each ending in the loss's fetch), and with remat off one
    more micro-step under ``torch.profiler`` (``_profile_micro``)."""
    from llmvox_tpu_torch.train.data import (BatchIterator,
                                             PackedBatchIterator,
                                             SpeechDataset, save_prepared)
    from llmvox_tpu_torch.train.trainer import (H100_PEAK_FLOPS, Trainer,
                                                estimate_mfu)
    from llmvox_tpu_torch.utils.config import TrainConfig
    path = os.path.join(work, "long.npz")
    save_prepared(path, synthetic_samples(64, 191, t - 1, cfg))
    data = SpeechDataset(path)
    tcfg = TrainConfig()
    k = tcfg.gradient_accumulation_steps
    out = {}
    for layout in ("bucketed", "packed"):
        it = (iter(BatchIterator(data, cfg, tcfg.batch_size, bucket=t,
                                 seed=tcfg.seed)) if layout == "bucketed"
              else iter(PackedBatchIterator(data, cfg, tcfg.batch_size, t,
                                            seed=tcfg.seed)))
        batches = [next(it) for _ in range(3 * k)]
        for remat in (False, True):
            mcfg = dataclasses.replace(cfg, remat_layers=remat)
            _sync(device)
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            tr = Trainer(tcfg, mcfg, table, codebook, device=device,
                         params=params)
            for b in batches[:k]:
                tr.step(*b)
            ms = []
            for b in batches[k:]:
                t0 = time.perf_counter()
                tr.step(*b)
                ms.append((time.perf_counter() - t0) * 1e3)
            micro = statistics.median(
                [m for i, m in enumerate(ms) if (i + 1) % k])
            update = statistics.median(ms[k - 1::k])
            cycle = sum(ms) / (len(ms) / k)
            tokens = tcfg.batch_size * t
            real = sum(int((b[1] != cfg.ignore_index).sum())
                       for b in batches[k:]) / len(ms)
            bound = estimate_mfu(mcfg, tr.n_params, tokens, 1.0,
                                 seq_len=t) * 1e3
            mfu = estimate_mfu(mcfg, tr.n_params, tokens * k, cycle / 1e3,
                               seq_len=t)
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if torch.device(device).type == "cuda" else 0.0)
            name = f"{layout} remat {'on' if remat else 'off'}"
            log(f"[train] bf16 {name}, 2 x {t}, k={k}: micro-step "
                f"{micro:.2f} ms, micro-step with the update "
                f"{update:.2f} ms, an update (k micro-steps) {cycle:.2f} ms; "
                f"{tokens * k / cycle * 1e3:.0f} tokens/s "
                f"({real / micro * 1e3:.0f} target tokens/s); MFU "
                f"{mfu * 100:.2f}% of {H100_PEAK_FLOPS / 1e12:.0f} TFLOP/s; "
                f"bound {bound:.2f} ms a micro-step "
                f"({bound / micro * 100:.1f}% of it); peak "
                f"{peak:.2f} GiB")
            out[name] = {"micro_ms": micro, "update_step_ms": update,
                         "update_ms": cycle,
                         "tokens_per_s": tokens * k / cycle * 1e3,
                         "mfu": mfu, "bound_ms": bound, "peak_gib": peak,
                         "target_tokens": real}
            if not remat:
                out[name]["profile"] = _profile_micro(tr, batches[k], name)
            del tr
    return out


def _profile_micro(tr, batch, name: str) -> dict:
    """One micro-step under ``torch.profiler``: its wall time, the device's
    busy time (the sum of the kernels' own times) and that time by kernel
    class: GEMMs, attention, and the rest (elementwise, norms, the loss)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(tr.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(*batch)
        _sync(tr.device)
        wall = (time.perf_counter() - t0) * 1e3
    classes = {"gemm_ms": 0.0, "attention_ms": 0.0, "other_ms": 0.0}
    top = []
    for e in prof.key_averages():
        # the kernels themselves: an op's entry repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        low = e.key.lower()
        if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet", "gemv")):
            classes["gemm_ms"] += ms
        elif any(w in low for w in ("fmha", "flash", "attention",
                                    "mem_eff")):
            classes["attention_ms"] += ms
        else:
            classes["other_ms"] += ms
        top.append((ms, e.key[:100]))
    busy = sum(classes.values())
    top.sort(reverse=True)
    log(f"[train] profile of one bf16 {name} micro-step: wall {wall:.2f} "
        f"ms, device busy {busy:.2f} ms ({busy / wall * 100:.1f}%); "
        + ", ".join(f"{c[:-3]} {ms:.2f} ms" for c, ms in classes.items())
        + "; top kernels: " + "; ".join(f"{n} {ms:.2f} ms"
                                        for ms, n in top[:4]))
    return {"wall_ms": wall, "busy_ms": busy, **classes,
            "top": [[n, ms] for ms, n in top[:8]]}


def _unpacked_twin(batch, cfg) -> tuple:
    """A packed batch's sentences, each in a row of its own as wide as the
    packed rows (``collate``'s layout)."""
    text, targets, seg, _ = batch
    rows = [(r, s) for r in range(seg.shape[0])
            for s in range(1, int(seg[r].max()) + 1)]
    tt = np.full((len(rows), seg.shape[1]), cfg.pad_token_id, np.int32)
    tg = np.full((len(rows), seg.shape[1]), cfg.ignore_index, np.int32)
    for i, (r, s) in enumerate(rows):
        sel = seg[r] == s
        tt[i, :sel.sum()], tg[i, :sel.sum()] = text[r, sel], targets[r, sel]
    return tt, tg


def _train_bf16_check(tr, table, codebook, t: int) -> dict:
    """bf16 at the deployed shape against f32 on the card, on ``tr``'s
    (trained) params: the loss of a bucketed and a packed batch at width
    t, the packed loss against its unpacked twin in both dtypes, and the
    packed loss with the segments dropped (what a mask that leaked across
    sentences would give); then ``_attention_bf16_check`` on the packed
    batch's segments."""
    from llmvox_tpu_torch.train.data import collate, collate_packed
    from llmvox_tpu_torch.train.trainer import Trainer
    cfg = tr.mcfg
    f32 = Trainer(tr.tcfg, cfg, table, codebook, compute_dtype=torch.float32,
                  device=tr.device, params=tr.params)
    samples = synthetic_samples(16, 194, t - 1, cfg)
    longest = max(samples, key=lambda s: len(s.codes))
    packed = collate_packed(samples, cfg, rows=2, seq_len=t)[:4]
    leak = packed[:2] + (np.minimum(packed[2], 1), packed[3])
    batches = {"bucketed": collate([longest, samples[0]], cfg, bucket=t),
               "packed": packed, "twin": _unpacked_twin(packed, cfg),
               "leak": leak}
    with torch.no_grad():
        loss = {(name, dt): float(trainer.loss(b, train=False))
                for name, b in batches.items()
                for dt, trainer in (("bf16", tr), ("f32", f32))}
    del f32

    def rel(a, b):
        return abs(loss[a] - loss[b]) / abs(loss[b])

    out = {"losses": {f"{n} {d}": v for (n, d), v in loss.items()},
           "bucketed_rel_err": rel(("bucketed", "bf16"), ("bucketed", "f32")),
           "packed_rel_err": rel(("packed", "bf16"), ("packed", "f32")),
           "twin_f32_rel_err": rel(("packed", "f32"), ("twin", "f32")),
           "twin_bf16_rel_err": rel(("packed", "bf16"), ("twin", "bf16")),
           "leak_f32_rel_err": rel(("leak", "f32"), ("twin", "f32"))}
    n_sent = batches["twin"][0].shape[0]
    log(f"[train] bf16 against f32 on the card at 2 x {t} (trained params): "
        f"bucketed loss {loss['bucketed', 'bf16']:.5f} / "
        f"{loss['bucketed', 'f32']:.5f}, rel err "
        f"{out['bucketed_rel_err']:.2e} (tol {TRAIN_BF16_RTOL:.0e}); packed "
        f"{loss['packed', 'bf16']:.5f} / {loss['packed', 'f32']:.5f}, rel err "
        f"{out['packed_rel_err']:.2e} (tol {TRAIN_BF16_RTOL:.0e}); packed "
        f"against its unpacked twin ({n_sent} sentences in rows of their "
        f"own): f32 rel err {out['twin_f32_rel_err']:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:.0e}), bf16 {out['twin_bf16_rel_err']:.2e} (tol "
        f"{TRAIN_BF16_RTOL:.0e}); the segments dropped (attention across "
        f"sentences) would miss the twin by {out['leak_f32_rel_err']:.2e} "
        f"(> tol {TRAIN_BF16_RTOL:.0e})")
    assert out["bucketed_rel_err"] <= TRAIN_BF16_RTOL, out
    assert out["packed_rel_err"] <= TRAIN_BF16_RTOL, out
    assert out["twin_f32_rel_err"] <= TRAIN_LOSS_RTOL, out
    assert out["twin_bf16_rel_err"] <= TRAIN_BF16_RTOL, out
    assert out["leak_f32_rel_err"] > TRAIN_BF16_RTOL, out
    out["attention"] = _attention_bf16_check(packed[2], cfg, tr.device)
    return out


def _attention_bf16_check(segments: np.ndarray, cfg, device) -> dict:
    """The training attention on the card in bf16 (``causal_attention_auto``:
    SDPA) at the packed batch's shape (B, T, n_head, head_dim), causal and
    with its segments, forward and backward, against the port's plain
    blockwise f32 version (``flash_causal_attention``, which the tests
    hold to JAX) on the same bf16 inputs, N(0, 1) from a seed; and the
    causal output against the packed reference: the error a mask that let
    tokens attend across sentences would show."""
    from llmvox_tpu_torch.ops import attention as A
    dev = torch.device(device)
    b, t = segments.shape
    g = torch.Generator(device=dev).manual_seed(195)
    q, k, v, do = (torch.randn((b, t, cfg.n_head, cfg.head_dim),
                               generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.as_tensor(segments).to(dev)
    out, outs = {}, {}
    for name, s in (("causal", None), ("packed", seg)):
        got, ref = [], []
        for fn, dt in ((A.causal_attention_auto, torch.bfloat16),
                       (A.flash_causal_attention, torch.float32)):
            x = [z.to(dt).detach().requires_grad_() for z in (q, k, v)]
            o = fn(*x, segments=s)
            o.backward(do.to(dt))
            (got if dt == torch.bfloat16 else ref).extend(
                [o.detach().float()] + [z.grad.float() for z in x])
            del o, x
        outs[name] = (got[0], ref[0])
        err = float((got[0] - ref[0]).abs().max())
        gerr = max(float((a - r).abs().max() / r.abs().max())
                   for a, r in zip(got[1:], ref[1:]))
        out[name] = {"out_abs_err": err, "grad_rel_err": gerr}
        log(f"[train] bf16 attention {name} ({b} x {t}, {cfg.n_head} heads "
            f"of {cfg.head_dim}) against the plain f32 version: output "
            f"max|err| {err:.2e} (tol {ATTN_BF16_ATOL:.0e}); dq, dk, dv worst "
            f"max|err| / max|g| {gerr:.2e} (tol {ATTN_BF16_GRAD_RTOL:.0e})")
        assert err <= ATTN_BF16_ATOL, (name, err)
        assert gerr <= ATTN_BF16_GRAD_RTOL, (name, gerr)
        del got, ref
    leak = float((outs["causal"][0] - outs["packed"][1]).abs().max())
    out["leak_out_abs_err"] = leak
    log(f"[train] a mask leaking across the packed sentences would miss the "
        f"packed output by {leak:.2e} (> 10 x tol {ATTN_BF16_ATOL:.0e})")
    assert leak > 10 * ATTN_BF16_ATOL, leak
    return out


def _train_loss_down(cfg, table, codebook, device, t: int, params):
    """Loss going down: one fixed bucketed batch at width t, bf16, k=1,
    warmup 0, TRAIN_LOSS_STEPS micro-steps."""
    from llmvox_tpu_torch.train.data import collate
    from llmvox_tpu_torch.train.trainer import Trainer
    from llmvox_tpu_torch.utils.config import TrainConfig
    tcfg = TrainConfig(gradient_accumulation_steps=1, warmup_iters=0,
                       learning_rate=1e-3)
    tr = Trainer(tcfg, cfg, table, codebook, device=device, params=params)
    batch = collate(synthetic_samples(2, 192, t - 1, cfg), cfg, bucket=t)
    losses = [tr.step(*batch) for _ in range(TRAIN_LOSS_STEPS)]
    log(f"[train] loss on one fixed batch (2 x {batch[0].shape[1]}, bf16, "
        f"lr 1e-3): {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{TRAIN_LOSS_STEPS} updates")
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 1.0, losses
    return tr, losses


def _train_cli(weights, device, root: str, work: str) -> dict:
    """(c) ``python -m llmvox_tpu_torch.train`` in a subprocess on an npz
    that ``save_prepared`` wrote: 4 micro-steps (a checkpoint at 2), then
    ``--init_from resume`` to 6; the checkpoint's params then serve one
    offline ``tts``."""
    from llmvox_tpu_torch.train.checkpoint import save_params_npz
    from llmvox_tpu_torch.train.data import save_prepared
    from llmvox_tpu_torch.utils import params as P
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    data = os.path.join(work, "data.npz")
    save_prepared(data, synthetic_samples(16, 193, 400, dcfg))
    np.savez(os.path.join(work, "byt5.npz"), table=table)
    # the CLI reads only the codec's codebooks
    save_params_npz(os.path.join(work, "codec.npz"),
                    {"codebooks": codec_p["codebooks"]})
    out = os.path.join(work, "out")
    args = [sys.executable, "-m", "llmvox_tpu_torch.train",
            "--data_path", data, "--out_dir", out,
            "--byt5_table", os.path.join(work, "byt5.npz"),
            "--codec_params", os.path.join(work, "codec.npz"),
            "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--eval_interval", "2", "--eval_iters", "1", "--bucket", "256",
            "--device", str(device)]
    # the decoder's fields where they are not the defaults (only a
    # rehearsal at a small size has any)
    default = type(dcfg)()
    for f in dataclasses.fields(dcfg):
        if getattr(dcfg, f.name) != getattr(default, f.name):
            args += [f"--{f.name}", str(getattr(dcfg, f.name))]
    runs = []
    for extra in (["--max_iters", "4"],
                  ["--max_iters", "6", "--init_from", "resume"]):
        t0 = time.perf_counter()
        proc = subprocess.run(args + extra, cwd=root, capture_output=True,
                              text=True, timeout=300)
        runs.append(time.perf_counter() - t0)
        if proc.returncode != 0:
            raise RuntimeError(f"training CLI failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        text = proc.stdout
    assert "resumed at iter 2" in text, text
    ckpt = os.path.join(out, "ckpt.npz")
    meta = P.load_meta(ckpt)
    assert meta["iter_num"] == 4, meta["iter_num"]
    losses = [line for line in text.splitlines() if "loss" in line]
    log(f"[train] CLI: 4 micro-steps in {runs[0]:.1f} s, resumed at iter 2 "
        f"to 6 in {runs[1]:.1f} s (checkpoint at iter {meta['iter_num']}); "
        f"last lines: {losses[-2:]}")
    trained = P.load_params_npz(ckpt)
    tcfg = type(dcfg)(**{k: v for k, v in meta["model_args"].items()
                         if k in type(dcfg).__dataclass_fields__})
    eng = make_engine((trained, codec_p, table, tcfg, ccfg, scfg), device,
                      torch.bfloat16, graphs=False)
    wav, toks = eng.tts(TEXT, max_tokens=64)
    n = synth_len(toks, tcfg.eoa_token_id)
    assert n > 0 and np.isfinite(wav).all(), (len(toks), n)
    assert len(wav) == ccfg.hop_length * n
    log(f"[train] the CLI's checkpoint served one offline tts: "
        f"{len(toks)} tokens, {len(wav)} finite samples")
    return {"cli_s": runs, "tts_tokens": len(toks)}


def _train_sample(tr, weights, device) -> dict:
    """(d) ``sample_block`` from the trained params: top-k 1 against
    ``decode_block``'s greedy tokens, two generator seeds at temperature 1
    drawing different tokens, K1's launches on the sampled blocks."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.ops import cuda_attn
    cfg, block = tr.mcfg, 32
    dev = torch.device(device)
    ids = np.frombuffer(TEXT.encode(), np.uint8).astype(np.int32) + 3
    window = torch.tensor(ids[:block], device=dev)
    n_text = torch.tensor(len(ids), dtype=torch.int32, device=dev)
    limit = torch.tensor(block, dtype=torch.int32, device=dev)
    table = torch.as_tensor(weights[2]).to(dev)
    codebook = torch.as_tensor(weights[1]["codebooks"][0]).to(dev)
    params = tr.params

    def state():
        return dec.init_decode_state(cfg, dtype=torch.float32, device=dev)

    with torch.no_grad():
        greedy, n, _ = dec.decode_block(params, table, codebook, state(),
                                        window, n_text, limit, cfg, block)
        cuda_attn.LAUNCHES = 0
        top1, m, _ = dec.sample_block(
            params, table, codebook, state(), window, n_text, limit,
            torch.Generator(device=dev).manual_seed(0), 1.0, cfg, block,
            top_k=1)
        draws = [dec.sample_block(
            params, table, codebook, state(), window, n_text, limit,
            torch.Generator(device=dev).manual_seed(s), 1.0, cfg,
            block)[0].cpu().numpy() for s in (1, 2)]
        _sync(device)
        launches = cuda_attn.LAUNCHES
    greedy, top1 = greedy.cpu().numpy(), top1.cpu().numpy()
    assert int(n) == int(m) == block
    assert np.array_equal(top1, greedy), (top1, greedy)
    differ = int((draws[0] != draws[1]).sum())
    assert differ > 0, draws
    assert launches == 3 * block * cfg.n_layer, launches
    log(f"[train] sample_block from the trained params (f32 cache): top-k 1 "
        f"= decode_block's {block} greedy tokens; seeds 1 and 2 at "
        f"temperature 1 differ at {differ} of {block} steps; K1 launches "
        f"{launches} = 3 blocks x {block} steps x {cfg.n_layer} layers")
    return {"sample_differ": differ, "k1_train_launches": launches}


def phase_train(weights, device="cuda", seq: int = 8192,
                check_seq: int = TRAIN_CHECK_T) -> dict:
    """Phase 19, decoder training at the deployed width (smaller widths
    and the CPU only to rehearse the control flow).  Its files go to the
    git-ignored ``build/phase19``, removed at the end."""
    import shutil
    from llmvox_tpu_torch.utils import params as P
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase19")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dec_p, codec_p, table, dcfg, _, _ = weights
    codebook = codec_p["codebooks"][0]
    out = {"f32_check": _train_f32_check(dcfg, table, codebook, device,
                                         check_seq)}
    params = P.init_decoder_params(20, dcfg)
    out["bf16"] = _train_times(dcfg, table, codebook, device, seq, params,
                               work)
    tr, losses = _train_loss_down(dcfg, table, codebook, device, seq, params)
    out["loss_first_last"] = [losses[0], losses[-1]]
    out["bf16_check"] = _train_bf16_check(tr, table, codebook, seq)
    out.update(_train_sample(tr, weights, device))
    del tr
    out["cli"] = _train_cli(weights, device, root, work)
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase 19: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: codec training
# ---------------------------------------------------------------------------

# (a): 2 crops of 0.4 s (30 frames), cut from 40 x 3 s because the CPU runs
# the same steps
CODEC_CHECK_BATCH, CODEC_CHECK_SAMPLES = 2, 9600
# logs to 1e-4 relative; each gradient tensor to 1e-4 of its largest
# element (the scale floored at 1e-6 of its tree's largest, for tensors
# whose exact gradient is 0); params after each half to JAX's own bound
# between its step implementations (tests/test_codec_train.py:245-251)
CODEC_LOG_RTOL = 1e-4
CODEC_GRAD_RTOL = 1e-4
CODEC_PARAM_RTOL, CODEC_PARAM_ATOL = 2e-3, 5e-5
# of the 16 sub-discriminators, how many a half may find with a leaky
# ReLU's slope flipped by rounding (8 at step 0 at the deployed widths)
CODEC_MAX_FLIPPED = 12
# the codebook after each step within the CPU tests' bound
# (tests/test_torch_codec_train.py)
CODEC_VQ_ATOL = 1e-5
# a nearest code that differs is a near tie: the CPU's two distances within
# 1e-5 of ||x||^2 + max ||e||^2
CODEC_TIE_RTOL = 1e-5
CODEC_TIMED_STEPS = 3


def codec_audio(b: int, n: int, seed: int, sr: int = 24000) -> np.ndarray:
    """(b, n) speech-like crops at ``sr`` drawn from a seed: each row its
    own noise, start and gain (peaks 0.2 to 0.9)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(b):
        x = speechish(n / sr + 1.0, seed * 1000 + i, sr)
        start = int(rng.integers(0, x.size - n))
        x = x[start:start + n]
        rows.append(x * float(rng.uniform(0.2, 0.9)) / np.abs(x).max())
    return np.stack(rows).astype(np.float32)


def _sub_disc(path: str) -> str:
    """The sub-discriminator a disc leaf belongs to (mpd/#0, dac/mrd/#1)."""
    parts = path.split("/")
    return "/".join(parts[:3] if parts[0] == "dac" else parts[:2])


def _codec_near_ties(before, audio, draws, cpu_codes, card_codes, cfg,
                     tcfg) -> tuple:
    """(codes that differ, the largest distance gap among them relative to
    its scale): the CPU's encoder output and assignment codebook of the
    step that ``before`` (encoder params, VQ state) started, recomputed."""
    from llmvox_tpu_torch.codec import seanet
    from llmvox_tpu_torch.train import vq_train
    encoder, vq = before
    cpu_codes, card_codes = cpu_codes.cpu(), card_codes.cpu()
    diff = (cpu_codes != card_codes).nonzero().flatten()
    if not len(diff):
        return 0, 0.0
    with torch.no_grad():
        flat = seanet.apply_seanet_encoder(encoder, torch.from_numpy(audio),
                                           cfg)
        flat = flat.reshape(-1, flat.shape[-1])
        embed = vq.embed if bool(vq.inited) else vq_train.kmeans(
            flat, cfg.vq_bins, tcfg.vq_kmeans_iters, draws.init_idx)[0]
        d = vq_train.pairwise_dist(flat[diff], embed)
        scale = (flat[diff].square().sum(-1) +
                 embed.square().sum(-1).max())
        rows = torch.arange(len(diff))
        gap = (d[rows, cpu_codes[diff].long()] -
               d[rows, card_codes[diff].long()]) / scale
    return len(diff), float(gap.max())


@torch.no_grad()
def _codec_sync(dst, src, half: str) -> None:
    """``dst`` takes ``src``'s state of one half: its params and AdamW
    moments (and for the generator the VQ state and the step count)."""
    from llmvox_tpu_torch.train.vq_train import VQState
    mod, opt = ("disc", "opt_d") if half == "disc" else ("gen", "opt_g")
    for p, q in zip(getattr(dst, mod).params, getattr(src, mod).params):
        p.copy_(q)
    getattr(dst, opt).load_state_dict(getattr(src, opt).state_dict())
    if half == "gen":
        dst.vq = VQState(*(t.to(dst.device, dst.dtype)
                           if t.is_floating_point() else t.to(dst.device)
                           for t in src.vq))
        dst.iter_num = src.iter_num


@torch.no_grad()
def _codec_half_grads(names, card, cpu, ref, half: str) -> dict:
    """One half's gradients, the card's f32 against the CPU's, each tensor
    within CODEC_GRAD_RTOL of its largest element: the worst error over
    its bound, the tensors off it, and the sub-discriminators flipped: a
    tensor of theirs is off, and one f32 side of it is off the card's f64
    (``ref``) by that bound (a leaky ReLU's slope flipped by rounding);
    with the bound of every tensor, for the params' check."""
    dev = card[0].device
    want = [g.to(dev, torch.float64) for g in cpu]
    top = max(float(w.abs().max()) for w in want)
    tols, worst, off, flipped = [], 0.0, [], set()
    for n, g, w, r in zip(names, card, want, ref):
        tol = CODEC_GRAD_RTOL * max(float(w.abs().max()), 1e-6 * top)
        tols.append(tol)
        g, r = g.double(), r.double()
        err = float((g - w).abs().max())
        worst = max(worst, err / tol)
        if err <= tol:
            continue
        off.append(n)
        if half == "disc" and max(float((g - r).abs().max()),
                                  float((w - r).abs().max())) > tol:
            flipped.add(_sub_disc(n))
    return {"worst": worst, "off": off, "flipped": flipped, "tols": tols,
            "want": want}


@torch.no_grad()
def _codec_half_params(names, card, cpu, grads: dict, excused) -> dict:
    """The card's params against the CPU's after one half, from one state:
    elements outside rtol / atol, and those of them not explained: an
    element outside must lie in an excused (flipped) sub-discriminator,
    or have a gradient within its tensor's bound of 0 (Adam's first
    updates move an element by about lr whatever its gradient's size, so
    a sign decided by rounding moves it by up to 2 lr)."""
    n_out = n_all = n_unexplained = 0
    worst = 0.0
    for n, p, q, w, tol in zip(names, card, cpu, grads["want"],
                               grads["tols"]):
        q = q.to(p.device, torch.float64)
        excess = (p.double() - q).abs() - (CODEC_PARAM_ATOL +
                                           CODEC_PARAM_RTOL * q.abs())
        out = excess > 0
        n_out += int(out.sum())
        n_all += out.numel()
        worst = max(worst, float(excess.max()))
        if excused(n):
            continue
        n_unexplained += int((out & (w.abs() > tol)).sum())
    return {"outside": n_out, "of": n_all, "unexplained": n_unexplained,
            "worst_excess": worst}


def _codec_check(cfg, tcfg, device, state: dict) -> dict:
    """(a) the card's f32 trainer against the CPU's plain path and the
    card's f64 trainer, from one seeded state with the same draws, 2 steps
    (step 0: the disc half on the uninitialised codebook, the k-means init
    in the gen half), each half from one state (the card's trainers take
    the CPU's before it).  Held: every log; every gradient tensor, but in
    the sub-discriminators where one f32 side is off the f64 run (a leaky
    ReLU whose input lies within rounding of 0 takes the other slope: a
    discrete change of that sub-discriminator's gradients), at most
    CODEC_MAX_FLIPPED of them; every param after each half, where an
    element outside the bound must lie in such a sub-discriminator or have
    a gradient within rounding of 0, at most 1 in 1000; the nearest codes
    (each that differs a near tie) and the codebook."""
    from llmvox_tpu_torch.train import codec_trainer as ct
    from llmvox_tpu_torch.utils import params as P
    card, cpu, ref = (ct.CodecTrainer(cfg, tcfg, device=dev, dtype=dt,
                                      keep_grads=True, **state)
                      for dev, dt in ((device, torch.float32),
                                      ("cpu", torch.float32),
                                      (device, torch.float64)))
    trainers = {"card": card, "cpu": cpu, "ref": ref}
    audio = codec_audio(CODEC_CHECK_BATCH, CODEC_CHECK_SAMPLES, 43)
    ys = {k: tr._audio(audio) for k, tr in trainers.items()}
    n_units = (len(tcfg.mpd_periods) + len(tcfg.mrd_resolutions) +
               len(tcfg.dac_periods) + len(tcfg.dac_fft_sizes))
    out, failures = {"steps": []}, []
    for i in range(2):
        draws = cpu.draw(*audio.shape)
        # the encoder and codebook the gen half starts from
        before = (P.to_torch(P.to_numpy(cpu.gen.tree()["encoder"]), "cpu"),
                  cpu.vq)
        rec, logs, seconds = {}, {k: {} for k in trainers}, {}
        for half in ("disc", "gen"):
            for k, tr in trainers.items():
                t0 = time.perf_counter()
                run = tr.disc_half if half == "disc" else tr.gen_half
                logs[k].update({n: float(v.detach()) for n, v in
                                run(ys[k], draws).items()})
                _sync(tr.device)
                seconds[f"{k} {half}"] = time.perf_counter() - t0
            mod = getattr(card, half)
            g = _codec_half_grads(mod.names, card.grads[half],
                                  cpu.grads[half], ref.grads[half], half)
            flipped = g["flipped"]
            bad = [n for n in g["off"] if _sub_disc(n) not in flipped]
            prm = _codec_half_params(mod.names, mod.params,
                                     getattr(cpu, half).params, g,
                                     lambda n: (half == "disc" and
                                                _sub_disc(n) in flipped))
            rec[half] = {"grad_worst": g["worst"], "tensors_off": len(
                g["off"]), "off_unexcused": bad, "flipped": sorted(flipped),
                "params": prm}
            if bad:
                failures.append(f"step {i} {half}: gradients off {bad}")
            if len(flipped) > CODEC_MAX_FLIPPED:
                failures.append(f"step {i} {half}: {len(flipped)} flipped")
            if prm["unexplained"] or prm["outside"] > prm["of"] / 1000:
                failures.append(f"step {i} {half}: params {prm}")
            for k in ("card", "ref"):
                _codec_sync(trainers[k], cpu, half)
        log_err = max(abs(logs["card"][k] - logs["cpu"][k]) /
                      max(abs(logs["cpu"][k]), 1e-12) for k in ct.LOG_KEYS)
        ref_err = max(abs(logs["ref"][k] - logs["cpu"][k]) /
                      max(abs(logs["cpu"][k]), 1e-12) for k in ct.LOG_KEYS)
        n, gap = _codec_near_ties(before, audio, draws, cpu.codes,
                                  card.codes, cpu.cfg, cpu.tcfg)
        vq_err = float((card.vq.embed.cpu().double() -
                        cpu.vq.embed.double()).abs().max())
        if log_err > CODEC_LOG_RTOL:
            failures.append(f"step {i}: logs {log_err}")
        if gap > CODEC_TIE_RTOL:
            failures.append(f"step {i}: codes {n} {gap}")
        if vq_err > CODEC_VQ_ATOL:
            failures.append(f"step {i}: codebook {vq_err}")
        rec.update({"log_rel_err": log_err, "f64_log_rel_err": ref_err,
                    "codes_differing": n, "code_gap_rel": gap,
                    "vq_embed_err": vq_err, "seconds": seconds})
        out["steps"].append(rec)
        d, gn = rec["disc"], rec["gen"]
        log(f"[codec] (a) f32, {CODEC_CHECK_BATCH} x {CODEC_CHECK_SAMPLES},"
            f" step {i}, each half from one state, the card against the "
            f"CPU: logs {log_err:.2e} (tol {CODEC_LOG_RTOL:g}; the card's "
            f"f64 {ref_err:.1e}); worst gradient error over its bound "
            f"({CODEC_GRAD_RTOL:g} of the tensor's largest): gen "
            f"{gn['grad_worst']:.2e}, disc {d['grad_worst']:.2e}; "
            f"{d['tensors_off']} disc tensors off it, in "
            f"{len(d['flipped'])} of {n_units} sub-discriminators with a "
            f"leaky ReLU's slope flipped by rounding (one f32 side off the "
            f"card's f64 run; at most {CODEC_MAX_FLIPPED}) {d['flipped']}, "
            f"tensors off it elsewhere "
            f"{d['off_unexcused'] + gn['off_unexcused']}; params outside "
            f"rtol {CODEC_PARAM_RTOL:g} / atol {CODEC_PARAM_ATOL:g}: disc "
            f"{d['params']['outside']}, gen {gn['params']['outside']} of "
            f"{d['params']['of'] + gn['params']['of']} (unexplained "
            f"{d['params']['unexplained'] + gn['params']['unexplained']}), "
            f"the codebook within {vq_err:.1e} (tol {CODEC_VQ_ATOL:g}); {n} of "
            f"{card.codes.numel()} nearest codes differ (largest gap "
            f"{gap:.1e} of the distance scale, tol {CODEC_TIE_RTOL:g}); "
            "seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                   seconds.items()))
    assert not failures, failures
    return out


def codec_f32_peak(card_props=None) -> tuple:
    """(FLOP/s, SMs, max SM MHz): the card's f32 rate outside the tensor
    cores, 128 FMA lanes an SM at its max clock (``nvidia-smi``)."""
    props = card_props or torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = props.multi_processor_count
    return sms * 128 * 2 * mhz * 1e6, sms, mhz


def _profile_codec_step(tr, audio) -> dict:
    """One step under ``torch.profiler``: wall, the device's busy time and
    that time by kernel class."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # in this order: cuDNN's RNN kernels are named cudnn:: too
    classes = {"lstm": ("rnn", "lstm", "persist"),
               "fft": ("fft",),
               "conv": ("conv", "cudnn", "xmma", "implicit", "winograd",
                        "dgrad", "wgrad", "fprop"),
               "gemm": ("gemm", "cublas", "cutlass", "nvjet", "gemv")}
    ms = {c: 0.0 for c in (*classes, "elementwise")}
    # the device's activity only
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(audio)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the trace's raw device events, summed by name (the profiler's
    # function events and their averages are not built)
    by_name = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns() / 1e6
    top = []
    for name, t in by_name.items():
        low = name.lower()
        cls = next((c for c, words in classes.items()
                    if any(w in low for w in words)), "elementwise")
        ms[cls] += t
        top.append((t, name[:90]))
    busy = sum(ms.values())
    assert busy > 0, "the profiler saw no kernel"
    top.sort(reverse=True)
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            **{f"{c}_ms": v for c, v in ms.items()},
            "top": [[n, t] for t, n in top[:6]]}


def _codec_deployed(cfg, tcfg, card: str, state: dict) -> dict:
    """(b) ``CodecConfig()`` and ``CodecTrainConfig()`` (40 x 3 s, every
    discriminator) in f32 from seeded audio, remat off: a warm step (the
    k-means init), 3 steps timed half by half, one profiled, one counted
    by ``FlopCounterMode``; the peak memory; the losses of every step."""
    from torch.utils.flop_counter import FlopCounterMode
    from llmvox_tpu_torch.train import codec_trainer as ct
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_b = time.perf_counter()
    tr = ct.CodecTrainer(cfg, tcfg, device="cuda", **state)
    n_gen, n_disc = (sum(p.numel() for p in mod.params)
                     for mod in (tr.gen, tr.disc))
    audio = codec_audio(tcfg.batch_size, tcfg.num_samples, 44)
    y = torch.from_numpy(audio).cuda()
    seconds = {"build": time.perf_counter() - t_b}
    t0 = time.perf_counter()
    logs = [tr.step(audio)]
    warm = time.perf_counter() - t0
    t_timed = time.perf_counter()
    times = []
    for _ in range(CODEC_TIMED_STEPS):
        draws = tr.draw(tcfg.batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = tr.disc_half(y, draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = tr.gen_half(y, draws)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t2 - t0) * 1e3))
        logs.append({k: float(v.detach()) for k, v in {**d, **g}.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seconds["timed"] = time.perf_counter() - t_timed
    t0 = time.perf_counter()
    prof = _profile_codec_step(tr, audio)
    seconds["profiled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        logs.append(tr.step(audio))
    flops = fc.get_total_flops()
    seconds["counted"] = time.perf_counter() - t0
    rate, sms, mhz = codec_f32_peak()
    bound = flops / rate * 1e3
    for lg in logs:
        assert all(np.isfinite(v) for v in lg.values()), lg
    disc_ms, gen_ms, step_ms = (statistics.median(t[i] for t in times)
                                for i in range(3))
    log(f"[codec] (b) deployed f32, {tcfg.batch_size} x {tcfg.num_samples},"
        f" every discriminator, remat off ({n_gen / 1e6:.2f} M generator, "
        f"{n_disc / 1e6:.2f} M discriminator params): a step "
        f"{step_ms:.1f} ms (disc half {disc_ms:.1f}, gen half "
        f"{gen_ms:.1f}; warm step with the k-means init {warm * 1e3:.0f} "
        f"ms); bound {bound:.1f} ms ({flops / 1e12:.2f} TFLOP of convs and "
        f"matmuls by FlopCounterMode over {rate / 1e12:.1f} TFLOP/s f32: "
        f"{sms} SMs x 128 lanes x 2 x {mhz:.0f} MHz; {bound / step_ms * 100:.1f}"
        f"% of the step); peak {peak:.2f} GiB; one profiled step "
        f"{prof['wall_ms']:.0f} ms, device busy {prof['busy_share'] * 100:.1f}"
        f"%: " + ", ".join(f"{c[:-3]} {prof[c]:.0f} ms" for c in (
            "conv_ms", "fft_ms", "lstm_ms", "gemm_ms", "elementwise_ms"))
        + f"; {card}; seconds " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
    log(f"[codec] (b) losses over {len(logs)} steps on one batch: mel "
        + " ".join(f"{lg['mel']:.3f}" for lg in logs) + ", disc_total "
        + " ".join(f"{lg['disc_total']:.3f}" for lg in logs))
    out = {"step_ms": step_ms, "disc_ms": disc_ms, "gen_ms": gen_ms,
           "steps_ms": times, "warm_ms": warm * 1e3, "bound_ms": bound,
           "tflop": flops / 1e12, "f32_tflops": rate / 1e12, "sms": sms,
           "max_sm_mhz": mhz, "peak_gib": peak, "profile": prof,
           "seconds": seconds,
           "mel": [lg["mel"] for lg in logs],
           "disc_total": [lg["disc_total"] for lg in logs]}
    del tr, y
    return out


def _write_pcm16(path: str, wav: np.ndarray, sr: int) -> None:
    import wave
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def _codec_clis(cfg, device, work: str, cfg_flags=()) -> dict:
    """(c) 4 wav files from a seed (2 at 24 kHz, 2 at 16 kHz): the
    training CLI 2 steps with a validation pass, its export loaded into
    ``WavCodec``; ``copy_synthesis`` of one file; ``prepare_data`` of the
    four, read back by ``train/data.py``."""
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.tools import copy_synthesis, prepare_data
    from llmvox_tpu_torch.train import codec_main
    from llmvox_tpu_torch.train.data import SpeechDataset
    from llmvox_tpu_torch.utils.params import load_meta
    files, items = [], []
    for i, sr in enumerate((24000, 16000, 24000, 16000)):
        path = os.path.join(work, f"utt{i}.wav")
        _write_pcm16(path, speechish(3.5 + 0.5 * i, 50 + i, sr), sr)
        files.append(path)
        items.append({"id": f"utt{i}", "answer_text": f"Utterance {i}."})
    lst = os.path.join(work, "files.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files))
    out = os.path.join(work, "out")
    t0 = time.perf_counter()
    codec_main.main(["--filelist_train", lst, "--filelist_val", lst,
                     "--out_dir", out, "--max_steps", "2", "--val_interval",
                     "2", "--log_interval", "1", "--batch_size", "2",
                     "--val_batch_size", "2", "--device", str(device),
                     *cfg_flags])
    train_s = time.perf_counter() - t0
    assert load_meta(os.path.join(out, "codec_ckpt.npz"))["iter_num"] == 2
    for name in ("codec_ckpt.npz", "codec_ckpt.disc.npz",
                 "codec_inference.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    export = os.path.join(out, "codec_inference.npz")
    codec = WavCodec.from_pretrained(export, cfg, device=device,
                                     graphs=False)
    _, codes = codec.encode_infer(speechish(1.0, 49, 24000)[None])
    assert codes.shape == (1, -(-24000 // cfg.hop_length)), codes.shape
    del codec
    t0 = time.perf_counter()
    copy_synthesis.main(["--codec_params", export, "--inputs", files[1],
                         "--out_dir", os.path.join(work, "recon"),
                         "--device", str(device)])
    recon = os.path.join(work, "recon", "utt1_recon.wav")
    from llmvox_tpu_torch.utils.audio import read_wav
    wav, sr = read_wav(recon)
    assert sr == 24000 and wav.shape[1] == 24000 * 4, wav.shape
    assert np.isfinite(wav).all()
    copy_s = time.perf_counter() - t0
    manifest = os.path.join(work, "data.json")
    with open(manifest, "w") as f:
        json.dump(items, f)
    t0 = time.perf_counter()
    prepare_data.main(["--data_path", manifest, "--speech_data_folder", work,
                       "--codec_params", export, "--out",
                       os.path.join(work, "prepared.npz"),
                       "--device", str(device)])
    prep_s = time.perf_counter() - t0
    data = SpeechDataset(os.path.join(work, "prepared.npz"))
    assert len(data) == 4
    lens = [len(s.codes) for s in data.samples]
    # every frame's code but the natural EOA's (453), stripped
    full = [-(-int(24000 * (3.5 + 0.5 * i)) // cfg.hop_length)
            for i in range(4)]
    assert all(0 < n <= m for n, m in zip(lens, full)), (lens, full)
    log(f"[codec] (c) codec_main 2 steps with a validation pass "
        f"{train_s:.1f} s (checkpoint, discriminators, export written; the "
        f"export loads into WavCodec); copy_synthesis of a 16 kHz file "
        f"{copy_s:.1f} s ({wav.shape[1]} samples at 24 kHz); prepare_data "
        f"of 4 files {prep_s:.1f} s ({lens} codes, read back by "
        f"SpeechDataset)")
    return {"train_s": train_s, "copy_s": copy_s, "prepare_s": prep_s,
            "codes": lens}


def phase_codec_train(card: str, device="cuda", cfg=None, tcfg=None,
                      check_tcfg=None, cli_flags=()) -> dict:
    """Phase 20, codec training at the deployed widths (smaller configs and
    the CPU only to rehearse the control flow).  Its files go to the
    git-ignored ``build/phase20``, removed at the end."""
    import shutil
    from llmvox_tpu_torch.utils.config import CodecConfig, CodecTrainConfig
    t_phase = time.perf_counter()
    cfg = cfg or CodecConfig()
    tcfg = tcfg or CodecTrainConfig()
    check_tcfg = check_tcfg or dataclasses.replace(
        tcfg, batch_size=CODEC_CHECK_BATCH, num_samples=CODEC_CHECK_SAMPLES)
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase20")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    from llmvox_tpu_torch.train import codec_trainer as ct
    from llmvox_tpu_torch.train.vq_train import init_vq_state
    # one seeded state for (a) and (b) (drawn once: ~5 s of numpy)
    state = {"gen_params": ct.init_generator_params(40, cfg),
             "disc_params": ct.init_discriminator_params(41, tcfg),
             "vq_state": init_vq_state(42, cfg.vq_bins, cfg.vq_dim)}
    state_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    out = {"check": _codec_check(cfg, check_tcfg, device, state),
           "state_s": state_s}
    out["check_s"] = time.perf_counter() - t0
    _zero_launches()
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        out["deployed"] = _codec_deployed(cfg, tcfg, card, state)
        out["deployed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = _codec_clis(cfg, device, work, cli_flags)
    out["cli_s"] = time.perf_counter() - t0
    out["launches"] = _read_launches()
    assert not any(out["launches"].values()), out["launches"]
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[codec] phase 20: {out['phase_s']:.1f} s (the state {state_s:.1f}, (a) "
        f"{out['check_s']:.1f}, (b) {out.get('deployed_s', 0.0):.1f}, (c) "
        f"{out['cli_s']:.1f}); the kernels' launches "
        f"on its path {out['launches']} (codec training reaches none)")
    return out


# ---------------------------------------------------------------------------
# phase 21: codec evaluation and compression
# ---------------------------------------------------------------------------

# (a) UTMOS: the f32 score and frame scores against the card's f64 run on
# the same weights and clip, absolute.  f32 keeps 24 bits; the frame
# scores come out of 7 convs, 12 post-norm layers (sums of up to 3072
# terms, each layer renormalised) and a 150-frame BiLSTM, which keep the
# features to ~1e-5 relative; the head's frame scores are ~0.1 in size
# with these weights, so 1e-4 is some 100 times that rounding and far
# below a real fault (a wrong norm or gate moves them by ~1e-2 or more)
UTMOS_ATOL = 1e-4
UTMOS_SECONDS, UTMOS_TIMED_SECONDS = 3.0, 10.0
# (b) the LM: 10 s of codes at 75 frames/s; the f32 probabilities against
# the card's f64 run over the first 64 frames, absolute (probabilities are
# at most 1; logits of a few units through 5 layers of width 200-800 keep
# ~1e-6 relative, so the softmax's entries move by under 1e-5)
LM_FRAMES, LM_CHECK_FRAMES = 750, 64
LM_PDF_ATOL = 1e-5
# (c) segmented encode/decode: 2 x 3 s, 1 s segments, overlap 0.01,
# volume normalisation; a code the f32 encoder picks other than f64's is a
# near tie (the f64 distances within CODEC_TIE_RTOL of the scale, phase
# 20's rule); the f32 decode of f64's frames within 1e-4 of the f64
# decode's peak (~30 convs and a 2-layer LSTM of width 512 in f32)
SEG_SECONDS, SEG_S, SEG_OVERLAP = 3.0, 1.0, 0.01
SEG_RTOL = 1e-4


def _utmos_check(cfg, weights, device) -> dict:
    """(a) the score and frame scores of a 3 s clip in f32 and f64, the f32
    scorer's ms on a 10 s clip and the peak memory."""
    from llmvox_tpu_torch.codec import metrics, utmos
    from llmvox_tpu_torch.utils.params import to_torch
    clip = speechish(UTMOS_SECONDS, 70, 16000)
    scores, frames = {}, {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        p = to_torch(weights, device, dtype)
        with torch.no_grad():
            fr = utmos.frame_scores(p, torch.from_numpy(clip)[None].to(
                device, dtype), cfg)
        frames[name] = fr[0].double().cpu().numpy()
        scores[name] = float(frames[name].mean() * 2 + 3)
        del p
    frame_err = float(np.abs(frames["f32"] - frames["f64"]).max())
    score_err = abs(scores["f32"] - scores["f64"])
    assert np.isfinite(frames["f32"]).all()
    assert frame_err <= UTMOS_ATOL and score_err <= UTMOS_ATOL, (
        frame_err, score_err)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    utmos.register(weights, cfg, device=device)
    long_clip = speechish(UTMOS_TIMED_SECONDS, 71, 16000)
    metrics.utmos_score(long_clip)                      # warm
    _sync(device)
    t0 = time.perf_counter()
    score10 = metrics.utmos_score(long_clip)
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.device(device).type == "cuda" else None)
    assert np.isfinite(score10)
    log(f"[eval] (a) UTMOS (wav2vec2-base + head, {cfg.encoder_layers} "
        f"layers of {cfg.encoder_dim}): a {UTMOS_SECONDS:.0f} s clip scores "
        f"{scores['f32']:.6f} in f32, {scores['f64']:.6f} in f64 (|diff| "
        f"{score_err:.3e}; {frames['f32'].size} frame scores, max |diff| "
        f"{frame_err:.3e}, tolerance {UTMOS_ATOL}); one f32 score of a "
        f"{UTMOS_TIMED_SECONDS:.0f} s clip {ms:.2f} ms; peak "
        + (f"{peak:.2f} GiB" if peak is not None else "not measured"))
    return {"score_f32": scores["f32"], "score_f64": scores["f64"],
            "score_err": score_err, "frame_err": frame_err,
            "frames": int(frames["f32"].size), "score_10s": score10,
            "ms_10s": ms, "peak_gib": peak}


def _lm_check(codec, cfg, device) -> dict:
    """(b) 10 s of codes from ``encode_infer`` compressed and decompressed
    through one captured LM step, exactly; ms a step; the f32 pdfs against
    the f64 run over 64 frames."""
    from llmvox_tpu_torch.codec import compress, lm
    from llmvox_tpu_torch.codec.entropy import quantized_cdf
    from llmvox_tpu_torch.utils.params import init_lm_params
    lcfg = lm.lm_config_for(cfg)
    weights = init_lm_params(72, lcfg)
    audio = codec_audio(1, LM_FRAMES * cfg.hop_length, 73)
    _, codes = codec.encode_infer(audio)
    assert codes.shape == (1, LM_FRAMES), codes.shape
    stepper = lm.LMStepper(weights, lcfg, device)
    t0 = time.perf_counter()
    blob = compress.compress_codes(stepper, codes)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = compress.decompress_codes(stepper, blob)
    dec_s = time.perf_counter() - t0
    assert np.array_equal(back, codes), "the LM round trip is not exact"
    # device time of one step: replays back to back
    replay_ms = None
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(100):
            stepper.graph()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / 100
    # f32 against f64 over the first frames, the same previous codes
    ref = lm.LMStepper(weights, lcfg, device, dtype=torch.float64)
    stepper.reset()
    prev = np.zeros((lcfg.n_q,), np.int64)
    pdf_err, cdf_differ = 0.0, 0
    for i in range(LM_CHECK_FRAMES):
        a, b = stepper.step(prev), ref.step(prev)
        pdf_err = max(pdf_err, float(np.abs(a - b).max()))
        cdf_differ += int(any((quantized_cdf(a[:, q]) !=
                               quantized_cdf(b[:, q])).any()
                              for q in range(lcfg.n_q)))
        prev = codes[:, i].astype(np.int64) + 1
    assert pdf_err <= LM_PDF_ATOL, pdf_err
    per_frame = (len(blob) - 6) / LM_FRAMES
    raw = lcfg.n_q * math.log2(lcfg.card) / 8
    step_ms = enc_s * 1e3 / LM_FRAMES
    log(f"[eval] (b) LM (n_q {lcfg.n_q}, card {lcfg.card}, dim {lcfg.dim}, "
        f"{lcfg.num_layers} layers, past {lcfg.past_context}) over "
        f"{LM_FRAMES} frames of encode_infer codes: compress {enc_s:.2f} s, "
        f"decompress {dec_s:.2f} s, round trip exact; {step_ms:.3f} ms a "
        f"frame with the coder (host), a step's graph replay "
        + (f"{replay_ms:.3f} ms (device)" if replay_ms else "not measured")
        + f"; {len(blob)} bytes, {per_frame:.3f} bytes a frame against "
        f"{raw:.1f} raw ({lcfg.n_q * math.log2(lcfg.card):.0f} bits); f32 "
        f"pdfs against f64 over {LM_CHECK_FRAMES} frames max |diff| "
        f"{pdf_err:.3e} (tolerance {LM_PDF_ATOL}), quantized cdfs differing "
        f"in {cdf_differ} of {LM_CHECK_FRAMES} frames")
    return {"frames": LM_FRAMES, "bytes": len(blob),
            "bytes_per_frame": per_frame, "raw_bytes_per_frame": raw,
            "compress_s": enc_s, "decompress_s": dec_s,
            "ms_per_step": step_ms, "replay_ms": replay_ms,
            "pdf_err": pdf_err, "cdf_differ": cdf_differ}


def _segment_check(codec, codec64, cfg, device) -> dict:
    """(c) ``encode_frames`` / ``decode_frames`` at 1 s segments, overlap
    0.01, normalised, f32 against the card's f64."""
    from llmvox_tpu_torch.codec import seanet
    audio = codec_audio(2, int(SEG_SECONDS * cfg.sample_rate), 74)
    t0 = time.perf_counter()
    f32 = codec.encode_frames(audio, SEG_S, SEG_OVERLAP, normalize=True)
    enc_s = time.perf_counter() - t0
    f64 = codec64.encode_frames(audio, SEG_S, SEG_OVERLAP, normalize=True)
    seg, stride = codec.segment_geometry(SEG_S, SEG_OVERLAP)
    differ = 0
    book = codec64.params["codebooks"][0]
    for k, ((c32, s32), (c64, s64)) in enumerate(zip(f32, f64)):
        assert np.array_equal(s32, s64), "the volume scales differ"
        bad = np.argwhere(c32 != c64)
        if not len(bad):
            continue
        x = torch.from_numpy(audio[:, k * stride: k * stride + seg] / s64
                             ).to(device, torch.float64)
        with torch.no_grad():
            emb = seanet.apply_seanet_encoder(codec64.params["encoder"], x,
                                              cfg)
        for b, i in bad:
            e = emb[b, i]
            d = ((e - book[[int(c32[b, i]), int(c64[b, i])]]) ** 2).sum(-1)
            scale = float(e.square().sum() + book.square().sum(-1).max())
            assert float(d[0] - d[1]) <= CODEC_TIE_RTOL * scale, (k, b, i)
            differ += 1
    t0 = time.perf_counter()
    y32 = codec.decode_frames(f64, SEG_S, SEG_OVERLAP)
    dec_s = time.perf_counter() - t0
    y64 = codec64.decode_frames(f64, SEG_S, SEG_OVERLAP)
    err = float(np.abs(y32 - y64).max())
    peak = float(np.abs(y64).max())
    assert np.isfinite(y32).all() and y32.shape[1] >= audio.shape[1]
    assert err <= SEG_RTOL * peak, (err, peak)
    n_codes = sum(c.size for c, _ in f32)
    log(f"[eval] (c) segmented encode/decode, 2 x {SEG_SECONDS:.0f} s at "
        f"{SEG_S:.0f} s segments, overlap {SEG_OVERLAP}, normalised: "
        f"{len(f32)} frames, {n_codes} codes ({differ} differing f32 "
        f"against f64, each a near tie); encode {enc_s * 1e3:.0f} ms, "
        f"decode {dec_s * 1e3:.0f} ms (f32); f32 decode against f64 max "
        f"|diff| {err:.3e} of peak {peak:.3f} (tolerance {SEG_RTOL} of the "
        f"peak); {y32.shape[1]} samples out for {audio.shape[1]} in")
    return {"frames": len(f32), "codes": int(n_codes),
            "codes_differing": differ, "decode_err": err,
            "decode_peak": peak, "encode_s": enc_s, "decode_s": dec_s}


def _eval_cli(codec_tree, cfg, device, work: str, cfg_flags=()) -> dict:
    """(d) ``python -m llmvox_tpu_torch.codec.eval`` in both modes over 4
    seeded wav files (2 at 16 kHz), in this process; the second scores the
    first's reconstructions."""
    import glob
    import tempfile
    from llmvox_tpu_torch.codec import eval as codec_eval
    from llmvox_tpu_torch.train.checkpoint import save_params_npz
    files = []
    for i, sr in enumerate((24000, 16000, 24000, 16000)):
        path = os.path.join(work, f"ref{i}.wav")
        _write_pcm16(path, speechish(3.5 + 0.5 * i, 80 + i, sr), sr)
        files.append(path)
    lst = os.path.join(work, "refs.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files))
    npz = os.path.join(work, "codec.npz")
    save_params_npz(npz, {k: v for k, v in codec_tree.items()
                          if k != "seanet_decoder"})
    quiet = open(os.devnull, "w")
    old_tmp, old_out = tempfile.tempdir, sys.stdout
    tempfile.tempdir = work     # the CLI's reconstructions land in ``work``
    sys.stdout = quiet          # its per-file rows
    try:
        t0 = time.perf_counter()
        synth = codec_eval.main(["--refs", lst, "--codec_params", npz,
                                 "--device", str(device), *cfg_flags])
        synth_s = time.perf_counter() - t0
        recon_dir, = glob.glob(os.path.join(work, "llmvox_eval_*"))
        t0 = time.perf_counter()
        scored = codec_eval.main(["--refs", lst, "--recon_dir", recon_dir,
                                  "--device", str(device), *cfg_flags])
        score_s = time.perf_counter() - t0
    finally:
        tempfile.tempdir, sys.stdout = old_tmp, old_out
        quiet.close()
    assert synth["n"] == scored["n"] == 4
    assert synth["mean"] == scored["mean"], (synth["mean"], scored["mean"])
    for k in ("mel_distance", "si_snr", "periodicity", "pesq", "stoi",
              "utmos"):
        assert synth["mean"].get(k) is not None and np.isfinite(
            synth["mean"][k]), (k, synth["mean"])
    log(f"[eval] (d) the eval CLI: --codec_params {synth_s:.1f} s (4 files "
        f"copy-synthesised and scored), --recon_dir {score_s:.1f} s, the "
        f"same means: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    sorted(synth["mean"].items())))
    return {"synth_s": synth_s, "score_s": score_s, "mean": synth["mean"]}


def _validation_full(codec_tree, cfg, device) -> dict:
    """(d) ``CodecTrainer.validation_metrics(full=True)`` on 2 x 3 s, the
    UTMOS of (a) registered.  Validation reads the generator and the VQ
    only, so the trainer is built with one discriminator of each family."""
    from llmvox_tpu_torch.train import codec_trainer as ct
    from llmvox_tpu_torch.train.vq_train import init_vq_state
    from llmvox_tpu_torch.utils.config import CodecTrainConfig
    tcfg = dataclasses.replace(
        CodecTrainConfig(), mpd_periods=(2,),
        mrd_resolutions=((512, 128, 512),), dac_periods=(2,),
        dac_fft_sizes=(512,))
    gen = {k: codec_tree[k] for k in ("encoder", "backbone", "head")}
    vq = init_vq_state(75, cfg.vq_bins, cfg.vq_dim)
    tr = ct.CodecTrainer(cfg, tcfg, device=device, gen_params=gen,
                         vq_state=vq)
    audio = codec_audio(2, int(3 * cfg.sample_rate), 76)
    t0 = time.perf_counter()
    out = tr.validation_metrics(audio, full=True)
    val_s = time.perf_counter() - t0
    want = {"val_mel_loss", "val_mel_distance", "val_si_snr",
            "val_periodicity", "val_pitch_rmse_cents", "val_voicing_f1",
            "val_pesq", "val_stoi", "val_utmos"}
    assert want <= set(out), sorted(out)
    assert all(np.isfinite(v) for v in out.values()), out
    log(f"[eval] (d) validation_metrics(full=True) on 2 x 3 s {val_s:.1f} s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(out.items())))
    return {"seconds": val_s, **out}


def phase_codec_eval(card: str, device="cuda", cfg=None, ucfg=None,
                     cli_flags=()) -> dict:
    """Phase 21, codec evaluation and compression at full width (smaller
    configs and the CPU only to rehearse the control flow).  Its files go
    to the git-ignored ``build/phase21``, removed at the end."""
    import shutil
    from llmvox_tpu_torch.codec import metrics, seanet, utmos
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.utils.config import CodecConfig
    from llmvox_tpu_torch.utils.device import resolve_device
    from llmvox_tpu_torch.utils.params import (init_codec_params,
                                               init_utmos_params)
    t_phase = time.perf_counter()
    # TF32 off before the first f32 product (the entry points' rule)
    device = resolve_device(device)
    cfg = cfg or CodecConfig()
    ucfg = ucfg or utmos.UTMOSConfig()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase21")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # the seeded trees, drawn by numpy
    uweights = init_utmos_params(77, ucfg)
    tree = init_codec_params(78, cfg)
    tree["encoder"] = seanet.init_seanet_encoder(79, cfg)
    tree["seanet_decoder"] = seanet.init_seanet_decoder(80, cfg)
    draw_s = time.perf_counter() - t_phase
    out = {"draw_s": draw_s}
    _zero_launches()
    seconds = {}
    try:
        t0 = time.perf_counter()
        out["utmos"] = _utmos_check(ucfg, uweights, device)
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        codec = WavCodec(tree, cfg, device=device, graphs=False)
        codec64 = WavCodec(tree, cfg, device=device, graphs=False,
                           dtype=torch.float64)
        out["lm"] = _lm_check(codec, cfg, device)
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["segments"] = _segment_check(codec, codec64, cfg, device)
        seconds["c"] = time.perf_counter() - t0
        del codec, codec64
        t0 = time.perf_counter()
        out["cli"] = _eval_cli(tree, cfg, device, work, cli_flags)
        out["validation"] = _validation_full(tree, cfg, device)
        seconds["d"] = time.perf_counter() - t0
    finally:
        metrics.register_plugin("utmos", None)
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = _read_launches()
    assert not any(out["launches"].values()), out["launches"]
    out["seconds"] = seconds
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[eval] phase 21: {out['phase_s']:.1f} s (the trees {draw_s:.1f}, "
        + ", ".join(f"({k}) {v:.1f}" for k, v in seconds.items())
        + f"); the kernels' launches on its path {out['launches']} (codec "
        f"evaluation and compression reach none); {card}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the server
# ---------------------------------------------------------------------------

def phase_block_graph(weights, batch: int = 0) -> float:
    """One 32-token bf16 decode block (EOA off, pos 0..31) eagerly and as a
    CUDA graph: the graph must give the same tokens, and its replay time
    is the device's busy time for the block, without the host's launch
    gaps that the eager block pays.  With ``batch`` B > 0 the block is the
    pool's batched one (``decode_block_batch``, K2) over B streams.
    Returns the replay's device ms."""
    from llmvox_tpu_torch.models import decoder as dec
    dcfg = dataclasses.replace(weights[3], eoa_token_id=-1)
    eng = make_engine((*weights[:3], dcfg, *weights[4:]), "cuda",
                      torch.bfloat16)
    n = eng.block
    ids = np.frombuffer(TEXT.encode(), np.uint8).astype(np.int32) + 3
    if batch:
        # each stream reads the text from its own offset
        window = torch.from_numpy(np.stack(
            [np.roll(ids, -i)[:n] for i in range(batch)])).cuda()
        text_len = torch.full((batch,), len(ids), dtype=torch.int32,
                              device="cuda")
        limit = torch.full((batch,), n, dtype=torch.int32, device="cuda")
        start = dec.init_decode_state_batch(dcfg, batch, torch.bfloat16,
                                            "cuda")
        step = dec.decode_block_batch
    else:
        window = torch.from_numpy(ids[:n].copy()).cuda()
        text_len = torch.tensor(len(ids), dtype=torch.int32, device="cuda")
        limit = torch.tensor(n, dtype=torch.int32, device="cuda")
        start = dec.init_decode_state(dcfg, torch.bfloat16, "cuda")
        step = dec.decode_block

    def run_block(state):
        return step(eng.params, eng.text_table, eng.codebook, state, window,
                    text_len, limit, dcfg, block=n)[0]

    def fresh():
        return dec.DecodeState(*(t.clone() for t in start))

    eager_ms = []
    for _ in range(5):
        state = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_block(state).tolist()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    state = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_block(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        toks = run_block(state)
    graph.replay()
    assert toks.tolist() == want, (toks.tolist(), want)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(10):
        graph.replay()
    end.record()
    end.synchronize()
    graph_ms = begin.elapsed_time(end) / 10
    eager = statistics.median(eager_ms)
    log(f"[graph] {n}-token bf16 block, B={batch or 1} (pos 0..{n - 1}): "
        f"eager "
        f"{eager:.1f} ms (host clock, median of 5), CUDA graph replay "
        f"{graph_ms:.2f} ms (device busy time), same tokens; the card is "
        f"idle {100 * (1 - graph_ms / eager):.1f}% of the eager block")
    return graph_ms


class _Server:
    """A server's serve() on its own thread and event loop."""

    def __init__(self, srv, port):
        self.srv, self.port = srv, port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_until_complete,
                                       args=(srv.serve(),), daemon=True)

    def __enter__(self):
        self.thread.start()
        for _ in range(100):
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=0.2):
                    return self
            except OSError:
                time.sleep(0.1)
        raise RuntimeError("server did not start")

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.thread.join(timeout=60)
        self.loop.close()
        assert not self.thread.is_alive(), "server did not stop"


class _LoopLag:
    """A coroutine on a running server's event loop that sleeps 1 ms in a
    loop and records how late each wake-up is: how long other work held
    the loop (a decode launch on the loop's thread would show here)."""

    def __init__(self, loop):
        self.lags, self._stop = [], False

        async def tick():
            while not self._stop:
                t0 = time.perf_counter()
                await asyncio.sleep(0.001)
                self.lags.append(time.perf_counter() - t0 - 0.001)

        self._done = asyncio.run_coroutine_threadsafe(tick(), loop)

    def stop(self) -> dict:
        """Median and largest lateness in ms, and the wake-ups counted."""
        self._stop = True
        self._done.result(timeout=30)
        return {"median_ms": statistics.median(self.lags) * 1e3,
                "max_ms": max(self.lags) * 1e3, "ticks": len(self.lags)}


def _zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0 (and its counts per
    shard of a dp-sharded pool, where it keeps them)."""
    from llmvox_tpu_torch.ops import (cuda_attn, cuda_batched_attn,
                                      cuda_int4_mm, cuda_verify_attn)
    for mod in (cuda_attn, cuda_batched_attn, cuda_verify_attn,
                cuda_int4_mm):
        mod.LAUNCHES = 0
        if hasattr(mod, "SHARD_LAUNCHES"):
            mod.SHARD_LAUNCHES.clear()


def _read_launches() -> dict:
    """Every kernel wrapper's launch count, as ``k1``..``k4``."""
    from llmvox_tpu_torch.ops import (cuda_attn, cuda_batched_attn,
                                      cuda_int4_mm, cuda_verify_attn)
    return {"k1": cuda_attn.LAUNCHES, "k2": cuda_batched_attn.LAUNCHES,
            "k3": cuda_verify_attn.LAUNCHES, "k4": cuda_int4_mm.LAUNCHES}


def _lag_text(lag: dict) -> str:
    return (f"event loop lag median {lag['median_ms']:.2f} ms, max "
            f"{lag['max_ms']:.1f} ms over {lag['ticks']} 1-ms sleeps")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def expected_chunks(tokens, dump, cfg, eoa) -> list:
    """The scheduler's chunk sizes (in codes) for one sentence's tokens:
    dumps on the x3 ladder, an EOA flush, and the end at EOA or when the
    buffer passes max_audio_length (the residual is dropped)."""
    out, buf = [], []
    for tok in tokens:
        buf.append(tok)
        if len(buf) >= dump:
            chunk, buf = buf[:dump], buf[dump:]
            out.append(sum(c != eoa for c in chunk))
            dump = min(dump * cfg.dump_growth_factor, cfg.max_dump_size)
        elif eoa in buf:
            out.append(sum(c != eoa for c in buf))
            buf = []
            dump = min(dump * cfg.dump_growth_factor, cfg.max_dump_size)
        if tok == eoa or len(buf) > cfg.max_audio_length:
            break
    return [n for n in out if n > 0]


def phase_server(engines, weights, record=None) -> int:
    """Three ``POST /tts`` on the dedicated replicas; with ``record`` (a
    list) each request's first audio, RTF and loop lag are appended to
    it."""
    from llmvox_tpu_torch.ops import cuda_attn
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    eoa, hop = dcfg.eoa_token_id, ccfg.hop_length
    # one delta holding both sentences goes to replica 0; the eos delta
    # gives replica 1 an empty sentence
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    want = []
    for text, dump in ((REPLY, scfg.initial_dump_size_1),
                       ("", scfg.initial_dump_size_2)):
        _, toks = engines[0].tts(text, max_tokens=cap)
        want += expected_chunks(toks, dump, scfg, eoa)
    ladder = set(scfg.dump_size_ladder(scfg.initial_dump_size_1)
                 + scfg.dump_size_ladder(scfg.initial_dump_size_2))
    log(f"[server] expected chunk sizes (codes) {want}; ladder "
        f"{sorted(ladder)}")

    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port)
    n_cap = captures()
    with _Server(build_server(cfg, engines), port) as server:
        cuda_attn.LAUNCHES = 0
        steps0 = sum(e.decode_steps for e in engines)
        for r in range(3):
            lag = _LoopLag(server.loop)
            t0 = time.perf_counter()
            chunks = post_chunks("127.0.0.1", port, "/tts",
                                 {"text": "Say something."}, timeout=300)
            wall = time.perf_counter() - t0
            lag = lag.stop()
            sizes = [len(c) // 4 // hop for _, c in chunks]
            assert chunks and all(len(c) % (4 * hop) == 0
                                  for _, c in chunks), "ragged chunk"
            wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
            assert np.isfinite(wav).all(), "non-finite samples"
            assert sizes == want, (sizes, want)
            audio_s = len(wav) / ccfg.sample_rate
            if record is not None:
                record.append({"ttfa_ms": chunks[0][0] * 1e3,
                               "rtf": wall / audio_s,
                               "lag_max_ms": lag["max_ms"]})
            log(f"[server] request {r}: {len(chunks)} chunks {sizes}, "
                f"{audio_s:.2f} s audio, first audio {chunks[0][0] * 1e3:.1f}"
                f" ms, wall {wall * 1e3:.1f} ms, RTF {wall / audio_s:.3f}; "
                f"{_lag_text(lag)} (both replicas' blocks launch on the "
                f"device's dispatch thread)")
        launches = cuda_attn.LAUNCHES
        steps = sum(e.decode_steps for e in engines) - steps0
    assert launches == dcfg.n_layer * steps > 0, (launches, steps)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    log(f"[server] K1 launches on the served path: {launches} = "
        f"{dcfg.n_layer} layers x {steps} decode steps ("
        f"{'CUDA graph replays' if engines[0]._blocks.enabled else 'eager'}"
        f"); no capture while serving")
    return launches


# ---------------------------------------------------------------------------
# phase 5: K2 against its plain version
# ---------------------------------------------------------------------------

K2_B = 16
# a ragged set across the 16 rows (the K1 positions among them) and uniform
# sets; row b attends rows 0..pos[b] of its own cache.  The served sets:
# pool requests stream about 290 codes a sentence, so served depths are
# 0..400 (a ragged set with rank 0 alone below 64 rows and split above,
# and uniform 127 and 255)
SERVED_RAGGED = [0, 3, 17, 40, 63, 64, 90, 127, 150, 200, 255, 256, 300,
                 333, 380, 400]
K2_POS = {
    "ragged": [0, 1, 255, 256, 511, 4095, 8191, 2, 100, 777, 1024, 2047,
               3000, 5000, 6500, 8190],
    "uniform 511": [511] * K2_B,
    "uniform 4095": [4095] * K2_B,
    "uniform 8191": [8191] * K2_B,
    "served ragged": SERVED_RAGGED,
    "uniform 127": [127] * K2_B,
    "uniform 255": [255] * K2_B,
}
# (dtype, width, heads) off the deployed shape, at S = ODD_S: K2 at bf16
# head 100 (rows not 16-byte aligned: plain loads) and f32 head 256 (fewer
# warps a block); K3 at bf16 head 40 (not a whole number of k16 steps: the
# run-time width path) and f32 head 128
K2_ODD = ((torch.bfloat16, 800, 8), (torch.float32, 1024, 4))
K3_ODD = ((torch.bfloat16, 320, 8), (torch.float32, 1024, 8))
ODD_S = 2048
# the sets timed (bf16): deep, the pool's served depths
K2_TIMED = ("uniform 8191", "uniform 4095", "ragged", "served ragged",
            "uniform 127", "uniform 255")


def k2_bound_ms(pos_list, c: int, dtype) -> tuple:
    """Least time for one call: each stream's K and V rows 0..pos_b, q and
    out once, pos once, over HBM's rate; or 4*sum(pos_b+1)*C flops over
    the peak rate of the inputs' type; whichever is longer."""
    es = torch.finfo(dtype).bits // 8
    b, n = len(pos_list), sum(p + 1 for p in pos_list)
    nbytes = 2 * n * c * es + 2 * b * c * es + 4 * b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n * c / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_k2() -> dict:
    from llmvox_tpu_torch.ops import attention, cuda_batched_attn
    from llmvox_tpu_torch.utils.config import DecoderConfig
    cfg = DecoderConfig()
    L, S, C, H = cfg.n_layer, cfg.block_size, cfg.n_embd, cfg.n_head
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn(L, K2_B, S, C, generator=gen, device=dev, dtype=dtype)
        v = torch.randn(L, K2_B, S, C, generator=gen, device=dev, dtype=dtype)
        q = torch.randn(K2_B, C, generator=gen, device=dev, dtype=dtype)
        for name, plist in K2_POS.items():
            p = torch.tensor(plist, dtype=torch.int32, device=dev)
            err = 0.0
            for layer in range(L):
                got = cuda_batched_attn.batched_decode_attention(
                    q, k[layer], v[layer], p, H)
                again = cuda_batched_attn.batched_decode_attention(
                    q, k[layer], v[layer], p, H)
                ref = attention.batched_decode_attention(
                    q, k[layer], v[layer], p, n_head=H)
                torch.cuda.synchronize()
                # K1's tolerances, for the same reason: f32 sums in
                # another order than the plain einsum's, and in bf16 the
                # output is rounded to bf16
                torch.testing.assert_close(got.float(), ref.float(),
                                           **K1_TOL[dtype])
                assert torch.equal(got, again), ("K2 not deterministic",
                                                 dtype, name, layer)
                err = max(err, (got.float() - ref.float()).abs().max().item())
            max_err = max(max_err, err)
            log(f"[k2] {str(dtype):15s} B={K2_B} {name:13s} ok, bitwise "
                f"repeatable, max |err| over {L} layers {err:.3g}")
            if dtype is torch.bfloat16 and name in K2_TIMED:
                timings[name] = _time_k2(q, k, v, p, plist, H, dtype)
        del k, v
        torch.cuda.empty_cache()
    for dtype, c, h in K2_ODD:
        k = torch.randn(1, 4, ODD_S, c, generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn(1, 4, ODD_S, c, generator=gen, device=dev,
                        dtype=dtype)
        q = torch.randn(4, c, generator=gen, device=dev, dtype=dtype)
        for plist in ([0, 31, 32, 33], [200, 1000, ODD_S - 2, ODD_S - 1]):
            p = torch.tensor(plist, dtype=torch.int32, device=dev)
            got = cuda_batched_attn.batched_decode_attention(q, k[0], v[0],
                                                             p, h)
            again = cuda_batched_attn.batched_decode_attention(q, k[0], v[0],
                                                               p, h)
            ref = attention.batched_decode_attention(q, k[0], v[0], p,
                                                     n_head=h)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(),
                                       **K1_TOL[dtype])
            assert torch.equal(got, again), ("K2 not deterministic", c, h)
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            log(f"[k2] {str(dtype):15s} width {c}, {h} heads of {c // h}, "
                f"pos {plist} ok, bitwise repeatable, max |err| {err:.3g}")
    return {"max_abs_err": max_err, "timings": timings}


def _time_k2(q, k, v, p, plist, H, dtype) -> dict:
    from llmvox_tpu_torch.ops import attention, cuda_batched_attn
    L, B, _, C = k.shape
    D = C // H
    li = [0]

    def nxt():
        li[0] = (li[0] + 1) % L   # cycle the layers: each view is far past L2
        return li[0]

    def run_kernel():
        i = nxt()
        cuda_batched_attn.batched_decode_attention(q, k[i], v[i], p, H)

    def run_plain():
        i = nxt()
        attention.batched_decode_attention(q, k[i], v[i], p, n_head=H)

    # the library yardstick: one SDPA call over rows 0..max(pos) with a
    # boolean (B, 1, 1, n) mask for each row's own depth
    n = max(plist) + 1
    q4 = q.view(B, H, 1, D)
    mask = (torch.arange(n, device=q.device)[None, :]
            <= p[:, None])[:, None, None, :]
    kv = [(k[i, :, :n].view(B, n, H, D).transpose(1, 2),
           v[i, :, :n].view(B, n, H, D).transpose(1, 2)) for i in range(L)]

    def run_library():
        i = nxt()
        torch.nn.functional.scaled_dot_product_attention(q4, *kv[i],
                                                         attn_mask=mask)

    lib_out = torch.nn.functional.scaled_dot_product_attention(
        q4, *kv[0], attn_mask=mask).reshape(B, C)
    torch.testing.assert_close(
        lib_out.float(),
        cuda_batched_attn.batched_decode_attention(q, k[0], v[0], p,
                                                   H).float(),
        **LIBRARY_TOL[dtype])
    bound, by = k2_bound_ms(plist, C, dtype)
    t = {"ms": graph_ms(run_kernel), "library_ms": graph_ms(run_library),
         "plain_ms": graph_ms(run_plain, per_graph=4, replays=5, reps=3),
         "bound_ms": bound, "bound_by": by, "eager_ms": eager_ms(run_kernel)}
    log(f"[k2] bf16 B={B} {_pos_name(plist)}: device time per call (CUDA "
        f"graph) kernel {t['ms'] * 1e3:.2f} us, plain "
        f"{t['plain_ms'] * 1e3:.2f} us, sdpa {t['library_ms'] * 1e3:.2f} us, "
        f"bound {bound * 1e3:.2f} us ({by}); eager back-to-back kernel "
        f"{t['eager_ms'] * 1e3:.1f} us")
    return t


def _pos_name(plist) -> str:
    return (f"pos {plist[0]}" if len(set(plist)) == 1
            else f"ragged pos (max {max(plist)})")


# ---------------------------------------------------------------------------
# phase 6: the offline batched path
# ---------------------------------------------------------------------------

BATCH_TEXTS = [f"Stream number {i} reads a different sentence aloud."
               for i in range(8)]


def phase_batch(weights, device="cuda") -> None:
    """``BatchTTS`` with 8 streams, EOA off, 64 tokens each: f32 rows equal
    the f32 B=1 engine's tokens; bf16 waves are finite and 64 frames long;
    the path launches K2 n_layer times per decode step and K1 never."""
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn
    from llmvox_tpu_torch.serve.batch import BatchTTS
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    dcfg = dataclasses.replace(dcfg, eoa_token_id=-1)
    codec = WavCodec(codec_p, ccfg, buckets=scfg.chunk_buckets,
                     device=device)
    n_tok = 64
    for dtype in (torch.float32, torch.bfloat16):
        bt = BatchTTS(dec_p, table, codec, max_streams=len(BATCH_TEXTS),
                      dcfg=dcfg, scfg=scfg, device=device, cache_dtype=dtype)
        bt.decode_texts(BATCH_TEXTS[:1], max_tokens=bt.block)   # warm
        cuda_attn.LAUNCHES = cuda_batched_attn.LAUNCHES = 0
        steps0 = bt.decode_steps
        t0 = time.perf_counter()
        if dtype is torch.float32:
            rows = bt.decode_texts(BATCH_TEXTS, max_tokens=n_tok)
        else:
            wavs = bt.tts_batch(BATCH_TEXTS, max_tokens=n_tok)
        dt = time.perf_counter() - t0
        steps = bt.decode_steps - steps0
        k1, k2 = cuda_attn.LAUNCHES, cuda_batched_attn.LAUNCHES
        assert k1 == 0 and k2 == dcfg.n_layer * steps > 0, (k1, k2, steps)
        if dtype is torch.float32:
            eng = make_engine((dec_p, codec_p, table, dcfg, ccfg, scfg),
                              device, torch.float32, graphs=False)
            for text, row in zip(BATCH_TEXTS, rows):
                want = eng.tts(text, max_tokens=n_tok)[1]
                assert len(row) == n_tok and row == want, (row, want)
            log(f"[batch] f32 BatchTTS, 8 streams x {n_tok} tokens (EOA "
                f"off) in {dt * 1e3:.1f} ms: every row equals the f32 B=1 "
                f"engine's tokens; K2 launches {k2} = {dcfg.n_layer} layers "
                f"x {steps} steps, K1 launches 0")
            del eng
        else:
            for w in wavs:
                assert w.shape == (n_tok * ccfg.hop_length,), w.shape
                assert np.isfinite(w).all(), "non-finite samples"
            log(f"[batch] bf16 tts_batch, 8 streams x {n_tok} tokens (EOA "
                f"off) in {dt * 1e3:.1f} ms: 8 finite waves of "
                f"{n_tok * ccfg.hop_length} samples; K2 launches {k2} = "
                f"{dcfg.n_layer} layers x {steps} steps, K1 launches 0")
        del bt


# ---------------------------------------------------------------------------
# phase 7: the server on the continuous-batching pool
# ---------------------------------------------------------------------------

def _concurrent_round(port, n, hop, sample_rate) -> tuple:
    """``n`` concurrent ``POST /tts``; returns (per-request (chunk sizes in
    codes, first audio s, wall s, audio s), round wall s)."""
    from concurrent.futures import ThreadPoolExecutor
    from llmvox_tpu_torch.serve.client import post_chunks

    def one(i):
        t0 = time.perf_counter()
        chunks = post_chunks("127.0.0.1", port, "/tts",
                             {"text": f"Request {i}."}, timeout=600)
        wall = time.perf_counter() - t0
        assert chunks and all(len(c) % (4 * hop) == 0 for _, c in chunks), \
            "ragged chunk"
        wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
        assert np.isfinite(wav).all(), "non-finite samples"
        return ([len(c) // 4 // hop for _, c in chunks], chunks[0][0], wall,
                len(wav) / sample_rate)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=n) as ex:
        res = list(ex.map(one, range(n)))
    return res, time.perf_counter() - t0


def phase_pool_server(engines, weights, device="cuda") -> tuple:
    """The deployed configs through the engines' weights; smaller ones and
    the CPU only to rehearse the script's control flow.  Returns K2's
    launches and each bf16 round's event-loop lag."""
    from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.serve.server import build_server
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    eoa, hop, sr = dcfg.eoa_token_id, ccfg.hop_length, ccfg.sample_rate
    codec = engines[0].codec

    # f32 round: with EOA on, each stream's chunk schedule is set by where
    # its tokens emit EOA, so equal schedules mean equal tokens up to EOA.
    # Only f32 is held to the B=1 engine: a batched bf16 GEMM may round
    # differently from a B=1 one and move a near-tied argmax.
    want = _greedy_schedule(weights, device)
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, pool_capacity=8)
    pool = DecodePool(dec_p, table, codec, capacity=8, dcfg=dcfg, scfg=cfg,
                      device=device, cache_dtype=torch.float32)
    srv = build_server(cfg, engines, pool=pool)
    n_cap = captures()
    with _Server(srv, port):
        res, _ = _concurrent_round(port, 4, hop, sr)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    for sizes, *_ in res:
        assert sizes == want, (sizes, want)
    log(f"[pool] f32 pool (8 slots), 4 concurrent requests: every stream's "
        f"chunks {want} equal the f32 B=1 engine's schedule")
    del pool

    # bf16 rounds with EOA off: every sentence runs to the length cap, so
    # each stream's schedule is the dump ladder's, whatever its tokens
    no_eoa = dataclasses.replace(dcfg, eoa_token_id=-1)
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    want = (expected_chunks([0] * 2 * cap, scfg.initial_dump_size_1, scfg,
                            -1)
            + expected_chunks([0] * 2 * cap, scfg.initial_dump_size_2, scfg,
                              -1))
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, pool_capacity=16)
    pool = DecodePool(dec_p, table, codec, capacity=16, dcfg=no_eoa,
                      scfg=cfg, device=device, cache_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    srv = build_server(cfg, engines, pool=pool)
    torch.cuda.synchronize()
    log(f"[pool] bf16 pool (16 slots) built and warmed in "
        f"{time.perf_counter() - t0:.2f} s ("
        f"{uploads_text(pool._steps, pool._vocode)}); expected chunks per "
        f"request {want} (EOA off: sentences end at the length cap)")
    cuda_attn.LAUNCHES = cuda_batched_attn.LAUNCHES = 0
    steps0 = pool.decode_steps
    lags = {}
    n_cap = captures()
    with _Server(srv, port) as server:
        for n in (4, 8):
            st0 = dict(pool.stats(), disp=pool.dispatch_s,
                       tok=pool.decode_steps)
            lag = _LoopLag(server.loop)
            res, wall = _concurrent_round(port, n, hop, sr)
            lags[n] = lag = lag.stop()
            for sizes, *_ in res:
                assert sizes == want, (sizes, want)
            for i, (_, ttfa, w, audio) in enumerate(res):
                log(f"[pool] {n}-way request {i}: first audio "
                    f"{ttfa * 1e3:.1f} ms, wall {w * 1e3:.1f} ms, "
                    f"{audio:.2f} s audio, RTF {w / audio:.3f}")
            st = pool.stats()
            steps = st["steps"] - st0["steps"]
            disp = pool.dispatch_s - st0["disp"]
            tok = pool.decode_steps - st0["tok"]
            audio = sum(r[3] for r in res)
            log(f"[pool] {n}-way round: {audio:.2f} s audio in "
                f"{wall:.2f} s wall, aggregate {audio / wall:.2f} s of audio "
                f"per second; pool steps {steps} (merged "
                f"{st['merged_steps'] - st0['merged_steps']}, {tok} token "
                f"steps), synth calls "
                f"{st['synth_calls'] - st0['synth_calls']}; "
                f"{disp * 1e3 / max(steps, 1):.1f} ms of host time issuing "
                f"each pool step ({disp * 1e3 / max(tok, 1):.2f} ms per "
                f"token step for up to 16 streams), on the device's "
                f"dispatch thread; {_lag_text(lag)}")
    k1, k2 = cuda_attn.LAUNCHES, cuda_batched_attn.LAUNCHES
    steps = pool.decode_steps - steps0
    assert k1 == 0 and k2 == dcfg.n_layer * steps > 0, (k1, k2, steps)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    log(f"[pool] stats {json.dumps(pool.stats())}; K2 launches on the pooled "
        f"path: {k2} = {dcfg.n_layer} layers x {steps} token steps (CUDA "
        f"graph replays); K1 launches 0; no capture while serving")
    return k2, lags


# ---------------------------------------------------------------------------
# phase 8: K3 against its plain version
# ---------------------------------------------------------------------------

K3_B = 16
# every verify width this script serves: the ladder's rung 2 and the
# default spec_k_draft 4, and k_draft 12
K3_NQ = (3, 5, 13)


def k3_positions(nq: int, s: int) -> dict:
    """A ragged set over the 16 rows (0, 1, 255, 256, 511, 4095 and S-nq,
    the deepest row whose queries all lie in the cache, among them; the
    last row at S-2, whose later queries pass S), uniform sets, and the
    served sets of K2 (depths 0..400)."""
    deep = s - nq
    return {
        "ragged": [0, 1, 255, 256, 511, 4095, deep, 2, 100, 777, 1024, 2047,
                   3000, 5000, 6500, s - 2],
        "uniform 511": [511] * K3_B,
        "uniform 4095": [4095] * K3_B,
        f"uniform {deep}": [deep] * K3_B,
        "served ragged": SERVED_RAGGED,
        "uniform 127": [127] * K3_B,
        "uniform 255": [255] * K3_B,
    }


def k3_bound_ms(pos_list, nq: int, s: int, c: int, dtype) -> tuple:
    """Least time for one call: each stream's K and V rows 0..min(pos_b +
    nq - 1, S - 1), q and out once, pos once, over HBM's rate; or 4*C flops
    per (query, attended row) over the peak rate of the inputs' type;
    whichever is longer."""
    es = torch.finfo(dtype).bits // 8
    b = len(pos_list)
    rows = sum(min(p + nq, s) for p in pos_list)
    nbytes = 2 * rows * c * es + 2 * b * nq * c * es + 4 * b
    attended = sum(min(p + j, s - 1) + 1 for p in pos_list for j in range(nq))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * attended * c / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _k3_check(q, k, v, p, H, dtype, what) -> float:
    """K3 against its plain version on every layer view; only the queries
    inside the cache are compared (a query past S has no committed use).
    K1's tolerances, for the same reason as K2's."""
    from llmvox_tpu_torch.ops import attention, cuda_verify_attn
    L, S = k.shape[0], k.shape[2]
    nq = q.shape[1]
    keep = (p[:, None] + torch.arange(nq, device=p.device)[None]) < S
    err = mag = 0.0
    for layer in range(L):
        got = cuda_verify_attn.verify_attention(q, k[layer], v[layer], p, H)
        again = cuda_verify_attn.verify_attention(q, k[layer], v[layer], p,
                                                  H)
        ref = attention.batched_verify_attention(q, k[layer], v[layer], p,
                                                 n_head=H)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == dtype
        assert torch.isfinite(got).all(), f"{what}: non-finite output"
        assert torch.equal(got, again), ("K3 not deterministic", what, layer)
        torch.testing.assert_close(got[keep].float(), ref[keep].float(),
                                   **K1_TOL[dtype])
        err = max(err, (got[keep].float() - ref[keep].float()).abs().max()
                  .item())
        mag = max(mag, ref[keep].float().abs().mean().item())
    log(f"[k3] {str(dtype):15s} {what} ok, bitwise repeatable, max |err| "
        f"over {L} layers {err:.3g}, mean |out| {mag:.3g} "
        f"({int(keep.sum())} of {keep.numel()} queries in the cache)")
    return err


def phase_k3() -> dict:
    from llmvox_tpu_torch.utils.config import DecoderConfig
    cfg = DecoderConfig()
    L, S, C, H = cfg.n_layer, cfg.block_size, cfg.n_embd, cfg.n_head
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn(L, K3_B, S, C, generator=gen, device=dev, dtype=dtype)
        v = torch.randn(L, K3_B, S, C, generator=gen, device=dev, dtype=dtype)
        for nq in K3_NQ:
            q = torch.randn(K3_B, nq, C, generator=gen, device=dev,
                            dtype=dtype)
            for name, plist in k3_positions(nq, S).items():
                p = torch.tensor(plist, dtype=torch.int32, device=dev)
                max_err = max(max_err, _k3_check(
                    q, k, v, p, H, dtype, f"B={K3_B} nq={nq:2d} {name:14s}"))
                if dtype is torch.bfloat16 and name != "uniform 511":
                    timings[f"nq={nq} {name}"] = _time_k3(q, k, v, p, plist,
                                                          H, dtype)
            # B=1, the dedicated spec engines' path: one stream's views
            q1 = q[:1].contiguous()
            for b, pos in enumerate((0, 127, 511, 4095, S - nq, S - 2)):
                p = torch.tensor([pos], dtype=torch.int32, device=dev)
                max_err = max(max_err, _k3_check(
                    q1, k[:, b:b + 1], v[:, b:b + 1], p, H, dtype,
                    f"B=1  nq={nq:2d} pos {pos}"))
                if dtype is torch.bfloat16 and pos == 127:
                    timings[f"nq={nq} B=1 pos 127"] = _time_k3(
                        q1, k[:, :1], v[:, :1], p, [pos], H, dtype)
        del k, v
        torch.cuda.empty_cache()
    for dtype, c, h in K3_ODD:
        k = torch.randn(1, 4, ODD_S, c, generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn(1, 4, ODD_S, c, generator=gen, device=dev,
                        dtype=dtype)
        for nq in (1, 5, 13):
            q = torch.randn(4, nq, c, generator=gen, device=dev, dtype=dtype)
            for plist in ([0, 49, 64, 100], [300, 1000, ODD_S - nq,
                                             ODD_S - 2]):
                p = torch.tensor(plist, dtype=torch.int32, device=dev)
                max_err = max(max_err, _k3_check(
                    q, k, v, p, h, dtype,
                    f"width {c}, {h} heads of {c // h}, nq={nq}, pos "
                    f"{plist}"))
        del k, v
    return {"max_abs_err": max_err, "timings": timings}


def _time_k3(q, k, v, p, plist, H, dtype) -> dict:
    from llmvox_tpu_torch.ops import attention, cuda_verify_attn
    L, B, S, C = k.shape
    nq, D = q.shape[1], C // H
    li = [0]

    def nxt():
        li[0] = (li[0] + 1) % L   # cycle the layers: each view is far past L2
        return li[0]

    def run_kernel():
        i = nxt()
        cuda_verify_attn.verify_attention(q, k[i], v[i], p, H)

    def run_plain():
        i = nxt()
        attention.batched_verify_attention(q, k[i], v[i], p, n_head=H)

    # the library yardstick: one SDPA call over rows 0..max(pos)+nq-1 with
    # a boolean (B, 1, nq, n) mask for each query's own depth
    n = min(max(plist) + nq, S)
    q4 = q.view(B, nq, H, D).transpose(1, 2)
    last = p[:, None] + torch.arange(nq, device=q.device)[None]
    mask = (torch.arange(n, device=q.device)[None, None, :]
            <= last[..., None])[:, None]
    kv = [(k[i, :, :n].view(B, n, H, D).transpose(1, 2),
           v[i, :, :n].view(B, n, H, D).transpose(1, 2)) for i in range(L)]

    def run_library():
        i = nxt()
        torch.nn.functional.scaled_dot_product_attention(q4, *kv[i],
                                                         attn_mask=mask)

    keep = last < S
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        q4, *kv[0], attn_mask=mask).transpose(1, 2).reshape(B, nq, C)
    torch.testing.assert_close(
        lib_out[keep].float(),
        cuda_verify_attn.verify_attention(q, k[0], v[0], p, H)[keep].float(),
        **LIBRARY_TOL[dtype])
    bound, by = k3_bound_ms(plist, nq, S, C, dtype)
    t = {"ms": graph_ms(run_kernel), "library_ms": graph_ms(run_library),
         "plain_ms": graph_ms(run_plain, per_graph=4, replays=5, reps=3),
         "bound_ms": bound, "bound_by": by, "eager_ms": eager_ms(run_kernel)}
    log(f"[k3] bf16 B={B} nq={nq} {_pos_name(plist)}: device time per call "
        f"(CUDA graph) kernel {t['ms'] * 1e3:.2f} us, plain "
        f"{t['plain_ms'] * 1e3:.2f} us, sdpa {t['library_ms'] * 1e3:.2f} us, "
        f"bound {bound * 1e3:.2f} us ({by}); eager back-to-back kernel "
        f"{t['eager_ms'] * 1e3:.1f} us")
    return t


# ---------------------------------------------------------------------------
# phase 9: speculative decode offline at full width
# ---------------------------------------------------------------------------

SPEC_K = 4          # the default spec_k_draft
SPEC_TOKENS = 64


def with_draft_heads(weights, n: int = SPEC_K):
    """The weights with ``n`` random draft heads (seed 0, drawn after the
    other decoder weights, which stay as they were)."""
    from llmvox_tpu_torch.utils import params as P
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    dcfg = dataclasses.replace(dcfg, n_draft_heads=n)
    heads = P.init_decoder_params(0, dcfg)["draft_heads"]
    return (dict(dec_p, draft_heads=heads), codec_p, table, dcfg, ccfg, scfg)


def _spec_windows(batch, n, pad):
    """(batch, n) windows: stream i reads the text from its own offset."""
    ids = np.frombuffer(TEXT.encode(), np.uint8).astype(np.int32) + 3
    w = np.full((batch, n), pad, np.int32)
    for i in range(batch):
        w[i, :len(ids)] = np.roll(ids, -i)[:n]
    return w, len(ids)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_spec_offline(weights, device="cuda") -> dict:
    """``decode_block_spec_batch`` at B=16 and ``decode_block_spec`` at
    B=1, EOA off, 64 tokens from pos 0, with oracle drafts (the greedy
    tokens), garbage drafts (a constant code greedy never emits) and the
    random draft heads.  In f32 every token equals ``decode_block_batch``
    / ``decode_block``; in bf16 the structure is checked and the match
    fraction printed.  K3 launches n_layer times per iteration issued, K1
    and K2 never.  Then the eager host ms per 64-token block, greedy
    against spec with oracle drafts, in both dtypes."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn, \
        cuda_verify_attn
    weights = with_draft_heads(weights)
    dcfg = dataclasses.replace(weights[3], eoa_token_id=-1)
    weights = (*weights[:3], dcfg, *weights[4:])
    n, b = SPEC_TOKENS, K3_B
    win_np, tlen = _spec_windows(b, n, dcfg.pad_token_id)
    win = torch.from_numpy(win_np).to(device)
    tl = torch.full((b,), tlen, dtype=torch.int32, device=device)
    lim = torch.full((b,), n, dtype=torch.int32, device=device)
    host_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        eng = make_engine(weights, device, dtype)
        args = (eng.params, eng.text_table, eng.codebook)

        def greedy(batch):
            if batch == 1:
                return dec.decode_block(
                    *args, dec.init_decode_state(dcfg, dtype, device),
                    win[0], tl[0], lim[0], dcfg, block=n)[0][None]
            return dec.decode_block_batch(
                *args, dec.init_decode_state_batch(dcfg, b, dtype, device),
                win, tl, lim, dcfg, block=n)[0]

        def spec(batch, drafts):
            if batch == 1:
                t, cnt, _, it = dec.decode_block_spec(
                    *args, dec.init_decode_state(dcfg, dtype, device),
                    win[0], tl[0], lim[0], dcfg,
                    block=n, k_draft=SPEC_K,
                    draft_tokens=None if drafts is None else drafts[0])
                return t[None], cnt[None], it[None]
            t, cnt, _, it = dec.decode_block_spec_batch(
                *args, dec.init_decode_state_batch(dcfg, b, dtype, device),
                win, tl, lim, dcfg, block=n, k_draft=SPEC_K,
                draft_tokens=drafts)
            return t, cnt, it

        for batch in (b, 1):
            want = greedy(batch).cpu()
            assert (want >= 0).all(), "greedy block ended early"
            # the code greedy emits least (at full width: never)
            rare = int(torch.bincount(want.flatten().long(),
                                      minlength=dcfg.vocab_size).argmin())
            kinds = {"oracle": want.to(device),
                     "garbage": torch.full_like(want, rare).to(device),
                     "heads": None}
            for kind, drafts in kinds.items():
                cuda_attn.LAUNCHES = cuda_batched_attn.LAUNCHES = 0
                cuda_verify_attn.LAUNCHES = 0
                it0 = dec.SPEC_ITERATIONS
                toks, cnt, iters = (x.cpu() for x in spec(batch, drafts))
                issued = dec.SPEC_ITERATIONS - it0
                k1, k2 = cuda_attn.LAUNCHES, cuda_batched_attn.LAUNCHES
                k3 = cuda_verify_attn.LAUNCHES
                assert k1 == k2 == 0 and k3 == dcfg.n_layer * issued > 0, \
                    (k1, k2, k3, issued)
                assert issued <= min(int(iters.max()) + 1, n), (issued, iters)
                assert toks.shape == (batch, n) and (cnt == n).all(), cnt
                assert ((toks >= 0) & (toks < dcfg.vocab_size)).all()
                match = (toks == want).float().mean().item()
                if dtype is torch.float32:
                    assert torch.equal(toks, want), f"{kind} B={batch}"
                    bound = (-(-n // (SPEC_K + 1)) + 1 if kind == "oracle"
                             else n)
                    assert int(iters.max()) <= bound, (kind, iters)
                log(f"[spec] {str(dtype):15s} B={batch:2d} {kind:7s} "
                    f"drafts: {100 * match:.1f}% of tokens equal greedy's"
                    f"{' (all, as required)' if match == 1.0 else ''}; "
                    f"iterations per stream max {int(iters.max())} mean "
                    f"{iters.float().mean().item():.2f}, issued {issued}; "
                    f"K3 launches {k3} = {dcfg.n_layer} x {issued}, K1 and "
                    f"K2 0")
            host_ms[(str(dtype), batch)] = _spec_block_ms(
                greedy, spec, batch, want, device, dtype)
        del eng
    return host_ms


def _spec_block_ms(greedy, spec, batch, want, device, dtype,
                   reps: int = 3) -> dict:
    """Host ms per 64-token block, issue to fetch, greedy against spec with
    oracle drafts (median of ``reps``)."""
    drafts = want.to(device)
    out = {}
    for name, fn in (("greedy", lambda: greedy(batch)),
                     ("spec", lambda: spec(batch, drafts)[0])):
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            fn().cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    log(f"[spec] {dtype} B={batch}: host ms per {SPEC_TOKENS}-token block, "
        f"issue to fetch: greedy {out['greedy']:.1f}, spec with oracle drafts "
        f"{out['spec']:.1f} ({out['greedy'] / out['spec']:.2f}x)")
    return out


# ---------------------------------------------------------------------------
# phase 10: the server with speculation, pooled and dedicated
# ---------------------------------------------------------------------------

def _greedy_schedule(weights, device) -> list:
    """The chunk sizes one scripted ``/tts`` reply streams, from the f32
    greedy B=1 engine's tokens (phase 4's computation)."""
    _, _, _, dcfg, _, scfg = weights
    eng = make_engine(weights, device, torch.float32, graphs=False)
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    want = []
    for text, dump in ((REPLY, scfg.initial_dump_size_1),
                       ("", scfg.initial_dump_size_2)):
        want += expected_chunks(eng.tts(text, max_tokens=cap)[1], dump, scfg,
                                dcfg.eoa_token_id)
    return want


def phase_spec_server(engines, weights, device="cuda") -> dict:
    """Speculative serving with the random draft heads: the f32 spec pool
    and the f32 dedicated spec engines against the greedy schedule, the
    bf16 spec pool at 4 and 8 concurrent requests, and one round on the
    adaptive ladder (0, 2, 4)."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.ops import cuda_attn, cuda_batched_attn, \
        cuda_verify_attn
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.serve.server import build_server
    weights = with_draft_heads(weights)
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    hop, sr = ccfg.hop_length, ccfg.sample_rate
    codec = engines[0].codec
    spec_cfg = dataclasses.replace(scfg, spec_decode=True,
                                   spec_k_draft=SPEC_K)
    want = _greedy_schedule(weights, device)

    # f32, EOA on: the dedicated spec engines, then an 8-slot spec pool
    eng32 = [make_engine((*weights[:5], spec_cfg), device, torch.float32)
             for _ in range(2)]
    assert all(e._spec for e in eng32)
    # offline first, EOA off so that the chains run 128 tokens
    deep = (*weights[:3], dataclasses.replace(dcfg, eoa_token_id=-1), ccfg)
    _, tg = make_engine((*deep, scfg), device, torch.float32,
                        graphs=False).tts(TEXT, max_tokens=128)
    _, ts = make_engine((*deep, spec_cfg), device, torch.float32,
                        graphs=False).tts(TEXT, max_tokens=128)
    assert len(tg) == 128 and ts == tg, (ts, tg)
    for e in eng32:
        e.warmup()
    port = _free_port()
    n_cap = captures()
    with _Server(build_server(dataclasses.replace(spec_cfg, api_port=port),
                              eng32), port):
        it0 = dec.SPEC_ITERATIONS
        cuda_verify_attn.LAUNCHES = 0
        chunks = post_chunks("127.0.0.1", port, "/tts",
                             {"text": "Say something."}, timeout=300)
        issued = dec.SPEC_ITERATIONS - it0
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    sizes = [len(c) // 4 // hop for _, c in chunks]
    assert sizes == want, (sizes, want)
    assert cuda_verify_attn.LAUNCHES == dcfg.n_layer * issued > 0
    log(f"[spec-server] f32 dedicated spec engine: tts tokens equal greedy's "
        f"(EOA off, {len(tg)} tokens); one /tts streamed chunks {sizes}, "
        f"the greedy schedule; K3 launches {cuda_verify_attn.LAUNCHES} = "
        f"{dcfg.n_layer} x {issued} iterations")
    del eng32
    port = _free_port()
    cfg = dataclasses.replace(spec_cfg, api_port=port, pool_capacity=8)
    pool = DecodePool(dec_p, table, codec, capacity=8, dcfg=dcfg, scfg=cfg,
                      device=device, cache_dtype=torch.float32)
    assert pool._spec
    srv = build_server(cfg, engines, pool=pool)
    n_cap = captures()
    with _Server(srv, port):
        res, _ = _concurrent_round(port, 4, hop, sr)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    for sizes, *_ in res:
        assert sizes == want, (sizes, want)
    log(f"[spec-pool] f32 spec pool (8 slots, k={SPEC_K}), 4 concurrent "
        f"requests: every stream's chunks {want} equal the f32 greedy B=1 "
        f"engine's schedule")
    del pool

    # bf16, EOA off: every stream's schedule is the dump ladder's
    no_eoa = dataclasses.replace(dcfg, eoa_token_id=-1)
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    want = (expected_chunks([0] * 2 * cap, scfg.initial_dump_size_1, scfg,
                            -1)
            + expected_chunks([0] * 2 * cap, scfg.initial_dump_size_2, scfg,
                              -1))
    out = {}
    for ladder, rounds in (((), (4, 8)), ((0, 2, SPEC_K), (4, 8))):
        port = _free_port()
        cfg = dataclasses.replace(spec_cfg, api_port=port, pool_capacity=16,
                                  spec_k_ladder=ladder)
        pool = DecodePool(dec_p, table, codec, capacity=16, dcfg=no_eoa,
                          scfg=cfg, device=device,
                          cache_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        srv = build_server(cfg, engines, pool=pool)
        _sync(device)
        tag = f"ladder {list(ladder)}" if ladder else f"k={SPEC_K}"
        log(f"[spec-pool] bf16 spec pool (16 slots, {tag}) built and warmed "
            f"in {time.perf_counter() - t0:.2f} s; stats "
            f"{json.dumps(pool.stats()['spec'])}")
        picks = []
        if pool._spec_ctl is not None:
            ctl_next = pool._spec_ctl.next_k

            def next_k():
                picks.append(ctl_next())
                return picks[-1]

            pool._spec_ctl.next_k = next_k
        cuda_attn.LAUNCHES = cuda_batched_attn.LAUNCHES = 0
        cuda_verify_attn.LAUNCHES = 0
        it0, steps0 = dec.SPEC_ITERATIONS, pool.decode_steps
        n_cap = captures()
        with _Server(srv, port) as server:
            for n in rounds:
                st0 = dict(pool.stats(), disp=pool.dispatch_s,
                           tok=pool.decode_steps)
                lag = _LoopLag(server.loop)
                res, wall = _concurrent_round(port, n, hop, sr)
                lag = lag.stop()
                for sizes, *_ in res:
                    assert sizes == want, (sizes, want)
                for i, (_, ttfa, w, audio) in enumerate(res):
                    log(f"[spec-pool] {tag} {n}-way request {i}: first "
                        f"audio {ttfa * 1e3:.1f} ms, wall {w * 1e3:.1f} ms, "
                        f"{audio:.2f} s audio, RTF {w / audio:.3f}")
                st = pool.stats()
                steps = st["steps"] - st0["steps"]
                disp = pool.dispatch_s - st0["disp"]
                audio = sum(r[3] for r in res)
                ttfa = [r[1] for r in res]
                out[(tag, n)] = {"ttfa_ms": [t * 1e3 for t in ttfa],
                                 "aggregate": audio / wall,
                                 "ms_per_step": disp * 1e3 / max(steps, 1),
                                 "loop_lag": lag}
                log(f"[spec-pool] {tag} {n}-way round: {audio:.2f} s audio "
                    f"in {wall:.2f} s wall, aggregate {audio / wall:.2f} s "
                    f"of audio per second; pool steps {steps} (merged "
                    f"{st['merged_steps'] - st0['merged_steps']}, "
                    f"{pool.decode_steps - st0['tok']} token steps); "
                    f"{disp * 1e3 / max(steps, 1):.1f} ms of host time "
                    f"issuing each pool step, on the dispatch thread; "
                    f"{_lag_text(lag)}")
        issued = dec.SPEC_ITERATIONS - it0
        k1, k2 = cuda_attn.LAUNCHES, cuda_batched_attn.LAUNCHES
        k3 = cuda_verify_attn.LAUNCHES
        assert k1 == 0 and k3 == dcfg.n_layer * issued > 0, (k1, k3, issued)
        assert captures() == n_cap, "a CUDA graph was captured while serving"
        tok_steps = pool.decode_steps - steps0
        if not ladder:
            assert k2 == 0, k2
            out["k3_launches"] = k3
            out["k3_iterations"] = issued
        log(f"[spec-pool] {tag}: stats {json.dumps(pool.stats())}; K3 "
            f"launches {k3} = {dcfg.n_layer} x {issued} iterations issued, "
            f"K2 launches {k2}, K1 0; {tok_steps} token steps"
            + (f"; rungs picked per step {picks}" if picks else ""))
        if ladder:
            # random heads accept nothing (p_hat 0), so once the first
            # estimate is in, the controller leaves the spec rungs for
            # greedy when its dwell runs out, and no probe falls due here
            ctl = pool._spec_ctl
            first = picks.index(0) if 0 in picks else len(picks)
            assert len(picks) >= ctl.dwell and first < ctl.dwell and all(
                k == 0 for k in picks[first:first + ctl.probe_every]), (
                    picks, ctl.cost_ms)
            log(f"[spec-pool] {tag}: the controller left the spec rungs at "
                f"step {first + 1} (dwell {ctl.dwell}), calibrated cost_ms "
                f"{json.dumps(ctl.cost_ms)}")
            out["ladder"] = {"cost_ms": ctl.cost_ms, "picks": picks}
        del pool, srv
    return out


# ---------------------------------------------------------------------------
# phase 11: K4 against its plain version
# ---------------------------------------------------------------------------

# the deployed decoder's w4 weights, (Cin, Cout), groups of 256 rows
K4_SHAPES = {"wqkv": (768, 2304), "wo": (768, 768), "wfc": (768, 3072),
             "wproj": (3072, 768)}
# every served M: the B=1 step, the B=1 spec verify (k=4), the 16-slot
# pool, and the spec pool's rungs k=2 and k=4 at B=16
K4_M = (1, 5, 16, 48, 80)
# K4 and its plain version form the same exact bf16 x bf16 products and
# sum them in f32 in other orders.  A bf16 output: one bf16 ulp (K1's
# limits).  An f32 output: ``k4_f32_check`` holds each of the two against
# an f64 product of the same bf16-rounded operands, within
# K4_F32_C * sqrt(Cin) * 2^-24 * sum_i |x_i| |w_i| per output: the
# probabilistic bound on the rounding error of an f32 sum of Cin terms
# (Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019), which grows with
# Cin as a fixed tolerance cannot (the fixed 1e-5 failed 20 of 8.4 M sums
# of 14336 products, where an output near 0 comes of terms that are not)
K4_TOL = {torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}
K4_F32_C = 1.0
L2_BYTES = 50e6
# the Llama-3.1-8B linears that ``--quantize w4`` runs through K4, (Cin,
# Cout) in groups of 256 (wq and wo share a shape, as wk and wv do); M is
# 1 in decode and the prefill's bucket (16 to 512 here)
K4_LLAMA_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
                   "wgate/wup": (4096, 14336), "wdown": (14336, 4096)}
# M 8: a decode step of the 8-slot LLM pool; 2048: its burst prefill (4
# arrivals of 512), and an expert's rows in a 4 x 512 MoE prefill; f32 and
# bf16 at every M
K4_LLAMA_M = (1, 8, 16, 128, 512, 2048)
K4_LLAMA_TIMED = (1, 8, 128, 2048)


def k4_f32_check(x, q, s, got, what) -> dict:
    """K4's f32 output ``got`` and the plain version's, each against the
    f64 product of the same operands (x and every dequantized weight
    ``nibble * s`` rounded to bf16, as both compute them), within
    ``K4_F32_C * sqrt(Cin) * 2^-24 * sum |x||w|`` at every output.
    Returns the largest errors, the bound's range, the largest
    error-to-bound ratio and how many outputs the old fixed tolerance
    (1e-5 absolute and relative, K4 against plain) would have failed."""
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    plain = cuda_int4_mm.plain_int4_matmul(x, q, s)
    xb = x.to(torch.bfloat16).double()
    wb = quant.dequantize(quant.Int4Tensor(q, s), torch.float32).to(
        torch.bfloat16).double()
    ref = xb @ wb
    bound = K4_F32_C * (x.shape[-1] ** 0.5) * 2.0 ** -24 * (
        xb.abs() @ wb.abs())
    out = {"bound_min": bound.min().item(), "bound_max": bound.max().item()}
    for name, y in (("k4", got), ("plain", plain)):
        err = (y.double() - ref).abs()
        ratio = (err / bound).max().item()
        assert ratio <= 1.0, (what, name, ratio, err.max().item())
        out[f"{name}_err"], out[f"{name}_ratio"] = err.max().item(), ratio
    out["old_tol_fails"] = int(((got - plain).abs() > 1e-5 * (
        1 + plain.abs())).sum().item())
    out["max_abs_err"] = (got - plain).abs().max().item()
    return out


def _k4_f32_text(r: dict) -> str:
    return (f"f64 check: max |K4 - f64| {r['k4_err']:.3g}, max |plain - f64| "
            f"{r['plain_err']:.3g}, bound {r['bound_min']:.3g}.."
            f"{r['bound_max']:.3g} (c={K4_F32_C}), worst err/bound "
            f"{max(r['k4_ratio'], r['plain_ratio']):.3g}; old 1e-5 tolerance "
            f"would fail {r['old_tol_fails']} output(s)")


def k4_bound_ms(m: int, cin: int, cout: int, groups: int, dtype) -> tuple:
    """Least time for one call: the packed weight, its scales, x and the
    output once over HBM's rate; or 2*M*Cin*Cout flops over the peak rate
    of the bf16 operands; whichever is longer."""
    es = torch.finfo(dtype).bits // 8
    nbytes = cin // 2 * cout + groups * cout * es + m * cin * es + \
        m * cout * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * cin * cout / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _int4pack_weight(q, s):
    """The one-off repack of an Int4Tensor for ``torch._weight_int4pack_mm``
    (unsigned nibbles n + 8 with zero points 0, (Cout, Cin) packed by
    ``_convert_weight_to_int4pack``): the library yardstick, never used by
    the port."""
    from llmvox_tpu_torch.ops import quant
    n = quant.unpack_int4(q).to(torch.int32)
    u = (n + 8).t().contiguous()
    packed = torch._convert_weight_to_int4pack(
        (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([s[:, 0, :].to(torch.bfloat16),
                      torch.zeros_like(s[:, 0, :], dtype=torch.bfloat16)],
                     dim=-1).contiguous()
    return packed, sz


def phase_k4() -> dict:
    """K4 against its plain version at every served M and weight shape, f32
    and bf16 (bf16 scales, as bf16 serving casts them); then the bf16 times
    per call with the weight copies cycled so each call reads from HBM."""
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    max_err = 0.0
    timings = {}
    for name, (cin, cout) in K4_SHAPES.items():
        w = quant.quantize_weight4(0.02 * torch.randn(cin, cout,
                                                      generator=gen))
        groups = w.s.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            q, s = w.q.to(dev), w.s.to(dev, dtype)
            err = _k4_shape_check(q, s, K4_M, dtype, gen, name)
            max_err = max(max_err, err)
            log(f"[k4] {str(dtype):15s} {name:5s} {cin}->{cout} ({groups} "
                f"groups) ok at M {K4_M}, bitwise repeatable, max |err| "
                f"{err:.3g}")
        for m in K4_M:
            timings[(name, m)] = _time_k4(w, m, gen)
    # the in-framework Llama's shapes, drawn on the card (bf16 serving)
    dgen = torch.Generator(device=dev).manual_seed(8)
    for name, (cin, cout) in K4_LLAMA_SHAPES.items():
        w = quant.quantize_weight4(0.02 * torch.randn(
            cin, cout, generator=dgen, device=dev))
        groups = w.s.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            err = _k4_shape_check(w.q, w.s.to(dtype), K4_LLAMA_M, dtype,
                                  dgen, f"Llama {name}")
            max_err = max(max_err, err)
            log(f"[k4] {str(dtype):15s} Llama {name:9s} {cin}->{cout} "
                f"({groups} groups) ok at M {K4_LLAMA_M}, bitwise "
                f"repeatable, max |err| {err:.3g}")
        for m in K4_LLAMA_TIMED:
            timings[(f"llama {name}", m)] = _time_k4(w, m, gen, quick=True)
    return {"max_abs_err": max_err, "timings": timings}


def _k4_shape_check(q, s, ms, dtype, gen, name) -> float:
    """K4 at one weight shape and each M of ``ms``: called twice (bitwise
    equal), against its plain version (bf16: ``K4_TOL``; f32: both held to
    the f64 product, ``k4_f32_check``, printed per M).  Returns the
    largest |K4 - plain|."""
    from llmvox_tpu_torch.ops import cuda_int4_mm
    dev = q.device
    cin, cout = 2 * q.shape[0], q.shape[1]
    err = 0.0
    for m in ms:
        x = torch.randn(m, cin, generator=gen, device=gen.device).to(dev,
                                                                     dtype)
        got = cuda_int4_mm.int4_matmul(x, q, s)
        again = cuda_int4_mm.int4_matmul(x, q, s)
        torch.cuda.synchronize()
        assert got.shape == (m, cout) and got.dtype == dtype
        assert torch.equal(got, again), ("K4 not deterministic", name,
                                         dtype, m)
        if dtype == torch.float32:
            r = k4_f32_check(x, q, s, got, (name, m))
            log(f"[k4] f32 {name} {cin}->{cout} M={m}: {_k4_f32_text(r)}")
            err = max(err, r["max_abs_err"])
        else:
            ref = cuda_int4_mm.plain_int4_matmul(x, q, s)
            torch.testing.assert_close(got.float(), ref.float(),
                                       **K4_TOL[dtype])
            err = max(err, (got.float() - ref.float()).abs().max().item())
    return err


def _time_k4(w, m, gen, quick: bool = False) -> dict:
    """bf16 device times per call; ``quick`` times the plain version with
    fewer calls (at the Llama shapes it takes milliseconds a call)."""
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    dev = torch.device("cuda")
    cin, cout = w.shape
    groups = w.s.shape[0]
    x = torch.randn(m, cin, generator=gen).to(dev, torch.bfloat16)
    # enough distinct copies that a cycle of calls exceeds the 50 MB L2
    n = int(2 * L2_BYTES // w.q.numel()) + 1
    qs = [w.q.to(dev).clone() for _ in range(n)]
    s = w.s.to(dev, torch.bfloat16)
    dense = quant.dequantize(quant.Int4Tensor(qs[0], s), torch.bfloat16)
    ds = [dense.clone() for _ in range(int(2 * L2_BYTES // (dense.numel()
                                                            * 2)) + 1)]
    idx = [0]

    def nxt(pool):
        idx[0] = (idx[0] + 1) % len(pool)
        return pool[idx[0]]

    def run_kernel():
        cuda_int4_mm.int4_matmul(x, nxt(qs), s)

    def run_plain():
        cuda_int4_mm.plain_int4_matmul(x, nxt(qs), s)

    def run_dense():
        torch.matmul(x, nxt(ds))

    ref = cuda_int4_mm.int4_matmul(x, qs[0], s).float()
    lib = torch.matmul(x, dense).float()
    gap = ((lib - ref).norm() / ref.norm()).item()
    assert gap < 1e-2, gap
    # at M 2048 a call takes milliseconds: fewer calls for every variant
    few = dict(per_graph=2, replays=3, reps=3)
    many = few if m >= 1024 else {}
    t = {"ms": graph_ms(run_kernel, **many),
         "plain_ms": graph_ms(run_plain, **(few if quick else many)),
         "dense_bf16_ms": graph_ms(run_dense, **many)}
    t["int4pack_ms"] = None
    if hasattr(torch, "_weight_int4pack_mm"):
        try:
            packs = [_int4pack_weight(q, s) for q in qs]
            group = cin // groups
            y = torch._weight_int4pack_mm(x, packs[0][0], group, packs[0][1])
            gap4 = ((y.float() - ref).norm() / ref.norm()).item()
            assert gap4 < 1e-2, gap4

            def run_int4pack():
                p = nxt(packs)
                torch._weight_int4pack_mm(x, p[0], group, p[1])

            t["int4pack_ms"] = graph_ms(run_int4pack, **many)
        except (RuntimeError, AssertionError, TypeError) as e:
            log(f"[k4] torch._weight_int4pack_mm not usable here: "
                f"{type(e).__name__}: {str(e)[:160]}")
    t["library_ms"] = t["dense_bf16_ms"]
    t["library"] = "torch.matmul, dense bf16 weight"
    t["bound_ms"], t["bound_by"] = k4_bound_ms(m, cin, cout, groups,
                                               torch.bfloat16)
    log(f"[k4] bf16 {cin}->{cout} M={m:2d}: device time per call (CUDA "
        f"graph, {n} weight copies) kernel {t['ms'] * 1e3:.2f} us, plain "
        f"{t['plain_ms'] * 1e3:.2f} us, dense bf16 matmul "
        f"{t['dense_bf16_ms'] * 1e3:.2f} us, _weight_int4pack_mm "
        + (f"{t['int4pack_ms'] * 1e3:.2f} us" if t["int4pack_ms"] else "n/a")
        + f", bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    return t


# ---------------------------------------------------------------------------
# phase 12: quantized serving at full width
# ---------------------------------------------------------------------------

QUANT_MODES = ("w8", "w8a8", "w4")


def _quantized(weights, mode):
    from llmvox_tpu_torch.ops import quant
    return (quant.quantize_decoder_params(weights[0], mode), *weights[1:])


def _cpu_forced_logits(eng, chain) -> list:
    """The f32 logits of the CPU engine ``eng`` at every step of ``chain``
    (tokens for ``TEXT``, EOA off), each step fed the chain's previous
    token as ``decode_block`` takes its inputs: at step d, the CPU's own
    chain restarted from ``chain[:d]``."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.ops import nn
    from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
    cfg = eng.dcfg
    ids = ByT5Tokenizer().encode(TEXT.strip()) + [cfg.text_eos_id]
    # the engine's static state: step d writes cache row d before it reads
    # rows <= d, so what an earlier block left there is never read
    state = eng.state
    out = []
    for d in range(len(chain)):
        temb = eng.text_table[ids[d] if d < len(ids) else cfg.pad_token_id]
        sfeat = (eng.codebook[chain[d - 1]] if d else
                 torch.zeros_like(eng.codebook[0]))
        x = nn.l2_normalize(torch.cat([temb, sfeat])).float()
        pos = torch.tensor(d, dtype=torch.int32, device=eng.device)
        out.append(dec._decode_one(eng.params, cfg, x,
                                   state._replace(pos=pos),
                                   return_logits=True)[1])
    return out


def near_tie(logits, want: int, got: int, what) -> float:
    """Assert that ``want`` is the argmax of the f32 ``logits`` and that
    ``got`` trails it by under 1% of the logits' standard deviation (the
    top-2 gap of 4096 such logits is ~25% on average); returns the gap in
    percent of the std.  w8a8 and w4 round activations (to int8, to bf16
    in K4), so a last-bit f32 difference between two computations of a
    sum can move one rounding and, at such a near tie, the argmax."""
    gap = (logits[want] - logits[got]).item()
    std = logits.std().item()
    assert int(logits.argmax()) == want and 0 <= gap < 0.01 * std, (
        what, want, got, gap, std)
    return 100 * gap / std


def check_chain(card, cpu, cpu_eng, what) -> str:
    """Card tokens against the CPU's, to the end of the chain: equal, or at
    every step d where they part, the CPU's logits after the card's
    ``card[:d]`` show a near tie (``near_tie``) of the CPU's token and the
    card's; the CPU's chain then restarts from ``card[:d + 1]`` and the
    comparison goes on.  Any other divergence fails.  Returns a
    description of every tie accepted."""
    if card == cpu:
        return f"{len(card)} tokens identical"
    ties = []
    for d, logits in enumerate(_cpu_forced_logits(cpu_eng, card)):
        want = int(logits.argmax())
        if want != card[d]:
            ties.append((d, near_tie(logits, want, card[d],
                                     (what, d, card, cpu))))
    assert ties, (what, "the chains part but no step differs", card, cpu)
    return (f"{len(card)} tokens, held to the end: {len(ties)} near "
            f"tie(s), the CPU's chain restarted from the card's after each "
            f"(step, gap in % of the CPU logits' std): "
            + ", ".join(f"({d}, {pct:.3f})" for d, pct in ties))


def phase_quant(engines, weights, device="cuda") -> dict:
    """For w8, w8a8 and w4 on the random seeded weights: the stored bytes;
    64 f32 tokens (EOA off) from the B=1 engine on the card equal to the
    CPU port's; the bf16 32-token block's host time beside the dense
    one's, and its device time as a CUDA graph.  For w4: an f32 spec
    block at B=16, k=4 (K4 at M=80) equal to the greedy block, and one
    4-way concurrent bf16 ``/tts`` round on a 16-slot w4 pool.  K4
    launches exactly 4 * n_layer times per step or iteration issued (and
    never outside w4); the peak device memory is printed."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.serve.server import build_server
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    no_eoa = dataclasses.replace(dcfg, eoa_token_id=-1)
    per_step = 4 * dcfg.n_layer
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"bytes": {"dense f32": quant.quantized_bytes(dec_p)}}
    deep = make_engine((dec_p, codec_p, table, no_eoa, ccfg, scfg), device,
                       torch.bfloat16, warm=True)
    out["block_ms"] = {"dense": statistics.median(block_times(deep))}
    if on_card:
        out["graph_ms"] = {"dense": phase_block_graph(
            (dec_p, *weights[1:]))}
    del deep
    for mode in QUANT_MODES:
        qw = _quantized(weights, mode)
        out["bytes"][mode] = quant.quantized_bytes(qw[0])
        qdeep = (qw[0], codec_p, table, no_eoa, ccfg, scfg)
        g32 = make_engine(qdeep, device, torch.float32, warm=True)
        c32 = make_engine(qdeep, "cpu", torch.float32)
        cuda_int4_mm.LAUNCHES = 0
        steps0 = g32.decode_steps
        _, tg = g32.tts(TEXT, max_tokens=64)
        launches = cuda_int4_mm.LAUNCHES
        steps = g32.decode_steps - steps0
        _, tc = c32.tts(TEXT, max_tokens=64)
        assert len(tg) == len(tc) == 64, (len(tg), len(tc))
        same = check_chain(tg, tc, c32, mode)
        assert launches == (per_step * steps if mode == "w4" else 0) and (
            steps > 0), (mode, launches, steps)
        del g32, c32
        eng = make_engine(qdeep, device, torch.bfloat16, warm=True)
        out["block_ms"][mode] = statistics.median(block_times(eng))
        del eng
        if on_card:
            out["graph_ms"][mode] = phase_block_graph(qw)
        log(f"[quant] {mode:4s}: decoder {out['bytes'][mode]} bytes stored "
            f"(dense f32 {out['bytes']['dense f32']}); f32 card vs f32 CPU, "
            f"EOA off: {same} (K4 launches {launches} = "
            f"{per_step if mode == 'w4' else 0} x {steps} steps); bf16 "
            f"32-token block (one graph replay) "
            f"{out['block_ms'][mode]:.1f} ms (dense "
            f"{out['block_ms']['dense']:.1f} ms, host clock, median of 8)"
            + (f", as a CUDA graph {out['graph_ms'][mode]:.2f} ms (dense "
               f"{out['graph_ms']['dense']:.2f} ms, device time)"
               if on_card else ""))

    # w4 speculation at B=16, k=4: every verify linear is K4 at M=80
    w4 = _quantized(with_draft_heads(weights), "w4")
    assert not isinstance(w4[0]["draft_heads"], quant.QUANTIZED)
    eng = make_engine((w4[0], codec_p, table, no_eoa, ccfg, scfg), device,
                      torch.float32)
    n, b = 32, K3_B
    win_np, tlen = _spec_windows(b, n, dcfg.pad_token_id)
    win = torch.from_numpy(win_np).to(device)
    tl = torch.full((b,), tlen, dtype=torch.int32, device=device)
    lim = torch.full((b,), n, dtype=torch.int32, device=device)
    args = (eng.params, eng.text_table, eng.codebook)
    cuda_int4_mm.LAUNCHES = 0
    want, _, _, logits = dec.decode_block_batch(
        *args, dec.init_decode_state_batch(no_eoa, b, torch.float32, device),
        win, tl, lim, no_eoa, block=n, return_logits=True)
    want, logits = want.cpu(), logits.cpu()
    greedy_launches = cuda_int4_mm.LAUNCHES
    cuda_int4_mm.LAUNCHES = 0
    it0 = dec.SPEC_ITERATIONS
    toks, cnt, _, iters = dec.decode_block_spec_batch(
        *args, dec.init_decode_state_batch(no_eoa, b, torch.float32, device),
        win, tl, lim, no_eoa, block=n, k_draft=SPEC_K)
    toks = toks.cpu()
    issued = dec.SPEC_ITERATIONS - it0
    spec_launches = cuda_int4_mm.LAUNCHES
    assert greedy_launches == per_step * n, greedy_launches
    assert spec_launches == per_step * issued > 0, (spec_launches, issued)
    assert (cnt.cpu() == n).all() and (toks >= 0).all(), (cnt, toks)
    # each stream: greedy's tokens, or greedy's up to a near tie in the
    # greedy block's own logits (the verify forward sums in another order)
    ties = []
    for row in range(b):
        diff = (toks[row] != want[row]).nonzero()
        if len(diff):
            d = int(diff[0])
            ties.append((row, d, near_tie(logits[row, d], int(want[row, d]),
                                          int(toks[row, d]), ("spec", row,
                                                              d))))
    log(f"[quant] w4 f32 spec block, B={b}, k={SPEC_K} (K4 at M="
        f"{b * (SPEC_K + 1)}), draft heads: {b - len(ties)} of {b} streams "
        f"equal the w4 greedy block's {n} tokens, the others up to a near "
        f"tie (stream, step, gap in % of the logits' std: {ties}); "
        f"iterations max {int(iters.max())}, issued {issued}; K4 launches "
        f"{spec_launches} = {per_step} x {issued} (greedy: "
        f"{greedy_launches} = {per_step} x {n} steps)")
    del eng

    # one 4-way bf16 round on a 16-slot w4 pool, EOA off
    w4 = _quantized(weights, "w4")
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    sched = (expected_chunks([0] * 2 * cap, scfg.initial_dump_size_1, scfg,
                             -1)
             + expected_chunks([0] * 2 * cap, scfg.initial_dump_size_2, scfg,
                               -1))
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, pool_capacity=16,
                              quantize="w4")
    pool = DecodePool(w4[0], table, engines[0].codec, capacity=16,
                      dcfg=no_eoa, scfg=cfg, device=device,
                      cache_dtype=torch.bfloat16)
    assert type(pool.params["h"]["wfc"]) is quant.Int4Tensor
    srv = build_server(cfg, engines, pool=pool)
    cuda_int4_mm.LAUNCHES = 0
    steps0, disp0, n0 = pool.decode_steps, pool.dispatch_s, pool.steps
    n_cap = captures()
    with _Server(srv, port) as server:
        lag = _LoopLag(server.loop)
        res, wall = _concurrent_round(port, 4, ccfg.hop_length,
                                      ccfg.sample_rate)
        lag = lag.stop()
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    ms_step = 1e3 * (pool.dispatch_s - disp0) / max(pool.steps - n0, 1)
    for sizes, *_ in res:
        assert sizes == sched, (sizes, sched)
    steps = pool.decode_steps - steps0
    assert cuda_int4_mm.LAUNCHES == per_step * steps > 0, (
        cuda_int4_mm.LAUNCHES, steps)
    audio = sum(r[3] for r in res)
    out["pool"] = {"ttfa_ms": [r[1] * 1e3 for r in res],
                   "aggregate": audio / wall}
    out["k4_launches"] = cuda_int4_mm.LAUNCHES
    log(f"[quant] w4 pool (16 slots), 4 concurrent bf16 requests: chunks "
        f"{sched} each; first audio "
        f"{', '.join(f'{t:.1f}' for t in out['pool']['ttfa_ms'])} ms; "
        f"{audio:.2f} s audio in {wall:.2f} s, aggregate "
        f"{audio / wall:.2f} s of audio per second; {ms_step:.2f} ms of "
        f"host time per pool step; {_lag_text(lag)}; "
        f"{uploads_text(pool._steps, pool._vocode)}"
        f"; K4 launches {cuda_int4_mm.LAUNCHES} = {per_step} x {steps} "
        f"token steps")
    del pool, srv
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[quant] peak device memory in phase 12: "
            f"{out['peak_gb']:.2f} GB")
    return out


# ---------------------------------------------------------------------------
# phase 13: serving through CUDA graphs against serving eagerly
# ---------------------------------------------------------------------------

class _Logged:
    """A served block's pending result that notes its tokens when fetched."""

    def __init__(self, pending, out):
        self.pending, self.out = pending, out

    def _keep(self, got):
        self.out.extend(got[0] if isinstance(got, tuple) else got)
        return got

    def fetch(self):
        return self._keep(self.pending.fetch())

    async def afetch(self):
        return self._keep(await self.pending.afetch())


class _TokenLog:
    """While active, the tokens that every served engine (a dedicated
    replica, or a pooled request's replica) fetches, in fetch order."""

    def __enter__(self):
        from llmvox_tpu_torch.serve.engine import TTSEngine
        from llmvox_tpu_torch.serve.pool import PooledEngine
        self.by_engine, self._saved = {}, []
        for cls in (TTSEngine, PooledEngine):
            for name in ("decode_block_async", "decode_block_fused_async"):
                orig = cls.__dict__[name]
                self._saved.append((cls, name, orig))
                setattr(cls, name, self._wrap(orig))
        return self

    def _wrap(self, orig):
        def call(eng, *args, **kwargs):
            pending, state = orig(eng, *args, **kwargs)
            return _Logged(pending, self.by_engine.setdefault(eng, [])), state
        return call

    def __exit__(self, *exc):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)

    def streams(self) -> list:
        return sorted(tuple(v) for v in self.by_engine.values())


def _requests(port, n, hop, sr) -> list:
    """``n`` concurrent ``POST /tts``; per request (chunk sizes in codes,
    PCM, first audio s, wall s, audio s)."""
    from concurrent.futures import ThreadPoolExecutor
    from llmvox_tpu_torch.serve.client import post_chunks, to_wave

    def one(i):
        t0 = time.perf_counter()
        chunks = post_chunks("127.0.0.1", port, "/tts",
                             {"text": f"Request {i}."}, timeout=600)
        wall = time.perf_counter() - t0
        wav = to_wave(chunks)
        assert chunks and np.isfinite(wav).all(), "no or non-finite audio"
        return ([len(c) // 4 // hop for _, c in chunks], wav, chunks[0][0],
                wall, len(wav) / sr)

    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(one, range(n)))


def _build(weights, kind, on, device, dtype, engines=None):
    """Two replicas (``kind`` "dedicated"; ``engines`` if given) or a
    16-slot pool with its own codec, with graphs (``on``) or eager, built
    and warmed."""
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.serve.pool import DecodePool
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    if kind == "dedicated":
        return engines or [make_engine(weights, device, dtype, graphs=on,
                                       warm=True) for _ in range(2)]
    codec = WavCodec(codec_p, ccfg, buckets=scfg.chunk_buckets,
                     device=device, graphs=on)
    pool = DecodePool(dec_p, table, codec, capacity=16, dcfg=dcfg,
                      scfg=dataclasses.replace(scfg, pool_capacity=16),
                      device=device, cache_dtype=dtype, graphs=on)
    pool.warmup()
    _sync(device)
    return pool


def _serve(weights, obj, kind, n) -> tuple:
    """``n`` requests on a fresh server over built engines or a pool:
    one after another on the dedicated replicas, concurrently on the
    pool.  Returns (per-request results of ``_requests``, the pool's host
    ms per step or None); asserts that nothing was captured."""
    from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
    from llmvox_tpu_torch.serve.server import TTSServer
    from llmvox_tpu_torch.streams.scripted import ScriptedStream
    _, _, _, _, ccfg, scfg = weights
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port)
    stream = ScriptedStream([cfg.scripted_reply], eos_token=cfg.eos_token)
    if kind == "dedicated":
        srv = TTSServer(StreamingScheduler(obj, cfg), cfg, stream)
    else:
        srv = TTSServer(None, cfg, stream, pool=obj)
        steps0, disp0 = obj.steps, obj.dispatch_s
    n_cap = captures()
    with _Server(srv, port):
        if kind == "dedicated":
            res = [_requests(port, 1, ccfg.hop_length, ccfg.sample_rate)[0]
                   for _ in range(n)]
        else:
            res = _requests(port, n, ccfg.hop_length, ccfg.sample_rate)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    ms_step = (None if kind == "dedicated" else
               1e3 * (obj.dispatch_s - disp0) / max(obj.steps - steps0, 1))
    return res, ms_step


def phase_graphs(engines, weights, device="cuda") -> dict:
    """Served with CUDA graphs and again eagerly, in one process.  f32: the
    dedicated replicas (one request), a 16-slot pool, the spec pool on the
    (0, 2, 4) ladder and a 16-slot w4 pool (4 concurrent requests each):
    the same chunks, the same tokens on every served stream, PCM within
    1e-5.  bf16, one turn with graphs and one eagerly (each warmed by an
    untimed request first), without the lag ticker: TTFA and RTF on the dedicated replicas (3 requests), TTFA,
    aggregate and the host ms per pool step at 4 and 8 concurrent
    requests on a 16-slot pool (EOA off).  ``engines`` are phase 3's bf16
    replicas, which serve through graphs."""
    dcfg = weights[3]
    cases = {"dedicated replicas": (weights, "dedicated"),
             "pool": (weights, "pool"),
             "spec pool, ladder (0, 2, 4)": (
                 (*with_draft_heads(weights)[:5],
                  dataclasses.replace(weights[5], spec_decode=True,
                                      spec_k_draft=SPEC_K,
                                      spec_k_ladder=(0, 2, SPEC_K))),
                 "pool"),
             "w4 pool": (_quantized(weights, "w4"), "pool")}
    out = {"f32": {}, "bf16": {}}
    for name, (w, kind) in cases.items():
        n = 1 if kind == "dedicated" else 4
        got = {}
        for on in (True, False):
            obj = _build(w, kind, on, device, torch.float32)
            with _TokenLog() as toks:
                res, _ = _serve(w, obj, kind, n)
            got[on] = (res, toks.streams())
            del obj
            gc.collect()
        (rg, sg), (re, se) = got[True], got[False]
        assert [r[0] for r in rg] == [r[0] for r in re], name
        assert sg == se and len(sg) >= 2 * n, (name, sg, se)
        diff = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(rg, re))
        assert diff <= 1e-5, (name, diff)
        out["f32"][name] = diff
        log(f"[graphs] f32 {name}: {n} request(s) with CUDA graphs and "
            f"eagerly: chunks {rg[0][0]} alike, the same tokens on all "
            f"{len(sg)} served streams ({sum(map(len, sg))} tokens), PCM "
            f"max |diff| {diff:.3g}")

    # bf16 timing, in turns
    no_eoa = (*weights[:3], dataclasses.replace(dcfg, eoa_token_id=-1),
              *weights[4:])
    built = {}
    for on in (True, False):
        eng = _build(weights, "dedicated", on, device, torch.bfloat16,
                     engines=engines if on else None)
        pool = _build(no_eoa, "pool", on, device, torch.bfloat16)
        # one untimed request each, so that both modes start warm alike
        _serve(weights, eng, "dedicated", 1)
        _serve(no_eoa, pool, "pool", 4)
        built[on] = (eng, pool)
    turns = {True: [], False: []}
    for on in (True, False):
        eng, pool = built[on]
        ded, _ = _serve(weights, eng, "dedicated", 3)
        rec = {"ttfa_ms": [r[2] * 1e3 for r in ded],
               "rtf": [r[3] / r[4] for r in ded]}
        for n in (4, 8):
            t0 = time.perf_counter()
            res, ms_step = _serve(no_eoa, pool, "pool", n)
            wall = time.perf_counter() - t0
            rec[f"pool {n}"] = {"ttfa_ms": [r[2] * 1e3 for r in res],
                                "aggregate": sum(r[4] for r in res) / wall,
                                "ms_per_step": ms_step}
        turns[on].append(rec)
    for on in (True, False):
        mode = "graphs" if on else "eager"
        rs = turns[on]
        ttfa = [x for r in rs for x in r["ttfa_ms"]]
        rtf = [x for r in rs for x in r["rtf"]]
        summary = {"ttfa_ms": statistics.median(ttfa),
                   "rtf": statistics.median(rtf)}
        text = (f"[graphs] bf16 {mode} (1 turn): dedicated TTFA median "
                f"{summary['ttfa_ms']:.1f} ms ({min(ttfa):.1f}-"
                f"{max(ttfa):.1f}), RTF median {summary['rtf']:.3f} "
                f"({min(rtf):.3f}-{max(rtf):.3f})")
        for n in (4, 8):
            pr = [r[f"pool {n}"] for r in rs]
            pt = [x for r in pr for x in r["ttfa_ms"]]
            summary[f"pool {n}"] = {
                "ttfa_ms": statistics.median(pt),
                "aggregate": [r["aggregate"] for r in pr],
                "ms_per_step": [r["ms_per_step"] for r in pr]}
            text += (f"; pool {n}-way TTFA median "
                     f"{statistics.median(pt):.1f} ms, aggregate "
                     + "/".join(f"{r['aggregate']:.2f}" for r in pr)
                     + " s of audio per s, host ms per step "
                     + "/".join(f"{r['ms_per_step']:.2f}" for r in pr))
        out["bf16"][mode] = summary
        log(text)
    del built
    gc.collect()
    log(f"[graphs] {graphs_text()}")
    log(json.dumps({"graphs_vs_eager": out}))
    return out


# ---------------------------------------------------------------------------
# phase 14: /tts from the in-framework Llama
# ---------------------------------------------------------------------------

# The depth of phases 14-18's models (Llama-3.1-8B, whisper-large-v3's
# encoder and decoder, Mixtral-8x7B), cut from their published 32 layers
# for the script's time: a graph's capture and a block's decode grow with
# the layers, the widths and every shape a kernel sees do not.
BIG_DEPTH = 4

# meta-llama/Llama-3.1-8B-Instruct's published config.json (rope_scaling
# llama3: factor 8, low 1, high 4, original 8192), with the KV capacity cut
# from 131072 to 8192 rows and the depth to BIG_DEPTH
LLAMA_8B = dict(vocab_size=128256, n_layer=BIG_DEPTH, n_head=32, n_kv_head=8,
                n_embd=4096, intermediate_size=14336, max_seq_len=8192,
                rope_theta=500000.0, rope_scaling_factor=8.0,
                rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                rope_original_max_position=8192, rms_eps=1e-5,
                tie_embeddings=False)
LLM_BLOCK = 32       # the default llm_block
LLM_TOKENS = 64      # the f32 chain, the graph-against-eager chain and the
                     # served replies' cap
LLM_ATTN_TIMED = (128, 1024, 8192)
LLM_PREFILL_TIMED = (16, 128, 512)


def speakable_head(params) -> None:
    """Zero the head's columns except the printable ASCII byte ids of the
    byte tokenizer (id = byte + 1), the eos id 0 among the zeroed: a random
    128256-way head would almost never pick a byte id, so greedy chains
    now emit printable text up to the token cap."""
    head = params["head"]
    keep = torch.zeros(head.shape[-1], dtype=head.dtype, device=head.device)
    keep[0x20 + 1:0x7e + 2] = 1
    head.mul_(keep)


def _llm_weights(params) -> int:
    """The logical weights of a Llama tree's layer matmuls (a quantized
    container's shape is logical; the experts' stacks count whole)."""
    return sum(int(np.prod(x.shape)) for k, x in params["h"].items()
               if k.startswith(("w", "moe_w", "router")))


def llm_token_bound_ms(params, cfg, rows: int, es: int,
                       expert_share: float = 1.0) -> tuple:
    """Least time for one decode token: every stored weight but the
    embedding read once (one embedding row; of an MoE's expert stacks
    ``expert_share``, top_k / E when only the chosen experts are read),
    K and V rows 0..pos of every layer (``rows`` of them, ``es`` bytes
    each), over HBM's rate; or two flops a weight and 4 * rows * C a
    layer of attention over the bf16 peak; whichever is longer."""
    from llmvox_tpu_torch.ops import quant
    emb = params["tok_emb"]
    c = cfg.n_embd
    experts = {k: v for k, v in params["h"].items()
               if k.startswith("moe_w")}
    skipped = 1.0 - expert_share
    nbytes = (quant.quantized_bytes(params) - emb.numel() * emb.element_size()
              - skipped * quant.quantized_bytes(experts)
              + c * emb.element_size()
              + 2 * cfg.n_layer * rows * cfg.n_kv_head * cfg.head_dim * es)
    # logical weight counts (a quantized container's shape is logical)
    n_weights = _llm_weights(params) - skipped * sum(
        int(np.prod(x.shape)) for x in experts.values())
    flops = 2 * (n_weights + c * cfg.vocab_size) + \
        4 * cfg.n_layer * rows * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _llm_prompt(tokenizer, text: str, system: str) -> list:
    from llmvox_tpu_torch.streams.llm import build_prompt_ids
    return build_prompt_ids(tokenizer, {"system": system, "prompt": text})


def _bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, cap)


def llm_chain(model, ids, n_blocks: int) -> list:
    """The greedy chain the stream generates for prompt ``ids``: the
    prefill's token, then ``n_blocks`` blocks, issued as ``predict``
    issues them (on the dispatch thread)."""
    out = [int(model._call(model._prefill, ids,
                           _bucket(len(ids), model.cfg.max_seq_len - 1))[0])]
    pos = len(ids)
    for _ in range(n_blocks):
        out += model._call(model._decode, model._attn_bucket(
            pos + model.block))[0].tolist()
        pos += model.block
    return out


def _timed_predict(model, stamps: list):
    """Wrap ``model.predict`` so each request notes the seconds from the
    call (the request's arrival) to its first text delta."""
    orig = model.predict

    def predict(request):
        t0 = time.perf_counter()
        gen = orig(request)

        def timed():
            first = True
            for d in gen:
                if first:
                    stamps.append(time.perf_counter() - t0)
                    first = False
                yield d
        return timed()
    model.predict = predict


def _serve_llm(model, engines, weights, n: int, what: str, card: str,
               device) -> dict:
    """``n`` sequential ``POST /tts`` answered by ``model`` through
    ``build_server`` on ``engines``; per request the first text delta,
    TTFA, RTF, the LLM's tokens/s and the loop's lag; every kernel's
    launches over the requests (K1 n_layer a TTS step, K2 and K3 none:
    the replicas neither batch nor speculate)."""
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, scripted_reply="",
                              llm_backend="jax", llm_block=LLM_BLOCK,
                              llm_max_tokens=LLM_TOKENS, llm_temperature=0.0)
    stamps = []
    _timed_predict(model, stamps)
    n_cap = captures()
    rows = []
    try:
        with _Server(build_server(cfg, engines, stream_model=model),
                     port) as server:
            _zero_launches()
            steps0 = sum(e.decode_steps for e in engines)
            for r in range(n):
                tok0, blk0 = model.tokens, model.block_s
                lag = _LoopLag(server.loop)
                t0 = time.perf_counter()
                chunks = post_chunks("127.0.0.1", port, "/tts",
                                     {"text": f"Tell me about request {r}."},
                                     timeout=300)
                wall = time.perf_counter() - t0
                lag = lag.stop()
                assert chunks and all(len(c) % (4 * ccfg.hop_length) == 0
                                      for _, c in chunks), "ragged chunk"
                wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
                assert np.isfinite(wav).all(), "non-finite samples"
                audio_s = len(wav) / ccfg.sample_rate
                toks = model.tokens - tok0
                row = {"first_delta_ms": stamps[-1] * 1e3,
                       "ttfa_ms": chunks[0][0] * 1e3, "rtf": wall / audio_s,
                       "audio_s": audio_s, "llm_tokens": toks,
                       "llm_tok_s": toks / max(model.block_s - blk0, 1e-9),
                       "lag_max_ms": lag["max_ms"]}
                rows.append(row)
                log(f"[llm] {what} request {r}: {len(chunks)} chunks, "
                    f"{audio_s:.2f} s audio; first text delta "
                    f"{row['first_delta_ms']:.1f} ms, first audio "
                    f"{row['ttfa_ms']:.1f} ms, wall {wall * 1e3:.1f} ms, RTF "
                    f"{row['rtf']:.3f}; LLM {toks} tokens at "
                    f"{row['llm_tok_s']:.1f} tokens/s while the TTS shares "
                    f"the card (host clock, waits for its blocks); "
                    f"{_lag_text(lag)} ({card})")
            counts = _read_launches()
            steps = sum(e.decode_steps for e in engines) - steps0
    finally:
        del model.predict
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    assert counts["k1"] == dcfg.n_layer * steps > 0, (counts, steps)
    assert counts["k2"] == counts["k3"] == 0, counts
    return {"requests": rows, "tts_steps": steps,
            **{f"{k}_launches": v for k, v in counts.items()}}


def phase_llm(engines, weights, card: str, device="cuda",
              cfg=None) -> dict:
    """The in-framework Llama (``streams/llm.py``) at the geometry of
    meta-llama/Llama-3.1-8B-Instruct with random seeded weights (the
    head's non-printable columns zeroed: ``speakable_head``) and the byte
    tokenizer.  (1) 2 layers at full width in f32: the card's greedy chain
    of 64 tokens after a prefill (two CUDA graph replays) against the CPU
    plain path's logits on that chain (teacher-forced ``apply_llama``),
    held by ``near_tie`` at every step where they part.  (2) Full depth in
    bf16: the graph and eager chains equal; two replays of a sampled block
    from one state draw different tokens; prefill and block times beside
    the byte bound; capture count, seconds and graph pool bytes.  (3)
    three ``/tts`` requests answered by the LLM through ``build_server``
    on the dedicated replicas.  (4) ``--quantize w4``: the LLM and the
    decoder quantized, the w4 block's time, one served request, and K4's
    launches on the LLM's path (7 a layer per token and per prefill).
    Returns the numbers, the bf16 stream (warmed: phase 15 serves
    ``/voicechat`` with it) and the w4 tree (phase 16 pools it)."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.streams.llm import ByteTokenizer, LlamaStreamModel
    from llmvox_tpu_torch.utils import graphs
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.params import to_torch
    scfg = weights[5]
    cfg = cfg or llama.LlamaConfig(**LLAMA_8B)
    on_card = torch.device(device).type == "cuda"
    tok = ByteTokenizer()
    n_blocks = LLM_TOKENS // LLM_BLOCK
    out = {"card": card}
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # (1) two layers at full width, f32, card against the CPU
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    p32 = P.init_llama_params(10, cfg2, device=device)
    speakable_head(p32)
    m32 = LlamaStreamModel(p32, cfg2, tok, block=LLM_BLOCK, device=device)
    m32.warmup()
    ids = _llm_prompt(tok, TEXT, scfg.system_prompt)
    card_chain = llm_chain(m32, ids, n_blocks)[:LLM_TOKENS]
    del m32
    cpu = to_torch(p32, "cpu")
    del p32
    seq = torch.tensor([ids + card_chain[:-1]])
    with torch.no_grad():
        forced = llama.apply_llama(cpu, seq, cfg2)[0, len(ids) - 1:]
    del cpu
    ties = []
    for d, logits in enumerate(forced):
        want = int(logits.argmax())
        if want != card_chain[d]:
            ties.append((d, near_tie(logits, want, card_chain[d],
                                     ("llm f32", d, card_chain))))
    assert len(card_chain) == LLM_TOKENS
    text = tok.decode(card_chain)
    assert text and all(32 <= ord(ch) < 127 for ch in text), text
    log(f"[llm] 2 layers at full width, f32: the card's {LLM_TOKENS}-token "
        f"greedy chain (prefill + {n_blocks} CUDA graph replays) against the "
        f"CPU plain path teacher-forced on it: "
        + (f"{len(ties)} near tie(s) (step, gap in % of the logits' std): "
           f"{ties}" if ties else "every token the CPU's argmax")
        + f"; text {text[:40]!r}...")
    out["f32_ties"] = len(ties)

    # (2) BIG_DEPTH layers, bf16
    t0 = time.perf_counter()
    params = P.init_llama_params(11, cfg, device=device, dtype=torch.bfloat16)
    speakable_head(params)
    _sync(device)
    log(f"[llm] {cfg.n_layer} layers, {quant.quantized_bytes(params)} bytes "
        f"of bf16 weights, drawn on the device in "
        f"{time.perf_counter() - t0:.2f} s")
    model = LlamaStreamModel(params, cfg, tok, block=LLM_BLOCK,
                             max_tokens=LLM_TOKENS, device=device,
                             dtype=torch.bfloat16)
    n_cap, s0 = captures(), graphs.CAPTURE_S
    model.warmup()
    out["captures"] = captures() - n_cap
    out["capture_s"] = graphs.CAPTURE_S - s0
    log(f"[llm] warmup: {out['captures']} CUDA graphs (blocks of "
        f"{LLM_BLOCK} at attn_len {list(model.attn_buckets)}) in "
        f"{out['capture_s']:.2f} s; {graphs_text()}; "
        + uploads_text(model._blocks))
    eager = LlamaStreamModel(params, cfg, tok, block=LLM_BLOCK,
                             device=device, dtype=torch.bfloat16,
                             graphs=False)
    ids = _llm_prompt(tok, TEXT, scfg.system_prompt)
    got, want = llm_chain(model, ids, n_blocks), llm_chain(eager, ids,
                                                           n_blocks)
    assert got == want, (got, want)
    log(f"[llm] bf16, {cfg.n_layer} layers: graph and eager chains equal "
        f"({len(got)} tokens: {tok.decode(got)[:40]!r}...)")
    if on_card:
        out.update(_llm_times(model, eager, params, cfg, card))
        sampled = LlamaStreamModel(params, cfg, tok, block=LLM_BLOCK,
                                   temperature=0.7, top_k=40, top_p=0.95,
                                   device=device, dtype=torch.bfloat16)
        sampled._blocks.capture((LLM_BLOCK, 128))
        sampled._call(sampled._prefill, ids, _bucket(len(ids), 8191))
        start = (sampled.state.pos.clone(), sampled.tok.clone())
        draws = []
        for _ in range(2):
            sampled.state.pos.copy_(start[0])
            sampled.tok.copy_(start[1])
            draws.append(sampled._call(sampled._decode, 128)[0].tolist())
        assert draws[0] != draws[1], draws
        log(f"[llm] sampled block (T 0.7, top-k 40, top-p 0.95; the "
            f"generator registered with the graph): two replays from one "
            f"state drew {tok.decode(draws[0])[:16]!r} and "
            f"{tok.decode(draws[1])[:16]!r}")
        del sampled
    del eager

    # (3) /tts answered by the LLM on the dedicated replicas
    out["served"] = _serve_llm(model, engines, weights, 3, "bf16", card,
                               device)
    assert out["served"]["k4_launches"] == 0, out["served"]

    # (4) --quantize w4: the LLM and the decoder (the bf16 stream stays
    # for phase 15's /voicechat, with its captures)
    qparams = quant.quantize_llama_params(params, "w4")
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    assert type(qparams["h"]["wgate"]) is quant.Int4Tensor
    assert type(qparams["head"]) is quant.QuantizedTensor
    qmodel = LlamaStreamModel(qparams, cfg, tok, block=LLM_BLOCK,
                              max_tokens=LLM_TOKENS, device=device,
                              dtype=torch.bfloat16)
    del qparams
    qmodel.warmup()
    log(f"[llm] w4: {quant.quantized_bytes(qmodel.params)} bytes stored; "
        f"{graphs_text()}")
    if on_card:
        out["w4_block"] = _llm_block_times(qmodel, None, qmodel.params, cfg,
                                           card, "w4", (128,))
    qw = _quantized(weights, "w4")
    engines4 = [make_engine(qw, device, torch.bfloat16, warm=True)
                for _ in range(2)]
    tokens0 = qmodel.tokens
    steps0 = sum(e.decode_steps for e in engines4)
    out["w4_served"] = _serve_llm(qmodel, engines4, qw, 1, "w4", card,
                                  device)
    llm_k4 = 7 * cfg.n_layer * (qmodel.tokens - tokens0 + 1)
    tts_k4 = 4 * qw[3].n_layer * (sum(e.decode_steps for e in engines4)
                                  - steps0)
    if on_card:
        assert out["w4_served"]["k4_launches"] == llm_k4 + tts_k4, (
            out["w4_served"]["k4_launches"], llm_k4, tts_k4)
    out["k4_llm_launches"] = llm_k4
    log(f"[llm] w4 served request: K4 launches {llm_k4 + tts_k4} = LLM "
        f"{llm_k4} (7 x {cfg.n_layer} layers x ({qmodel.tokens - tokens0} "
        f"tokens + 1 prefill); the head stays int8) + TTS decoder {tts_k4}")
    qtree = qmodel.params
    del qmodel, engines4
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[llm] peak device memory in phase 14: {out['peak_gb']:.2f} GB "
            f"({card})")
    return out, model, qtree


def _llm_block_times(model, eager, params, cfg, card: str, what: str,
                     attns) -> dict:
    """A block of ``model.block`` tokens as one graph replay (device time,
    CUDA events, median of 3) at each ``attn_len`` in ``attns``, from pos
    attn_len - block (so the block's rows fill the window), beside the
    byte bound; and, with ``eager``, the same block issued eagerly (host
    clock to a synchronise)."""
    out = {}
    es = model.state.k.element_size()
    for attn in attns:
        g = model._blocks.get((model.block, attn))
        pos = attn - model.block
        times = []
        for _ in range(3):
            model.state.pos.fill_(pos)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end) / model.block)
        ms = statistics.median(times)
        bound, by = llm_token_bound_ms(params, cfg, pos + model.block // 2,
                                       es)
        row = {"ms_per_token": ms, "tokens_s": 1e3 / ms, "bound_ms": bound,
               "bound_by": by}
        if eager is not None:
            eg = eager._blocks.get((model.block, attn))
            eager.state.pos.fill_(pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eg()
            torch.cuda.synchronize()
            row["eager_ms_per_token"] = ((time.perf_counter() - t0) * 1e3
                                         / model.block)
        out[attn] = row
        log(f"[llm] {what} block of {model.block} at attn_len {attn} (pos "
            f"{pos}..{attn - 1}): one CUDA graph replay {ms:.3f} ms a token "
            f"({row['tokens_s']:.1f} tokens/s, device time), bound "
            f"{bound:.3f} ms ({by}, {bound / ms * 100:.0f}% of it)"
            + (f"; eager {row['eager_ms_per_token']:.3f} ms a token (host "
               f"clock)" if eager is not None else "") + f" ({card})")
    return out


def _llm_times(model, eager, params, cfg, card: str) -> dict:
    """Prefill times per bucket, and the block's times (``_llm_block_times``
    at ``LLM_ATTN_TIMED``)."""
    out = {"prefill_ms": {}}
    for bucket in LLM_PREFILL_TIMED:
        ids = [33 + i % 90 for i in range(bucket)]
        model._call(model._prefill, ids, bucket)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            model._call(model._prefill, ids, bucket)
            times.append((time.perf_counter() - t0) * 1e3)
        out["prefill_ms"][bucket] = statistics.median(times)
    log("[llm] bf16 prefill (eager, on the dispatch thread, host clock to "
        "the first token): " + ", ".join(
            f"bucket {b}: {ms:.2f} ms" for b, ms in out["prefill_ms"].items())
        + f" ({card})")
    out["block"] = _llm_block_times(model, eager, params, cfg, card, "bf16",
                                    LLM_ATTN_TIMED)
    return out


# ---------------------------------------------------------------------------
# phase 16: the continuous-batching LLM pool
# ---------------------------------------------------------------------------

LLM_POOL_CAP = 8
LLM_FIRST_BLOCK = 16            # the default llm_first_block
LLM_POOL_BUCKETS = (32, 64, 128, 256, 512)   # the default prefill buckets
W4_POOL_KV = 1024               # the w4 pool's cut: KV 1024, one bucket
W4_POOL_BUCKETS = (512,)
# the burst's user texts: with the system prompt's prefix cached, suffixes
# of 10..700 ids span every prefix bucket, and the last one (over 512)
# prefills in a 188-id chunk and a 512-id continuation
BURST_LENGTHS = (9, 40, 70, 120, 200, 300, 450, 699)


def _burst_text(n: int, r: int) -> str:
    words = ("the", "pool", "serves", "every", "request", "at", "once",
             "while", "speech", "streams")
    text = f"Request {r}:"
    i = 0
    while len(text) < n - 1:
        text += " " + words[(i * 7 + r) % len(words)]
        i += 1
    return text[: n - 1] + "?"


def llm_pool_step_bound_ms(params, cfg, b: int, rows: int, es: int
                           ) -> tuple:
    """Least time for one pooled decode step of ``b`` rows, each reading
    ``rows`` K and V rows a layer (``es`` bytes each): every stored weight
    but the embedding read once for all rows (b embedding rows), the KV
    rows over HBM's rate; or b tokens' two flops a weight and 4 * rows * C
    a layer of attention over the bf16 peak; whichever is longer."""
    from llmvox_tpu_torch.ops import quant
    emb = params["tok_emb"]
    c = cfg.n_embd
    nbytes = (quant.quantized_bytes(params)
              - emb.numel() * emb.element_size()
              + b * c * emb.element_size()
              + 2 * cfg.n_layer * b * rows * cfg.n_kv_head * cfg.head_dim
              * es)
    n_weights = _llm_weights(params)
    flops = b * (2 * (n_weights + c * cfg.vocab_size)
                 + 4 * cfg.n_layer * rows * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_llm_pool(params, cfg, tok, system: str, device, dtype,
                  buckets=LLM_POOL_BUCKETS, graphs=None,
                  first_block=LLM_FIRST_BLOCK, **kw):
    """The pooled LLM stream as ``build_llama_stream`` makes it for
    ``--llm_pool_capacity 8 --llm_block 32 --llm_first_block 16``, the
    system prompt's prefix cached, greedy, replies capped at
    ``LLM_TOKENS``, ``kw`` to the pool (``spec_ladder``); not warmed."""
    from llmvox_tpu_torch.serve.llm_pool import LLMPool
    from llmvox_tpu_torch.streams.llm import PooledLlamaStreamModel
    pool = LLMPool(params, cfg, capacity=LLM_POOL_CAP, block=LLM_BLOCK,
                   first_block=first_block, dtype=dtype, device=device,
                   prefill_buckets=buckets, graphs=graphs, **kw)
    model = PooledLlamaStreamModel(pool, tok, max_tokens=LLM_TOKENS)
    model.enable_prefix_cache(system)
    return model


def _pool_rows(pool, prompts, delays, budgets) -> list:
    """``generate`` for each prompt after its delay, concurrently, on a
    fresh event loop; each row's tokens (the pool stopped after)."""
    async def one(ids, delay, n):
        await asyncio.sleep(delay)
        out = []
        async for toks in pool.generate(ids, max_tokens=n):
            out.extend(toks)
        return out

    async def go():
        try:
            return await asyncio.gather(*[one(p, d, n) for p, d, n in
                                          zip(prompts, delays, budgets)])
        finally:
            pool.stop()
    return asyncio.run(go())


def _hold_rows(params, cfg, prompts, got, want, budgets, what) -> tuple:
    """Each row of ``got`` (the tokens generated after its prompt) holds
    its first ``budgets[r]`` tokens, each the argmax of the f32 logits of
    the row's chain teacher-forced through ``apply_llama`` on the card or
    a near tie of it (``near_tie``); where the row parts from ``want[r]``,
    the first differing step is such a tie between the two.  Returns the
    rows that parted and the ties (row, step, gap)."""
    from llmvox_tpu_torch.models import llama
    dev = params["tok_emb"].device
    parted, ties = 0, []
    for r, (ids, row, ref) in enumerate(zip(prompts, got, want)):
        n = budgets[r]
        row, ref = row[:n], ref[:n]
        assert len(row) == n, (what, r, len(row))
        seq = torch.tensor([ids + row[:-1]], device=dev)
        with torch.no_grad():
            forced = llama.apply_llama(params, seq, cfg)[0, len(ids) - 1:]
        forced = forced.float().cpu()
        for d, logits in enumerate(forced):
            top = int(logits.argmax())
            if top != row[d]:
                ties.append((r, d, near_tie(logits, top, row[d],
                                            (what, r, d, row))))
        if row != ref:
            d = next(i for i, (a, b) in enumerate(zip(row, ref)) if a != b)
            top = int(forced[d].argmax())
            assert top in (row[d], ref[d]), (what, r, d, top, row[d],
                                             ref[d])
            other = ref[d] if top == row[d] else row[d]
            ties.append((r, d, near_tie(forced[d], top, other,
                                        (what, r, d))))
            parted += 1
    return parted, ties


def _pool_f32_check(cfg, scfg, device, card, graphs=None) -> dict:
    """2 layers at full width in f32: ten rows through a graph-captured
    8-slot pool (mixed lengths, staggered arrivals, two rows that reuse
    the slots of rows that finished, the system prefix, one chunked
    prompt) against each prompt's B=1 chain from ``LlamaStreamModel``;
    where a row parts from its B=1 chain, and at every step of its own
    chain, the logits of the row's chain teacher-forced through
    ``apply_llama`` on the card show the row's token as the argmax or a
    near tie of it (``near_tie``).  Then the overlapped prompt: for three
    texts, ``predict_streaming`` of cumulative transcripts gives
    ``predict``'s text exactly."""
    from llmvox_tpu_torch.streams.llm import ByteTokenizer, LlamaStreamModel
    from llmvox_tpu_torch.utils import params as P
    tok = ByteTokenizer()
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    p32 = P.init_llama_params(12, cfg2, device=device)
    speakable_head(p32)
    system = scfg.system_prompt
    texts = [_burst_text(n, r) for r, n in enumerate(BURST_LENGTHS)]
    texts += ["Hi.", "What comes next?"]
    prompts = [_llm_prompt(tok, t, system) for t in texts]
    b1 = LlamaStreamModel(p32, cfg2, tok, block=LLM_BLOCK, device=device,
                          graphs=graphs)
    b1.warmup()
    want = [llm_chain(b1, ids, LLM_TOKENS // LLM_BLOCK)[:LLM_TOKENS]
            for ids in prompts]
    del b1
    model = make_llm_pool(p32, cfg2, tok, system, device, torch.float32,
                          graphs=graphs)
    pool = model.pool
    n_cap = captures()
    model.warmup()
    n_graphs = captures() - n_cap
    # rows 0-7 arrive 0..70 ms apart; rows 0 and 2 stop after their first
    # block, so rows 8 and 9 (arriving at 0.3 s) reuse their slots
    delays = [0.01 * r for r in range(8)] + [0.3, 0.3]
    budgets = [LLM_FIRST_BLOCK + 1 if r in (0, 2) else LLM_TOKENS
               for r in range(10)]
    calls0 = pool.prefill_calls
    got = _pool_rows(pool, prompts, delays, budgets)
    assert captures() == n_cap + n_graphs, "captured while serving"
    parted, ties = _hold_rows(p32, cfg2, prompts, got, want, budgets,
                              "pool vs B=1")
    log(f"[llm-pool] 2 layers at full width, f32, {LLM_POOL_CAP} slots "
        f"({n_graphs} CUDA graphs): 10 rows (prompts of "
        f"{min(map(len, prompts))}..{max(map(len, prompts))} ids, the "
        f"system prefix of {len(pool._prefix_ids)} cached, arrivals 0..70 "
        f"ms apart, 2 rows on reused slots, {pool.prefill_calls - calls0} "
        f"prefill programs) against each prompt's B=1 chain: "
        + ("every row equal" if not parted else
           f"{10 - parted} rows equal, {parted} parted")
        + (f"; near ties (row, step, gap in % of the logits' std): {ties}"
           if ties else "; every token the teacher-forced argmax")
        + f" ({card})")
    # the overlapped prompt: cumulative transcripts through the pool
    pairs = []
    for text in texts[4:7]:
        cum = [text[: max(1, len(text) * k // 4)] for k in (1, 2, 3)]

        async def both(text=text, cum=cum):
            async def feed():
                for c in cum + [text]:
                    await asyncio.sleep(0.002)
                    yield c, c is text
            try:
                serial = "".join([d async for d in model.predict(
                    {"system": system, "prompt": text})])
                overlapped = "".join([d async for d in
                                      model.predict_streaming(
                                          {"system": system}, feed())])
                return serial, overlapped
            finally:
                pool.stop()
        serial, overlapped = asyncio.run(both())
        assert overlapped == serial and serial, (text, serial, overlapped)
        pairs.append(len(serial))
    log(f"[llm-pool] f32 overlapped prompts (cumulative transcripts "
        f"streamed into the prefill) equal the serial replies: 3 texts, "
        f"{pairs} characters each")
    assert captures() == n_cap + n_graphs, "captured while serving"
    del model, pool, p32
    return {"rows_equal": 10 - parted, "ties": len(ties),
            "graphs": n_graphs}


def _pool_times(model, card: str) -> dict:
    """Device times of the bf16 pool's graphs (CUDA events, median of 3
    replays) before serving: each decode block per (rung, width) with all
    rows active from pos rung - width (the window full), beside the byte
    bound of a step; each plain prefill per (bucket, arrival size), every
    row a full bucket."""
    from llmvox_tpu_torch.utils.graphs import fill
    pool = model.pool
    es = pool.state.k.element_size()
    out = {"step": {}, "prefill": {}}

    def replay_ms(g):
        times = []
        for _ in range(3):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end))
        return statistics.median(times)

    for key in pool.warmup_keys():
        if key[0] != "block":
            continue
        _, attn, width = key
        fill(pool._in, np.ones(pool.B, np.int32))
        pool.state.pos.fill_(attn - width)
        ms = replay_ms(pool._graphs.get(key)) / width
        bound, by = llm_pool_step_bound_ms(pool.params, pool.cfg, pool.B,
                                           attn - width // 2, es)
        out["step"][f"{attn}/{width}"] = {"ms": ms, "bound_ms": bound,
                                          "bound_by": by}
        log(f"[llm-pool] bf16 block of {width} at attn_len {attn}, "
            f"{pool.B} rows active: {ms:.3f} ms a step ({pool.B * 1e3 / ms:.0f} "
            f"tokens/s, device time), bound {bound:.3f} ms ({by}, "
            f"{bound / ms * 100:.0f}% of it) ({card})")
    for key in pool.warmup_keys():
        if key[0] != "prefill" or key[3]:
            continue
        _, bucket, n, _ = key
        tokens = (33 + np.arange(n * bucket) % 90).astype(np.int32)
        fill(pool._in, np.concatenate([
            tokens, np.full(n, bucket), np.arange(n), np.ones(n)]).astype(
                np.int32))
        ms = replay_ms(pool._graphs.get(key))
        out["prefill"][f"{bucket}x{n}"] = ms
        log(f"[llm-pool] bf16 prefill of {n} x {bucket} ids: {ms:.2f} ms "
            f"(device time, one replay; {n * bucket / ms:.0f} ids/ms) "
            f"({card})")
    pool.state.pos.zero_()
    pool.state.tok.zero_()
    torch.cuda.synchronize()
    return out


def _timed_stream(model, stamps: dict, what: str):
    """Wrap ``model.<what>`` (``predict`` or ``predict_streaming``) so each
    request notes the seconds from the call (the request's arrival) to its
    first text delta and to its end."""
    orig = getattr(model, what)

    def wrapped(request, *a, **k):
        t0 = time.perf_counter()
        gen = orig(request, *a, **k)
        rec = {"prompt": request.get("prompt")}
        stamps.setdefault(what, []).append(rec)

        async def timed():
            async for d in gen:
                rec.setdefault("first", time.perf_counter() - t0)
                yield d
            rec["end"] = time.perf_counter() - t0
        return timed()
    setattr(model, what, wrapped)


def _count_tokens(pool, served: list) -> None:
    """Wrap ``pool.generate`` so that the tokens it yields add up in
    ``served[0]``."""
    orig = pool.generate

    def counted(*a, **k):
        gen = orig(*a, **k)

        async def out():
            try:
                async for toks in gen:
                    served[0] += len(toks)
                    yield toks
            finally:
                await gen.aclose()
        return out()
    pool.generate = counted


def _serve_pool(model, tts_pool, weights, texts, what: str, card: str
                ) -> dict:
    """``texts`` as concurrent ``POST /tts`` through ``build_server`` with
    the pooled LLM ``model`` and the TTS pool; per request the first text
    delta and TTFA; the LLM's tokens/s over the round; the loop's
    largest lag; every kernel's launches over the round (K2 n_layer a TTS
    pool step; K1 and K3 none: no replica, and the Llama's verify forward
    is plain torch; K4 the caller's to check)."""
    from concurrent.futures import ThreadPoolExecutor
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    pool = model.pool
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, scripted_reply="",
                              llm_backend="jax", pool_capacity=tts_pool.B)
    stamps: dict = {}
    _timed_stream(model, stamps, "predict")
    served_toks = [0]
    _count_tokens(pool, served_toks)
    n_cap = captures()
    try:
        srv = build_server(cfg, [], stream_model=model, pool=tts_pool)
        assert captures() == n_cap, "build_server captured again"
        with _Server(srv, port) as server:
            st0 = dict(pool.stats(), disp=pool.dispatch_s)
            tts0 = tts_pool.decode_steps
            _zero_launches()
            lag = _LoopLag(server.loop)

            def one(text):
                t0 = time.perf_counter()
                chunks = post_chunks("127.0.0.1", port, "/tts",
                                     {"text": text}, timeout=600)
                assert chunks and all(
                    len(c) % (4 * ccfg.hop_length) == 0 for _, c in chunks)
                wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
                assert np.isfinite(wav).all(), "non-finite samples"
                return chunks[0][0], time.perf_counter() - t0

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=len(texts)) as ex:
                res = list(ex.map(one, texts))
            wall = time.perf_counter() - t0
            lag = lag.stop()
            st = pool.stats()
        # read once the server has stopped the TTS pool, which waits for
        # its last launch (a step issued ahead may still be launching)
        counts = _read_launches()
        tts_steps = tts_pool.decode_steps - tts0
        served = captures() - n_cap
    finally:
        del model.predict
        del pool.generate
    assert served == 0, "a CUDA graph was captured while serving"
    k2 = counts["k2"]
    assert k2 == dcfg.n_layer * tts_steps > 0, (counts, tts_steps)
    assert counts["k1"] == counts["k3"] == 0, counts
    by_prompt = {r["prompt"]: r for r in stamps["predict"]}
    rows = [by_prompt[t] for t in texts]
    llm_s = max(r["end"] for r in rows)
    toks = served_toks[0]
    steps = st["steps"] - st0["steps"]
    out = {"requests": [{"first_delta_ms": r["first"] * 1e3,
                         "ttfa_ms": ttfa * 1e3, "wall_ms": w * 1e3}
                        for r, (ttfa, w) in zip(rows, res)],
           "llm_tokens": toks, "llm_tok_s": toks / llm_s, "steps": steps,
           "prefill_calls": st["prefill_calls"] - st0["prefill_calls"],
           "host_ms_per_step": (pool.dispatch_s - st0["disp"]) * 1e3
           / max(steps, 1),
           "lag_max_ms": lag["max_ms"], "wall_s": wall,
           "captures_while_serving": served, "tts_steps": tts_steps,
           **{f"{k}_launches": v for k, v in counts.items()}}
    for i, r in enumerate(out["requests"]):
        log(f"[llm-pool] {what} request {i} ({len(texts[i])} characters): "
            f"first text delta {r['first_delta_ms']:.1f} ms, first audio "
            f"{r['ttfa_ms']:.1f} ms, wall {r['wall_ms']:.1f} ms ({card})")
    log(f"[llm-pool] {what}: {len(texts)} requests in {wall:.2f} s; LLM "
        f"{toks} tokens for active rows in {steps} pooled steps "
        f"({out['prefill_calls']} prefill programs), "
        f"{out['llm_tok_s']:.1f} tokens/s over the LLM's {llm_s:.2f} s "
        f"(host clock, the TTS pool sharing the card), "
        f"{out['host_ms_per_step']:.2f} ms of host issuing a pool "
        f"iteration on the dispatch thread; {_lag_text(lag)}; 0 captures "
        f"while serving; launches K1 {counts['k1']}, K2 {k2} (the TTS pool: "
        f"{dcfg.n_layer} layers x {tts_steps} token steps), K3 "
        f"{counts['k3']}, K4 {counts['k4']} ({card})")
    return out


def phase_llm_pool(engines, weights, card: str, llm_model, qtree,
                   device="cuda", cfg=None, graphs=None) -> tuple:
    """The continuous-batching LLM pool (``serve/llm_pool.py``), at phase
    14's Llama-3.1-8B geometry, 8 slots, blocks of 32 and a first block
    of 16, prefill buckets 32..512, the system prompt's prefix cached, KV
    8192.  (1) 2 layers at full width in f32 (``_pool_f32_check``).  (2)
    Phase 14's bf16 tree (no second draw): the captures, each (rung,
    width) step's and each prefill's device time (``_pool_times``), then
    ``/tts`` through the server with the 16-slot bf16 TTS pool: one
    request, then a burst of 8 whose prompts span the buckets (one over
    512: chunked). (3) Phase 14's w4 tree on a cut pool (KV
    ``W4_POOL_KV``, buckets ``W4_POOL_BUCKETS``): a burst of 8 and K4's
    launches on the pooled path (7 a layer per token step and per
    prefill program).  ``graphs`` goes to the pools (None: on for a
    card).  Returns the numbers and the warmed bf16 pooled stream (phase
    15 serves ``/voicechat`` through it)."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.streams.llm import ByteTokenizer
    from llmvox_tpu_torch.utils import graphs
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    cfg = cfg or llama.LlamaConfig(**LLAMA_8B)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    out = {"card": card,
           "f32": _pool_f32_check(cfg, scfg, device, card, graphs)}

    # (2) the bf16 pool over phase 14's tree
    model = make_llm_pool(llm_model.params, cfg, tok, scfg.system_prompt,
                          device, torch.bfloat16, graphs=graphs)
    pool = model.pool
    n_cap, s0 = captures(), graphs.CAPTURE_S
    model.warmup()
    out["captures"] = captures() - n_cap
    out["capture_s"] = graphs.CAPTURE_S - s0
    keys = pool.warmup_keys()
    log(f"[llm-pool] bf16 pool of {pool.B}: {out['captures']} CUDA graphs "
        f"({sum(k[0] == 'prefill' for k in keys)} prefills, "
        f"{sum(k[0] == 'continue' for k in keys)} continuations, "
        f"{sum(k[0] == 'block' for k in keys)} blocks) in "
        f"{out['capture_s']:.2f} s; prefix of {len(pool._prefix_ids)} ids; "
        f"{graphs_text()}; " + uploads_text(pool._graphs))
    assert out["captures"] == (len(keys) if pool._graphs.enabled else 0)
    if on_card:
        out["times"] = _pool_times(model, card)
    tts_pool = DecodePool(dec_p, table, engines[0].codec, capacity=16,
                          dcfg=dcfg, scfg=dataclasses.replace(
                              scfg, pool_capacity=16),
                          device=device, cache_dtype=torch.bfloat16)
    tts_pool.warmup()
    burst = [_burst_text(n, r) for r, n in enumerate(BURST_LENGTHS)]
    out["one"] = _serve_pool(model, tts_pool, weights,
                             ["Tell me about the pool."], "bf16 1-way",
                             card)
    out["burst"] = _serve_pool(model, tts_pool, weights, burst,
                               "bf16 8-way burst", card)
    assert out["one"]["k4_launches"] == out["burst"]["k4_launches"] == 0
    out["prefill_calls"] = pool.prefill_calls
    log(f"[llm-pool] bf16 stats {json.dumps(pool.stats())}")

    # (3) the w4 tree on a cut pool
    wcfg = dataclasses.replace(cfg, max_seq_len=W4_POOL_KV)
    log(f"[llm-pool] w4 pool cut: KV {W4_POOL_KV} (not 8192), prefill "
        f"buckets {W4_POOL_BUCKETS} (not {LLM_POOL_BUCKETS})")
    wmodel = make_llm_pool(qtree, wcfg, tok, scfg.system_prompt, device,
                           torch.bfloat16, buckets=W4_POOL_BUCKETS,
                           graphs=graphs)
    wpool = wmodel.pool
    n_cap, s0 = captures(), graphs.CAPTURE_S
    wmodel.warmup()
    out["w4_captures"] = captures() - n_cap
    out["w4_capture_s"] = graphs.CAPTURE_S - s0
    log(f"[llm-pool] w4 pool: {out['w4_captures']} CUDA graphs in "
        f"{out['w4_capture_s']:.2f} s")
    steps0, calls0 = wpool.decode_steps, wpool.prefill_calls
    out["w4_burst"] = _serve_pool(wmodel, tts_pool, weights, burst,
                                  "w4 8-way burst", card)
    k4 = out["w4_burst"]["k4_launches"]
    want = 7 * cfg.n_layer * (wpool.decode_steps - steps0
                              + wpool.prefill_calls - calls0)
    if on_card:
        assert k4 == want > 0, (k4, want)
    out["k4_llm_pool_launches"] = k4
    for k in ("k2", "k3"):
        out[f"{k}_llm_pool_launches"] = sum(
            out[r][f"{k}_launches"] for r in ("one", "burst", "w4_burst"))
    log(f"[llm-pool] w4 burst: K4 launches {want} = 7 x {cfg.n_layer} "
        f"layers x ({wpool.decode_steps - steps0} pooled token steps + "
        f"{wpool.prefill_calls - calls0} prefill programs); the head stays "
        f"int8")
    tts_pool.stop()
    del wmodel, wpool, tts_pool
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    if on_card:
        torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[llm-pool] phase 16 took {out['phase_s']:.1f} s"
        + (f", peak device memory {out['peak_gb']:.2f} GB" if on_card
           else "") + f" ({card})")
    return out, model


# ---------------------------------------------------------------------------
# phase 17: the pooled speculative Llama
# ---------------------------------------------------------------------------

LLM_SPEC_HEADS = 4              # random draft heads (4 x 4096 x 128256)
LLM_SPEC_LADDER = (0, 2, 4)
SPEC_POOL_K = 2                 # the rung a served burst is pinned to
SPEC_POOL_KV = 1024             # the f32 served check's cut KV


def llm_spec_iter_bound_ms(params, cfg, b: int, k: int, rows: int,
                           es: int) -> tuple:
    """Least time for one speculative iteration of ``b`` rows at ``k``
    drafts, each row's K and V ``rows`` deep: a step's bytes (every
    stored weight but the embedding and the heads, the KV rows), a
    verify forward's (the weights again, the KV rows and k more), and
    the k draft heads read once, over HBM's rate; or the b (1 + k)
    positions' two flops a weight (heads included) over the bf16 peak;
    whichever is longer."""
    from llmvox_tpu_torch.ops import quant
    heads = params["draft_heads"]
    base = {key: v for key, v in params.items() if key != "draft_heads"}
    emb = params["tok_emb"]
    c = cfg.n_embd
    weights = (quant.quantized_bytes(base)
               - emb.numel() * emb.element_size())
    kv_row = 2 * cfg.n_layer * cfg.n_kv_head * cfg.head_dim * es
    nbytes = (2 * weights + k * heads[0].numel() * heads.element_size()
              + b * (1 + k) * c * emb.element_size()
              + b * (2 * rows + k) * kv_row)
    flops = (b * (1 + k) * 2 * (_llm_weights(base) + c * cfg.vocab_size)
             + b * k * 2 * c * cfg.vocab_size
             + b * (1 + k) * 4 * cfg.n_layer * rows * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _hold_chain(params, cfg, ids, chain, what) -> list:
    """Each token of ``chain`` (generated after ``ids``) is the argmax of
    the logits teacher-forced through ``apply_llama`` on the card, or a
    near tie of it (``near_tie``); returns the ties (step, gap)."""
    from llmvox_tpu_torch.models import llama
    dev = params["tok_emb"].device
    seq = torch.tensor([list(ids) + list(chain[:-1])], device=dev)
    with torch.no_grad():
        forced = llama.apply_llama(params, seq, cfg)[0, len(ids) - 1:]
    forced = forced.float().cpu()
    ties = []
    for d, logits in enumerate(forced):
        top = int(logits.argmax())
        if top != chain[d]:
            ties.append((d, near_tie(logits, top, chain[d], (what, d))))
    return ties


def _spec_f32_check(cfg, scfg, device, card) -> dict:
    """2 layers at full width in f32 with 4 random draft heads: 8 rows
    (prompts of 129..618 ids) prefilled into a pool state; two plain
    pooled blocks of 32 against two speculative blocks at each rung of
    the ladder (equal tokens, or held by ``near_tie`` against the chain
    teacher-forced on the card); oracle drafts (the plain blocks' tokens)
    take ceil(32 / (k + 1)) iterations and garbage drafts 16; two rows at
    the cache's last rows (pos + block + k + 1 = KV) equal the plain
    block's."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.streams.llm import ByteTokenizer
    from llmvox_tpu_torch.utils import params as P
    tok = ByteTokenizer()
    cfg2 = dataclasses.replace(cfg, n_layer=2, n_draft_heads=LLM_SPEC_HEADS)
    p32 = P.init_llama_params(13, cfg2, device=device)
    speakable_head(p32)
    texts = [_burst_text(n, r) for r, n in
             enumerate((9, 40, 70, 120, 200, 300, 450, 500))]
    prompts = [_llm_prompt(tok, t, scfg.system_prompt) for t in texts]
    b, block, s_cap = len(prompts), LLM_BLOCK, cfg2.max_seq_len
    tpad = max(map(len, prompts))
    tokens = torch.zeros((b, tpad), dtype=torch.int32)
    for i, ids in enumerate(prompts):
        tokens[i, :len(ids)] = torch.tensor(ids)
    valid = torch.tensor([len(ids) for ids in prompts], dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool, device=device)
    attn = 1024
    assert tpad + 2 * block + max(LLM_SPEC_LADDER) + 1 <= attn

    def fresh():
        st = llama.init_llama_pool_state(cfg2, b, device=device)
        first, st = llama.prefill_slots(
            p32, tokens.to(device), valid.to(device), st,
            torch.arange(b, dtype=torch.int32, device=device), active, cfg2)
        return first, st

    first, st = fresh()
    plain = []
    for _ in range(2):
        toks, st = llama.decode_block_pooled(p32, st, active, cfg2,
                                             block=block, attn_len=attn)
        plain.append(toks)
    plain = torch.cat(plain, dim=1).cpu()
    out = {"rungs": {}}
    ties = []
    for k in [r for r in LLM_SPEC_LADDER if r > 0]:
        _, st = fresh()
        got, iters = [], []
        for _ in range(2):
            toks, st, it = llama.decode_block_spec_pooled(
                p32, st, active, cfg2, block=block, k_draft=k,
                attn_len=attn)
            got.append(toks)
            iters.append(it)
        got = torch.cat(got, dim=1).cpu()
        rows_equal = int((got == plain).all(dim=1).sum())
        for r in range(b):
            if not torch.equal(got[r], plain[r]):
                chain = [int(first[r])] + got[r].tolist()
                ties += [(k, r, d, g) for d, g in _hold_chain(
                    p32, cfg2, prompts[r], chain, ("spec f32", k, r))]
        # oracle drafts (the plain chain) and garbage drafts (never it)
        _, st = fresh()
        _, _, it_o = llama.decode_block_spec_pooled(
            p32, st, active, cfg2, block=block, k_draft=k, attn_len=attn,
            draft_tokens=plain[:, :block].to(device))
        _, st = fresh()
        _, _, it_g = llama.decode_block_spec_pooled(
            p32, st, active, cfg2, block=block, k_draft=k, attn_len=attn,
            draft_tokens=((plain[:, :block] + 1) % 95 + 34).to(device))
        it_o, it_g = it_o.cpu().tolist(), it_g.cpu().tolist()
        same = (got[:, :block] == plain[:, :block]).all(dim=1).tolist()
        want_o = -(-block // (k + 1))
        assert all(i == want_o for i, eq in zip(it_o, same) if eq), (
            k, it_o, same)
        assert it_g == [(block + 1) // 2] * b, (k, it_g)
        # the cache's last rows: rows 0 and 1 at pos S - block - k - 1
        _, st = fresh()
        st.pos[:2] = s_cap - block - k - 1
        st2 = st._replace(k=st.k.clone(), v=st.v.clone())
        edge_p, _ = llama.decode_block_pooled(p32, st, active, cfg2,
                                              block=block)
        edge_s, st2, _ = llama.decode_block_spec_pooled(
            p32, st2, active, cfg2, block=block, k_draft=k)
        assert torch.equal(edge_p, edge_s), (k, edge_p[:2], edge_s[:2])
        assert int(st2.pos[0]) == s_cap - k - 1
        del st, st2
        out["rungs"][k] = {"rows_equal": rows_equal,
                           "iters": torch.stack(iters).sum(0).tolist(),
                           "oracle_iters": it_o, "garbage_iters": it_g}
        log(f"[llm-spec] f32, 2 layers at full width, k={k}: {rows_equal} "
            f"of {b} rows' 64 tokens equal the plain pooled blocks' "
            f"(iterations per row {out['rungs'][k]['iters']}); oracle "
            f"drafts {it_o} iterations (ceil(32/{k + 1}) = {want_o}), "
            f"garbage drafts {it_g}; rows 0-1 at pos {s_cap - block - k - 1}"
            f" (the cache's last {block + k + 1} rows): equal to the plain "
            f"block ({card})")
    if ties:
        log(f"[llm-spec] f32 rows parted from the plain blocks only at near "
            f"ties (k, row, step, gap in % of the logits' std): {ties}")
    out["ties"] = len(ties)
    out["served"] = _spec_pool_f32_check(p32, cfg2, prompts,
                                         scfg.system_prompt, device, card)
    del p32
    return out


def _count_spec_blocks(pool) -> list:
    """Wrap ``pool._spec_block`` so that each speculative block it issues
    appends its iterations to the list returned."""
    blocks = []
    issue = pool._spec_block

    def counted(*args):
        bufs, n = issue(*args)
        blocks.append(n)
        return bufs, n
    pool._spec_block = counted
    return blocks


def _spec_pool_f32_check(p32, cfg2, prompts, system, device, card) -> dict:
    """The served speculative path at 2 layers, full width, f32: the
    prompts (arrivals 10 ms apart, 64 tokens each) through a graph-captured
    8-slot pool pinned at ``spec_k`` 2 (each block its start graph, then
    iteration graphs over the shared buffers of its width, issued by
    ``run_spec_loop`` on the dispatch thread with ``pipeline_depth`` 2),
    and through the plain pool on the same params; the speculative rows
    held to the plain rows (``_hold_rows``).  KV cut to 1024: the prompts
    and replies fit."""
    from llmvox_tpu_torch.streams.llm import ByteTokenizer
    tok = ByteTokenizer()
    kcfg = dataclasses.replace(cfg2, max_seq_len=SPEC_POOL_KV)
    plain = {key: v for key, v in p32.items() if key != "draft_heads"}
    delays = [0.01 * r for r in range(len(prompts))]
    budgets = [LLM_TOKENS] * len(prompts)
    rows, n_graphs = {}, {}
    for name, params, kw in (("plain", plain, {}),
                             ("spec", p32, {"spec_k": SPEC_POOL_K})):
        model = make_llm_pool(params, kcfg, tok, system, device,
                              torch.float32, **kw)
        pool = model.pool
        n_cap = captures()
        model.warmup()
        n_graphs[name] = captures() - n_cap
        if name == "spec":
            assert pool.use_spec and pool._spec_rungs == (SPEC_POOL_K,)
            blocks = _count_spec_blocks(pool)
        steps0 = pool.steps
        rows[name] = _pool_rows(pool, prompts, delays, budgets)
        assert captures() == n_cap + n_graphs[name], "captured while serving"
        if name == "spec":
            assert len(blocks) == pool.steps - steps0 > 0, (
                len(blocks), pool.steps - steps0)
        del model, pool
    parted, ties = _hold_rows(p32, kcfg, prompts, rows["spec"],
                              rows["plain"], budgets, "spec pool vs plain")
    log(f"[llm-spec] f32 served, 2 layers at full width, KV "
        f"{SPEC_POOL_KV}: {len(prompts)} rows through the pool pinned at "
        f"k={SPEC_POOL_K} ({n_graphs['spec']} CUDA graphs; {len(blocks)} "
        f"speculative blocks, {sum(blocks)} iterations issued) against the "
        f"plain pool ({n_graphs['plain']} graphs): "
        + ("every row's 64 tokens equal" if not parted else
           f"{len(prompts) - parted} rows equal, {parted} parted")
        + (f"; near ties (row, step, gap in % of the logits' std): {ties}"
           if ties else "; every token the teacher-forced argmax")
        + f"; 0 captures while serving ({card})")
    return {"rows_equal": len(prompts) - parted, "ties": len(ties),
            "blocks": len(blocks), "iterations": sum(blocks),
            "graphs": n_graphs}


def _spec_times(model, card: str) -> dict:
    """Device times of the bf16 spec pool's graphs (CUDA events, median of
    3 replays), all 8 rows active at pos attn - 32 - 5: the plain step
    (a block of 32 over its width) and one speculative iteration per
    rung, at attn_len 128 and 8192, beside their byte bounds."""
    from llmvox_tpu_torch.utils.graphs import fill
    pool = model.pool
    es = pool.state.k.element_size()
    base = {key: v for key, v in pool.params.items() if key != "draft_heads"}

    def replay_ms(g, reset):
        times = []
        for _ in range(3):
            reset()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end))
        return statistics.median(times)

    out = {}
    for attn in (128, 8192):
        pos = attn - LLM_BLOCK - pool._spec_margin
        fill(pool._in, np.ones(pool.B, np.int32))
        step = replay_ms(pool._graphs.get(("block", attn, LLM_BLOCK)),
                         lambda: pool.state.pos.fill_(pos)) / LLM_BLOCK
        sb, sby = llm_pool_step_bound_ms(base, pool.cfg, pool.B,
                                         pos + LLM_BLOCK // 2, es)
        row = {"step_ms": step, "step_bound_ms": sb, "iter": {}}
        for k in pool._spec_rungs:
            if k == 0:
                continue
            start = pool._graphs.get(("spec_start", LLM_BLOCK, k))

            def reset(start=start):
                pool.state.pos.fill_(pos)
                start.graph.replay()
            ms = replay_ms(pool._graphs.get(("spec_iter", attn, LLM_BLOCK,
                                             k)), reset)
            bound, by = llm_spec_iter_bound_ms(pool.params, pool.cfg,
                                               pool.B, k, pos, es)
            row["iter"][k] = {"ms": ms, "bound_ms": bound, "bound_by": by}
            log(f"[llm-spec] bf16 iteration at k={k}, attn_len {attn}, "
                f"{pool.B} rows: {ms:.3f} ms (device time), bound "
                f"{bound:.3f} ms ({by}, {bound / ms * 100:.0f}% of it); the "
                f"plain step {step:.3f} ms, bound {sb:.3f} ms ({card})")
        out[attn] = row
    pool.state.pos.zero_()
    pool.state.tok.zero_()
    torch.cuda.synchronize()
    return out


def phase_llm_spec(engines, weights, card: str, params, device="cuda",
                   cfg=None, graphs=None) -> dict:
    """The pooled speculative Llama (``models/llama.py::
    decode_block_spec_pooled`` in ``LLMPool``) at phase 14's
    Llama-3.1-8B geometry with 4 random draft heads, 8 slots, blocks of
    32, a first block of 16, the ladder (0, 2, 4).  (1) 2 layers at full
    width in f32 (``_spec_f32_check``).  (2) Phase 14's bf16 tree
    (``params``) with 4 random bf16 heads (4.2 GB): the captures (per
    attention rung and width a block at rung 0, a start and an iteration
    at each other rung), the calibrated costs, the iterations' and a
    plain step's device times (``_spec_times``), a burst of 8 ``/tts``
    through the server with a 16-slot bf16 TTS pool on the adaptive
    ladder (its rung picks, first deltas, TTFA, LLM tokens/s, 0 captures
    while serving), the same burst with every block pinned at rung 2
    (random heads park the ladder on rung 0), every kernel's launches
    over both bursts, the peak memory."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.streams.llm import ByteTokenizer
    from llmvox_tpu_torch.utils import graphs
    dec_p, _, table, dcfg, _, scfg = weights
    cfg = cfg or llama.LlamaConfig(**LLAMA_8B)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"card": card, "f32": _spec_f32_check(cfg, scfg, device, card)}

    hcfg = dataclasses.replace(cfg, n_draft_heads=LLM_SPEC_HEADS)
    dtype = params["tok_emb"].dtype
    gen = torch.Generator(device=device).manual_seed(14)
    heads = torch.randn((LLM_SPEC_HEADS, cfg.n_embd, cfg.vocab_size),
                        generator=gen, device=device, dtype=dtype).mul_(0.02)
    model = make_llm_pool({**params, "draft_heads": heads}, hcfg,
                          ByteTokenizer(), scfg.system_prompt, device,
                          torch.bfloat16, graphs=graphs,
                          spec_ladder=LLM_SPEC_LADDER)
    del heads
    pool = model.pool
    n_cap, s0 = captures(), graphs.CAPTURE_S
    t0 = time.perf_counter()
    model.warmup()
    out["warmup_s"] = time.perf_counter() - t0
    out["captures"] = captures() - n_cap
    out["capture_s"] = graphs.CAPTURE_S - s0
    keys = pool.warmup_keys()
    assert out["captures"] == (len(keys) if pool._graphs.enabled else 0)
    out["cost_ms"] = dict(pool._spec_ctl.cost_ms)
    log(f"[llm-spec] bf16 pool of {pool.B} on the ladder "
        f"{list(pool._spec_rungs)}: {out['captures']} CUDA graphs "
        f"({sum(k[0] == 'block' for k in keys)} blocks, "
        f"{sum(k[0] == 'spec_start' for k in keys)} speculative starts, "
        f"{sum(k[0] == 'spec_iter' for k in keys)} iterations, "
        f"{sum(k[0] in ('prefill', 'continue') for k in keys)} prefills and "
        f"continuations) in {out['capture_s']:.2f} s, warmup "
        f"{out['warmup_s']:.2f} s; calibrated costs (ms a token at rung 0, "
        f"an iteration at the others) {json.dumps(out['cost_ms'])}; "
        f"{graphs_text()}")
    if on_card:
        out["times"] = _spec_times(model, card)
    tts_pool = DecodePool(dec_p, table, engines[0].codec, capacity=16,
                          dcfg=dcfg, scfg=dataclasses.replace(
                              scfg, pool_capacity=16),
                          device=device, cache_dtype=torch.bfloat16)
    tts_pool.warmup()
    picks = []
    next_k = pool._spec_ctl.next_k

    def counted():
        picks.append(next_k())
        return picks[-1]
    pool._spec_ctl.next_k = counted
    burst = [_burst_text(n, r) for r, n in enumerate(BURST_LENGTHS)]
    out["burst"] = _serve_pool(model, tts_pool, weights, burst,
                               "bf16 spec-ladder 8-way burst", card)
    ctl = pool._spec_ctl.stats()
    out["ladder"] = {"picks": {k: picks.count(k) for k in pool._spec_rungs},
                     "final": ctl}
    log(f"[llm-spec] the ladder over the burst: rung picks "
        f"{out['ladder']['picks']} (the pool's steps), final state "
        f"{json.dumps(ctl)} ({card})")
    # the same burst with every block at rung 2: the captured iterations
    # serve every block at depth (random heads would park the ladder)
    pool._spec_ctl.next_k = lambda: SPEC_POOL_K
    blocks = _count_spec_blocks(pool)
    out["pinned"] = _serve_pool(model, tts_pool, weights, burst,
                                f"bf16 8-way burst pinned at "
                                f"k={SPEC_POOL_K}", card)
    del pool._spec_ctl.next_k, pool._spec_block
    assert len(blocks) == out["pinned"]["steps"] > 0, (
        len(blocks), out["pinned"]["steps"])
    out["pinned"]["iterations"] = sum(blocks)
    log(f"[llm-spec] the pinned burst: {len(blocks)} speculative blocks at "
        f"k={SPEC_POOL_K}, {sum(blocks)} iterations issued (captured "
        f"iterations over {cfg.n_layer} layers) ({card})")
    for run in ("burst", "pinned"):
        assert out[run]["k4_launches"] == 0, out[run]
    for k in ("k1", "k2", "k3", "k4"):
        out[f"{k}_launches"] = sum(out[run][f"{k}_launches"]
                                   for run in ("burst", "pinned"))
    tts_pool.stop()
    del model, pool, tts_pool
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    if on_card:
        torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[llm-spec] phase 17 took {out['phase_s']:.1f} s"
        + (f", peak device memory {out['peak_gb']:.2f} GB" if on_card
           else "") + f" ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 18: the mixture-of-experts Llama
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-Instruct-v0.1's published geometry; KV cut to
# 1024 of 32768 (each attention rung of 32 layers was an MoE block graph
# of ~10 s to capture; the requests fit) and the depth to BIG_DEPTH; the
# capacity factor E / k that JAX's converter writes
MIXTRAL_8X7B = dict(vocab_size=32000, n_layer=BIG_DEPTH, n_head=32,
                    n_kv_head=8,
                    n_embd=4096, intermediate_size=14336, max_seq_len=1024,
                    rope_theta=1e6, rms_eps=1e-5, tie_embeddings=False,
                    n_experts=8, moe_top_k=2, moe_capacity_factor=4.0)
# one prefill bucket, the burst's longest suffix's (each bucket is two
# ~5 s captures, n = 1 and 4; 32 and 64 were cut to give the script's time
# to phase 22)
MOE_POOL_BUCKETS = (128,)
MOE_BURST = 4
# K4 calls a layer per token step or prefill program: wq, wk, wv, wo and
# three matmuls of each of the 8 experts (the head stays int8)
MOE_K4_PER_LAYER = 4 + 3 * 8
# the w4 experts through K4 against JAX's group einsum (the norm of the
# gap over the output's): K4 rounds x and each weight to bf16
W4_EINSUM_GAP = 1e-2


def draw_moe_w4(seed: int, cfg, device) -> dict:
    """A random MoE Llama tree quantized ``w4`` (groups of 256; head int8)
    on ``device``, drawn and quantized a layer at a time: the dense part
    in bf16, then each layer's experts (bf16, from
    ``params.draw_llama_experts``) quantized into preallocated stacks, so
    the bf16 experts (93 GB at Mixtral-8x7B) never exist at once."""
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.utils import params as P
    dense = P.init_llama_params(seed, cfg, device=device,
                                dtype=torch.bfloat16, experts=False)
    speakable_head(dense)
    tree = quant.quantize_llama_params(dense, "w4")
    del dense
    n, e, c, i = (cfg.n_layer, cfg.n_experts, cfg.n_embd,
                  cfg.intermediate_size)
    stacks = {}
    for key, (cin, cout) in (("moe_wgate", (c, i)), ("moe_wup", (c, i)),
                             ("moe_wdown", (i, c))):
        g = cin // 256 if cin % 256 == 0 else 1
        stacks[key] = quant.Int4Tensor(
            q=torch.empty((n, e, cin // 2, cout), dtype=torch.int8,
                          device=device),
            s=torch.empty((n, e, g, 1, cout), dtype=torch.float32,
                          device=device))
    routers = []
    for layer in range(n):
        ex = P.draw_llama_experts(seed + 1, cfg, [layer], device,
                                  torch.bfloat16)
        routers.append(ex.pop("router")[0])
        for key, w in ex.items():
            for j in range(e):
                w4 = quant.quantize_weight4(w[0, j])
                stacks[key].q[layer, j].copy_(w4.q)
                stacks[key].s[layer, j].copy_(w4.s)
        del ex
    tree["h"].update(stacks, router=torch.stack(routers))
    return tree


def _moe_f32_check(cfg, scfg, device, card) -> dict:
    """2 layers at full width in f32, dense: the card's 64-token greedy
    chain from the B=1 stream (CUDA graph replays) against the CPU's plain
    ``apply_llama`` teacher-forced on it (``near_tie`` where they part);
    ``moe_ffn`` of layer 0 on the card against the CPU on the same rows;
    the layer's experts quantized ``w4`` through K4 (one launch an
    expert) against JAX's group einsum formulation on the card."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.ops import cuda_int4_mm, moe, quant
    from llmvox_tpu_torch.streams.llm import ByteTokenizer, LlamaStreamModel
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.params import to_torch
    tok = ByteTokenizer()
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    p32 = P.init_llama_params(30, cfg2, device=device)
    speakable_head(p32)
    m32 = LlamaStreamModel(p32, cfg2, tok, block=LLM_BLOCK, device=device)
    m32.warmup()
    ids = _llm_prompt(tok, TEXT, scfg.system_prompt)
    card_chain = llm_chain(m32, ids, LLM_TOKENS // LLM_BLOCK)[:LLM_TOKENS]
    del m32
    lp = {k: v[0] for k, v in p32["h"].items()}
    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn((64, cfg.n_embd), generator=gen, device=device)
    y_card, _ = moe.moe_ffn(x, lp["router"], lp["moe_wgate"], lp["moe_wup"],
                            lp["moe_wdown"], cfg.moe_top_k, drop_free=True)
    cpu = to_torch(p32, "cpu")
    del p32
    lcpu = {k: v[0] for k, v in cpu["h"].items()}
    y_cpu, _ = moe.moe_ffn(x.cpu(), lcpu["router"], lcpu["moe_wgate"],
                           lcpu["moe_wup"], lcpu["moe_wdown"],
                           cfg.moe_top_k, drop_free=True)
    moe_err = ((y_card.cpu() - y_cpu).norm() / y_cpu.norm()).item()
    assert moe_err < 1e-5, moe_err
    seq = torch.tensor([ids + card_chain[:-1]])
    with torch.no_grad():
        forced = llama.apply_llama(cpu, seq, cfg2)[0, len(ids) - 1:]
    ties = []
    for d, logits in enumerate(forced):
        want = int(logits.argmax())
        if want != card_chain[d]:
            ties.append((d, near_tie(logits, want, card_chain[d],
                                     ("moe f32", d, card_chain))))
    text = tok.decode(card_chain)
    assert text and all(32 <= ord(ch) < 127 for ch in text), text
    # the w4 experts: K4 per expert against JAX's group einsum, on the card
    w4 = quant.quantize_weight4(lcpu["moe_wup"].to(device))
    del cpu, lcpu
    xe = torch.randn((cfg.n_experts, 16, cfg.n_embd), generator=gen,
                     device=device).to(torch.bfloat16)
    w4 = quant.Int4Tensor(q=w4.q, s=w4.s.to(torch.bfloat16))
    n0 = cuda_int4_mm.LAUNCHES
    got = moe.expert_matmul(xe, w4)
    launches = cuda_int4_mm.LAUNCHES - n0
    want = moe.expert_matmul_einsum(xe, w4)
    gap = ((got.float() - want.float()).norm() / want.float().norm()).item()
    if torch.device(device).type == "cuda":
        assert launches == cfg.n_experts, launches
    assert gap < W4_EINSUM_GAP, gap
    log(f"[moe] 2 layers at full width, f32: the card's {LLM_TOKENS}-token "
        f"greedy chain against the CPU plain path teacher-forced on it: "
        + (f"{len(ties)} near tie(s) (step, gap in % of the logits' std): "
           f"{ties}" if ties else "every token the CPU's argmax")
        + f"; text {text[:40]!r}...; moe_ffn of 64 rows on the card against "
        f"the CPU: relative error {moe_err:.3g}; w4 moe_wup (8 experts, 16 "
        f"rows each, bf16) through K4 ({launches} launches) against JAX's "
        f"group einsum on the card: relative gap {gap:.3g} ({card})")
    return {"ties": len(ties), "moe_ffn_rel_err": moe_err,
            "w4_einsum_gap": gap}


def _moe_step_ms(pool, attn: int, width: int) -> float:
    """One pooled block of ``width`` as a graph replay (device time, CUDA
    events, median of 3), 8 rows active at pos attn - width, over its
    width."""
    from llmvox_tpu_torch.utils.graphs import fill
    g = pool._graphs.get(("block", attn, width))
    times = []
    for _ in range(3):
        fill(pool._in, np.ones(pool.B, np.int32))
        pool.state.pos.fill_(attn - width)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        g.graph.replay()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / width)
    pool.state.pos.zero_()
    pool.state.tok.zero_()
    return statistics.median(times)


def phase_moe(engines, weights, card: str, device="cuda", cfg=None,
              graphs=None) -> dict:
    """The mixture-of-experts Llama at mistralai/Mixtral-8x7B-Instruct-
    v0.1's published geometry (random seeded weights, the head zeroed but
    for the printable byte ids, the byte tokenizer; cut: KV 1024 of 32768,
    pool prefill bucket 128 only, no chunked prefill and no first block
    in the pool; depth BIG_DEPTH of 32).  (1) 2 layers at full width in
    f32 (``_moe_f32_check``).  (2) BIG_DEPTH layers quantized w4
    (``draw_moe_w4``: at 32 layers 46.7 B parameters are 93 GB in
    bf16): the B=1 stream's 32-token block and an 8-row pooled step as
    graph replays beside the byte bound (every expert's packed bytes:
    drop-free routing runs every expert), and the B=1 block beside the routed bound (the chosen experts' bytes); one
    ``/tts`` on the B=1 stream with the dedicated replicas and a burst of
    4 through an 8-slot pool with a 16-slot bf16 TTS pool, each answered,
    0 captures while serving; K4's launches on each (28 a layer per token
    step and per prefill program)."""
    from llmvox_tpu_torch.models import llama
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.streams.llm import ByteTokenizer, LlamaStreamModel
    dec_p, _, table, dcfg, _, scfg = weights
    cfg = cfg or llama.LlamaConfig(**MIXTRAL_8X7B)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    out = {"card": card, "f32": _moe_f32_check(cfg, scfg, device, card)}
    if on_card:
        torch.cuda.empty_cache()
    log(f"[moe] cuts: KV {cfg.max_seq_len} (of 32768), pool prefill "
        f"buckets {MOE_POOL_BUCKETS} (not {LLM_POOL_BUCKETS}), no chunked "
        f"prefill and no {LLM_FIRST_BLOCK}-token first block in the pool")

    t0 = time.perf_counter()
    tree = draw_moe_w4(32, cfg, device)
    _sync(device)
    out["draw_s"] = time.perf_counter() - t0
    out["stored_bytes"] = quant.quantized_bytes(tree)
    log(f"[moe] {cfg.n_layer} layers, w4: {out['stored_bytes']} bytes "
        f"stored, drawn and quantized on the device a layer at a time in "
        f"{out['draw_s']:.2f} s")
    model = LlamaStreamModel(tree, cfg, tok, block=LLM_BLOCK,
                             max_tokens=LLM_TOKENS, device=device,
                             dtype=torch.bfloat16)
    n_cap = captures()
    model.warmup()
    out["b1_captures"] = captures() - n_cap
    if on_card:
        out["b1_block"] = _llm_block_times(model, None, model.params, cfg,
                                           card, "MoE w4", (128, 1024))
        # what the function needs: the dense part and, a layer, the
        # top_k chosen experts' packed bytes (drop-free runs all E)
        es = model.state.k.element_size()
        for attn, row in out["b1_block"].items():
            bound, by = llm_token_bound_ms(
                model.params, cfg, attn - LLM_BLOCK // 2, es,
                expert_share=cfg.moe_top_k / cfg.n_experts)
            row["routed_bound_ms"], row["routed_bound_by"] = bound, by
            log(f"[moe] B=1 at attn_len {attn}: routed bound {bound:.3f} ms "
                f"({by}; the dense part and {cfg.moe_top_k} of "
                f"{cfg.n_experts} experts' packed bytes a layer), "
                f"{bound / row['ms_per_token'] * 100:.1f}% of the measured "
                f"{row['ms_per_token']:.3f} ms a token ({card})")
    tokens0 = model.tokens
    b1 = out["b1_served"] = _serve_llm(model, engines, weights, 1,
                                       "MoE w4", card, device)
    k4_b1 = MOE_K4_PER_LAYER * cfg.n_layer * (model.tokens - tokens0 + 1)
    if on_card:
        assert b1["k4_launches"] == k4_b1, (b1["k4_launches"], k4_b1)
    log(f"[moe] B=1 request: K4 launches {b1['k4_launches']} = "
        f"{MOE_K4_PER_LAYER} x {cfg.n_layer} layers x "
        f"({model.tokens - tokens0} tokens + 1 prefill); K1 "
        f"{b1['k1_launches']} on the replicas, K2 {b1['k2_launches']}, K3 "
        f"{b1['k3_launches']}")
    del model

    # chunked prefill off: the burst's suffixes (the system prompt's
    # prefix cached) fit the top bucket, and each continuation graph of
    # the MoE takes ~5 s to capture; no 16-token first block (phase 16
    # serves it on the dense pool): its block graph at every attention
    # rung is another ~7 s each
    pmodel = make_llm_pool(tree, cfg, tok, scfg.system_prompt, device,
                           torch.bfloat16, buckets=MOE_POOL_BUCKETS,
                           graphs=graphs, chunked_prefill=False,
                           first_block=0)
    del tree
    pool = pmodel.pool
    n_cap = captures()
    t0 = time.perf_counter()
    pmodel.warmup()
    out["pool_warmup_s"] = time.perf_counter() - t0
    out["pool_captures"] = captures() - n_cap
    log(f"[moe] w4 pool of {pool.B}: {out['pool_captures']} CUDA graphs in "
        f"{out['pool_warmup_s']:.2f} s; {graphs_text()}")
    if on_card:
        es = pool.state.k.element_size()
        out["pool_step"] = {}
        for attn in (128, 1024):
            ms = _moe_step_ms(pool, attn, LLM_BLOCK)
            bound, by = llm_pool_step_bound_ms(pool.params, cfg, pool.B,
                                               attn - LLM_BLOCK // 2, es)
            out["pool_step"][attn] = {"ms": ms, "bound_ms": bound,
                                      "bound_by": by}
            log(f"[moe] w4 pooled step, {pool.B} rows at attn_len {attn}: "
                f"{ms:.3f} ms (device time; {pool.B * 1e3 / ms:.0f} "
                f"tokens/s), bound {bound:.3f} ms ({by}, "
                f"{bound / ms * 100:.0f}% of it) ({card})")
    tts_pool = DecodePool(dec_p, table, engines[0].codec, capacity=16,
                          dcfg=dcfg, scfg=dataclasses.replace(
                              scfg, pool_capacity=16),
                          device=device, cache_dtype=torch.bfloat16)
    tts_pool.warmup()
    steps0, calls0 = pool.decode_steps, pool.prefill_calls
    burst = [_burst_text(n, r) for r, n in
             enumerate(BURST_LENGTHS[:MOE_BURST])]
    out["burst"] = _serve_pool(pmodel, tts_pool, weights, burst,
                               f"MoE w4 {MOE_BURST}-way burst", card)
    k4 = MOE_K4_PER_LAYER * cfg.n_layer * (pool.decode_steps - steps0
                                           + pool.prefill_calls - calls0)
    if on_card:
        assert out["burst"]["k4_launches"] == k4 > 0, (
            out["burst"]["k4_launches"], k4)
    for k in ("k1", "k2", "k3", "k4"):
        out[f"{k}_launches"] = (b1[f"{k}_launches"]
                                + out["burst"][f"{k}_launches"])
    log(f"[moe] w4 burst: K4 launches {out['burst']['k4_launches']} = "
        f"{MOE_K4_PER_LAYER} x "
        f"{cfg.n_layer} layers x ({pool.decode_steps - steps0} pooled token "
        f"steps + {pool.prefill_calls - calls0} prefill programs); K2 "
        f"{out['burst']['k2_launches']} on the TTS pool")
    tts_pool.stop()
    del pmodel, pool, tts_pool
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    if on_card:
        torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[moe] phase 18 took {out['phase_s']:.1f} s"
        + (f", peak device memory {out['peak_gb']:.2f} GB" if on_card
           else "") + f" ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 15: /voicechat with the in-framework Whisper ASR
# ---------------------------------------------------------------------------

WHISPER_LARGE_V3 = dict(vocab_size=51866, n_mels=128, d_model=1280,
                        enc_layers=BIG_DEPTH, dec_layers=BIG_DEPTH,
                        enc_heads=20,
                        dec_heads=20, enc_ffn=5120, dec_ffn=5120,
                        max_source_positions=1500, max_target_positions=448,
                        decoder_start_token_id=50258, eos_token_id=50257)
ASR_BUCKETS = (600, 1200, 3000)   # the default asr_ctx_buckets (mel frames)
ASR_PRINTABLE = range(0x20, 0x7f)  # the smoke tokenizer's printable ids
ASR_SECONDS = (3.0, 6.5, 10.0)     # the served requests' audio


class PrintableIds:
    """The smoke's Whisper tokenizer: id i in 0x20..0x7e is chr(i); every
    other id (the specials among them) is dropped.  The card's machine has
    no transformers, so no ``WhisperTokenizer``."""

    def decode(self, ids, skip_special_tokens=True) -> str:
        return "".join(chr(i) for i in ids if i in ASR_PRINTABLE)


def asr_generation(cfg) -> dict:
    """A generation config in large-v3's ids (four of its languages, the
    tasks, no-timestamps, max_length 448) whose ``suppress_tokens`` mask
    every id but the printable ones and EOS: a random 51866-way tied head
    then writes printable transcripts through JAX's own ``_suppress``
    mechanism.  ``begin_suppress`` keeps EOS and the space off the first
    token, as large-v3's does."""
    eos = cfg.eos_token_id
    keep = set(ASR_PRINTABLE) | {eos}
    return {"lang_to_id": {"<|en|>": 50259, "<|zh|>": 50260,
                           "<|de|>": 50261, "<|es|>": 50262},
            "task_to_id": {"translate": 50359, "transcribe": 50360},
            "no_timestamps_token_id": 50364,
            "suppress_tokens": [i for i in range(cfg.vocab_size)
                                if i not in keep],
            "begin_suppress_tokens": [0x20, eos],
            "max_length": cfg.max_target_positions}


def speechish(seconds: float, seed: int, sr: int = 16000) -> np.ndarray:
    """A speech-like signal at ``sr``: voiced harmonics under a
    syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.5 * t) ** 2
    return (0.3 * env * voiced + 0.02 * rng.standard_normal(t.size)).astype(
        np.float32)


def _b64_pcm(audio: np.ndarray) -> str:
    import base64
    return base64.b64encode((audio * 32767 / np.abs(audio).max()).astype(
        np.int16).tobytes()).decode()


def make_asr(params, cfg, scfg, device, buckets=ASR_BUCKETS, graphs=None):
    """The in-framework ASR on ``params`` (kept in their dtype, as JAX's
    ``build_asr`` keeps a loaded checkpoint's), the smoke's generation
    config and tokenizer, the given context buckets."""
    from llmvox_tpu_torch.streams.asr import WhisperModelASR
    asr = WhisperModelASR(dataclasses.replace(
        scfg, asr_backend="jax", asr_ctx_buckets=buckets),
        device=device, graphs=graphs)
    asr.cfg = cfg
    asr._finish_load(params, asr_generation(cfg), PrintableIds())
    return asr


def asr_chain(asr, audio, language, n_blocks: int = 2):
    """The prep's first token and ``n_blocks`` decode blocks, issued as
    ``transcribe_stream`` issues them (frozen EOS rows included); returns
    (bucket frames, forced prompt as the prep left it, tokens)."""
    frames, _, first = asr._prep_single(audio, "transcribe", language,
                                        asr._pick_ctx(len(audio)))
    out = [first]
    for _ in range(n_blocks):
        out += asr._wait(asr._issue(asr._decode, frames))[0].tolist()
    forced = asr._buckets[frames].forced.cpu().tolist()
    return frames, forced, out


def _allowed_tie(logits, want, got, allowed, what) -> float:
    """``near_tie`` over the logits the generation config leaves."""
    idx = {t: i for i, t in enumerate(allowed.tolist())}
    return near_tie(logits[allowed], idx[want], idx[got], what)


def _asr_small_check(cfg, scfg, device, card, graphs) -> dict:
    """2 + 2 layers at full width, f32, the card against the CPU's plain
    path from the same seed, at the 1200-frame bucket (language forced) and
    at the full window (language detected)."""
    from llmvox_tpu_torch.models import whisper as W
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.params import to_torch
    cfg2 = dataclasses.replace(cfg, enc_layers=2, dec_layers=2)
    p2 = P.init_whisper_params(20, cfg2, device=device)
    cpu_p = to_torch(p2, "cpu")
    asr = make_asr(p2, cfg2, scfg, device, buckets=(1200, 3000),
                   graphs=graphs)
    asr.warmup()
    gen = asr_generation(cfg2)
    allowed = torch.tensor(sorted(set(ASR_PRINTABLE) | {cfg2.eos_token_id}))
    out = {}
    for seconds, language in ((9.0, "en"), (20.0, None)):
        audio = speechish(seconds, 30)
        ctx = asr._pick_ctx(len(audio))
        pad = W.pad_or_trim(audio, cfg2, ctx)
        # each function on the same inputs, card against CPU
        mel = W.log_mel(torch.from_numpy(pad), cfg2)
        mel_err = (W.log_mel(torch.from_numpy(pad).to(device), cfg2).cpu()
                   - mel).abs().max().item()
        enc = W.encode(cpu_p, mel, cfg2)
        enc_err = (W.encode(p2, mel.to(device), cfg2).cpu()
                   - enc).abs().max().item()
        cross = W.make_cross_kv(cpu_p, enc, cfg2)
        frames, forced, chain = asr_chain(asr, audio, language)
        card_cross = W.CrossKV(cross.k.to(device), cross.v.to(device))
        logits, _ = W.prefill(cpu_p, torch.tensor([forced]),
                              W.init_whisper_decode_state(cfg2), cross, cfg2)
        card_logits, _ = W.prefill(
            p2, torch.tensor([forced], device=device),
            W.init_whisper_decode_state(cfg2, device=device), card_cross,
            cfg2)
        logit_err = (card_logits.cpu() - logits).abs().max().item()
        assert mel_err <= 2e-4 and enc_err <= 2e-5 and logit_err <= 2e-5, (
            seconds, mel_err, enc_err, logit_err)
        # the detected language: the CPU's [sot] argmax over the languages
        langs = sorted(gen["lang_to_id"].values())
        if language is None:
            sot, _ = W.prefill(cpu_p, torch.tensor([forced[:1]]),
                               W.init_whisper_decode_state(cfg2), cross,
                               cfg2)
            row = sot[0, 0][langs]
            want = langs[int(row.argmax())]
            if want != forced[1]:
                near_tie(row, langs.index(want), langs.index(forced[1]),
                         ("asr detect", seconds))
        # the card's chain (graph replays) against the CPU teacher-forced on
        # it, to its first EOS: every divergence a near tie
        end = (chain.index(cfg2.eos_token_id) + 1
               if cfg2.eos_token_id in chain else len(chain))
        seq = torch.tensor([forced + chain[:end - 1]])
        with torch.no_grad():
            forced_logits, _ = W.prefill(cpu_p, seq,
                                         W.init_whisper_decode_state(cfg2),
                                         cross, cfg2)
        first_allowed = torch.tensor(
            [t for t in allowed.tolist()
             if t not in gen["begin_suppress_tokens"]])
        ties = []
        for d in range(end):
            row = forced_logits[0, len(forced) - 1 + d]
            ids = first_allowed if d == 0 else allowed
            want = int(ids[row[ids].argmax()])
            if want != chain[d]:
                ties.append((d, _allowed_tie(row, want, chain[d], ids,
                                             ("asr f32", seconds, d))))
        text = PrintableIds().decode(chain[:end])
        assert text and all(32 <= ord(c) < 127 for c in text), text
        out[frames] = {"log_mel_err": mel_err, "encoder_err": enc_err,
                       "logits_err": logit_err, "tokens": end,
                       "ties": len(ties)}
        log(f"[asr] 2+2 layers at full width, f32, bucket {frames} "
            f"({seconds:.1f} s, language "
            f"{'forced en' if language else 'detected'}: forced prompt "
            f"{forced}): card against CPU log_mel max |diff| {mel_err:.2e} "
            f"(<= 2e-4), encoder {enc_err:.2e}, prefill logits "
            f"{logit_err:.2e} (<= 2e-5); the card's {end}-token greedy chain "
            f"(prep + 2 CUDA graph blocks) against the CPU teacher-forced: "
            + (f"{len(ties)} near tie(s) {ties}" if ties else
               "every token the CPU's argmax") + f"; text {text[:32]!r}")
    return out


def asr_token_bound_ms(params, cfg, frames: int, pos: int, es: int) -> tuple:
    """Least time for one decode token: the decoder's layer weights and the
    tied head (0.905 B values at large-v3) read once, one embedding and one
    position row, the bucket's cross-KV and ``pos`` self-KV rows of every
    layer, over HBM's rate; or two flops a weight and the attention's
    products over the dtype's peak."""
    d, s = cfg.d_model, frames // 2
    dec = params["dec"]
    n_layer_w = sum(v.numel() for v in dec["h"].values())
    n_w = n_layer_w + dec["tok_emb"].numel()
    kv = 2 * cfg.dec_layers * (s + pos) * d
    nbytes = (n_w + 2 * d + kv) * es
    flops = 2 * n_w + 2 * kv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dec["tok_emb"].dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def asr_prep_bound_ms(params, cfg, frames: int, n_forced: int) -> tuple:
    """Least time for a prep: the convolutions, the encoder layers
    (projections, the FFN, the S x S attention), the cross-KV projections
    and the forced prompt's prefill with the head at every position, over
    the dtype's peak; or every weight, the audio and the cross-KV written,
    over HBM's rate."""
    from llmvox_tpu_torch.ops import quant
    d, f, s = cfg.d_model, cfg.enc_ffn, frames // 2
    dtype = params["dec"]["tok_emb"].dtype
    es = torch.finfo(dtype).bits // 8
    enc = (2 * 3 * cfg.n_mels * d * frames + 2 * 3 * d * d * s
           + cfg.enc_layers * (2 * s * (4 * d * d + 2 * d * f)
                               + 4 * s * s * d))
    cross = 2 * 2 * cfg.dec_layers * s * d * d
    n_dec = sum(v.numel() for v in params["dec"]["h"].values())
    prefill = 2 * n_forced * (n_dec + params["dec"]["tok_emb"].numel())
    nbytes = (quant.quantized_bytes(params) + frames * cfg.hop_length * 4
              + 2 * cfg.dec_layers * s * d * es)
    t_ops = (enc + cross + prefill) / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), enc + cross + prefill


def _replay_ms(graph, reps: int = 3) -> float:
    """Device time of one replay, CUDA events, the median of ``reps``."""
    times = []
    for _ in range(reps):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    return statistics.median(times)


def _asr_depth(cfg, scfg, device, card, dtype, seed, graphs) -> tuple:
    """BIG_DEPTH layers in ``dtype``: the warmup's captures, the graph and
    eager chains equal (prep + 2 blocks, language detected and forced), and
    on a card the prep's and the block's device times at every bucket
    beside their bounds.  Returns (numbers, the graph ASR)."""
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.utils import graphs as G
    from llmvox_tpu_torch.utils import params as P
    name = "f32" if dtype == torch.float32 else "bf16"
    t0 = time.perf_counter()
    params = P.init_whisper_params(seed, cfg, device=device, dtype=dtype)
    _sync(device)
    n_bytes = quant.quantized_bytes(params)
    log(f"[asr] {cfg.enc_layers}+{cfg.dec_layers} layers, {n_bytes} bytes "
        f"of {name} weights, drawn on the device in "
        f"{time.perf_counter() - t0:.2f} s")
    asr = make_asr(params, cfg, scfg, device, graphs=graphs)
    n_cap, s0 = captures(), G.CAPTURE_S
    asr.warmup()
    out = {"captures": captures() - n_cap, "capture_s": G.CAPTURE_S - s0}
    log(f"[asr] {name} warmup: {out['captures']} CUDA graphs (per bucket "
        f"{list(ASR_BUCKETS)}: prep, prep with language detection, "
        f"{asr.decode_block_size}-token block) in {out['capture_s']:.2f} s; "
        f"{graphs_text()}; " + uploads_text(asr._preps, asr._blocks))
    eager = make_asr(params, cfg, scfg, device, graphs=False)
    for seconds, language in ((3.0, None), (10.0, "en")):
        audio = speechish(seconds, 40)
        got, want = asr_chain(asr, audio, language), asr_chain(
            eager, audio, language)
        assert got == want, (name, seconds, got, want)
        log(f"[asr] {name}: graph and eager chains equal at bucket "
            f"{got[0]} (language {language or 'detected'}, forced "
            f"{got[1]}): {len(got[2])} tokens "
            f"{PrintableIds().decode(got[2])[:32]!r}")
    del eager
    if torch.device(device).type == "cuda":
        es = params["dec"]["tok_emb"].element_size()
        out["prep_ms"], out["block_ms_per_token"] = {}, {}
        for frames in ASR_BUCKETS:
            pos = asr._forced_len
            ms = _replay_ms(asr._preps.get((frames, False)).graph)
            bound, by, flops = asr_prep_bound_ms(params, cfg, frames, pos)
            out["prep_ms"][frames] = {"ms": ms, "bound_ms": bound,
                                      "bound_by": by,
                                      "tflop_s": flops / ms / 1e9}
            bk = asr._buckets[frames]
            bk.state.pos.fill_(pos)
            bk.state.done.zero_()
            block = asr._blocks.get(frames).graph
            times = []
            for _ in range(3):
                bk.state.pos.fill_(pos)
                times.append(_replay_ms(block, reps=1)
                             / asr.decode_block_size)
            tok_ms = statistics.median(times)
            tb, tby = asr_token_bound_ms(
                params, cfg, frames, pos + asr.decode_block_size // 2, es)
            out["block_ms_per_token"][frames] = {"ms": tok_ms,
                                                 "bound_ms": tb,
                                                 "bound_by": tby}
            log(f"[asr] {name} bucket {frames}: prep (mel, encoder, "
                f"cross-KV, forced prefill) one replay {ms:.3f} ms, bound "
                f"{bound:.3f} ms ({by}, {bound / ms * 100:.0f}% of it, "
                f"{flops / ms / 1e9:.1f} TFLOP/s); {asr.decode_block_size}"
                f"-token block {tok_ms:.3f} ms a token, bound {tb:.3f} ms "
                f"({tby}, {tb / tok_ms * 100:.0f}% of it) ({card})")
    return out, asr


def _serve_voicechat(asr, model, engines, weights, card: str) -> dict:
    """Three sequential ``POST /voicechat`` (base64 int16 PCM of
    ``ASR_SECONDS`` of speech-like audio, source and target "english")
    through ``build_server`` with ``chat_type`` "voice": ``asr`` transcribes
    (the card has no transformers, so "english" resolves to no language
    token and the language is detected, as JAX would without it),
    ``model`` (the LLM) replies, the replicas speak.  Per request the
    transcript's time, the first text delta, TTFA, RTF and the loop's
    lag."""
    from llmvox_tpu_torch.ops import cuda_attn
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    port = _free_port()
    cfg = dataclasses.replace(
        scfg, api_port=port, scripted_reply="", chat_type="voice",
        asr_backend="jax", llm_backend="jax", llm_block=LLM_BLOCK,
        llm_max_tokens=LLM_TOKENS, llm_temperature=0.0)
    stamps, prompts, asr_s = [], [], []
    _timed_predict(model, stamps)
    orig_predict, orig_run = model.predict, asr.run_asr
    served_captures = None

    def predict(request):
        prompts.append(request["prompt"])
        return orig_predict(request)

    def run_asr(body):
        t0 = time.perf_counter()
        text = orig_run(body)
        asr_s.append(time.perf_counter() - t0)
        return text

    model.predict, asr.run_asr = predict, run_asr
    n_cap = captures()
    rows, bodies = [], []
    try:
        with _Server(build_server(cfg, engines, stream_model=model,
                                  asr_model=asr), port) as server:
            assert captures() == n_cap, "build_server captured again"
            cuda_attn.LAUNCHES = 0
            steps0 = sum(e.decode_steps for e in engines)
            for r, seconds in enumerate(ASR_SECONDS):
                body = {"audio_base64": _b64_pcm(speechish(seconds, 50 + r)),
                        "source_language": "english",
                        "target_language": "english"}
                bodies.append(body)
                lag = _LoopLag(server.loop)
                t0 = time.perf_counter()
                chunks = post_chunks("127.0.0.1", port, "/voicechat", body,
                                     timeout=300)
                wall = time.perf_counter() - t0
                lag = lag.stop()
                assert chunks and all(len(c) % (4 * ccfg.hop_length) == 0
                                      for _, c in chunks), "ragged chunk"
                wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
                assert np.isfinite(wav).all(), "non-finite samples"
                text = prompts[-1]
                assert text and all(32 <= ord(c) < 127 for c in text), text
                audio_s = len(wav) / ccfg.sample_rate
                row = {"audio_in_s": seconds,
                       "bucket": asr._pick_ctx(int(16000 * seconds)),
                       "transcript_ms": asr_s[-1] * 1e3,
                       "transcript_chars": len(text),
                       "first_delta_ms": (asr_s[-1] + stamps[-1]) * 1e3,
                       "ttfa_ms": chunks[0][0] * 1e3, "rtf": wall / audio_s,
                       "audio_s": audio_s, "lag_median_ms": lag["median_ms"],
                       "lag_max_ms": lag["max_ms"]}
                rows.append(row)
                log(f"[asr] /voicechat request {r} ({seconds:.1f} s of "
                    f"audio, bucket {row['bucket'] or 3000}): transcript "
                    f"{row['transcript_ms']:.1f} ms ({len(text)} chars "
                    f"{text[:24]!r}), first text delta "
                    f"{row['first_delta_ms']:.1f} ms, first audio "
                    f"{row['ttfa_ms']:.1f} ms, wall {wall * 1e3:.1f} ms, "
                    f"{audio_s:.2f} s audio out, RTF {row['rtf']:.3f}; "
                    f"{_lag_text(lag)} ({card})")
            k1 = cuda_attn.LAUNCHES
            steps = sum(e.decode_steps for e in engines) - steps0
        served_captures = captures() - n_cap
    finally:
        del model.predict, asr.run_asr
    assert served_captures == 0, "a CUDA graph was captured while serving"
    assert k1 == dcfg.n_layer * steps > 0, (k1, steps)
    # the served transcript is the ASR's, as run_asr gives it again
    assert asr.run_asr(bodies[0]) == prompts[0], prompts[0]
    return {"requests": rows, "captures_while_serving": served_captures,
            "k1_launches": k1, "tts_steps": steps}


def _serve_voicechat_pooled(asr, model, engines, weights, card: str
                            ) -> dict:
    """Three ``POST /voicechat`` (``_serve_voicechat``'s bodies) with the
    pooled LLM stream ``model``, first overlapped (``s2s_overlap``: the
    ASR's partial transcripts stream into the pool's prefill, through
    ``predict_streaming``), then serial (the whole transcript, then
    ``predict``), in one process on the dedicated replicas.  Per request
    the transcript's time, the first text delta and TTFA."""
    from llmvox_tpu_torch.ops import cuda_attn
    from llmvox_tpu_torch.serve.client import post_chunks
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    out = {"k1_launches": 0}
    for overlap in (True, False):
        what = "overlapped" if overlap else "serial"
        port = _free_port()
        cfg = dataclasses.replace(
            scfg, api_port=port, scripted_reply="", chat_type="voice",
            asr_backend="jax", llm_backend="jax", s2s_overlap=overlap)
        stamps, asr_s = {}, []
        orig_stream, orig_run = asr.transcribe_stream_async, asr.run_asr
        _timed_stream(model, stamps, "predict")
        _timed_stream(model, stamps, "predict_streaming")

        def stream(*a, **k):
            t0 = time.perf_counter()

            async def gen():
                async for item in orig_stream(*a, **k):
                    yield item
                asr_s.append(time.perf_counter() - t0)
            return gen()

        def run_asr(body):
            t0 = time.perf_counter()
            text = orig_run(body)
            asr_s.append(time.perf_counter() - t0)
            return text

        asr.transcribe_stream_async, asr.run_asr = stream, run_asr
        n_cap = captures()
        rows = []
        try:
            with _Server(build_server(cfg, engines, stream_model=model,
                                      asr_model=asr), port) as server:
                cuda_attn.LAUNCHES = 0
                steps0 = sum(e.decode_steps for e in engines)
                for r, seconds in enumerate(ASR_SECONDS):
                    body = {"audio_base64": _b64_pcm(speechish(seconds,
                                                               50 + r)),
                            "source_language": "english",
                            "target_language": "english"}
                    lag = _LoopLag(server.loop)
                    t0 = time.perf_counter()
                    chunks = post_chunks("127.0.0.1", port, "/voicechat",
                                         body, timeout=300)
                    wall = time.perf_counter() - t0
                    lag = lag.stop()
                    wav = np.frombuffer(b"".join(c for _, c in chunks),
                                        "<f4")
                    assert chunks and np.isfinite(wav).all()
                    rec = stamps["predict_streaming" if overlap
                                 else "predict"][-1]
                    first = rec["first"] + (0.0 if overlap else asr_s[-1])
                    rows.append({"audio_in_s": seconds,
                                 "transcript_ms": asr_s[-1] * 1e3,
                                 "first_delta_ms": first * 1e3,
                                 "ttfa_ms": chunks[0][0] * 1e3,
                                 "wall_ms": wall * 1e3,
                                 "lag_max_ms": lag["max_ms"]})
                    log(f"[asr] pooled /voicechat, {what}, request {r} "
                        f"({seconds:.1f} s of audio): transcript "
                        f"{asr_s[-1] * 1e3:.1f} ms, first text delta "
                        f"{first * 1e3:.1f} ms, first audio "
                        f"{chunks[0][0] * 1e3:.1f} ms, wall "
                        f"{wall * 1e3:.1f} ms; {_lag_text(lag)} ({card})")
                k1 = cuda_attn.LAUNCHES
                steps = sum(e.decode_steps for e in engines) - steps0
            served = captures() - n_cap
        finally:
            del model.predict, model.predict_streaming
            del asr.transcribe_stream_async, asr.run_asr
        assert served == 0, "a CUDA graph was captured while serving"
        used = {k: len(v) for k, v in stamps.items()}
        assert used == ({"predict_streaming": 3} if overlap
                        else {"predict": 3}), used
        assert k1 == dcfg.n_layer * steps > 0, (k1, steps)
        out[what] = rows
        out["k1_launches"] += k1
    log(f"[asr] pooled /voicechat: K1 launches {out['k1_launches']} on the "
        f"dedicated replicas over the six requests")
    return out


def phase_asr(engines, weights, card: str, llm_model, llm=None,
              device="cuda", cfg=None, graphs=None, pooled=None) -> dict:
    """``/voicechat`` with the in-framework Whisper (``streams/asr.py``) at
    openai/whisper-large-v3's geometry, random seeded weights, the
    smoke's printable-id tokenizer and generation config
    (``asr_generation``).  (1) 2 + 2 layers at full width in f32, card
    against the CPU (``_asr_small_check``).  (2) BIG_DEPTH + BIG_DEPTH
    layers in f32 (as served: JAX's ``build_asr`` keeps a checkpoint's f32)
    and in bf16: the captures, graph and eager chains equal, the prep and
    block times per bucket (``_asr_depth``).  (3) three ``/voicechat``
    requests with the f32 ASR, phase 14's bf16 LLM stream (its captures
    reused) and the dedicated replicas (``_serve_voicechat``).  (4) ``--quantize w4`` with
    the in-framework ASR is refused.  (5) With ``pooled`` (phase 16's bf16
    pooled LLM stream), three ``/voicechat`` overlapped and three serial
    through it (``_serve_voicechat_pooled``).  ``graphs`` goes to the
    graph ASRs (None: on for a card)."""
    from llmvox_tpu_torch.models import whisper as W
    from llmvox_tpu_torch.streams.asr import WhisperModelASR
    scfg = weights[5]
    cfg = cfg or W.WhisperConfig(**WHISPER_LARGE_V3)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"card": card,
           "small": _asr_small_check(cfg, scfg, device, card, graphs)}
    out["bf16"], asr = _asr_depth(cfg, scfg, device, card, torch.bfloat16,
                                  22, graphs)
    del asr
    out["f32"], asr = _asr_depth(cfg, scfg, device, card, torch.float32,
                                 21, graphs)
    out["served"] = _serve_voicechat(asr, llm_model, engines, weights, card)
    if llm is not None:
        out["llm_tts"] = llm["served"]["requests"]
    try:
        WhisperModelASR(dataclasses.replace(scfg, asr_backend="jax",
                                            quantize="w4"), device=device)
    except ValueError as e:
        assert "346-349" in str(e) and "ROADMAP" in str(e), e
        log(f"[asr] --quantize w4 with the in-framework ASR refused: {e}")
    else:
        raise AssertionError("a quantized in-framework ASR was built")
    if pooled is not None:
        out["pooled"] = _serve_voicechat_pooled(asr, pooled, engines,
                                                weights, card)
    out["phase_s"] = time.perf_counter() - t0
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[asr] phase 15 took {out['phase_s']:.1f} s"
        + (f", peak device memory {out['peak_gb']:.2f} GB" if on_card else "")
        + f" ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 22: data parallelism
# ---------------------------------------------------------------------------

DP_MAX_WORLD = 4          # ranks and pool shards: every card, up to 4
DP_TRAIN_T = 512          # the decoder check's sequence width (cut for time)
DP_POOL_CAP = 16
DP_POOL_TOKENS = 64       # each served bf16 chain held by check_chain
DP_AUDIO_TOKENS = 96      # the pool rounds' length cap (cut for time)
# the codec trainer's params after two steps, data-parallel against one
# process on the card: Adam's first steps move an element by about lr
# whatever its gradient's size, so where a gradient lies within rounding of
# 0 (or a leaky ReLU's slope flips) two f32 runs part by up to ~2 lr; the
# port's one-process bound against JAX (tests/test_torch_codec_train.py):
# rtol 2e-3, atol 5e-5, at most 1 element in 1000 outside
DP_CODEC_PARAM_TOL = (2e-3, 5e-5)
# the codec trainer's logs, data-parallel against one process: the ranks'
# gradients are summed in another order, and the generator's gradient
# norm (commitment x 1000 over every code) moves by ~2e-4 relative between
# two f32 runs (both f32 runs 1e-4 to 2e-4 off the f64 run's in a CPU
# rehearsal at a small config), above phase 20's 1e-4 between two
# devices' single runs of one batch; a log the one-process f32 run gets
# farther from the f64 run than this (a leaky ReLU's slope flipped there)
# is held to the f64 run instead
DP_CODEC_LOG_RTOL = 1e-3


def dp_layout(device="cuda") -> tuple:
    """(world, backend, each rank's device): NCCL over every card up to
    ``DP_MAX_WORLD`` when there are two or more; on one card two gloo
    ranks share it (NCCL refuses two ranks on one GPU, gloo carries
    all_reduce and broadcast of the card's tensors); two gloo ranks on
    the CPU to rehearse."""
    if device == "cpu":
        return 2, "gloo", ["cpu", "cpu"]
    n = torch.cuda.device_count()
    if n >= 2:
        w = min(n, DP_MAX_WORLD)
        return w, "nccl", [f"cuda:{i}" for i in range(w)]
    return 2, "gloo", ["cuda:0", "cuda:0"]


def _dp_decoder_inputs(world: int, cfg=None):
    """Phase 19's f32 check at a global batch of 2 x world rows: the
    deployed width with its draft heads, seeded params, 4 micro-batches
    (bucketed and packed in turn; the ranks' rows hold different numbers
    of valid targets) at T = ``DP_TRAIN_T``, accumulation 2."""
    from llmvox_tpu_torch.train.data import collate, collate_packed
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import DecoderConfig, TrainConfig
    cfg = dataclasses.replace(cfg or DecoderConfig(),
                              n_draft_heads=TRAIN_HEADS)
    rows, t = 2 * world, min(DP_TRAIN_T, cfg.block_size)
    tcfg = TrainConfig(batch_size=rows, gradient_accumulation_steps=2,
                       learning_rate=1e-3, warmup_iters=0, grad_clip=0.1,
                       dp_size=-1)
    rng = np.random.default_rng(22)
    table = P.random_text_table(2, cfg)
    codebook = rng.standard_normal(
        (max(cfg.vocab_size, cfg.eoa_token_id + 1), cfg.speech_embed_dim)
    ).astype(np.float32)
    samples = synthetic_samples(12 * rows, 220, t - 1, cfg)
    batches = []
    for i in range(4):
        part = samples[i * 3 * rows:(i + 1) * 3 * rows]
        batches.append(collate(part[:rows], cfg, bucket=t) if i % 2 == 0
                       else collate_packed(part, cfg, rows=rows,
                                           seq_len=t)[:4])
        assert batches[-1][0].shape == (rows, t)
    return cfg, tcfg, P.init_decoder_params(22, cfg), table, codebook, batches


def _dp_updates(tr, batches, lockstep: bool = True) -> tuple:
    """Micro-steps over ``batches``: (losses, ms of each update: its
    micro-steps between two syncs, lockstep after each update unless
    ``lockstep`` is off)."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    losses, ms, same = [], [], []
    k = tr.tcfg.gradient_accumulation_steps
    for i in range(0, len(batches), k):
        _sync(tr.device)
        t0 = time.perf_counter()
        for b in batches[i:i + k]:
            losses.append(tr.step(*b))
        _sync(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if lockstep and pmesh.world() > 1:
            same.append(_lockstep(list(tr.opt.params) + tr.opt.mu
                                  + tr.opt.nu + tr.opt.acc))
    return losses, ms, same


def _lockstep(tensors) -> bool:
    """Every rank's tensors bitwise equal to rank 0's: a broadcast from
    rank 0 and an exact compare on each rank, agreed by an all-reduce."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    bad = 0
    for t in tensors:
        ref = t.detach().clone()
        pmesh.broadcast_from_master(ref)
        bad += int(not torch.equal(ref, t.detach()))
    flag = torch.tensor([float(bad)], device=tensors[0].device)
    pmesh.all_reduce_([flag])
    return float(flag[0]) == 0.0


def _dp_codec_inputs(world: int, cfg=None, samples: int = 0, **kw):
    """Phase 20's check size at 2 x world crops: ``CodecConfig()`` and
    every discriminator of ``CodecTrainConfig()``, its seeded state, two
    steps' audio."""
    from llmvox_tpu_torch.train import codec_trainer as ct
    from llmvox_tpu_torch.train.vq_train import init_vq_state
    from llmvox_tpu_torch.utils.config import CodecConfig, CodecTrainConfig
    cfg = cfg or CodecConfig()
    samples = samples or CODEC_CHECK_SAMPLES
    tcfg = CodecTrainConfig(batch_size=2 * world, num_samples=samples,
                            dp_size=-1, **kw)
    state = {"gen_params": ct.init_generator_params(40, cfg),
             "disc_params": ct.init_discriminator_params(41, tcfg),
             "vq_state": init_vq_state(42, cfg.vq_bins, cfg.vq_dim)}
    audios = [codec_audio(2 * world, samples, 220 + i) for i in range(2)]
    return cfg, tcfg, state, audios


def _codec_steps(tr, audios) -> tuple:
    """(each step's logs, ms and the codebook after it, lockstep)."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    logs, ms, embeds, same = [], [], [], []
    for audio in audios:
        _sync(tr.device)
        t0 = time.perf_counter()
        logs.append(tr.step(audio))
        _sync(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        embeds.append(tr.vq.embed.detach().cpu().numpy().copy())
        if pmesh.world() > 1:
            same.append(_lockstep(list(tr.gen.params) + list(tr.disc.params)
                                  + list(tr.vq)[:3] + tr.opt_g.mu
                                  + tr.opt_g.nu + tr.opt_d.mu + tr.opt_d.nu))
    return logs, ms, embeds, same


def _params_off(a_params, b_params) -> tuple:
    """(elements off DP_CODEC_PARAM_TOL, elements) between two lists of
    tensors (b the reference)."""
    rtol, atol = DP_CODEC_PARAM_TOL
    off = n = 0
    for a, b in zip(a_params, b_params):
        a, b = a.detach().double(), b.detach().double()
        off += int(((a - b).abs() > atol + rtol * b.abs()).sum())
        n += b.numel()
    return off, n


# phase 22's tensor-parallel checks, in the same ranks: the decoder trainer
# at tp 2 (dp = world / 2), the Llama at tp = world
TP_PROMPT = 16            # the Llama checks' prompt tokens
TP_TOKENS = 16            # the B=1 block
TP_POOL_ROWS = 4          # the pooled step's rows
TP_POOL_BLOCK = 8
TP_F32_DEPTH = 2          # the f32 check's depth (identical tokens)
TP_MOE_DEPTH = 2          # Mixtral-8x7B's depth at tp
TP_MOE_BLOCK = 8
# (name, which geometry, depth, dtype): the bf16 8B run is timed; the f32
# runs' tokens must be identical to one process's; the bf16 8B chains
# equal or at ties (``_held_to``).  A bf16 difference in the residual
# stream can flip an MoE token's top-2 routing at a near tie of the
# router's logits, and its output then differs by a whole expert, so the
# MoE chains are held to one process forced onto the tp run's routes
# (``_routes``), each route it would have taken otherwise at a router tie
TP_RUNS = (("bf16", "llama", BIG_DEPTH, torch.bfloat16),
           ("f32", "llama", TP_F32_DEPTH, torch.float32),
           ("moe", "moe", TP_MOE_DEPTH, torch.bfloat16),
           ("moe f32", "moe", TP_MOE_DEPTH, torch.float32))
# a bf16 chain at tp may part from one process's where the one process's
# own logits (teacher-forced on the tp chain) hold the two tokens within
# this many bf16 ulps of the larger for each rank of the tp group: a
# row-parallel product is the sum of tp partial products, each rounded to
# bf16, added in bf16 in the all-reduce's order, so its rounding grows
# with tp (2 ulps at tp 2; an 8B pooled row parted at 3.0 ulps at tp 4
# over NCCL)
TP_TIE_ULPS = 1
# a token's experts at tp may differ from the ones the one process's own
# router picks (forced onto the tp run's routes, teacher-forced on its
# chain) only where its logits hold the two sets within this many ulps of
# the row's largest |logit| (the logits' dtype) for each rank of the tp
# group: the residual streams differ by the rounding of the row-parallel
# sums (the router logits 4.25 bf16 ulps apart at tp 2)
TP_ROUTE_TIE_ULPS = 2


def tp_sizes(world: int) -> tuple:
    """(the decoder trainer's tp, the Llama's tp) for a world of ranks:
    2 and 2 on two ranks (one card shared over gloo), 2 (dp 2) and 4 on
    four cards over NCCL."""
    return 2, world


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _llama_tree(cfg, seed: int, device, dtype):
    """The seeded tree, its head's non-printable columns zeroed
    (``speakable_head``), drawn alike on every rank of a card."""
    from llmvox_tpu_torch.utils import params as P
    full = P.init_llama_params(seed, cfg, device=device, dtype=dtype)
    speakable_head(full)
    return full


def _tp_prompts(cfg, rows: int) -> tuple:
    """(rows, TP_PROMPT) right-padded printable-id prompts and their
    lengths (the first row full)."""
    rng = np.random.default_rng(16)
    lens = [TP_PROMPT] + [int(x) for x in
                          rng.integers(5, TP_PROMPT, rows - 1)]
    ids = np.zeros((rows, TP_PROMPT), np.int64)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(0x21, 0x7f, n)
    return ids, np.asarray(lens, np.int32)


def _llama_chains(params, cfg, device, dtype, tp=None, pooled=True,
                  block=TP_TOKENS, timed=True, ep=None) -> dict:
    """A B=1 prefill of the first prompt and a greedy block after it
    (then, ``timed``, a second block timed: ms a token), and a pooled
    prefill of ``TP_POOL_ROWS`` prompts with one ``TP_POOL_BLOCK`` block;
    each chain is its first token and the block's.  Under ``tp`` the
    params are this rank's shard and the caches its KV heads; under
    ``ep`` its block of experts."""
    from llmvox_tpu_torch.models import llama as L
    ids, lens = _tp_prompts(cfg, TP_POOL_ROWS)
    out = {}
    with torch.no_grad():
        st = L.init_llama_decode_state(cfg, 1, dtype, device, tp=tp)
        out["cache_bytes"] = _tree_bytes({"k": st.k, "v": st.v})
        lg, st = L.prefill(params, torch.as_tensor(ids[:1], device=device),
                           st, cfg, tp=tp, ep=ep)
        out["logits"] = lg[0].float().cpu()
        first = torch.argmax(lg, dim=-1).to(torch.int32)
        toks, st = L.decode_block(params, first, st, cfg, block=block, tp=tp,
                                  ep=ep)
        out["b1"] = [int(first[0])] + toks[0].tolist()
        if timed:
            _sync(device)
            t0 = time.perf_counter()
            L.decode_block(params, toks[:, -1], st, cfg, block=block, tp=tp,
                           ep=ep)
            _sync(device)
            out["token_ms"] = (time.perf_counter() - t0) * 1e3 / block
        del st
        if pooled:
            pst = L.init_llama_pool_state(cfg, TP_POOL_ROWS, dtype, device,
                                          tp=tp)
            n = TP_POOL_ROWS
            pf, pst = L.prefill_slots(
                params, torch.as_tensor(ids, device=device),
                torch.as_tensor(lens, device=device), pst,
                torch.arange(n, device=device),
                torch.ones(n, dtype=torch.bool, device=device), cfg, tp=tp,
                ep=ep)
            pt, _ = L.decode_block_pooled(
                params, pst, torch.ones(n, dtype=torch.bool, device=device),
                cfg, block=TP_POOL_BLOCK, tp=tp, ep=ep)
            out["pooled"] = [[int(pf[r])] + pt[r].tolist() for r in range(n)]
            del pst
    return out


class _routes:
    """Wraps ``ops/moe.py``'s top-k for the block: ``calls`` gets each
    call's f32 router logits and the experts they pick, on the host.
    With ``forced`` (an earlier run's ``calls``, one per call in order)
    each call is routed to the forced run's experts instead, weighted by
    this run's own logits at them; ``calls`` still holds this run's own
    picks."""

    def __init__(self, forced=None):
        self.forced, self.calls = forced, []

    def __enter__(self):
        from llmvox_tpu_torch.ops import moe
        self.orig = moe.top_k_lower_index

        def top_k(logits, k):
            vals, idx = self.orig(logits, k)
            self.calls.append((logits.detach().float().cpu(), idx.cpu()))
            if self.forced is None:
                return vals, idx
            want = self.forced[len(self.calls) - 1][1].to(idx.device)
            assert want.shape == idx.shape, (want.shape, idx.shape)
            return logits.gather(-1, want), want
        moe.top_k_lower_index = top_k
        return self.calls

    def __exit__(self, *exc):
        from llmvox_tpu_torch.ops import moe
        moe.top_k_lower_index = self.orig


def _ulp(x: float, dtype) -> float:
    """One unit in the last place of ``|x|`` in ``dtype`` (bf16 or f32)."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - bits)


def _route_flips(tp_calls, own_calls, dtype, tp: int, what) -> dict:
    """The tokens whose experts at tp differ from the ones the one
    process's own router picks (``own_calls``, recorded while it was
    forced onto ``tp_calls``), each at a gap of its own logits between
    the two sets within ``TP_ROUTE_TIE_ULPS`` x ``tp`` ulps of the row's
    largest |logit|; and the router logits' largest gap between the runs
    in such ulps."""
    assert len(tp_calls) == len(own_calls), (what, len(tp_calls),
                                             len(own_calls))
    flips, gaps, worst, rows = 0, [], 0.0, 0
    for (tl_, ti), (ol, oi) in zip(tp_calls, own_calls):
        for r in range(ti.shape[0]):
            ulp = _ulp(float(ol[r].abs().max()), dtype)
            worst = max(worst, float((tl_[r] - ol[r]).abs().max() / ulp))
            rows += 1
            mine, theirs = set(oi[r].tolist()), set(ti[r].tolist())
            if mine == theirs:
                continue
            gap = (min(float(ol[r, e]) for e in mine - theirs)
                   - max(float(ol[r, e]) for e in theirs - mine))
            flips += 1
            gaps.append(float(gap / ulp))
            assert 0 <= gap <= TP_ROUTE_TIE_ULPS * tp * ulp, (
                what, r, sorted(mine), sorted(theirs), gap, ulp)
    return {"flips": flips, "rows": rows, "flip_gap_ulps": gaps,
            "router_logits_ulps": worst}


def _forced_logits(full, cfg, prompt, chain) -> torch.Tensor:
    """One process's f32 logits before each token of ``chain``, teacher-
    forced on it through the decode path the chain took (the prompt's
    prefill, then one cached token a step)."""
    from llmvox_tpu_torch.models import llama as L
    dev = full["tok_emb"].device
    dtype = full["tok_emb"].dtype
    with torch.no_grad():
        st = L.init_llama_decode_state(cfg, 1, dtype, dev)
        lg, st = L.prefill(full, torch.as_tensor([list(prompt)], device=dev),
                           st, cfg)
        rows = [lg[0].float()]
        for tok in chain[:-1]:
            lg, st = L.prefill(full, torch.tensor([[tok]], device=dev), st,
                               cfg)
            rows.append(lg[0].float())
    return torch.stack(rows)


def _held_to(full, cfg, chain, prompt, tp: int, what, rows=None) -> str:
    """A tp chain against one process's greedy picks teacher-forced on it
    (``rows``, or ``_forced_logits``'): every token equal, or within
    ``TP_TIE_ULPS`` x ``tp`` bf16 ulps of the one process's pick; returns
    the ties as (step, ulps, % of the std of the printable ids'
    logits)."""
    ties = []
    if rows is None:
        rows = _forced_logits(full, cfg, prompt, chain)
    for d, row in enumerate(rows):
        want, got = int(row.argmax()), chain[d]
        if want == got:
            continue
        top = row[want].abs().item()
        ulp = 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
        gap = (row[want] - row[got]).item()
        std = row[0x20 + 1:0x7e + 2].std().item()
        ties.append((d, gap / ulp, 100 * gap / std))
        assert 0 <= gap <= TP_TIE_ULPS * tp * ulp, (what, d, want, got, gap,
                                                     ulp,
                                               std)
    return ", ".join(f"({d}, {u:.1f} ulps, {p:.3f}%)" for d, u, p in ties)


def _tp_rank(rank: int, world: int, dev, small) -> dict:
    """The tensor-parallel checks on one rank (the group still formed):
    the decoder trainer at tp 2 on phase 22's inputs, then the Llama at
    tp = world: Llama-3.1-8B's geometry at ``BIG_DEPTH`` layers in bf16
    and ``TP_F32_DEPTH`` in f32, Mixtral-8x7B's at ``TP_MOE_DEPTH`` in
    bf16.  Rank 0 keeps what it compares with one process once the
    group is gone (``_tp_one``)."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.parallel import sharding as psh
    from llmvox_tpu_torch.models.llama import LlamaConfig
    from llmvox_tpu_torch.train.trainer import Trainer
    dec_tp, llm_tp = tp_sizes(world)
    _zero_launches()
    cfg, tcfg, params, table, codebook, batches = _dp_decoder_inputs(
        world, small[0])
    tr = Trainer(dataclasses.replace(tcfg, tp_size=dec_tp), cfg, table,
                 codebook, compute_dtype=torch.float32, device=dev,
                 params=params)
    assert (tr.dp, tr.tp) == (world // dec_tp, dec_tp)
    losses, ms, _ = _dp_updates(tr, batches, lockstep=False)
    out = {"decoder": {"losses": losses, "update_ms": ms, "dp": tr.dp,
                       "tp": tr.tp},
           "keep": {"decoder": [t.clone() for t in
                                tr._gather(tr.opt.params)]}}
    del tr
    mp = pmesh.initialize_model_parallel(llm_tp)
    g = mp.tp_group
    geometry = dict(zip(("llama", "moe"), small[4] if len(small) > 4
                        else (LLAMA_8B, MIXTRAL_8X7B)))
    for name, which, depth, dtype in TP_RUNS:
        lcfg = LlamaConfig(**dict(geometry[which], n_layer=depth))
        full = _llama_tree(lcfg, 160, dev, dtype)
        shard = psh.shard_llama(full, lcfg, llm_tp, mp.tp_rank)
        del full
        with _routes() as calls:
            res = _llama_chains(shard, lcfg, dev, dtype, tp=g,
                                pooled=which == "llama",
                                block=TP_TOKENS if which == "llama"
                                else TP_MOE_BLOCK, timed=name == "bf16")
        if which == "moe":
            # the router is replicated: every rank's routes are the same
            res["routes"] = calls
        res["weight_bytes"] = _tree_bytes(shard)
        out[name] = res
        del shard
    out["launches"] = _read_launches()
    out["llm_tp"] = llm_tp
    return out


def _geometry(small) -> dict:
    """The Llama's and the MoE's config fields (the rehearsal's tiny
    ones from ``small``)."""
    return dict(zip(("llama", "moe"), small[4] if len(small) > 4
                    else (LLAMA_8B, MIXTRAL_8X7B)))


def _hold_run(got: dict, which: str, depth: int, dtype, dev, small, n: int,
              name: str, timed: bool, par: str = "tp") -> dict:
    """One process on this card runs the chains a run of ``n`` ranks
    (tp or ep) ran (``got``, ``_llama_chains``' with the MoE's recorded
    routes) and holds them to it: f32 tokens identical; bf16 tokens equal
    or at ties (``_held_to``); an MoE chain also against the one process
    forced onto the ranks' routes (``_route_flips``)."""
    from llmvox_tpu_torch.models.llama import LlamaConfig
    geometry = _geometry(small)
    ids, lens = _tp_prompts(LlamaConfig(**geometry["llama"]), TP_POOL_ROWS)
    lcfg = LlamaConfig(**dict(geometry[which], n_layer=depth))
    full = _llama_tree(lcfg, 160, dev, dtype)
    one = _llama_chains(full, lcfg, dev, dtype, pooled="pooled" in got,
                        block=TP_TOKENS if which == "llama"
                        else TP_MOE_BLOCK, timed=timed)
    one["weight_bytes"] = _tree_bytes(full)
    chains = [("b1", got["b1"], one["b1"], ids[0])]
    chains += [(f"row {r}", c, o, ids[r, :lens[r]]) for r, (c, o) in
               enumerate(zip(got.get("pooled", []), one.get("pooled", [])))]
    held = {}
    for what, c, o, prompt in chains:
        if dtype == torch.float32:
            assert c == o, (name, what, c, o)
        if c == o:
            held[what] = "identical"
            continue
        part = next(d for d, (a, b) in enumerate(zip(c, o)) if a != b)
        held[what] = f"parts at step {part}"
        if which == "llama":
            held[what] += "; ties: " + (
                _held_to(full, lcfg, c, prompt, n, (name, what))
                or "none (every token the one process's pick "
                   "teacher-forced on the chain)")
    keep = slice(0x20 + 1, 0x7e + 2)
    dlog = float((got["logits"] - one["logits"])[keep].abs().max()
                 / one["logits"][keep].std())
    if which == "moe":
        # one process forced onto the ranks' routes, teacher-forced on
        # their chain: the route flips at router ties, the chain's tokens
        # its picks or at ties, the prefill logits' gap
        with _routes(forced=got["routes"]) as own:
            rows = _forced_logits(full, lcfg, ids[0], got["b1"])
        routes = _route_flips(got["routes"], own, dtype, n, name)
        ties = _held_to(full, lcfg, got["b1"], ids[0], n,
                        (name, "forced"), rows=rows)
        routes.update(
            held=ties or "every token the one process's pick",
            prefill_logits_err=float(
                (got["logits"] - rows[0].cpu())[keep].abs().max()
                / rows[0][keep].std().cpu()))
    res = {"held": held, "tokens": len(got["b1"]),
           "prefill_logits_err": dlog,
           "chains": {par: got["b1"], "one": one["b1"]},
           par: {k: got[k] for k in ("weight_bytes", "cache_bytes")},
           "one": {k: one[k] for k in ("weight_bytes", "cache_bytes")}}
    if "token_ms" in got:
        res.update({f"{par}_token_ms": got["token_ms"],
                    "one_token_ms": one["token_ms"]})
    if which == "moe":
        res["routes"] = routes
    del full
    return res


def _tp_one(tp: dict, dev, small, one_params) -> dict:
    """Rank 0, the group gone: one process on this card runs what the tp
    ranks ran and holds them to it (the decoder's params to the trainer
    bounds; the Llama's f32 tokens identical, bf16 tokens equal or at
    ties, ``_held_to``)."""
    perr = max(float((a - b.detach()).abs().max())
               for a, b in zip(tp["keep"]["decoder"], one_params))
    assert perr <= TRAIN_PARAM_ATOL, perr
    out = {"decoder": dict(tp["decoder"], param_abs_err=perr)}
    for name, which, depth, dtype in TP_RUNS:
        out[name] = _hold_run(tp[name], which, depth, dtype, dev, small,
                              tp["llm_tp"], name, timed=name == "bf16")
    out["launches"] = tp["launches"]
    out["llm_tp"] = tp["llm_tp"]
    return out


# phase 22's sequence-parallel and FSDP checks, in the same ranks
SP_T = 2048               # the f32 checks' sequence width
SP_BF16_T = 8192          # the timed bf16 update's: the deployed block
SP_TIMED = 2              # timed bf16 updates, after one to warm up


def sp_layouts(world: int) -> tuple:
    """(the f32 checks' (name, TrainConfig fields), the names also timed
    in bf16 at ``SP_BF16_T``): two ranks (one card, or two over NCCL) run
    sp 2 ring and zigzag and FSDP at dp 2; four (NCCL) dp 2 x sp 2 with
    FSDP, sp 4 zigzag and sp 2 x tp 2."""
    if world == 2:
        return ((("sp 2 ring", dict(sp_size=2)),
                 ("sp 2 zigzag", dict(sp_size=2, sp_layout="zigzag")),
                 ("fsdp dp 2", dict(fsdp=True))),
                ("sp 2 ring", "sp 2 zigzag"))
    assert world == 4, f"phase 22's sp checks run on 2 or 4 ranks, not {world}"
    return ((("dp 2 x sp 2 fsdp", dict(sp_size=2, fsdp=True)),
             ("sp 4 zigzag", dict(sp_size=4, sp_layout="zigzag")),
             ("sp 2 x tp 2", dict(sp_size=2, tp_size=2))),
            ("sp 4 zigzag",))


def _sp_inputs(cfg=None, t: int = SP_T, n: int = 4, k: int = 2):
    """``n`` bucketed micro-batches of 2 rows at T = ``t`` (packed ones do
    not compose with sp), the deployed width with its draft heads, seeded
    params, accumulation ``k``."""
    from llmvox_tpu_torch.train.data import collate
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import DecoderConfig, TrainConfig
    cfg = dataclasses.replace(cfg or DecoderConfig(),
                              n_draft_heads=TRAIN_HEADS)
    t = min(t, cfg.block_size)
    tcfg = TrainConfig(batch_size=2, gradient_accumulation_steps=k,
                       learning_rate=1e-3, warmup_iters=0, grad_clip=0.1,
                       dp_size=-1)
    rng = np.random.default_rng(23)
    table = P.random_text_table(2, cfg)
    codebook = rng.standard_normal(
        (max(cfg.vocab_size, cfg.eoa_token_id + 1), cfg.speech_embed_dim)
    ).astype(np.float32)
    samples = synthetic_samples(2 * n, 230 + t, t - 1, cfg)
    batches = [collate(samples[2 * i:2 * i + 2], cfg, bucket=t)
               for i in range(n)]
    assert all(b[0].shape == (2, t) for b in batches)
    return cfg, tcfg, P.init_decoder_params(23, cfg), table, codebook, batches


def _state_bytes(tr) -> tuple:
    """(this rank's parameter bytes, its AdamW moments' bytes)."""
    size = lambda ts: sum(x.numel() * x.element_size() for x in ts)  # noqa
    return size(tr.opt.params), size(tr.opt.mu + tr.opt.nu)


def _timed_updates(tr, batches) -> tuple:
    """(ms of each update after the first, one micro-step each; the peak
    device memory of this process over them, None off the card)."""
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(tr.device)
    ms = []
    for b in batches:
        _sync(tr.device)
        t0 = time.perf_counter()
        tr.step(*b)
        _sync(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[1:], (torch.cuda.max_memory_allocated(tr.device) if cuda
                    else None)


def _sp_rank(rank: int, world: int, dev, small) -> dict:
    """The sequence-parallel and FSDP checks on one rank (the group still
    formed): each of ``sp_layouts``' f32 trainers on the same inputs (rank
    0 keeps its gathered params for ``_sp_one``), then the timed bf16
    updates at ``SP_BF16_T``."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.train.trainer import Trainer
    checks, timed = sp_layouts(world)
    _zero_launches()
    cfg, tcfg, params, table, codebook, batches = _sp_inputs(small[0])
    out = {"route": pmesh.route(dev), "checks": {}, "timed": {},
           "T": batches[0][0].shape[1]}
    for name, kw in checks:
        tr = Trainer(dataclasses.replace(tcfg, **kw), cfg, table, codebook,
                     compute_dtype=torch.float32, device=dev, params=params)
        losses, ms, _ = _dp_updates(tr, batches, lockstep=False)
        res = {"losses": losses, "update_ms": ms,
               "layout": f"dp {tr.dp} x sp {tr.sp} x tp {tr.tp}"
                         + (" fsdp" if tr.fsdp else ""),
               "bytes": _state_bytes(tr)}
        if tr.fsdp:
            res["ckpt"] = _sharded_ckpt(tr, rank)
        full = tr._gather(tr.opt.params)
        if rank == 0:
            res["keep"] = [x.clone() for x in full]
        out["checks"][name] = res
        del tr, full
    cfg16, tcfg16, params16, table16, codebook16, batches16 = _sp_inputs(
        small[0], SP_BF16_T, SP_TIMED + 1, 1)
    out["T_bf16"] = batches16[0][0].shape[1]
    for name, kw in checks:
        if name not in timed:
            continue
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        tr = Trainer(dataclasses.replace(tcfg16, **kw), cfg16, table16,
                     codebook16, compute_dtype=torch.bfloat16, device=dev,
                     params=params16)
        ms, peak = _timed_updates(tr, batches16)
        out["timed"][name] = {"update_ms": ms, "peak_bytes": peak}
        del tr
    # one ring step's rotation over every rank at the timed shape: the
    # bf16 (k, v) share forward, its f32 gradient backward
    shape = (2, 2, out["T_bf16"] // world, cfg16.n_embd)
    out["rotate_ms"] = {
        str(dt).split(".")[-1]: (_rotate_ms(torch.zeros(
            shape, dtype=dt, device=dev)), int(np.prod(shape)) * (
                2 if dt == torch.bfloat16 else 4))
        for dt in (torch.bfloat16, torch.float32)}
    out["launches"] = _read_launches()
    return out


def _sharded_ckpt(tr, rank: int) -> dict:
    """The trainer's shards written with ``save_sharded`` (its layout's
    specs) into a directory of this launch under the temporary directory,
    then read whole on rank 0: equal to the gathered tree, bit for bit;
    each rank's file bytes and the seconds each way."""
    import shutil
    import tempfile
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.train import checkpoint as ckpt
    # the ranks are children of one process: its pid names the directory
    path = os.path.join(tempfile.gettempdir(),
                        f"llmvox_sharded_{os.getppid()}")
    specs = {}
    for name, spec in zip(tr.names, tr.specs):
        *parents, leaf = name.split("/")
        node = specs
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = spec
    t0 = time.perf_counter()
    ckpt.save_sharded(path, tr.params, specs, tr.mp)
    res = {"save_s": time.perf_counter() - t0, "bytes": os.path.getsize(
        os.path.join(path, f"shards-{pmesh.rank()}.npz"))}
    full = tr._gather(tr.opt.params)
    if rank == 0:
        t0 = time.perf_counter()
        back = ckpt.load_sharded(path)
        res["load_s"] = time.perf_counter() - t0
        for name, want in zip(tr.names, full):
            node = back
            for k in name.split("/"):
                node = node[k]
            assert torch.equal(node, want.detach().cpu()), name
        res["leaves"] = len(full)
    pmesh.barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    return res


def _rotate_ms(x: torch.Tensor, reps: int = 5) -> float:
    """The median ms of ``rotate(x)`` over every rank (after one to warm
    up), synchronised."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    ms = []
    for _ in range(reps + 1):
        _sync(x.device)
        t0 = time.perf_counter()
        pmesh.rotate(x, None)
        _sync(x.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[1:])


def _sp_one(sp: dict, dev, small) -> dict:
    """Rank 0, the group gone: one process on this card trains the same
    f32 updates and holds every layout to it (the trainer bounds), then
    times the bf16 update at ``SP_BF16_T`` with SDPA."""
    from llmvox_tpu_torch.train.trainer import Trainer
    cfg, tcfg, params, table, codebook, batches = _sp_inputs(small[0])
    one = Trainer(dataclasses.replace(tcfg, dp_size=1), cfg, table,
                  codebook, compute_dtype=torch.float32, device=dev,
                  params=params)
    start = [p.detach().clone() for p in one.opt.params]
    l1, ms1, _ = _dp_updates(one, batches, lockstep=False)
    moved = max(float((b.detach() - a).abs().max())
                for a, b in zip(start, one.opt.params))
    assert moved > 10 * TRAIN_PARAM_ATOL, moved
    out = {"checks": {}, "one": {"update_ms": ms1,
                                 "bytes": _state_bytes(one),
                                 "param_moved": moved}}
    for name, res in sp["checks"].items():
        lerr = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], l1))
        perr = max(float((a - b.detach()).abs().max())
                   for a, b in zip(res.pop("keep"), one.opt.params))
        assert lerr <= TRAIN_LOSS_RTOL, (name, res["losses"], l1)
        assert perr <= TRAIN_PARAM_ATOL, (name, perr)
        out["checks"][name] = dict(res, loss_rel_err=lerr,
                                   param_abs_err=perr)
    del one, start
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg16, tcfg16, params16, table16, codebook16, batches16 = _sp_inputs(
        small[0], SP_BF16_T, SP_TIMED + 1, 1)
    one16 = Trainer(dataclasses.replace(tcfg16, dp_size=1), cfg16, table16,
                    codebook16, compute_dtype=torch.bfloat16, device=dev,
                    params=params16)
    ms, peak = _timed_updates(one16, batches16)
    out["one"].update(bf16_update_ms=ms, bf16_peak_bytes=peak)
    out.update(timed=sp["timed"], route=sp["route"], T=sp["T"],
               T_bf16=sp["T_bf16"], launches=sp["launches"],
               rotate_ms=sp["rotate_ms"])
    return out


# phase 22's checks of the last multi-device paths, in the same ranks:
# experts over ep on replicated tokens, the pipelined Llama, the
# hand-written all-to-all MoE, the ep-aware FSDP step of the Llama, and
# (in ``_sp_rank``) the sharded checkpoint
EP_RUNS = (("ep bf16", "moe", BIG_DEPTH, torch.bfloat16),
           ("ep f32", "moe", TP_MOE_DEPTH, torch.float32))
PP_POOL = 8               # the pipelined pool's rows
PP_BLOCK = 8              # tokens a row a block
PP_SEQ = 1024             # the pipelined caches' rows (8192 cut for time)
PP_RUNS = (("pp bf16", torch.bfloat16), ("pp f32", torch.float32))
A2A_ROWS = 256            # each rank's token rows of the all-to-all MoE
# f32 on the card, the a2a against moe_ffn(group_size=rows): the largest
# |difference| over the largest |value|, for y and every gradient (the
# expert matmuls sum 4096 or 14336 products in another order, over
# another count of rows); aux to JAX's bound
A2A_REL = 1e-4
A2A_AUX_RTOL = 1e-5
FSDP_ROWS, FSDP_T = 4, 65  # the global batch of the ep-aware FSDP step
FSDP_CF = 1.0             # its capacity factor: routes drop
# its gradients against the one process, leaf by leaf, to TRAIN_GRAD_RTOL
# of the leaf's largest |gradient| (the same f32 sums over another split
# of the rows); its params after one AdamW step (lr 1e-3) to the
# trainer's atol, except where the one process's |gradient| is within
# that rounding bound of 0, where Adam's g / (|g| + eps) may take the
# other sign (up to 2 lr apart)
FSDP_LR = 1e-3


def _peak(dev):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def _timed(fn, dev, reps: int = 1):
    """(fn's result, the ms of its last run after one untimed)."""
    res = fn()
    ms = 0.0
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    return res, ms


def _ep_rank(mp, dev, small) -> dict:
    """Mixtral-8x7B's geometry with each rank's E/ep experts (``EP_RUNS``):
    the B=1 chain (timed in bf16) and its routes."""
    from llmvox_tpu_torch.models.llama import LlamaConfig
    from llmvox_tpu_torch.parallel import sharding as psh
    out = {}
    for name, which, depth, dtype in EP_RUNS:
        lcfg = LlamaConfig(**dict(_geometry(small)[which], n_layer=depth))
        full = _llama_tree(lcfg, 160, dev, dtype)
        shard = psh.shard_llama(full, lcfg, 1, 0, ep=mp.ep,
                                ep_rank=mp.ep_rank)
        del full
        with _routes() as calls:
            res = _llama_chains(shard, lcfg, dev, dtype, pooled=False,
                                block=TP_MOE_BLOCK, timed=False,
                                ep=mp.ep_group)
        res["routes"] = calls
        if name == "ep bf16":
            # timed apart: the recorded routes are the chain's alone
            res["token_ms"] = _llama_chains(
                shard, lcfg, dev, dtype, pooled=False, block=TP_MOE_BLOCK,
                ep=mp.ep_group)["token_ms"]
        res["weight_bytes"] = _tree_bytes(shard)
        out[name] = res
        del shard
    return out


def _pp_rank(group, dev, small) -> dict:
    """Llama-3.1-8B's geometry at ``BIG_DEPTH`` layers over a pp group of
    every rank: the pp prefill of a fresh pool of ``PP_POOL`` prompts,
    then from it a ``PP_BLOCK`` block at n_micro pp and 2 pp (each
    timed); bf16 and f32."""
    from llmvox_tpu_torch.models import llama as L
    from llmvox_tpu_torch.models import llama_pp as LP
    from llmvox_tpu_torch.parallel import mesh as pmesh
    pp, s = pmesh.group_size(group), pmesh.group_rank(group)
    lcfg = L.LlamaConfig(**dict(_geometry(small)["llama"],
                                n_layer=BIG_DEPTH, max_seq_len=PP_SEQ))
    ids, lens = _tp_prompts(lcfg, PP_POOL)
    out = {"pp": pp}
    for name, dtype in PP_RUNS:
        full = _llama_tree(lcfg, 180, dev, dtype)
        shard = LP.shard_llama_pp(full, lcfg, pp, s)
        stage_cfg = dataclasses.replace(lcfg, n_layer=lcfg.n_layer // pp)
        fresh = L.init_llama_pool_state(stage_cfg, PP_POOL, dtype, dev)
        first, st = LP.make_pp_prefill(group, lcfg, n_micro=pp)(
            shard, torch.as_tensor(ids, device=dev),
            torch.as_tensor(lens, device=dev), fresh)
        res = {"first": first.tolist(), "pos": st.pos.tolist(),
               "stage_bytes": _tree_bytes(shard["h"]) + _tree_bytes(
                   {"k": st.k, "v": st.v}), "blocks": {}}
        ones = torch.ones(PP_POOL, dtype=torch.bool, device=dev)
        for m in (pp, 2 * pp):
            decode = LP.make_pp_decode(group, lcfg, block=PP_BLOCK,
                                       n_micro=m)
            (toks, _), ms = _timed(lambda: decode(shard, st._replace(
                k=st.k.clone(), v=st.v.clone()), ones), dev)
            res["blocks"][m] = {"toks": toks.tolist(),
                                "step_ms": ms / PP_BLOCK}
        out[name] = res
        del full, shard, fresh, st
    return out


def _a2a_inputs(mcfg, ep: int, dev):
    """The all-to-all MoE's inputs at the MoE's widths, seeded alike on
    every rank: (ep * A2A_ROWS, C) rows and the layer's router and
    experts (the scale of tests/test_moe.py::_a2a_setup), f32."""
    g = torch.Generator(device=dev).manual_seed(190)
    c, i, e = mcfg["n_embd"], mcfg["intermediate_size"], mcfg["n_experts"]

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    return {"x": draw(ep * A2A_ROWS, c), "rw": draw(c, e),
            "wg": draw(e, c, i, scale=c ** -0.5),
            "wu": draw(e, c, i, scale=c ** -0.5),
            "wd": draw(e, i, c, scale=i ** -0.5)}


def _a2a_reference(mcfg, ep: int, e0: int, e_loc: int, dev) -> dict:
    """``moe_ffn(group_size=A2A_ROWS)`` on one process: y of rank 0's rows
    and aux, drop-free and capped (cf 1), and the gradients of sum(y * y)
    + aux of the router and of experts [e0, e0 + e_loc) (drop-free),
    kept on the card; timed."""
    from llmvox_tpu_torch.ops import moe
    a = _a2a_inputs(mcfg, ep, dev)
    out = {}
    for name, kw in (("drop-free", dict(drop_free=True)),
                     ("cf 1", dict(capacity_factor=1.0))):
        with torch.no_grad():
            (y, aux), ms = _timed(lambda: moe.moe_ffn(
                a["x"], a["rw"], a["wg"], a["wu"], a["wd"], 2,
                group_size=A2A_ROWS, **kw), dev)
        out[name] = (y[:A2A_ROWS].clone(), float(aux), ms)
    p = {k: a[k].requires_grad_() for k in ("rw", "wg", "wu", "wd")}
    y, aux = moe.moe_ffn(a["x"], p["rw"], p["wg"], p["wu"], p["wd"], 2,
                         group_size=A2A_ROWS, drop_free=True)
    ((y * y).sum() + aux).backward()
    out["grads"] = {"rw": p["rw"].grad} | {
        k: p[k].grad[e0:e0 + e_loc].clone() for k in ("wg", "wu", "wd")}
    return out


def _rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _a2a_rank(mp, rank: int, dev, small) -> dict:
    """``moe_ffn_a2a`` at the MoE's widths over the ep group of every rank:
    this rank's rows, drop-free and capped, and the gradients (the
    router's summed over the group); rank 0 holds its rows and experts to
    the one process's ``moe_ffn(group_size=rows)``, run first while the
    others wait.  Then ``all_to_all_dim``'s all-reduce route held bitwise
    to the native one, in bf16 and f32 at the dispatch's shape."""
    from llmvox_tpu_torch.ops import moe
    from llmvox_tpu_torch.parallel import mesh as pmesh
    mcfg = _geometry(small)["moe"]
    g, ep = mp.ep_group, mp.ep
    i = pmesh.group_rank(g)
    e_loc = mcfg["n_experts"] // ep
    ref = (_a2a_reference(mcfg, ep, i * e_loc, e_loc, dev) if rank == 0
           else None)
    pmesh.barrier()
    a = _a2a_inputs(mcfg, ep, dev)
    rows = slice(i * A2A_ROWS, (i + 1) * A2A_ROWS)
    ex = slice(i * e_loc, (i + 1) * e_loc)
    x = a["x"][rows].clone()
    w = {k: a[k][ex].clone() for k in ("wg", "wu", "wd")}
    rw = a["rw"]
    del a
    out = {"ep": ep, "rows": A2A_ROWS, "cases": {}}
    for name, kw in (("drop-free", dict(drop_free=True)),
                     ("cf 1", dict(capacity_factor=1.0))):
        with torch.no_grad():
            (y, aux), ms = _timed(lambda: moe.moe_ffn_a2a(
                x, rw, w["wg"], w["wu"], w["wd"], 2, g, **kw), dev)
        res = {"ms": ms}
        if ref is not None:
            ry, raux, rms = ref[name]
            res.update(y_rel_err=_rel_err(y, ry),
                       aux_rel_err=abs(float(aux) - raux) / abs(raux),
                       one_ms=rms)
            assert res["y_rel_err"] <= A2A_REL, (name, res)
            assert res["aux_rel_err"] <= A2A_AUX_RTOL, (name, res)
        out["cases"][name] = res
    p = {k: v.requires_grad_() for k, v in
         dict(w, rw=rw.clone()).items()}
    y, aux = moe.moe_ffn_a2a(x, p["rw"], p["wg"], p["wu"], p["wd"], 2, g,
                             drop_free=True)
    ((y * y).sum() + aux).backward()
    grads = {k: v.grad for k, v in p.items()}
    pmesh.all_reduce_([grads["rw"]], group=g)
    if ref is not None:
        out["grad_rel_err"] = {k: _rel_err(grads[k], ref["grads"][k])
                               for k in grads}
        assert max(out["grad_rel_err"].values()) <= A2A_REL, out
    del p, grads, y, ref
    # the all-to-all's routes at the dispatch's (E, cap, C) shape
    bit = {}
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(191 + rank)
        buf = torch.randn((mcfg["n_experts"], 16, mcfg["n_embd"]),
                          generator=gen, device=dev).to(dt)
        red = pmesh.all_to_all_dim(buf, g, via=pmesh.ALL_REDUCE)
        nat = (pmesh.all_to_all_dim(buf, g, via=pmesh.NATIVE)
               if pmesh.route(dev) == pmesh.NATIVE else
               pmesh.all_to_all_dim(buf.cpu(), g, via=pmesh.NATIVE))
        bit[str(dt).split(".")[-1]] = bool(torch.equal(red.cpu(),
                                                       nat.cpu()))
    assert all(bit.values()), bit
    out["routes_bitwise"] = bit
    out["route"] = pmesh.route(dev)
    return out


def _fsdp_llama_step(params, cfg, toks, dev, ep=None, fsdp=None,
                     dp_rank: int = 0, dp: int = 1, keep=None):
    """One AdamW step (optax.adamw(1e-3)'s update) of ``llama_loss`` on
    ``params`` (this rank's shards under ``fsdp``): (the batch's loss,
    the ms of the step, the moments' bytes, and given ``keep`` (name,
    tensor -> a copy to keep) its copy of each leaf's batch gradient,
    else None)."""
    from llmvox_tpu_torch.models import llama as L
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.parallel import sharding as psh
    from llmvox_tpu_torch.train.optim import AdamW, named_leaves
    from llmvox_tpu_torch.utils.config import CodecTrainConfig
    leaves = named_leaves(params)
    for _, t in leaves:
        t.requires_grad_()
    rows = psh.dp_rows(toks.shape[0], dp_rank, dp)
    _sync(dev)
    t0 = time.perf_counter()
    loss = L.llama_loss(params, toks[rows], cfg, ep=ep, fsdp=fsdp)
    loss.backward()
    grads = [t.grad for _, t in leaves]
    if fsdp is not None:
        whole = [g for (n, _), g in zip(leaves, grads)
                 if n not in fsdp.dims]
        pmesh.all_reduce_(whole, group=fsdp.group)
    kept = None
    if keep is not None:
        _sync(dev)
        t_keep = time.perf_counter()
        kept = {n: keep(n, g.detach()) for (n, _), g in zip(leaves, grads)}
        _sync(dev)
        t0 += time.perf_counter() - t_keep   # the copy is not the step's
    opt = AdamW(CodecTrainConfig(initial_learning_rate=FSDP_LR,
                                 num_warmup_steps=0),
                [t for _, t in leaves], [True] * len(leaves))
    opt.step(grads)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    total = loss.detach().reshape(1)
    if fsdp is not None:
        pmesh.all_reduce_([total], group=fsdp.group)
    moments = sum(m.numel() * m.element_size() for m in opt.mu + opt.nu)
    del opt, grads
    for _, t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return float(total[0]), ms, moments, kept


def _fsdp_rank(mp, rank: int, dev, small) -> dict:
    """The ep-aware FSDP step at the MoE's widths, 1 layer, f32, at capacity
    ``FSDP_CF``: rank 0 first runs it on one process and keeps the result
    on the host while the others wait; then every rank its shard of the
    step (dp x ep, ``LLAMA_FSDP_SPECS``), rank 0 holding its shard to the
    one process's: its loss, each leaf's gradient and its params after
    the step."""
    from llmvox_tpu_torch.models.llama import LlamaConfig
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.parallel import sharding as psh
    from llmvox_tpu_torch.train.optim import named_leaves
    from llmvox_tpu_torch.utils import params as P
    cfg = LlamaConfig(**dict(_geometry(small)["moe"], n_layer=1,
                             moe_capacity_factor=FSDP_CF))
    toks = torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.vocab_size, (FSDP_ROWS, FSDP_T)), device=dev)
    out = {"dp": mp.dp, "ep": mp.ep, "rows": FSDP_ROWS, "T": FSDP_T}

    def mine(name, whole):
        """Rank 0's shard of a whole leaf, on the host."""
        spec = psh.LLAMA_FSDP_SPECS
        for k in name.split("/"):
            spec = spec[k]
        return psh.shard_leaf(whole, spec, 1, 0, dp=mp.dp,
                              dp_rank=mp.dp_rank, ep=mp.ep,
                              ep_rank=mp.ep_rank).cpu()
    one = one_grads = None
    if rank == 0:
        full = P.init_llama_params(200, cfg, device=dev)
        out["params"] = sum(t.numel() for _, t in named_leaves(full))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out["one_loss"], out["one_ms"], _, one_grads = _fsdp_llama_step(
            full, cfg, toks, dev, keep=mine)
        out["one_peak_bytes"] = _peak(dev)
        one = {k: mine(k, v.detach()) for k, v in named_leaves(full)}
        del full
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    pmesh.barrier()
    full = P.init_llama_params(200, cfg, device=dev)
    shard = psh.shard_llama(full, cfg, 1, 0, ep=mp.ep, ep_rank=mp.ep_rank,
                            dp=mp.dp, dp_rank=mp.dp_rank)
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    fsdp = psh.llama_fsdp(shard, mp.dp_group)
    loss, ms, moments, grads = _fsdp_llama_step(
        shard, cfg, toks, dev, ep=mp.ep_group, fsdp=fsdp,
        dp_rank=mp.dp_rank, dp=mp.dp,
        keep=None if one is None else lambda n, g: g.clone())
    out.update(loss=loss, ms=ms, peak_bytes=_peak(dev),
               shard_bytes=_tree_bytes(shard), moment_bytes=moments,
               expert_shard=tuple(shard["h"]["moe_wgate"].shape))
    if one is not None:
        out["loss_rel_err"] = abs(loss - out["one_loss"]) / abs(
            out["one_loss"])
        assert out["loss_rel_err"] <= TRAIN_LOSS_RTOL, out
        worst = off = bad = n = 0
        grad_err = {}
        for name, t in named_leaves(shard):
            g_one = one_grads[name].to(dev)
            grad_err[name] = _rel_err(grads[name], g_one)
            # where the one process's gradient is within rounding of 0
            near0 = g_one.abs() <= TRAIN_GRAD_RTOL * g_one.abs().max()
            err = (t.detach() - one[name].to(dev)).abs()
            worst = max(worst, float(err.max()))
            past = err > TRAIN_PARAM_ATOL
            off += int(past.sum())
            bad += int((past & ~near0).sum())
            n += err.numel()
        out.update(grad_rel_err=max(grad_err.values()),
                   grad_rel_err_at=max(grad_err, key=grad_err.get),
                   param_abs_err=worst, params_off=off, params_held=n,
                   params_off_not_near0=bad)
        assert all(e <= TRAIN_GRAD_RTOL for e in grad_err.values()), \
            grad_err
        assert bad == 0 and worst <= 2 * FSDP_LR, out
    del shard, one, one_grads, grads
    return out


def _mp_rank(rank: int, world: int, dev, small) -> dict:
    """The last multi-device paths on one rank (the group still formed),
    each counted from 0 for the kernels' launches: experts over ep =
    world (``_ep_rank``), the pipeline over pp = world (``_pp_rank``), the
    all-to-all MoE over ep = world (``_a2a_rank``) and the ep-aware FSDP
    step at dp 2 x ep world/2 (``_fsdp_rank``); this rank's peak device
    memory over them."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"launches": {}, "s": {}}
    mp = pmesh.initialize_model_parallel(1, 1, world)
    for name, fn in (("ep", lambda: _ep_rank(mp, dev, small)),
                     ("pp", lambda: _pp_rank(mp.ep_group, dev, small)),
                     ("a2a", lambda: _a2a_rank(mp, rank, dev, small))):
        _zero_launches()
        t0 = time.perf_counter()
        out[name] = fn()
        out["s"][name] = time.perf_counter() - t0
        out["launches"][name] = _read_launches()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["peak_bytes"] = _peak(dev)
    _zero_launches()
    t0 = time.perf_counter()
    out["fsdp"] = _fsdp_rank(pmesh.initialize_model_parallel(
        1, 1, world // 2), rank, dev, small)
    out["s"]["fsdp"] = time.perf_counter() - t0
    out["launches"]["llama_fsdp"] = _read_launches()
    return out


def _mp_one(mp: dict, dev, small) -> dict:
    """Rank 0, the group gone: one process holds the ep and pp ranks'
    chains (``_hold_run``; the pp chains against
    ``prefill_slots`` + ``decode_block_pooled``, f32 identical, bf16 equal
    or at ties)."""
    from llmvox_tpu_torch.models import llama as L
    out = {"ep": {}, "pp": {}, "a2a": mp["a2a"], "fsdp": mp["fsdp"],
           "launches": mp["launches"], "peak_bytes": mp["peak_bytes"],
           "s": mp["s"]}
    ep = mp["a2a"]["ep"]
    for name, which, depth, dtype in EP_RUNS:
        out["ep"][name] = _hold_run(mp["ep"][name], which, depth, dtype, dev,
                                    small, ep, name,
                                    timed=name == "ep bf16", par="ep")
    pp = mp["pp"]["pp"]
    lcfg = L.LlamaConfig(**dict(_geometry(small)["llama"],
                                n_layer=BIG_DEPTH, max_seq_len=PP_SEQ))
    ids, lens = _tp_prompts(lcfg, PP_POOL)
    ones = torch.ones(PP_POOL, dtype=torch.bool, device=dev)
    for name, dtype in PP_RUNS:
        got = mp["pp"][name]
        full = _llama_tree(lcfg, 180, dev, dtype)
        with torch.no_grad():
            st = L.init_llama_pool_state(lcfg, PP_POOL, dtype, dev)
            first, st = L.prefill_slots(
                full, torch.as_tensor(ids, device=dev),
                torch.as_tensor(lens, device=dev), st,
                torch.arange(PP_POOL, device=dev), ones, lcfg)
            (toks, _), ms = _timed(lambda: L.decode_block_pooled(
                full, st._replace(k=st.k.clone(), v=st.v.clone()), ones,
                lcfg, block=PP_BLOCK), dev)
        res = {"one_step_ms": ms / PP_BLOCK, "held": {},
               "step_ms": {m: b["step_ms"] for m, b in got["blocks"].items()},
               "stage_bytes": got["stage_bytes"]}
        assert got["first"] == first.tolist(), (name, got["first"])
        assert got["pos"] == lens.tolist(), (name, got["pos"])
        for m, b in got["blocks"].items():
            for r in range(PP_POOL):
                c = [got["first"][r]] + b["toks"][r]
                o = [int(first[r])] + toks[r].tolist()
                what = f"n_micro {m} row {r}"
                if dtype == torch.float32:
                    assert c == o, (name, what, c, o)
                if c == o:
                    continue
                res["held"][what] = _held_to(
                    full, lcfg, c[1:], list(ids[r, :lens[r]]) + c[:1], pp,
                    (name, what)) or "equal picks teacher-forced"
        out["pp"][name] = res
        del full, st
    out["pp"]["pp"] = pp
    return out


def _dp_rank(rank: int, world: int, small=None) -> dict:
    """One rank of phase 22 (``parallel/launch.py::spawn``): the decoder
    and codec trainers data-parallel on this rank's card, lockstep after
    every update; then rank 0, with the group gone, runs both one-process
    on the same inputs and holds the data-parallel run to them (the f64
    trainer referees the codec's logs).  Between the two, with the group
    still formed, the tensor-parallel checks (``_tp_rank``, ``_tp_one``).
    ``small`` (the CPU rehearsal): (decoder config, codec config, crop
    samples, CodecTrainConfig fields[, (the Llama's and the MoE's config
    fields)])."""
    import torch.distributed as dist
    from llmvox_tpu_torch.parallel import mesh as pmesh
    from llmvox_tpu_torch.train import codec_trainer as ct
    from llmvox_tpu_torch.train.trainer import Trainer
    small = small or (None, None, 0, {})
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() and small[0] is None
           else torch.device("cpu"))
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": pmesh.world()}
    cfg, tcfg, params, table, codebook, batches = _dp_decoder_inputs(
        world, small[0])
    tr = Trainer(tcfg, cfg, table, codebook, compute_dtype=torch.float32,
                 device=dev, params=params)
    assert tr.dp == world
    start = [p.detach().clone() for p in tr.opt.params]
    losses, ms, same = _dp_updates(tr, batches)
    out["decoder"] = {"losses": losses, "update_ms": ms, "lockstep": same}
    dec_params = [p.detach().clone() for p in tr.opt.params]
    del tr
    ccfg, ctcfg, state, audios = _dp_codec_inputs(world, small[1],
                                                  small[2], **small[3])
    ctr = ct.CodecTrainer(ccfg, ctcfg, device=dev, **state)
    logs, cms, embeds, csame = _codec_steps(ctr, audios)
    out["codec"] = {"logs": logs, "step_ms": cms, "lockstep": csame}
    codec_params = [p.detach().clone() for p in
                    list(ctr.gen.params) + list(ctr.disc.params)]
    del ctr
    assert all(same) and all(csame), (rank, same, csame)
    t0 = time.perf_counter()
    tp = _tp_rank(rank, world, dev, small)
    out["tp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = _sp_rank(rank, world, dev, small)
    out["sp_s"] = time.perf_counter() - t0
    out["sp_rank"] = {"timed": sp["timed"],
                      "bytes": {k: v["bytes"]
                                for k, v in sp["checks"].items()},
                      "ckpt": {k: v["ckpt"] for k, v in sp["checks"].items()
                               if "ckpt" in v}}
    t0 = time.perf_counter()
    mp = _mp_rank(rank, world, dev, small)
    out["mp_s"] = time.perf_counter() - t0
    out["mp_rank"] = {"peak_bytes": mp["peak_bytes"],
                      "fsdp": {k: mp["fsdp"][k] for k in (
                          "ms", "peak_bytes", "shard_bytes",
                          "moment_bytes")},
                      "a2a_ms": {k: v["ms"] for k, v in
                                 mp["a2a"]["cases"].items()}}
    dist.destroy_process_group()
    if rank:
        return out
    # world 1 on this card, the same global batches and draws
    one = Trainer(dataclasses.replace(tcfg, dp_size=1), cfg, table,
                  codebook, compute_dtype=torch.float32, device=dev,
                  params=params)
    l1, ms1, _ = _dp_updates(one, batches)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses, l1))
    perr = max(float((a - b.detach()).abs().max())
               for a, b in zip(dec_params, one.opt.params))
    moved = max(float((b.detach() - a).abs().max())
                for a, b in zip(start, one.opt.params))
    out["decoder"].update(world1_update_ms=ms1, loss_rel_err=lerr,
                          param_abs_err=perr, param_moved=moved)
    assert lerr <= TRAIN_LOSS_RTOL, (losses, l1)
    assert perr <= TRAIN_PARAM_ATOL, perr
    assert moved > 10 * TRAIN_PARAM_ATOL, moved
    tlerr = max(abs(a - b) / abs(b) for a, b in zip(tp["decoder"]["losses"],
                                                    l1))
    assert tlerr <= TRAIN_LOSS_RTOL, (tp["decoder"]["losses"], l1)
    t0 = time.perf_counter()
    out["tp"] = _tp_one(tp, dev, small, one.opt.params)
    out["tp"]["decoder"]["loss_rel_err"] = tlerr
    out["tp_s"] += time.perf_counter() - t0
    del one, tp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["sp"] = _sp_one(sp, dev, small)
    out["sp_s"] += time.perf_counter() - t0
    del sp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["mp"] = _mp_one(mp, dev, small)
    out["mp_s"] += time.perf_counter() - t0
    del mp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r32 = ct.CodecTrainer(ccfg, dataclasses.replace(ctcfg, dp_size=1),
                          device=dev, **state)
    logs1, cms1, embeds1, _ = _codec_steps(r32, audios)
    logs64 = None
    excused, worst = set(), 0.0
    for s, (g, w) in enumerate(zip(logs, logs1)):
        for k in w:
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
            if rel <= DP_CODEC_LOG_RTOL:
                worst = max(worst, rel)
                continue
            # the one-process f32 run may be off the f64 (a leaky ReLU's
            # slope flipped there): then the data-parallel run is held to
            # the f64 trainer's, run only when a log needs it
            if logs64 is None:
                r64 = ct.CodecTrainer(ccfg, dataclasses.replace(
                    ctcfg, dp_size=1), device=dev, dtype=torch.float64,
                    **state)
                logs64 = _codec_steps(r64, audios)[0]
                del r64
            f = logs64[s][k]
            assert abs(w[k] - f) > DP_CODEC_LOG_RTOL * abs(f), (s, k, g[k],
                                                            w[k], f)
            assert abs(g[k] - f) <= DP_CODEC_LOG_RTOL * abs(f), (s, k, g[k],
                                                             w[k], f)
            excused.add(f"step {s} {k}")
    vq_err = max(float(np.abs(a - b).max()) for a, b in zip(embeds, embeds1))
    assert vq_err <= CODEC_VQ_ATOL, vq_err
    off, n = _params_off(codec_params,
                         list(r32.gen.params) + list(r32.disc.params))
    assert off <= n / 1000, (off, n)
    out["codec"].update(world1_step_ms=cms1, log_rel_err=worst,
                        logs_excused=sorted(excused), vq_abs_err=vq_err,
                        params_off=off, params=n)
    return out


def _spread_slots(pool, n: int) -> list:
    """Hold every slot but ``n``, left free round-robin over the shards,
    so that the next ``n`` slots acquired (the lowest free ones) lie on
    every shard; returns the held slots (release them after)."""
    shards = len(pool.shards or [pool])
    per = pool.B // shards
    free = [(k % shards) * per + k // shards for k in range(n)]
    held = [pool.try_acquire() for _ in range(pool.B)]
    for i in free:
        pool.release(i)
    return [i for i in held if i not in free]


def _record_tokens(pool) -> dict:
    """Wrap ``pool.submit``: every resolved block's tokens, by (slot, the
    sentence's text length), in the order the slot's blocks resolve."""
    rec = collections.defaultdict(list)
    submit = pool.submit

    def recording(idx, window, text_len, limit, fused_dump=0):
        fut = submit(idx, window, text_len, limit, fused_dump)

        def done(f):
            if not f.cancelled() and f.exception() is None:
                r = f.result()
                rec[(idx, text_len)].extend(r[0] if isinstance(r, tuple)
                                            else r)
        fut.add_done_callback(done)
        return fut
    pool.submit = recording
    return rec


def _serve_mesh_round(pool, engines, weights, dtype_name: str) -> tuple:
    """Three concurrent ``/tts`` (the reply ``TEXT``, EOA off) through
    ``build_server`` on ``pool``, its free slots spread over the shards;
    returns (the chains by (slot, text length), per-request results, host
    ms a pool step)."""
    from llmvox_tpu_torch.serve.server import build_server
    _, _, _, dcfg, ccfg, scfg = weights
    port = _free_port()
    cfg = dataclasses.replace(
        scfg, api_port=port, pool_capacity=pool.B, scripted_reply=TEXT,
        pool_mesh_dp=len(pool.shards) if pool.shards else 1)
    srv = build_server(cfg, engines, pool=pool)
    held = _spread_slots(pool, 6)
    rec = _record_tokens(pool)
    steps0, disp0 = pool.steps, pool.dispatch_s
    n_cap = captures()
    with _Server(srv, port):
        res = _requests(port, 3, ccfg.hop_length, ccfg.sample_rate)
    assert captures() == n_cap, "a CUDA graph was captured while serving"
    for i in held:
        pool.release(i)
    ms_step = 1e3 * (pool.dispatch_s - disp0) / max(pool.steps - steps0, 1)
    return dict(rec), res, ms_step


def _dp_pool(engines, weights, devices, graphs=None) -> dict:
    """The dp-sharded pool at ``DecoderConfig()``, capacity 16, over
    ``devices`` (one shard a device), against the one-card pool: f32
    served chains identical; a bf16 served round held by ``check_chain``
    against the bf16 B=1 engine, K2 launched on every shard."""
    from llmvox_tpu_torch.ops import cuda_batched_attn
    from llmvox_tpu_torch.parallel import create_mesh
    from llmvox_tpu_torch.serve.pool import DecodePool
    from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    no_eoa = dataclasses.replace(dcfg, eoa_token_id=-1)
    scfg = dataclasses.replace(scfg, max_audio_length=DP_AUDIO_TOKENS)
    nw = (dec_p, codec_p, table, no_eoa, ccfg, scfg)
    codec = engines[0].codec
    text_len = len(ByT5Tokenizer().encode(TEXT.strip())) + 1
    mesh = create_mesh(dp_size=len(devices), devices=devices)
    out = {"mesh": str(mesh)}

    def pool_of(dtype, m):
        return DecodePool(dec_p, table, codec, capacity=DP_POOL_CAP,
                          dcfg=no_eoa, scfg=scfg, device=codec.device,
                          cache_dtype=dtype, mesh=m, graphs=graphs)

    chains = {}
    for name, m in (("one card", None), ("mesh", mesh)):
        pool = pool_of(torch.float32, m)
        rec, res, ms = _serve_mesh_round(pool, engines, nw, "f32")
        got = {tuple(v[:scfg.max_audio_length]) for (_, tl), v in rec.items()
               if tl == text_len}
        assert len(got) == 1, (name, "the requests' chains differ")
        slots = sorted(s for s, tl in rec if tl == text_len)
        chains[name] = got.pop()
        log(f"[dp] f32 {name} pool ({DP_POOL_CAP} slots"
            + (f" over {mesh}" if m is not None else "")
            + f"): 3 concurrent /tts, TEXT decoded on slots {slots}, "
            f"{len(chains[name])} tokens each, {ms:.1f} ms of host time a "
            f"pool step")
        if m is not None:
            per = DP_POOL_CAP // len(devices)
            assert len({s // per for s in slots}) > 1, slots
        del pool
    assert chains["mesh"] == chains["one card"], "f32 chains differ"
    out["f32_tokens_identical"] = len(chains["mesh"])

    ref = make_engine(nw, codec.device, torch.bfloat16, graphs=False)
    want = ref.tts(TEXT, max_tokens=DP_POOL_TOKENS)[1]
    pool = pool_of(torch.bfloat16, mesh)
    pool.warmup()
    _zero_launches()
    tok0 = pool.decode_steps
    rec, res, ms = _serve_mesh_round(pool, engines, nw, "bf16")
    launches = _read_launches()
    shard = dict(cuda_batched_attn.SHARD_LAUNCHES)
    assert launches["k1"] == launches["k3"] == launches["k4"] == 0, launches
    toks = pool.decode_steps - tok0
    held = []
    for (slot, tl), chain in sorted(rec.items()):
        if tl != text_len:
            continue
        assert len(chain) >= DP_POOL_TOKENS, (slot, len(chain))
        held.append(f"slot {slot}: " + check_chain(
            chain[:DP_POOL_TOKENS], want, ref, f"bf16 mesh pool slot {slot}"))
    if torch.device(codec.device).type == "cuda":
        # the plain versions the CPU runs count nothing
        assert sorted(shard) == sorted(pool._tags), shard
        assert all(v == dcfg.n_layer * toks > 0 for v in shard.values()), (
            shard, toks)
        assert cuda_batched_attn.LAUNCHES == sum(shard.values())
    audio = sum(r[4] for r in res)
    log(f"[dp] bf16 mesh pool: 3 concurrent /tts through build_server "
        f"(pool_mesh_dp {len(devices)}), {audio:.2f} s of audio, first audio "
        f"{', '.join(f'{r[2] * 1e3:.0f}' for r in res)} ms; each chain's "
        f"first {DP_POOL_TOKENS} tokens against the bf16 B=1 engine: "
        f"{'; '.join(held)}; K2 launches per shard {shard} = {dcfg.n_layer} "
        f"layers x {toks} token steps; {ms:.1f} ms of host time a pool "
        f"step; no capture while serving")
    out.update(bf16_chains=held, k2_shard_launches=shard,
               launches=launches, bf16_host_ms_step=ms, token_steps=toks)
    del pool, ref
    return out


def _log_tp(t: dict, ranks, backend: str, card: str) -> None:
    """Phase 22's tensor-parallel figures, each beside the card."""
    d, gb = t["decoder"], 1e9
    log(f"[tp] decoder, DecoderConfig() with {TRAIN_HEADS} draft heads, f32, "
        f"dp {d['dp']} x tp {d['tp']}, the dp check's batches, 2 updates: "
        f"losses' rel err {d['loss_rel_err']:.2e} (tol {TRAIN_LOSS_RTOL:.0e}), "
        f"params' max|err| {d['param_abs_err']:.2e} (tol "
        f"{TRAIN_PARAM_ATOL:.0e}) against one process on the same card; ms "
        f"an update (the second) {d['update_ms'][1]:.1f} at tp ({backend}; "
        f"{card})")
    for name, which, depth, dtype in TP_RUNS:
        r = t[name]
        held = "; ".join(f"{k}: {v}" for k, v in r["held"].items())
        what = ("Llama-3.1-8B" if which == "llama" else "Mixtral-8x7B")
        msg = (f"[tp] {what} geometry, {depth} layers, "
               f"{str(dtype).split('.')[-1]}, tp {t['llm_tp']}: "
               f"{r['tokens']}-token chains against one process (ties as "
               f"(step, bf16 ulps, % of the printable ids' logits' std), "
               f"tol {TP_TIE_ULPS * t['llm_tp']} ulps): "
               f"{held}; prefill logits' max|err| "
               f"{100 * r['prefill_logits_err']:.4f}% of their std; each "
               f"rank's weights "
               f"{r['tp']['weight_bytes'] / gb:.3f} GB + KV cache "
               f"{r['tp']['cache_bytes'] / gb:.3f} GB, one process's "
               f"{r['one']['weight_bytes'] / gb:.3f} + "
               f"{r['one']['cache_bytes'] / gb:.3f} GB")
        if "tp_token_ms" in r:
            msg += (f"; ms a B=1 token {r['tp_token_ms']:.2f} at tp, "
                    f"{r['one_token_ms']:.2f} one process")
        if "routes" in r:
            f = r["routes"]
            msg += (f"; against one process forced onto the tp routes: "
                    f"route flips {f['flips']} of {f['rows']} token-layers "
                    f"(gaps {[round(g, 2) for g in f['flip_gap_ulps']]} "
                    f"ulps of the row's largest logit, tol "
                    f"{TP_ROUTE_TIE_ULPS * t['llm_tp']}), router logits' "
                    f"max|err| "
                    f"{f['router_logits_ulps']:.2f} such ulps, chain: "
                    f"{f['held']}, prefill logits' max|err| "
                    f"{100 * f['prefill_logits_err']:.4f}% of their std")
        log(msg + f" ({backend}; {card})")
    log(f"[tp] kernel launches on the tp path (rank 0, counted): "
        f"{t['launches']}; the ranks' tp checks took "
        f"{[round(r['tp_s'], 1) for r in ranks]} s")


def _log_sp(t: dict, ranks, backend: str, card: str) -> None:
    """Phase 22's sequence-parallel and FSDP figures, each beside the
    card."""
    gb = 1e9
    one = t["one"]
    log(f"[sp] the rotation, all-gather and reduce-scatter took the "
        f"{t['route']!r} route ({backend}; {card})")
    for name, r in t["checks"].items():
        per = [rk["sp_rank"]["bytes"][name] for rk in ranks]
        log(f"[sp] decoder, DecoderConfig() with {TRAIN_HEADS} draft heads, "
            f"f32, 2 x {t['T']} rows, k=2, 2 updates, {name} "
            f"({r['layout']}): losses' rel err {r['loss_rel_err']:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}), params' max|err| "
            f"{r['param_abs_err']:.2e} (tol {TRAIN_PARAM_ATOL:.0e}; moved "
            f"up to {one['param_moved']:.2e}) against one process on the "
            f"same card; each rank's params + moments "
            f"{[f'{p / gb:.4f} + {m / gb:.4f}' for p, m in per]} GB, one "
            f"process's {one['bytes'][0] / gb:.4f} + "
            f"{one['bytes'][1] / gb:.4f} GB; ms an update (the second) "
            f"{r['update_ms'][1]:.1f}, one process "
            f"{one['update_ms'][1]:.1f} ({backend}; {card})")
    for name, r in t["timed"].items():
        ms = [rk["sp_rank"]["timed"][name]["update_ms"] for rk in ranks]
        peaks = [rk["sp_rank"]["timed"][name]["peak_bytes"] for rk in ranks]
        log(f"[sp] bf16 update (one micro-step) at T={t['T_bf16']}, B=2, "
            f"{name}: ms {[[round(x, 1) for x in m] for m in ms]} (each "
            f"rank), one process (SDPA) "
            f"{[round(x, 1) for x in one['bf16_update_ms']]}; peak device "
            f"memory {[round(p / gb, 3) for p in peaks if p is not None]} "
            f"GB each rank, one process "
            f"{(one['bf16_peak_bytes'] or 0) / gb:.3f} GB "
            f"({backend}; {card})")
    rot = t["rotate_ms"]
    log(f"[sp] one ring step's rotation over the {len(ranks)} ranks at "
        f"T={t['T_bf16']}, B=2 ({t['route']!r} route): "
        + ", ".join(f"{dt} {ms:.2f} ms ({nbytes / 1e6:.1f} MB a rank)"
                    for dt, (ms, nbytes) in rot.items())
        + f" ({backend}; {card})")
    log(f"[sp] kernel launches on the sp / fsdp path (rank 0, counted): "
        f"{t['launches']}; the ranks' sp checks took "
        f"{[round(r['sp_s'], 1) for r in ranks]} s")


def _log_mp(t: dict, ranks, backend: str, card: str) -> None:
    """Phase 22's figures of the ep, pp, a2a and FSDP paths and of the
    sharded checkpoint, each beside the card."""
    gb, at = 1e9, f" ({backend}; {card})"
    ep = t["a2a"]["ep"]
    for name, which, depth, dtype in EP_RUNS:
        r = t["ep"][name]
        held = "; ".join(f"{k}: {v}" for k, v in r["held"].items())
        f = r["routes"]
        msg = (f"[ep] Mixtral-8x7B geometry, {depth} layers, "
               f"{str(dtype).split('.')[-1]}, ep {ep} (each rank "
               f"{8 // ep} experts): {r['tokens']}-token B=1 chain against "
               f"one process: {held}; forced onto the ep routes: route "
               f"flips {f['flips']} of {f['rows']} token-layers (gaps "
               f"{[round(g, 2) for g in f['flip_gap_ulps']]} ulps, tol "
               f"{TP_ROUTE_TIE_ULPS * ep}), chain: {f['held']}; prefill "
               f"logits' max|err| {100 * r['prefill_logits_err']:.4f}% of "
               f"their std; each rank's weights "
               f"{r['ep']['weight_bytes'] / gb:.3f} GB, one process's "
               f"{r['one']['weight_bytes'] / gb:.3f} GB")
        if "ep_token_ms" in r:
            msg += (f"; ms a B=1 token {r['ep_token_ms']:.2f} at ep, "
                    f"{r['one_token_ms']:.2f} one process")
        log(msg + at)
    pp = t["pp"]["pp"]
    for name, dtype in PP_RUNS:
        r = t["pp"][name]
        log(f"[pp] Llama-3.1-8B geometry, {BIG_DEPTH} layers, KV "
            f"{PP_SEQ}, {str(dtype).split('.')[-1]}, pp {pp}, a pool of "
            f"{PP_POOL}: the pp prefill's first tokens and pos equal "
            f"prefill_slots'; {PP_BLOCK}-token blocks at n_micro "
            f"{list(r['step_ms'])} against decode_block_pooled: "
            f"{r['held'] or 'identical'}; ms a token step "
            + ", ".join(f"{ms:.2f} at n_micro {m}"
                        for m, ms in r["step_ms"].items())
            + f", one process's pooled step {r['one_step_ms']:.2f}; each "
            f"stage's layers + KV {r['stage_bytes'] / gb:.3f} GB" + at)
    a = t["a2a"]
    cases = "; ".join(
        f"{k}: y rel err {v['y_rel_err']:.2e}, aux rel err "
        f"{v['aux_rel_err']:.2e}, ms {v['ms']:.2f} (ep), {v['one_ms']:.2f} "
        f"(one process)" for k, v in a["cases"].items())
    log(f"[a2a] moe_ffn_a2a, Mixtral-8x7B's layer widths (4096, 8 experts "
        f"of 14336, top-2), f32, ep {ep}, {a['rows']} rows a rank, against "
        f"moe_ffn(group_size={a['rows']}) on one process (tol {A2A_REL:.0e} "
        f"of the largest |value|, aux {A2A_AUX_RTOL:.0e}): {cases}; "
        f"gradients' rel err "
        f"{ {k: f'{v:.2e}' for k, v in a['grad_rel_err'].items()} }; the "
        f"{a['route']!r} route, the all-reduce route bitwise equal to the "
        f"native: {a['routes_bitwise']}" + at)
    f = t["fsdp"]
    per = [rk["mp_rank"]["fsdp"] for rk in ranks]
    state = [f"{p['shard_bytes'] / gb:.3f} + {p['moment_bytes'] / gb:.3f}"
             for p in per]
    log(f"[fsdp] llama_loss + AdamW step, Mixtral-8x7B's widths at 1 layer "
        f"({f['params'] / 1e9:.2f} G params), f32, capacity factor "
        f"{FSDP_CF}, {f['rows']} x {f['T']} tokens, dp {f['dp']} x ep "
        f"{f['ep']} (LLAMA_FSDP_SPECS; experts a rank {f['expert_shard']}): "
        f"loss rel err {f['loss_rel_err']:.2e} (tol {TRAIN_LOSS_RTOL:.0e}), "
        f"rank 0's gradients, worst max|err| / max|g| "
        f"{f['grad_rel_err']:.2e} at {f['grad_rel_err_at']} (tol "
        f"{TRAIN_GRAD_RTOL:.0e} a leaf), params max|err| "
        f"{f['param_abs_err']:.2e}, {f['params_off']} of {f['params_held']} "
        f"off by more than {TRAIN_PARAM_ATOL:.0e}, of them "
        f"{f['params_off_not_near0']} where |g| is past the rounding bound "
        f"(tol 0) against one process; ms a step {[round(p['ms'], 1) for p in per]} (each "
        f"rank), one process {f['one_ms']:.1f}; each rank's params + "
        f"moments {state} GB, "
        f"peak {[round((p['peak_bytes'] or 0) / gb, 3) for p in per]} GB, "
        f"one process's peak {(f['one_peak_bytes'] or 0) / gb:.3f} GB" + at)
    for name, r in ranks[0]["sp_rank"]["ckpt"].items():
        each = [rk["sp_rank"]["ckpt"][name] for rk in ranks]
        log(f"[ckpt] save_sharded of the decoder trainer's {name} shards: "
            f"{[round(e['bytes'] / 1e6, 1) for e in each]} MB a rank, save "
            f"{[round(e['save_s'], 2) for e in each]} s (each rank), "
            f"load whole on one process {r['load_s']:.2f} s, "
            f"{r['leaves']} leaves equal to the gathered tree" + at)
    log(f"[mp] peak device memory over the ep, pp and a2a checks "
        f"{[round((rk['mp_rank']['peak_bytes'] or 0) / gb, 3) for rk in ranks]} "
        f"GB each rank; kernel launches (rank 0, each path counted from 0): "
        f"{t['launches']}; seconds {[round(rk['mp_s'], 1) for rk in ranks]} "
        f"(each rank), rank 0's by path "
        f"{ {k: round(v, 1) for k, v in t['s'].items()} }")


def phase_dp(engines, weights, card: str, device="cuda", small=None,
             graphs=None) -> dict:
    """Phase 22: data and tensor parallelism on the card(s).  The trainers'
    ranks (``dp_layout``; the tp checks in the same ranks) run first,
    spawned while this process holds no large tree; then the dp-sharded
    pool.  ``device="cpu"`` with ``small``
    (``_dp_rank``'s) and small weights rehearses the control flow."""
    from llmvox_tpu_torch.parallel.launch import spawn
    t0 = time.perf_counter()
    world, backend, devices = dp_layout(device)
    log(f"[dp] {world} ranks over {backend} on {devices} ({card})")
    # the host's cores split over the ranks: OpenMP threads that
    # outnumber the cores spin against each other
    ranks = spawn(_dp_rank, world, world, small, backend=backend,
                  devices=devices, threads=max(1, os.cpu_count() // world),
                  timeout_s=600)
    r0 = ranks[0]
    for r in ranks:
        assert (r["world"], r["backend"]) == (world, backend), r
        log(f"[dp] rank {r['rank']} on {r['device']}: decoder updates "
            f"{[f'{m:.1f}' for m in r['decoder']['update_ms']]} ms, codec "
            f"steps {[f'{m:.1f}' for m in r['codec']['step_ms']]} ms, "
            f"lockstep after every update {r['decoder']['lockstep']} / "
            f"{r['codec']['lockstep']}")
    d, c = r0["decoder"], r0["codec"]
    log(f"[dp] decoder, DecoderConfig() with {TRAIN_HEADS} draft heads, f32, "
        f"{2 * world} x {DP_TRAIN_T} rows a micro-step, k=2, 2 updates: "
        f"losses' rel err {d['loss_rel_err']:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:.0e}), params' max|err| {d['param_abs_err']:.2e} "
        f"(tol {TRAIN_PARAM_ATOL:.0e}; moved up to {d['param_moved']:.2e}) "
        f"against one process on the same card; ms an update (the second) "
        f"world {world} {d['update_ms'][1]:.1f}, world 1 "
        f"{d['world1_update_ms'][1]:.1f} ({backend}; {card})")
    log(f"[dp] codec, CodecConfig() and every discriminator, f32, "
        f"{2 * world} x {CODEC_CHECK_SAMPLES}, the k-means step and one more: "
        f"logs' worst rel err {c['log_rel_err']:.2e} (tol "
        f"{DP_CODEC_LOG_RTOL:.0e}; held to the f64 run instead: "
        f"{c['logs_excused'] or 'none'}), codebook max|err| "
        f"{c['vq_abs_err']:.2e} (tol {CODEC_VQ_ATOL:.0e}), params off "
        f"{DP_CODEC_PARAM_TOL} {c['params_off']} of {c['params']}; ms a step "
        f"(the second) world {world} {c['step_ms'][1]:.1f}, world 1 "
        f"{c['world1_step_ms'][1]:.1f} ({backend}; {card})")
    _log_tp(r0["tp"], ranks, backend, card)
    _log_sp(r0["sp"], ranks, backend, card)
    _log_mp(r0["mp"], ranks, backend, card)
    train_s = time.perf_counter() - t0
    pool = _dp_pool(engines, weights, devices[:world], graphs)
    out = {"world": world, "backend": backend, "devices": devices,
           "decoder": d, "codec": c, "tp": r0["tp"], "sp": r0["sp"],
           "mp": r0["mp"], "pool": pool,
           "train_s": train_s,
           "ranks": [{k: r[k] for k in ("rank", "device")} for r in ranks]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[dp] phase 22 took {out['phase_s']:.1f} s (ranks {train_s:.1f})")
    return out


def block_graphs(argv) -> int:
    """``--block-graphs [--root DIR]``: only the B=1 bf16 32-token block as
    a CUDA graph, dense and w4, with ``llmvox_tpu_torch`` imported from DIR
    (another checkout, e.g. the parent commit) when given, so two versions
    are timed by one script on one card, one process each.  A measurement
    aid for comparing two checkouts: no check of the smoke run uses it, and
    phase 12 prints the same graph block times of this checkout."""
    if "--root" in argv:
        sys.path.insert(0, os.path.abspath(argv[argv.index("--root") + 1]))
    from llmvox_tpu_torch.ops import build
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import CodecConfig, DecoderConfig
    import llmvox_tpu_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[block-graphs] package {os.path.dirname(llmvox_tpu_torch.__file__)}"
        f" on {card}")
    build.build_all()
    dcfg, ccfg = DecoderConfig(), CodecConfig()
    weights = (P.init_decoder_params(0, dcfg), P.init_codec_params(1, ccfg),
               P.random_text_table(2, dcfg), dcfg, ccfg,
               smoke_serve_config())
    out = {mode: [phase_block_graph(w) for _ in range(3)]
           for mode, w in (("dense", weights),
                           ("w4", _quantized(weights, "w4")))}
    log(json.dumps({"block_graph_ms": out, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def k23_times(argv) -> int:
    """``--k23-times [--root DIR]``: only K2's and K3's bf16 device times
    per call at every shape phases 5 and 8 time, with ``llmvox_tpu_torch``
    imported from DIR (another checkout, e.g. the parent commit) when
    given, so two designs are timed on one card in one call.  A
    measurement aid: no check of the smoke run uses it."""
    if "--root" in argv:
        sys.path.insert(0, os.path.abspath(argv[argv.index("--root") + 1]))
    from llmvox_tpu_torch.ops import build, cuda_batched_attn, \
        cuda_verify_attn
    from llmvox_tpu_torch.utils.config import DecoderConfig
    import llmvox_tpu_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[k23-times] package {os.path.dirname(llmvox_tpu_torch.__file__)}"
        f" on {card}")
    build.build_all()
    cfg = DecoderConfig()
    L, S, C, H = cfg.n_layer, cfg.block_size, cfg.n_embd, cfg.n_head
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn(L, K2_B, S, C, generator=gen, device=dev, dtype=bf)
    v = torch.randn(L, K2_B, S, C, generator=gen, device=dev, dtype=bf)
    li = [0]

    def cycled(fn):
        def run():
            li[0] = (li[0] + 1) % L
            fn(li[0])
        return run

    out = {}
    q = torch.randn(K2_B, C, generator=gen, device=dev, dtype=bf)
    for name in K2_TIMED:
        p = torch.tensor(K2_POS[name], dtype=torch.int32, device=dev)
        out[f"K2 {name}"] = graph_ms(cycled(
            lambda i: cuda_batched_attn.batched_decode_attention(
                q, k[i], v[i], p, H)))
    for nq in K3_NQ:
        q = torch.randn(K3_B, nq, C, generator=gen, device=dev, dtype=bf)
        sets = {n: pl for n, pl in k3_positions(nq, S).items()
                if n != "uniform 511"}
        for name, plist in sets.items():
            p = torch.tensor(plist, dtype=torch.int32, device=dev)
            out[f"K3 nq={nq} {name}"] = graph_ms(cycled(
                lambda i: cuda_verify_attn.verify_attention(q, k[i], v[i], p,
                                                            H)))
        q1 = q[:1].contiguous()
        p = torch.tensor([127], dtype=torch.int32, device=dev)
        out[f"K3 nq={nq} B=1 pos 127"] = graph_ms(cycled(
            lambda i: cuda_verify_attn.verify_attention(q1, k[i, :1],
                                                        v[i, :1], p, H)))
    for name, ms in out.items():
        log(f"[k23-times] {name}: {ms * 1e3:.2f} us")
    log(json.dumps({"k23_ms": out, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dispatch_ab(argv) -> int:
    """``--dispatch-ab``: phase 4's three dedicated requests with the
    replicas' blocks launched three ways, in turns, in one process: on the
    event loop (the port before its dispatch thread), on a thread per
    replica, and on the card's one dispatch thread (the served design),
    each with the 1 ms lag ticker and without it.  A measurement aid: no
    check uses it."""
    import functools
    from concurrent.futures import ThreadPoolExecutor
    global _LoopLag
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[dispatch-ab] {card}")
    engines, weights = phase_offline()
    ticker = _LoopLag

    class _NoLag:
        def __init__(self, loop):
            pass

        def stop(self):
            return {"median_ms": float("nan"), "max_ms": float("nan"),
                    "ticks": 0}

    def own_thread():
        ex = ThreadPoolExecutor(1, initializer=torch.cuda.set_device,
                                initargs=(torch.cuda.current_device(),))

        async def dispatch(fn, *args, **kwargs):
            return await asyncio.get_running_loop().run_in_executor(
                ex, functools.partial(fn, *args, **kwargs))
        return ex, dispatch

    order = [(d, t) for t in (True, False)
             for d in ("card thread", "loop", "thread per replica")]
    out = {}
    for design, tick in order + order[::-1]:
        _LoopLag = ticker if tick else _NoLag
        own = []
        for e in engines:
            if design == "loop":
                e.dispatch = None   # the scheduler calls the engine itself
            elif design == "thread per replica":
                ex, e.dispatch = own_thread()
                own.append(ex)
        key = f"{design}, ticker {'on' if tick else 'off'}"
        log(f"[dispatch-ab] {key}")
        rec = out.setdefault(key, [])
        try:
            phase_server(engines, weights, record=rec)
        finally:
            _LoopLag = ticker
            for e in engines:
                e.__dict__.pop("dispatch", None)
            for ex in own:
                ex.shutdown(wait=True)
    for key, rec in out.items():
        log(f"[dispatch-ab] {key}: first audio "
            f"{min(r['ttfa_ms'] for r in rec):.1f}-"
            f"{max(r['ttfa_ms'] for r in rec):.1f} ms, RTF "
            f"{min(r['rtf'] for r in rec):.3f}-"
            f"{max(r['rtf'] for r in rec):.3f}, loop lag max "
            + ", ".join(f"{r['lag_max_ms']:.1f}" for r in rec) + " ms")
    log(json.dumps({"dispatch_ab": out, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase22_alone(argv) -> int:
    """``--phase22``: the kernels built, two bf16 engines at
    ``DecoderConfig()`` for the pool's reference, then phase 22 alone over
    every card up to ``DP_MAX_WORLD`` (two gloo ranks on one card, NCCL
    over four): the data- and tensor-parallel checks without the other
    phases.  It fails where phase 22 fails."""
    from llmvox_tpu_torch.utils import params as P
    from llmvox_tpu_torch.utils.config import CodecConfig, DecoderConfig
    lap = Laps()
    card = phase_card_and_build()
    lap("build")
    d, cc = DecoderConfig(), CodecConfig()
    weights = (P.init_decoder_params(0, d), P.init_codec_params(1, cc),
               P.random_text_table(2, d), d, cc, smoke_serve_config())
    engines = [make_engine(weights, "cuda", torch.bfloat16, warm=True)
               for _ in range(2)]
    lap("engines")
    dp = phase_dp(engines, weights, card)
    log(json.dumps({"dp": dp}))
    lap("phase 22")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--phase22" in argv:
        return phase22_alone(argv)
    if "--block-graphs" in argv:
        return block_graphs(argv)
    if "--k23-times" in argv:
        return k23_times(argv)
    if "--dispatch-ab" in argv:
        return dispatch_ab(argv)
    kernels_only = "--kernels" in argv
    lap = Laps()
    card = phase_card_and_build()
    lap("build")
    k1 = phase_k1()
    k2 = phase_k2()
    k3 = phase_k3()
    k4 = phase_k4()
    phase_other_cards()
    lap("kernels K1-K4")
    launches = pool_launches = spec_launches = quant_launches = None
    llm_k4_launches = voicechat_launches = train_launches = None
    codec_launches = {"k1": None, "k2": None, "k3": None, "k4": None}
    eval_launches = dict(codec_launches)
    pool_llm = {"k1": None, "k2": None, "k3": None, "k4": None}
    spec_llm = dict(pool_llm)
    moe_llm = dict(pool_llm)
    mesh_pool = dict(pool_llm)
    tp_path = dict(pool_llm)
    sp_path = dict(pool_llm)
    mp_paths = {p: dict(pool_llm) for p in ("ep", "a2a", "pp", "llama_fsdp")}
    if not kernels_only:
        engines, weights = phase_offline()
        lap("offline")
        train = phase_train(weights)
        train_launches = train["k1_train_launches"]
        log(json.dumps({"train": train}))
        lap("phase 19")
        codec_train = phase_codec_train(card)
        codec_launches = codec_train["launches"]
        log(json.dumps({"codec_train": codec_train}))
        lap("phase 20")
        codec_eval = phase_codec_eval(card)
        eval_launches = codec_eval["launches"]
        log(json.dumps({"codec_eval": codec_eval}))
        lap("phase 21")
        phase_block_graph(weights)
        launches = phase_server(engines, weights)
        lap("graph block, server")
        phase_batch(weights)
        phase_block_graph(weights, batch=K2_B)
        pool_launches, _ = phase_pool_server(engines, weights)
        lap("batch, pool")
        phase_spec_offline(weights)
        spec_launches = phase_spec_server(engines, weights)["k3_launches"]
        lap("speculation")
        quant_launches = phase_quant(engines, weights)["k4_launches"]
        lap("quantized")
        phase_graphs(engines, weights)
        lap("graphs and eager")
        llm, llm_model, qtree = phase_llm(engines, weights, card)
        llm_k4_launches = llm["k4_llm_launches"]
        log(json.dumps({"llm": llm}))
        lap("phase 14")
        # phase 16 before phase 15: phase 15 serves through its pool
        llm_pool, pooled = phase_llm_pool(engines, weights, card,
                                          llm_model, qtree)
        del qtree
        log(json.dumps({"llm_pool": llm_pool}))
        lap("phase 16")
        asr = phase_asr(engines, weights, card, llm_model, llm=llm,
                        pooled=pooled)
        voicechat_launches = asr["served"]["k1_launches"]
        # the pooled LLM's paths: phase 15's pooled /voicechat on the
        # dedicated replicas (K1), phase 16's rounds with the TTS pool
        # (K2, K3) and its w4 burst (K4)
        pool_llm = {"k1": asr["pooled"]["k1_launches"],
                    "k2": llm_pool["k2_llm_pool_launches"],
                    "k3": llm_pool["k3_llm_pool_launches"],
                    "k4": llm_pool["k4_llm_pool_launches"]}
        log(json.dumps({"asr": asr}))
        lap("phase 15")
        # phase 17 speculates on phase 14's bf16 tree; the streams and
        # pools of phases 14-16 are freed first
        params = llm_model.params
        del llm_model, pooled
        gc.collect()
        torch.cuda.empty_cache()
        llm_spec = phase_llm_spec(engines, weights, card, params)
        del params
        log(json.dumps({"llm_spec": llm_spec}))
        lap("phase 17")
        # its two bursts, each counted from 0 to its end
        spec_llm = {k: llm_spec[f"{k}_launches"]
                    for k in ("k1", "k2", "k3", "k4")}
        gc.collect()
        torch.cuda.empty_cache()
        moe = phase_moe(engines, weights, card)
        log(json.dumps({"moe": moe}))
        lap("phase 18")
        # its B=1 request and its burst, each counted from 0 to its end
        moe_llm = {k: moe[f"{k}_launches"] for k in ("k1", "k2", "k3", "k4")}
        # phase 22 spawns its ranks once phase 18's trees are freed
        del moe
        gc.collect()
        torch.cuda.empty_cache()
        dp = phase_dp(engines, weights, card)
        log(json.dumps({"dp": dp}))
        lap("phase 22")
        # the bf16 mesh pool round, counted from 0 to its end: K2's per
        # shard, the others' totals (0)
        mesh_pool = dict(dp["pool"]["launches"],
                         k2=dp["pool"]["k2_shard_launches"])
        # phase 22's tensor-parallel checks on rank 0, counted from 0
        tp_path = dp["tp"]["launches"]
        # and its sequence-parallel and FSDP checks
        sp_path = dp["sp"]["launches"]
        # and its ep, a2a, pp and Llama FSDP checks, each from 0
        mp_paths = dp["mp"]["launches"]
    deep = k1["timings"][8191]
    entry = {"name": "K1 decode_attention", "route": "cuda",
             "source": "llmvox_tpu_torch/csrc/decode_attention.cu",
             "replaces": "llmvox_tpu/ops/pallas_attn.py:693",
             "tpu": "llmvox_tpu/ops/pallas_attn.py::pallas_decode_attention",
             "launches": launches, "max_abs_err": k1["max_abs_err"],
             "voicechat_launches": voicechat_launches,
             "train_launches": train_launches,
             "llm_pool_launches": pool_llm["k1"],
             "llm_spec_launches": spec_llm["k1"],
             "moe_launches": moe_llm["k1"],
             "mesh_pool_launches": mesh_pool["k1"],
             "tp_launches": tp_path["k1"],
             "sp_fsdp_launches": sp_path["k1"],
             **{f"{p}_launches": n["k1"] for p, n in mp_paths.items()},
             "codec_train_launches": codec_launches["k1"],
             "codec_eval_launches": eval_launches["k1"],
             "pos": 8191, "dtype": "bfloat16", **deep,
             "other": {f"pos {pos}": {key: t[key] for key in
                                      ("ms", "bound_ms", "plain_ms",
                                       "library_ms")}
                       for pos, t in k1["timings"].items() if pos != 8191}}
    k2_deep = k2["timings"]["uniform 8191"]
    entry2 = {"name": "K2 batched_decode_attention", "route": "cuda",
              "source": "llmvox_tpu_torch/csrc/batched_decode_attention.cu",
              "replaces": "llmvox_tpu/ops/pallas_attn.py:307",
              "tpu": "llmvox_tpu/ops/pallas_attn.py::"
                     "pallas_batched_decode_attention",
              "launches": pool_launches, "max_abs_err": k2["max_abs_err"],
              "llm_pool_launches": pool_llm["k2"],
              "llm_spec_launches": spec_llm["k2"],
              "moe_launches": moe_llm["k2"],
              "mesh_pool_launches": mesh_pool["k2"],
              "tp_launches": tp_path["k2"],
              "sp_fsdp_launches": sp_path["k2"],
              **{f"{p}_launches": n["k2"] for p, n in mp_paths.items()},
              "codec_train_launches": codec_launches["k2"],
              "codec_eval_launches": eval_launches["k2"],
              "B": K2_B, "pos": 8191, "dtype": "bfloat16", **k2_deep,
              "other": {name: {key: t[key] for key in
                               ("ms", "bound_ms", "plain_ms", "library_ms")}
                        for name, t in k2["timings"].items()
                        if name != "uniform 8191"}}
    k3_name = f"nq={SPEC_K + 1} uniform {8192 - SPEC_K - 1}"
    entry3 = {"name": "K3 verify_attention", "route": "cuda",
              "source": "llmvox_tpu_torch/csrc/verify_attention.cu",
              "replaces": "llmvox_tpu/ops/pallas_attn.py:634",
              "tpu": "llmvox_tpu/ops/pallas_attn.py::pallas_verify_attention",
              "launches": spec_launches, "max_abs_err": k3["max_abs_err"],
              "llm_pool_launches": pool_llm["k3"],
              "llm_spec_launches": spec_llm["k3"],
              "moe_launches": moe_llm["k3"],
              "mesh_pool_launches": mesh_pool["k3"],
              "tp_launches": tp_path["k3"],
              "sp_fsdp_launches": sp_path["k3"],
              **{f"{p}_launches": n["k3"] for p, n in mp_paths.items()},
              "codec_train_launches": codec_launches["k3"],
              "codec_eval_launches": eval_launches["k3"],
              "B": K3_B, "nq": SPEC_K + 1, "pos": 8192 - SPEC_K - 1,
              "dtype": "bfloat16", **k3["timings"][k3_name],
              "other": {name: {key: t[key] for key in
                               ("ms", "bound_ms", "plain_ms", "library_ms")}
                        for name, t in k3["timings"].items()
                        if name != k3_name}}
    k4_main = ("wproj", 1)
    entry4 = {"name": "K4 int4_matmul", "route": "cuda",
              "source": "llmvox_tpu_torch/csrc/int4_matmul.cu",
              "replaces": "llmvox_tpu/ops/pallas_quant.py:82",
              "tpu": "llmvox_tpu/ops/pallas_quant.py::_int4_mm",
              "launches": quant_launches, "max_abs_err": k4["max_abs_err"],
              "llm_launches": llm_k4_launches,
              "llm_pool_launches": pool_llm["k4"],
              "llm_spec_launches": spec_llm["k4"],
              "moe_launches": moe_llm["k4"],
              "mesh_pool_launches": mesh_pool["k4"],
              "tp_launches": tp_path["k4"],
              "sp_fsdp_launches": sp_path["k4"],
              **{f"{p}_launches": n["k4"] for p, n in mp_paths.items()},
              "codec_train_launches": codec_launches["k4"],
              "codec_eval_launches": eval_launches["k4"],
              "weight": "wproj 3072->768", "M": 1, "dtype": "bfloat16",
              **k4["timings"][k4_main],
              "other": {f"{name} M={m}": {key: t[key] for key in
                                          ("ms", "bound_ms", "plain_ms",
                                           "library_ms", "int4pack_ms")}
                        for (name, m), t in k4["timings"].items()
                        if (name, m) != k4_main}}
    lap.total()
    log(json.dumps({"kernels": [entry, entry2, entry3, entry4]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
