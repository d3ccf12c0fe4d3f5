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
     decoder's four weight shapes, f32 and bf16, twice (bitwise equal);
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
     bf16 turns (graphs, eager, eager, graphs) without the lag ticker:
     TTFA and RTF on the replicas, TTFA, aggregate and host ms per step
     at 4 and 8 concurrent requests on a 16-slot pool.
Then one JSON line with the kernels' numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
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
# sum them in f32 in another order: f32 differs by sum-order noise, a bf16
# output by one bf16 ulp (K1's limits, with f32 at 1e-5)
K4_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}
L2_BYTES = 50e6


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
            err = 0.0
            for m in K4_M:
                x = torch.randn(m, cin, generator=gen).to(dev, dtype)
                got = cuda_int4_mm.int4_matmul(x, q, s)
                again = cuda_int4_mm.int4_matmul(x, q, s)
                ref = cuda_int4_mm.plain_int4_matmul(x, q, s)
                torch.cuda.synchronize()
                assert got.shape == (m, cout) and got.dtype == dtype
                assert torch.equal(got, again), ("K4 not deterministic",
                                                 name, dtype, m)
                torch.testing.assert_close(got.float(), ref.float(),
                                           **K4_TOL[dtype])
                err = max(err, (got.float() - ref.float()).abs().max().item())
            max_err = max(max_err, err)
            log(f"[k4] {str(dtype):15s} {name:5s} {cin}->{cout} ({groups} "
                f"groups) ok at M {K4_M}, bitwise repeatable, max |err| "
                f"{err:.3g}")
        for m in K4_M:
            timings[(name, m)] = _time_k4(w, m, gen)
    return {"max_abs_err": max_err, "timings": timings}


def _time_k4(w, m, gen) -> dict:
    from llmvox_tpu_torch.ops import cuda_int4_mm, quant
    dev = torch.device("cuda")
    cin, cout = w.shape
    groups = w.s.shape[0]
    x = torch.randn(m, cin, generator=gen).to(dev, torch.bfloat16)
    # enough distinct copies that a cycle of calls exceeds the 50 MB L2
    n = int(2 * L2_BYTES // w.q.numel()) + 1
    qs = [w.q.to(dev) for _ in range(n)]
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
    t = {"ms": graph_ms(run_kernel), "plain_ms": graph_ms(run_plain),
         "dense_bf16_ms": graph_ms(run_dense)}
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

            t["int4pack_ms"] = graph_ms(run_int4pack)
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
    1e-5.  bf16, in turns graph, eager, eager, graph, without the lag
    ticker: TTFA and RTF on the dedicated replicas (3 requests), TTFA,
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
    for on in (True, False, False, True):
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
        text = (f"[graphs] bf16 {mode} (2 turns): dedicated TTFA median "
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--block-graphs" in argv:
        return block_graphs(argv)
    if "--k23-times" in argv:
        return k23_times(argv)
    if "--dispatch-ab" in argv:
        return dispatch_ab(argv)
    kernels_only = "--kernels" in argv
    card = phase_card_and_build()
    k1 = phase_k1()
    k2 = phase_k2()
    k3 = phase_k3()
    k4 = phase_k4()
    phase_other_cards()
    launches = pool_launches = spec_launches = quant_launches = None
    if not kernels_only:
        engines, weights = phase_offline()
        phase_block_graph(weights)
        launches = phase_server(engines, weights)
        phase_batch(weights)
        phase_block_graph(weights, batch=K2_B)
        pool_launches, _ = phase_pool_server(engines, weights)
        phase_spec_offline(weights)
        spec_launches = phase_spec_server(engines, weights)["k3_launches"]
        quant_launches = phase_quant(engines, weights)["k4_launches"]
        phase_graphs(engines, weights)
    deep = k1["timings"][8191]
    entry = {"name": "K1 decode_attention", "route": "cuda",
             "source": "llmvox_tpu_torch/csrc/decode_attention.cu",
             "replaces": "llmvox_tpu/ops/pallas_attn.py:693",
             "tpu": "llmvox_tpu/ops/pallas_attn.py::pallas_decode_attention",
             "launches": launches, "max_abs_err": k1["max_abs_err"],
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
              "weight": "wproj 3072->768", "M": 1, "dtype": "bfloat16",
              **k4["timings"][k4_main],
              "other": {f"{name} M={m}": {key: t[key] for key in
                                          ("ms", "bound_ms", "plain_ms",
                                           "library_ms", "int4pack_ms")}
                        for (name, m), t in k4["timings"].items()
                        if (name, m) != k4_main}}
    log(json.dumps({"kernels": [entry, entry2, entry3, entry4]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
