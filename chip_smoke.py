#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels    # phases 1, 2 and 5 only

Phases, each of which raises on failure (exit code non-zero, no result):
  1. the card's name and power limit; build every kernel from the sources
     in ``llmvox_tpu_torch/csrc`` (nvcc's register/shared-memory report is
     printed);
  2. kernel K1 (decode attention) against its plain PyTorch version at the
     deployed decoder's width, every layer view of a (4, 8192, 768) cache,
     f32 and bf16; its times beside the byte bound and a library yardstick;
  3. the offline main path at full width with random seeded weights:
     ``TTSEngine.tts`` in bf16, f32 on the card against f32 on the CPU, the
     kernel's launch count on that path, decode and synthesis times;
  4. the HTTP server on two replicas answering three sequential
     ``POST /tts``; each stream's chunk sizes against the dump ladder,
     time to first audio and real-time factor.  K1's launch count in the
     JSON line is this phase's.
  5. kernel K2 (batched decode attention) against its plain version at
     the pool's full width, every layer view of (4, 16, 8192, 768) caches,
     f32 and bf16, at ragged and uniform positions; its times beside the
     byte bound and a library yardstick;
  6. the offline batched path: ``BatchTTS`` with 8 streams, f32 rows
     against the f32 B=1 engine token for token, bf16 waves finite; one
     B=16 batched block eagerly and as a CUDA graph;
  7. the HTTP server on the continuous-batching pool: one f32 round of
     concurrent ``POST /tts`` checked against the B=1 engine's chunk
     schedule, then 4 and 8 concurrent bf16 requests on a 16-slot pool
     (per-request first audio and RTF, aggregate throughput, the pool's
     counters).  K2's launch count in the JSON line is this phase's.
Then one JSON line with the kernels' numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import dataclasses
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
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                log(f"[build] {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

K1_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
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


def phase_k1() -> dict:
    from llmvox_tpu_torch.ops import attention, cuda_attn
    from llmvox_tpu_torch.utils.config import DecoderConfig
    cfg = DecoderConfig()
    L, S, C, H = cfg.n_layer, cfg.block_size, cfg.n_embd, cfg.n_head
    D = C // H
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    max_err = 0.0
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.randn(L, S, C, generator=gen).to(dev, dtype)
        v = torch.randn(L, S, C, generator=gen).to(dev, dtype)
        q = torch.randn(C, generator=gen).to(dev, dtype)
        for pos in (0, 1, 255, 256, 511, 4095, 8191):
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            err = 0.0
            for layer in range(L):
                got = cuda_attn.decode_attention(q, k[layer], v[layer], p, H)
                ref = attention.decode_attention(q, k[layer], v[layer], p,
                                                 n_head=H)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), ref.float(),
                                           **K1_TOL[dtype])
                err = max(err, (got.float() - ref.float()).abs().max().item())
            max_err = max(max_err, err)
            log(f"[k1] {str(dtype):15s} pos {pos:5d} ok, max |err| over "
                f"{L} layers {err:.3g}")
            if dtype is torch.bfloat16 and pos in (511, 4095, 8191):
                timings[pos] = _time_k1(q, k, v, p, pos, H, D, dtype)
        del k, v
    return {"max_abs_err": max_err, "timings": timings}


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
        **K1_TOL[dtype])
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


def make_engine(weights, device, dtype):
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.serve.engine import TTSEngine
    dec_p, codec_p, table, dcfg, ccfg, scfg = weights
    codec = WavCodec(codec_p, ccfg, buckets=scfg.chunk_buckets,
                     device=device)
    return TTSEngine(dec_p, table, codec, dcfg, scfg, device=device,
                     cache_dtype=dtype)


def synth_len(tokens, eoa) -> int:
    return len(tokens) - (1 if tokens and tokens[-1] == eoa else 0)


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
    torch.cuda.synchronize()
    log(f"[offline] warmup of both engines: {time.perf_counter() - t0:.2f} s")

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
    deep = make_engine(no_eoa, device, torch.bfloat16)
    cuda_attn.LAUNCHES = 0
    wav, toks = deep.tts(TEXT, max_tokens=256)
    assert len(toks) == 256 and len(wav) == 256 * ccfg.hop_length
    assert np.isfinite(wav).all(), "non-finite samples"
    assert cuda_attn.LAUNCHES == dcfg.n_layer * deep.decode_steps > 0
    log(f"[offline] bf16 tts, EOA off: 256 tokens (pos 0..255), "
        f"{len(wav)} finite samples; K1 launches {cuda_attn.LAUNCHES}")
    g32 = make_engine(no_eoa, device, torch.float32)
    c32 = make_engine(no_eoa, "cpu", torch.float32)
    _, tg = g32.tts(TEXT, max_tokens=64)
    _, tc = c32.tts(TEXT, max_tokens=64)
    assert len(tg) == 64 and tg == tc, (tg, tc)
    log("[offline] f32 card vs f32 CPU (plain path), EOA off: 64 tokens "
        "identical")
    del g32, c32

    # decode time per 32-token block, each fetched before the next is
    # issued, over positions 0..255
    ids = list(np.frombuffer(TEXT.encode(), np.uint8).astype(np.int32) + 3)
    buf = np.full(8 * deep.block + len(ids), dcfg.pad_token_id, np.int32)
    buf[:len(ids)] = ids
    state = deep.new_state()
    block_ms = []
    for i in range(8):
        t0 = time.perf_counter()
        got, state = deep.decode_block(
            state, buf[i * deep.block:(i + 1) * deep.block], len(ids),
            deep.block)
        block_ms.append((time.perf_counter() - t0) * 1e3)
        assert len(got) == deep.block
    log(f"[offline] decode ms per {deep.block}-token block (pos 0..255, "
        f"bf16, host clock, issue to fetch): "
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
    log("[offline] synthesis ms per bucket (f32, host to host): "
        + ", ".join(f"{b}: {ms:.1f}" for b, ms in synth_ms.items()))
    return engines, weights


# ---------------------------------------------------------------------------
# phase 4: the server
# ---------------------------------------------------------------------------

def phase_block_graph(weights, batch: int = 0) -> None:
    """One 32-token bf16 decode block (EOA off, pos 0..31) eagerly and as a
    CUDA graph: the graph must give the same tokens, and its replay time
    is the device's busy time for the block, without the host's launch
    gaps that the eager block pays.  With ``batch`` B > 0 the block is the
    pool's batched one (``decode_block_batch``, K2) over B streams."""
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
        start = eng.new_state()
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


def phase_server(engines, weights) -> int:
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
    with _Server(build_server(cfg, engines), port):
        cuda_attn.LAUNCHES = 0
        steps0 = sum(e.decode_steps for e in engines)
        for r in range(3):
            t0 = time.perf_counter()
            chunks = post_chunks("127.0.0.1", port, "/tts",
                                 {"text": "Say something."}, timeout=300)
            wall = time.perf_counter() - t0
            sizes = [len(c) // 4 // hop for _, c in chunks]
            assert chunks and all(len(c) % (4 * hop) == 0
                                  for _, c in chunks), "ragged chunk"
            wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
            assert np.isfinite(wav).all(), "non-finite samples"
            assert sizes == want, (sizes, want)
            audio_s = len(wav) / ccfg.sample_rate
            log(f"[server] request {r}: {len(chunks)} chunks {sizes}, "
                f"{audio_s:.2f} s audio, first audio {chunks[0][0] * 1e3:.1f}"
                f" ms, wall {wall * 1e3:.1f} ms, RTF {wall / audio_s:.3f}")
        launches = cuda_attn.LAUNCHES
        steps = sum(e.decode_steps for e in engines) - steps0
    assert launches == dcfg.n_layer * steps > 0, (launches, steps)
    log(f"[server] K1 launches on the served path: {launches} = "
        f"{dcfg.n_layer} layers x {steps} decode steps")
    return launches


# ---------------------------------------------------------------------------
# phase 5: K2 against its plain version
# ---------------------------------------------------------------------------

K2_B = 16
# a ragged set across the 16 rows (the K1 positions among them) and uniform
# sets; row b attends rows 0..pos[b] of its own cache
K2_POS = {
    "ragged": [0, 1, 255, 256, 511, 4095, 8191, 2, 100, 777, 1024, 2047,
               3000, 5000, 6500, 8190],
    "uniform 511": [511] * K2_B,
    "uniform 4095": [4095] * K2_B,
    "uniform 8191": [8191] * K2_B,
}


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
                ref = attention.batched_decode_attention(
                    q, k[layer], v[layer], p, n_head=H)
                torch.cuda.synchronize()
                # K1's tolerances, for the same reason: f32 sums in
                # another order than the plain einsum's, and in bf16 the
                # output is rounded to bf16
                torch.testing.assert_close(got.float(), ref.float(),
                                           **K1_TOL[dtype])
                err = max(err, (got.float() - ref.float()).abs().max().item())
            max_err = max(max_err, err)
            log(f"[k2] {str(dtype):15s} B={K2_B} {name:12s} ok, max |err| "
                f"over {L} layers {err:.3g}")
            if dtype is torch.bfloat16:
                timings[name] = _time_k2(q, k, v, p, plist, H, dtype)
        del k, v
        torch.cuda.empty_cache()
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
        **K1_TOL[dtype])
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
                              device, torch.float32)
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


def phase_pool_server(engines, weights, device="cuda") -> int:
    """The deployed configs through the engines' weights; smaller ones and
    the CPU only to rehearse the script's control flow."""
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
    eng32 = make_engine(weights, device, torch.float32)
    cap = 2 * (scfg.max_audio_length + scfg.initial_dump_size_2)
    want = []
    for text, dump in ((REPLY, scfg.initial_dump_size_1),
                       ("", scfg.initial_dump_size_2)):
        want += expected_chunks(eng32.tts(text, max_tokens=cap)[1], dump,
                                scfg, eoa)
    del eng32
    port = _free_port()
    cfg = dataclasses.replace(scfg, api_port=port, pool_capacity=8)
    pool = DecodePool(dec_p, table, codec, capacity=8, dcfg=dcfg, scfg=cfg,
                      device=device, cache_dtype=torch.float32)
    with _Server(build_server(cfg, engines, pool=pool), port):
        res, _ = _concurrent_round(port, 4, hop, sr)
    for sizes, *_ in res:
        assert sizes == want, (sizes, want)
    log(f"[pool] f32 pool (8 slots), 4 concurrent requests: every stream's "
        f"chunks {want} equal the f32 B=1 engine's schedule")
    del pool

    # bf16 rounds with EOA off: every sentence runs to the length cap, so
    # each stream's schedule is the dump ladder's, whatever its tokens
    no_eoa = dataclasses.replace(dcfg, eoa_token_id=-1)
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
        f"{time.perf_counter() - t0:.2f} s; expected chunks per request "
        f"{want} (EOA off: sentences end at the length cap)")
    cuda_attn.LAUNCHES = cuda_batched_attn.LAUNCHES = 0
    steps0 = pool.decode_steps
    with _Server(srv, port):
        for n in (4, 8):
            st0 = dict(pool.stats(), disp=pool.dispatch_s,
                       tok=pool.decode_steps)
            res, wall = _concurrent_round(port, n, hop, sr)
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
                f"{st['synth_calls'] - st0['synth_calls']}; the event loop "
                f"spent {disp * 1e3 / max(steps, 1):.1f} ms issuing each "
                f"pool step ({disp * 1e3 / max(tok, 1):.2f} ms per token "
                f"step for up to 16 streams)")
    k1, k2 = cuda_attn.LAUNCHES, cuda_batched_attn.LAUNCHES
    steps = pool.decode_steps - steps0
    assert k1 == 0 and k2 == dcfg.n_layer * steps > 0, (k1, k2, steps)
    log(f"[pool] stats {json.dumps(pool.stats())}; K2 launches on the pooled "
        f"path: {k2} = {dcfg.n_layer} layers x {steps} token steps; K1 "
        f"launches 0")
    return k2


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    kernels_only = "--kernels" in argv
    card = phase_card_and_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches = pool_launches = None
    if not kernels_only:
        engines, weights = phase_offline()
        phase_block_graph(weights)
        launches = phase_server(engines, weights)
        phase_batch(weights)
        phase_block_graph(weights, batch=K2_B)
        pool_launches = phase_pool_server(engines, weights)
    deep = k1["timings"][8191]
    entry = {"name": "K1 decode_attention", "route": "cuda",
             "source": "llmvox_tpu_torch/csrc/decode_attention.cu",
             "replaces": "llmvox_tpu/ops/pallas_attn.py:693",
             "tpu": "llmvox_tpu/ops/pallas_attn.py::pallas_decode_attention",
             "launches": launches, "max_abs_err": k1["max_abs_err"],
             "pos": 8191, "dtype": "bfloat16", **deep}
    k2_deep = k2["timings"]["uniform 8191"]
    entry2 = {"name": "K2 batched_decode_attention", "route": "cuda",
              "source": "llmvox_tpu_torch/csrc/batched_decode_attention.cu",
              "replaces": "llmvox_tpu/ops/pallas_attn.py:307",
              "tpu": "llmvox_tpu/ops/pallas_attn.py::"
                     "pallas_batched_decode_attention",
              "launches": pool_launches, "max_abs_err": k2["max_abs_err"],
              "B": K2_B, "pos": 8191, "dtype": "bfloat16", **k2_deep,
              "other": {name: {"ms": t["ms"], "bound_ms": t["bound_ms"]}
                        for name, t in k2["timings"].items()
                        if name != "uniform 8191"}}
    log(json.dumps({"kernels": [entry, entry2]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
