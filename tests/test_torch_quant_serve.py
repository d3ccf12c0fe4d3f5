"""The port's quantized serving (``--quantize w8 | w8a8 | w4``) against the
JAX package's, on the tiny serving stack in f32 on the CPU from the same
numpy weights: the quantized pool's rows against the B=1 chain, the w4
engines and the w4 pool (greedy and speculating) under the scheduler
against JAX's, and the CLI serving ``/tts`` under ``--quantize w4``.  For
w4 JAX runs on its TPU route, K4 in interpret mode
(``tests/test_torch_quant.py::jax_route``)."""
import asyncio
import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.codec.codec import init_codec_params
from llmvox_tpu.serve import pool as jpool
from llmvox_tpu.serve.engine import TTSEngine as JTTSEngine
from llmvox_tpu.serve.scheduler import StreamingScheduler as JScheduler
from llmvox_tpu.streams.scripted import ScriptedStream as JScripted
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.ops import cuda_int4_mm
from llmvox_tpu_torch.ops import quant as tq
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.engine import TTSEngine as TTTSEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler as TScheduler
from llmvox_tpu_torch.streams.scripted import ScriptedStream as TScripted
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.test_torch_quant import MODES, _noisy_params, _tcfg, _trees, \
    jax_route
from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

CODEC_TOL = dict(atol=2e-3, rtol=1e-3)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)


# ---------------------------------------------------------------------------
# the pool, the engines and the spec pool under the scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_stack():
    """The tiny serving stack (tests/tiny_stack.py) with three draft heads."""
    cfg = dataclasses.replace(DEC_CFG, n_draft_heads=3)
    params = _noisy_params(cfg, 7)
    rng = np.random.default_rng(7)
    table = rng.standard_normal(
        (cfg.text_vocab_size, cfg.text_embed_dim)).astype(np.float32)
    codec = jax.device_get(init_codec_params(jax.random.PRNGKey(8),
                                             CODEC_CFG))
    return cfg, params, table, codec


def _run(coro, timeout=600):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def _drive_pool(pool, n_steps, vocab):
    """One slot, n sequential block submits; returns the token stream."""
    win = np.arange(pool.block, dtype=np.int32) % min(vocab, 7)

    async def go():
        pool.start()
        idx = pool.acquire()
        out = []
        for _ in range(n_steps):
            out.extend(await pool.submit(idx, win, text_len=5,
                                         limit=pool.block))
        pool.release(idx)
        pool.stop()
        return out

    return _run(go())


@pytest.mark.parametrize("mode", MODES)
def test_quantized_pool_rows_equal_the_b1_chain(serve_stack, mode):
    """A quantized pool slot's token stream is the B=1 engine's chain over
    the same windows (the JAX pool's chunks are held below)."""
    cfg, params, table, codec = serve_stack
    scfg = dataclasses.replace(SERVE_CFG, pool_merge_blocks=False,
                               pool_decode_block=8)
    tscfg = _tcfg(tconfig.ServeConfig, scfg)
    tdcfg = _tcfg(tconfig.DecoderConfig, cfg)
    tp = to_torch(tq.quantize_decoder_params(params, mode), "cpu")
    tcodec = TWavCodec(codec, T_CODEC, buckets=scfg.chunk_buckets,
                       device="cpu")
    pool = tpool.DecodePool(tp, table, tcodec, capacity=4, dcfg=tdcfg,
                            scfg=tscfg, device="cpu",
                            cache_dtype=torch.float32)
    assert type(pool.params["h"]["wo"]) is tq._mode_cls(mode)
    got = _drive_pool(pool, 4, cfg.text_vocab_size)
    eng = TTTSEngine(tp, table, tcodec, tdcfg, tscfg, device="cpu",
                     cache_dtype=torch.float32)
    st = eng.new_state()
    win = np.arange(8, dtype=np.int32) % 7
    chain = []
    for _ in range(4):
        toks, st = eng.decode_block(st, win, 5, 8)
        chain += toks
    assert got == chain and len(got) == 32


REQUESTS = [["Quantized request one", "with two deltas."],
            ["Second concurrent request."]]


def _served_audio(side, mode, serve_stack, kind):
    """Chunks of each request, served by two dedicated engines
    (``kind="engine"``, requests one after another) or by a pool of 8
    slots (``"pool"``, greedy; ``"spec_pool"``, k=3 drafts) under the
    scheduler, on the quantized tiny stack."""
    cfg, params, table, codec = serve_stack
    scfg = dataclasses.replace(SERVE_CFG, spec_decode=kind == "spec_pool",
                               spec_k_draft=3)
    jp, tp = _trees(params, mode)
    if side == "jax":
        mod, sched_cls, stream_cls = jpool, JScheduler, JScripted

        def codec_():
            return JWavCodec(codec, CODEC_CFG, buckets=scfg.chunk_buckets)

        if kind == "engine":
            engines = [JTTSEngine(jp, table, codec_(), cfg, scfg,
                                  cache_dtype=jnp.float32)
                       for _ in range(2)]
        else:
            pool = jpool.DecodePool(jp, table, codec_(), capacity=8, dcfg=cfg,
                                    scfg=scfg, cache_dtype=jnp.float32,
                                    param_dtype=jnp.float32)
    else:
        mod, sched_cls, stream_cls = tpool, TScheduler, TScripted
        scfg = _tcfg(tconfig.ServeConfig, scfg)
        tdcfg = _tcfg(tconfig.DecoderConfig, cfg)

        def codec_():
            return TWavCodec(codec, T_CODEC, buckets=scfg.chunk_buckets,
                             device="cpu")

        if kind == "engine":
            engines = [TTTSEngine(tp, table, codec_(), tdcfg, scfg,
                                  device="cpu", cache_dtype=torch.float32)
                       for _ in range(2)]
        else:
            pool = tpool.DecodePool(tp, table, codec_(), capacity=8,
                                    dcfg=tdcfg, scfg=scfg, device="cpu",
                                    cache_dtype=torch.float32)
            assert pool._spec == (kind == "spec_pool")

    async def one(deltas):
        if kind == "engine":
            engs = engines
        else:
            engs = [mod.PooledEngine(pool, scfg), mod.PooledEngine(pool, scfg)]
        stream = stream_cls(deltas, eos_token=scfg.eos_token)
        out = [c async for c in sched_cls(engs, scfg).run(stream.predict({}),
                                                           trace=None)]
        if kind != "engine":
            for e in engs:
                e.close()
        return out

    async def go():
        if kind == "engine":
            return [await one(d) for d in REQUESTS]
        res = await asyncio.gather(*[one(d) for d in REQUESTS])
        pool.stop()
        return res

    with jax_route(mode if side == "jax" else ""):
        return _run(go())


@pytest.mark.parametrize("kind", ["engine", "pool"])
def test_quantized_serving_streams_jax_chunks(serve_stack, kind):
    """The port's w4 engines and w4 pool stream JAX's chunk schedule with
    samples within the codec bound; a w4 pool speculating with k=3 draft
    heads streams the greedy pool's bytes."""
    want = _served_audio("jax", "w4", serve_stack, kind)
    got = _served_audio("port", "w4", serve_stack, kind)
    if kind == "pool":
        spec = _served_audio("port", "w4", serve_stack, "spec_pool")
        for s, g in zip(spec, got):
            assert b"".join(s) == b"".join(g)
    for g, w in zip(got, want):
        assert [len(c) for c in g] == [len(c) for c in w] and len(g) >= 2
        np.testing.assert_allclose(np.frombuffer(b"".join(g), "<f4"),
                                   np.frombuffer(b"".join(w), "<f4"),
                                   **CODEC_TOL)


# ---------------------------------------------------------------------------
# the CLI serves /tts under --quantize
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_quantize_w4_serves_tts(monkeypatch):
    """``python -m llmvox_tpu_torch.serve --device cpu --random_seed 0
    --quantize w4`` (the tiny configs standing in for the deployed ones)
    quantizes the random decoder before the replicas and the pool are
    built, and its dedicated replicas answer ``POST /tts`` with finite
    audio; every decode step ran K4's wrapper 4 times per layer (the
    pool's wiring under ``--quantize w4``: tests/test_torch_pool.py)."""
    from llmvox_tpu_torch.serve import __main__ as cli
    from llmvox_tpu_torch.serve import server as tserver
    from llmvox_tpu_torch.serve.__main__ import main as serve_main
    from llmvox_tpu_torch.serve.client import post_chunks
    t_dec = _tcfg(tconfig.DecoderConfig, DEC_CFG)
    port = _free_port()
    real_build = tserver.build_server
    got = {}

    class _NoRun:
        def run(self):
            pass

    def fake_build_server(cfg, engines, pool=None):
        got.update(engines=engines, pool=pool, srv=real_build(
            dataclasses.replace(cfg, api_host="127.0.0.1", api_port=port),
            engines, pool=pool))
        return _NoRun()

    monkeypatch.setattr(cli, "DecoderConfig", lambda: t_dec)
    monkeypatch.setattr(tserver, "build_server", fake_build_server)
    codec_flags = [a for f in ("vq_bins", "vq_dim", "backbone_input_channels",
                               "backbone_dim", "backbone_intermediate_dim",
                               "backbone_num_layers", "n_fft", "hop_length")
                   for a in (f"--{f}", str(getattr(CODEC_CFG, f)))]
    serve_main(["--device", "cpu", "--random_seed", "0", "--quantize", "w4",
                "--decode_block", "8", "--max_audio_length", "10",
                "--initial_dump_size_1", "4", "--initial_dump_size_2", "8",
                "--max_dump_size", "16",
                "--chunk_buckets", "[4,8,16,32]", "--scripted_reply",
                "Hello there. How are you?"] + codec_flags)
    assert got["pool"] is None
    for h in got["engines"]:
        wqkv = h.params["h"]["wqkv"]
        assert type(wqkv) is tq.Int4Tensor and wqkv.q.dtype == torch.int8
        assert wqkv.s.dtype == torch.bfloat16          # compute_dtype
        assert type(h.params["head"]) is tq.QuantizedTensor
    calls = []
    real = cuda_int4_mm.int4_matmul
    monkeypatch.setattr(cuda_int4_mm, "int4_matmul",
                        lambda *a: calls.append(1) or real(*a))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_until_complete,
                              args=(got["srv"].serve(),), daemon=True)
    thread.start()
    try:
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=0.2):
                    break
            except OSError:
                time.sleep(0.1)
        chunks = post_chunks("127.0.0.1", port, "/tts", {"text": "Hi."},
                             timeout=300)
    finally:
        got["srv"].shutdown()
        thread.join(timeout=60)
        loop.close()
    wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
    assert chunks and wav.size > 0 and np.isfinite(wav).all()
    assert calls and len(calls) % (4 * t_dec.n_layer) == 0
