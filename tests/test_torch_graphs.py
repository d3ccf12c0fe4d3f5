"""Serving through CUDA graphs, held on the CPU: the static-buffer protocol
of ``llmvox_tpu_torch/utils/graphs.py`` and the engine, pool and codec
bodies built on it, against the JAX package on the tiny stack (both sides
f32, the same numpy parameters).

The CPU runs every body directly, which is the same buffer and aliasing
path a card replays.  The ``stub_graphs`` fixture also runs the graph
path itself here: its "capture" and "replay" call the body (a replay with
the launch counters held still, as a replay runs no Python), so the
warmup sets, the raise on a shape that was not captured, the capture
count while serving and the replay accounting are all exercised."""
import asyncio
import dataclasses
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import codec as jcodec
from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.codec.codec import init_codec_params
from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.serve import pool as jpool
from llmvox_tpu.serve.engine import TTSEngine as JTTSEngine
from llmvox_tpu.serve.scheduler import StreamingScheduler as JScheduler
from llmvox_tpu.streams.scripted import ScriptedStream as JScripted
from llmvox_tpu.utils.config import ServeConfig as JServeConfig
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.ops import cuda_attn, cuda_int4_mm, istft
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.engine import TTSEngine as TTTSEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler as TScheduler
from llmvox_tpu_torch.streams.scripted import ScriptedStream as TScripted
from llmvox_tpu_torch.tools import warmup_cache
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import graphs
from llmvox_tpu_torch.utils.params import to_torch

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

# the whole-decode bound of the codec tests (tests/test_torch_codec.py)
CODEC_TOL = dict(atol=2e-3, rtol=1e-3)
CFG = dataclasses.replace(DEC_CFG, n_draft_heads=3)
CPU = torch.device("cpu")


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC = _tcfg(tconfig.DecoderConfig, CFG)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(41)
    params = jax.device_get(
        jdec.init_decoder_params(jax.random.PRNGKey(41), CFG))
    params = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    table = rng.standard_normal(
        (CFG.text_vocab_size, CFG.text_embed_dim)).astype(np.float32)
    codec = jax.device_get(init_codec_params(jax.random.PRNGKey(42),
                                             CODEC_CFG))
    return params, table, codec


class _StubGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        before = graphs.counts()
        self.body()
        graphs._add({k: before[k] - v for k, v in graphs.counts().items()})


@pytest.fixture
def stub_graphs(monkeypatch):
    """Capture and replay on the CPU: the warm pass and the recording run
    the body, as a capture runs the Python that issues the kernels; a
    replay runs it with the counters held still."""
    monkeypatch.setattr(graphs, "_warm", lambda body, device: body())

    def record(body, device):
        body()
        return _StubGraph(body)

    monkeypatch.setattr(graphs, "_record", record)


MODES = ["eager", "stub graphs"]


def _graphs_on(mode, request) -> bool:
    if mode == "stub graphs":
        request.getfixturevalue("stub_graphs")
        return True
    return False


def _jax_engine(stack, scfg=SERVE_CFG):
    params, table, codec = stack
    return JTTSEngine(params, table,
                      JWavCodec(codec, CODEC_CFG, buckets=scfg.chunk_buckets),
                      CFG, scfg, cache_dtype=jnp.float32)


def _port_codec(stack, scfg=SERVE_CFG, graphs_on=False):
    return TWavCodec(stack[2], T_CODEC, buckets=scfg.chunk_buckets,
                     device="cpu", graphs=graphs_on)


def _port_engine(stack, scfg=SERVE_CFG, graphs_on=False, codec=None):
    params, table, _ = stack
    return TTTSEngine(params, table,
                      codec or _port_codec(stack, scfg, graphs_on), T_DEC,
                      _tcfg(tconfig.ServeConfig, scfg), device="cpu",
                      cache_dtype=torch.float32, graphs=graphs_on)


def _port_pool(stack, capacity, scfg=SERVE_CFG, graphs_on=False):
    params, table, _ = stack
    return tpool.DecodePool(params, table,
                            _port_codec(stack, scfg, graphs_on),
                            capacity=capacity, dcfg=T_DEC,
                            scfg=_tcfg(tconfig.ServeConfig, scfg),
                            device="cpu", cache_dtype=torch.float32,
                            graphs=graphs_on)


def _run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ---------------------------------------------------------------------------
# module 1: the graph holder
# ---------------------------------------------------------------------------

def _bump():
    """A body that stands for a step: 2 K1 launches, 3 K4 launches and one
    speculative iteration."""
    with cuda_attn._count_lock:
        cuda_attn.LAUNCHES += 2
    with cuda_int4_mm._count_lock:
        cuda_int4_mm.LAUNCHES += 3
    with tdec._spec_lock:
        tdec.SPEC_ITERATIONS += 1


def _moved(c0):
    """How far each registered counter moved since ``c0``."""
    return {k: v - c0[k] for k, v in graphs.counts().items() if v != c0[k]}


PER_BUMP = {"llmvox_tpu_torch.ops.cuda_attn.LAUNCHES": 2,
            "llmvox_tpu_torch.ops.cuda_int4_mm.LAUNCHES": 3,
            "llmvox_tpu_torch.models.decoder.SPEC_ITERATIONS": 1}


def _times(n):
    return {k: n * v for k, v in PER_BUMP.items()}


def test_replay_adds_what_the_capture_counted(stub_graphs):
    calls = []

    def body():
        calls.append(1)
        _bump()

    c0, n0 = graphs.counts(), graphs.CAPTURES
    g = graphs.StepGraph(body, "out", CPU, True, "stub")
    with pytest.raises(RuntimeError, match="not captured"):
        g()
    g.capture()
    # the warm pass and the first replay (which uploads the graph) launch
    # and count; the recording, which launches nothing on a card, is taken
    # back out
    assert _moved(c0) == _times(2) and len(calls) == 3
    assert graphs.CAPTURES == n0 + 1 and g.upload_s >= 0
    g.capture()                                  # once only
    assert graphs.CAPTURES == n0 + 1 and len(calls) == 3
    for _ in range(3):
        assert g() == "out"
    assert _moved(c0) == _times(5)


def test_without_graphs_the_body_runs_and_counts_itself():
    c0, n0 = graphs.counts(), graphs.CAPTURES
    g = graphs.StepGraph(_bump, None, CPU, False)
    g.capture()                                  # one eager pass
    g()
    assert _moved(c0) == _times(2) and graphs.CAPTURES == n0


def test_a_counter_registered_later_gets_the_replays_counts(
        stub_graphs, monkeypatch):
    """Any counter registered beside its kernel wrapper is replayed: the
    graph holder names no module of the layers above it."""
    mod, lock = types.ModuleType("later_kernel"), threading.Lock()
    mod.LAUNCHES = 0
    monkeypatch.setitem(sys.modules, "later_kernel", mod)
    monkeypatch.setattr(graphs, "_COUNTERS", dict(graphs._COUNTERS))
    graphs.register_counter("later_kernel", "LAUNCHES", lock)

    def body():
        with lock:
            mod.LAUNCHES += 4

    g = graphs.StepGraph(body, None, CPU, True)
    g.capture()                       # the warm pass and the first replay
    g()
    g()
    assert mod.LAUNCHES == 4 * 4
    assert "later_kernel.LAUNCHES" in graphs.counts()


def test_graph_set_raises_for_a_key_warmup_did_not_capture(stub_graphs):
    made = []

    def make(key):
        made.append(key)
        return (lambda: None), key

    gs = graphs.GraphSet("test path", CPU, True, make)
    gs.capture(8)
    assert gs.get(8).out == 8
    with pytest.raises(RuntimeError, match=r"no CUDA graph for 16.*\[8\]"):
        gs.get(16)
    assert made == [8]
    eager = graphs.GraphSet("test path", CPU, False, make)
    assert eager.get(16).out == 16 and made == [8, 16]


def test_use_graphs_default_is_the_card():
    assert graphs.use_graphs(torch.device("cuda", 0), None)
    assert not graphs.use_graphs(CPU, None)
    assert not graphs.use_graphs(torch.device("cuda", 0), False)


# ---------------------------------------------------------------------------
# ops/istft.py: the window is made once per device
# ---------------------------------------------------------------------------

def test_istft_makes_its_window_once(monkeypatch):
    rng = np.random.default_rng(3)
    spec = torch.from_numpy((rng.standard_normal((1, 6, 65))
                             + 1j * rng.standard_normal((1, 6, 65))
                             ).astype(np.complex64))
    first = istft.istft_same(spec, n_fft=128, hop_length=32)
    ptr = istft.device_window(128, "cpu").data_ptr()
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: made.append(a.shape) or real(a))
    again = istft.istft_same(spec, n_fft=128, hop_length=32,
                             valid_len=torch.tensor([6]))
    assert made == [] and istft.device_window(128, CPU).data_ptr() == ptr
    np.testing.assert_array_equal(again.numpy(), first.numpy())


# ---------------------------------------------------------------------------
# codec/codec.py: a tensor valid length in a static buffer, every bucket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", SERVE_CFG.chunk_buckets)
def test_codec_static_buffers_match_jax_decode_codes(stack, bucket):
    rng = np.random.default_rng(bucket)
    n = bucket - 1 if bucket > 4 else bucket
    codes = rng.integers(0, CODEC_CFG.vq_bins, (1, n)).astype(np.int32)
    want = np.asarray(jcodec._decode_codes(
        stack[2], jnp.asarray(codes), jnp.int32(0), jnp.int32(n), CODEC_CFG))
    tc = _port_codec(stack)
    got = tc.decode_codes(codes)
    assert got.shape == want.shape == (1, n * CODEC_CFG.hop_length)
    np.testing.assert_allclose(got, want, **CODEC_TOL)
    # the bucket's static buffers are reused by the next call
    inp, _ = tc._graphs.get((1, bucket, 0)).out
    assert int(inp[-1]) == n
    np.testing.assert_array_equal(tc.decode_codes(codes), got)


def test_codec_graphs_serve_only_the_captured_buckets(stack, stub_graphs):
    tc = _port_codec(stack, graphs_on=True)
    n0 = graphs.CAPTURES
    tc.warmup()
    assert graphs.CAPTURES == n0 + len(SERVE_CFG.chunk_buckets)
    codes = np.arange(10, dtype=np.int32)[None] % CODEC_CFG.vq_bins
    np.testing.assert_array_equal(tc.decode_codes(codes),
                                  _port_codec(stack).decode_codes(codes))
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        tc.decode_codes(np.zeros((1, 40), np.int32))   # past the buckets
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        tc.decode_codes_ragged(np.zeros((8, 10), np.int32),
                               np.full(8, 10, np.int32))
    assert graphs.CAPTURES == n0 + len(SERVE_CFG.chunk_buckets)


# ---------------------------------------------------------------------------
# serve/engine.py: the fused warmup set is JAX's
# ---------------------------------------------------------------------------

FUSED_CFGS = {
    "tiny": SERVE_CFG,
    "deployed": JServeConfig(),
    "no short first block": JServeConfig(first_decode_block=0),
    "larger first dump": JServeConfig(initial_dump_size_1=5,
                                      dump_growth_factor=2),
    "not fused": JServeConfig(fused_first_chunk=False),
}


class _Done:
    def fetch(self):
        return [], b""


@pytest.mark.parametrize("name", sorted(FUSED_CFGS))
def test_fused_warmup_set_is_the_set_jax_warmup_compiles(stack, name):
    scfg = FUSED_CFGS[name]
    jeng = _jax_engine(stack, scfg)
    calls = []

    def fused(state, window, text_len, limit, dump, block=None):
        calls.append((block or jeng.block, dump))
        return _Done(), None

    jeng.decode_block_fused_async = fused
    jeng.decode_block_async = lambda *a, **k: (_Done(), None)
    jeng.decode_block = lambda *a, **k: ([], None)
    jeng.codec.warmup = lambda *a, **k: None
    jeng.warmup()
    got = _port_engine(stack, scfg).fused_variants()
    # JAX's set, in its order, then the second replica's first dumps that
    # fit a block (JAX compiles those on first use; a graph cannot be)
    assert got[:len(calls)] == calls
    second = dataclasses.replace(
        scfg, initial_dump_size_1=scfg.initial_dump_size_2)
    assert set(got) == set(calls) | set(
        _port_engine(stack, second).fused_variants())
    if name == "deployed":
        assert got == calls == [(16, 10), (32, 30)]
    if name == "tiny":
        assert calls == [(8, 4)] and got == [(8, 4), (8, 8)]


def test_engine_warmup_captures_every_reachable_body(stack, stub_graphs):
    teng = _port_engine(stack, graphs_on=True)
    n0 = graphs.CAPTURES
    teng.warmup()
    want = (len(teng.block_lengths()) + len(teng.fused_variants())
            + len(SERVE_CFG.chunk_buckets))
    assert graphs.CAPTURES == n0 + want and teng.block_lengths() == [8, 128]
    with pytest.raises(RuntimeError, match="no CUDA graph for 5"):
        teng.decode_block_async(None, np.zeros(5, np.int32), 1, 5, block=5)
    with pytest.raises(RuntimeError, match=r"no CUDA graph for \(8, 3\)"):
        teng.decode_block_fused_async(None, np.zeros(8, np.int32), 1, 8, 3)
    assert graphs.CAPTURES == n0 + want


def test_offline_tts_synthesizes_past_the_largest_bucket(stack, stub_graphs):
    """Offline ``tts`` vocodes its whole utterance eagerly: 40 codes, past
    the largest captured bucket (32), decode as JAX decodes that length,
    and nothing is captured for it."""
    params, table, _ = stack
    teng = TTTSEngine(params, table, _port_codec(stack, graphs_on=True),
                      dataclasses.replace(T_DEC, eoa_token_id=-1),
                      _tcfg(tconfig.ServeConfig, SERVE_CFG), device="cpu",
                      cache_dtype=torch.float32, graphs=True)
    teng.warmup()
    n0 = graphs.CAPTURES
    wav, tokens = teng.tts("Hello there.", max_tokens=40)
    assert len(tokens) == 40 > max(SERVE_CFG.chunk_buckets)
    want = np.asarray(jcodec._decode_codes(
        stack[2], jnp.asarray(tokens, jnp.int32)[None], jnp.int32(0),
        jnp.int32(40), CODEC_CFG))[0]
    assert wav.shape == want.shape == (40 * CODEC_CFG.hop_length,)
    np.testing.assert_allclose(wav, want, **CODEC_TOL)
    assert graphs.CAPTURES == n0
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        teng.synthesize(tokens)                # the served path stays strict


def test_a_block_on_a_state_not_its_own_raises(stack):
    teng = _port_engine(stack)
    window = np.zeros(SERVE_CFG.decode_block, np.int32)
    _, state = teng.decode_block_async(teng.new_state(), window, 1, 4)
    assert state is teng.state
    teng.decode_block_async(state, window, 1, 4)
    other = _port_engine(stack)
    with pytest.raises(ValueError, match="new_state"):
        teng.decode_block_async(other.state, window, 1, 4)
    with pytest.raises(ValueError, match="new_state"):
        teng.decode_block_async(None, window, 1, 4)


# ---------------------------------------------------------------------------
# the dedicated engine's static state against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_engine_chains_blocks_issued_ahead_with_resets_like_jax(
        stack, mode, request):
    """Two sentences of three blocks, each a fused first block then two
    plain ones, all three issued before the first is fetched; the engine's
    one static state is reset between the sentences."""
    on = _graphs_on(mode, request)
    jeng, teng = _jax_engine(stack), _port_engine(stack, graphs_on=on)
    teng.warmup()
    n0 = graphs.CAPTURES
    rng = np.random.default_rng(5)
    blk, dump = SERVE_CFG.decode_block, SERVE_CFG.initial_dump_size_1
    for sentence in range(2):
        ids = rng.integers(3, 259, 3 * blk).astype(np.int32)
        tlen = 2 * blk + 3
        got = []
        for eng in (jeng, teng):
            state = eng.new_state()
            p0, state = eng.decode_block_fused_async(state, ids[:blk], tlen,
                                                     blk, dump)
            p1, state = eng.decode_block_async(state, ids[blk:2 * blk],
                                               tlen, blk)
            p2, state = eng.decode_block_async(state, ids[2 * blk:], tlen,
                                               blk - 3)
            got.append((p0.fetch(), p1.fetch(), p2.fetch(), int(state.pos)))
        (jt0, jwav), jt1, jt2, jpos = got[0]
        (tt0, twav), tt1, tt2, tpos = got[1]
        assert (tt0, tt1, tt2) == (jt0, jt1, jt2) and tpos == jpos
        assert len(tt0) == len(tt1) == blk and len(tt2) == blk - 3
        np.testing.assert_allclose(np.frombuffer(twav, "<f4"),
                                   np.frombuffer(jwav, "<f4"), **CODEC_TOL)
    assert graphs.CAPTURES == n0


async def _served(engines, sched_cls, stream_cls, cfg, requests):
    out = []
    for deltas in requests:
        stream = stream_cls(deltas, eos_token=cfg.eos_token)
        out.append([c async for c in
                    sched_cls(engines, cfg).run(stream.predict({}))])
    return out


REQUESTS = [["Hello", "there.", "And a second sentence."],
            ["Back to back,", "the next request."]]


@pytest.mark.parametrize("mode", MODES)
def test_dedicated_replicas_serve_back_to_back_requests_like_jax(
        stack, mode, request):
    on = _graphs_on(mode, request)
    jengs = [_jax_engine(stack) for _ in range(2)]
    tengs = [_port_engine(stack, graphs_on=on) for _ in range(2)]
    for e in tengs:
        e.warmup()
    n0 = graphs.CAPTURES
    want = _run(_served(jengs, JScheduler, JScripted, SERVE_CFG, REQUESTS))
    got = _run(_served(tengs, TScheduler, TScripted,
                       _tcfg(tconfig.ServeConfig, SERVE_CFG), REQUESTS))
    assert graphs.CAPTURES == n0
    for g, w in zip(got, want):
        assert [len(c) for c in g] == [len(c) for c in w] and len(g) >= 2
        np.testing.assert_allclose(np.frombuffer(b"".join(g), "<f4"),
                                   np.frombuffer(b"".join(w), "<f4"),
                                   **CODEC_TOL)


# ---------------------------------------------------------------------------
# the pool's static steps against JAX's decode_block_batch and spec block
# ---------------------------------------------------------------------------

B = 4


def _host(windows, tlens, limits, reset):
    return np.concatenate([np.asarray(reset, np.int32),
                           np.asarray(tlens, np.int32),
                           np.asarray(limits, np.int32),
                           np.asarray(windows, np.int32).ravel()])


def _jax_step(stack, st, windows, tlens, limits, reset, k=0):
    params, table, codec = stack
    st = jpool._masked_reset(st, jnp.asarray(np.asarray(reset, bool)))
    args = (params, jnp.asarray(table), jnp.asarray(codec["codebooks"][0]),
            st, jnp.asarray(windows), jnp.asarray(tlens, jnp.int32),
            jnp.asarray(limits, jnp.int32), CFG)
    if k == 0:
        toks, n, st = jdec.decode_block_batch(*args,
                                              block=windows.shape[1])
        return np.asarray(toks), np.asarray(n), None, st
    toks, n, st, iters = jdec.decode_block_spec_batch(
        *args, block=windows.shape[1], k_draft=k)
    return np.asarray(toks), np.asarray(n), np.asarray(iters), st


# (width in blocks, limits, reset mask): a reset of every slot, a merged
# width, partial resets between the widths
STEPS = [(1, [32, 32, 20, 0], [1, 1, 1, 1]),
         (2, [64, 40, 64, 64], [0, 0, 0, 0]),
         (1, [32, 32, 32, 5], [1, 0, 1, 0]),
         (2, [64, 64, 11, 64], [0, 1, 0, 0])]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [0, 2])
def test_pool_static_steps_chain_and_reset_like_jax(stack, mode, k, request):
    """Four chained steps at widths 32 and 64 with resets between them,
    greedy (rung 0) or speculative at 2 drafts, through the pool's static
    buffers: JAX's tokens, counts and iterations, and the spec rung
    equals the greedy tokens."""
    on = _graphs_on(mode, request)
    scfg = dataclasses.replace(SERVE_CFG, spec_decode=k > 0,
                               spec_k_draft=max(k, 1))
    pool = _port_pool(stack, B, scfg, graphs_on=on)
    assert sorted(pool._decode_fns) == [(32, k), (64, k)]
    pool.warmup()
    n0 = graphs.CAPTURES
    rng = np.random.default_rng(17 + k)
    jst = jgreedy = jdec.init_decode_state_batch(CFG, B, jnp.float32)
    for width, limits, reset in STEPS:
        w = 32 * width
        windows = rng.integers(3, 259, (B, w)).astype(np.int32)
        tlens = rng.integers(0, 2 * w, B).astype(np.int32)
        graphs.fill(pool._in, _host(windows, tlens, limits, reset))
        toks, n, iters = pool._decode_fns[(w, k)]()
        want, wn, witers, jst = _jax_step(stack, jst, windows, tlens, limits,
                                          reset, k)
        np.testing.assert_array_equal(toks.numpy(), want)
        np.testing.assert_array_equal(n.numpy(), wn)
        np.testing.assert_array_equal(pool.states.pos.numpy(),
                                      np.asarray(jst.pos))
        if k:
            np.testing.assert_array_equal(iters.numpy(), witers)
            greedy, _, _, jgreedy = _jax_step(stack, jgreedy, windows, tlens,
                                              limits, reset)
            np.testing.assert_array_equal(toks.numpy(), greedy)
    assert graphs.CAPTURES == n0


REQUESTS_POOL = [["Hello", "there.", "Another sentence", "now."],
                 ["Second request arriving now.", "More."],
                 ["Third one", "with two", "deltas."]]


async def _pooled(pool, mod, sched_cls, stream_cls, cfg):
    async def one(deltas):
        engines = [mod.PooledEngine(pool, cfg), mod.PooledEngine(pool, cfg)]
        stream = stream_cls(deltas, eos_token=cfg.eos_token)
        out = [c async for c in sched_cls(engines, cfg).run(
            stream.predict({}), trace=None)]
        for e in engines:
            e.close()
        return out

    res = await asyncio.gather(*[one(d) for d in REQUESTS_POOL])
    pool.stop()
    return res


@pytest.mark.parametrize("mode", MODES)
def test_pooled_requests_with_resets_at_both_widths_match_jax(
        stack, mode, request):
    on = _graphs_on(mode, request)
    params, table, codec = stack
    jp = jpool.DecodePool(params, table,
                          JWavCodec(codec, CODEC_CFG,
                                    buckets=SERVE_CFG.chunk_buckets),
                          capacity=8, dcfg=CFG, scfg=SERVE_CFG,
                          cache_dtype=jnp.float32, param_dtype=jnp.float32)
    want = _run(_pooled(jp, jpool, JScheduler, JScripted, SERVE_CFG))
    tp = _port_pool(stack, 8, graphs_on=on)
    tp.warmup()
    n0 = graphs.CAPTURES
    got = _run(_pooled(tp, tpool, TScheduler, TScripted,
                       _tcfg(tconfig.ServeConfig, SERVE_CFG)))
    assert graphs.CAPTURES == n0
    st = tp.stats()
    assert 0 < st["merged_steps"] < st["steps"]       # both widths ran
    for g, w in zip(got, want):
        assert [len(c) for c in g] == [len(c) for c in w] and len(g) >= 2
        np.testing.assert_allclose(np.frombuffer(b"".join(g), "<f4"),
                                   np.frombuffer(b"".join(w), "<f4"),
                                   **CODEC_TOL)


def test_pool_warmup_captures_steps_vocodes_and_buckets(stack, stub_graphs):
    scfg = dataclasses.replace(SERVE_CFG, spec_decode=True, spec_k_draft=2,
                               spec_k_ladder=(0, 2))
    pool = _port_pool(stack, B, scfg, graphs_on=True)
    n0 = graphs.CAPTURES
    pool.warmup()
    # (32, 0), (64, 0): one graph each; (32, 2), (64, 2): start and
    # iteration; the fused vocodes at both widths and buckets <= 32; the
    # ragged synthesis buckets
    fused = [b for b in SERVE_CFG.chunk_buckets if b <= pool._fuse_bucket]
    want = 2 + 4 + 2 * len(fused) + len(SERVE_CFG.chunk_buckets)
    assert graphs.CAPTURES == n0 + want
    assert set(pool._spec_ctl.cost_ms) == {0, 2}
    assert not pool.states.pos.any() and not pool.states.done.any()


def test_warmup_cache_runs_the_deployed_warmup_at_a_tiny_size(capsys):
    warmup_cache.main([
        "--device", "cpu", "--n_layer", "1", "--n_head", "2", "--n_embd",
        "32", "--block_size", "128", "--vocab_size", "16",
        "--text_embed_dim", "12", "--speech_embed_dim", "20", "--vq_bins",
        "16", "--vq_dim", "20", "--backbone_input_channels", "20",
        "--backbone_dim", "32", "--backbone_intermediate_dim", "64",
        "--backbone_num_layers", "1", "--n_fft", "128", "--hop_length", "32",
        "--chunk_buckets", "[4, 8]", "--decode_block", "8",
        "--decode_block_large", "16", "--first_decode_block", "4",
        "--initial_dump_size_1", "4", "--pool_capacity", "2",
        "--pool_decode_block", "8", "--compute_dtype", "float32"])
    out = capsys.readouterr().out
    assert "engine (blocks [4, 8, 16], fused [(4, 4)]" in out
    assert "pool of 2 (steps [(8, 0), (16, 0)])" in out
    assert "CUDA graphs captured" in out


def test_a_shape_warmup_did_not_capture_fails_the_request(stack,
                                                          stub_graphs):
    """Without the second replica's fused first block the request raises
    (no capture while serving, no eager fallback) instead of hanging."""
    tengs = [_port_engine(stack, graphs_on=True) for _ in range(2)]
    for e in tengs:
        e.warmup()
    del tengs[1]._fused.graphs[(8, 8)]
    n0 = graphs.CAPTURES
    with pytest.raises(RuntimeError, match=r"no CUDA graph for \(8, 8\)"):
        _run(_served(tengs, TScheduler, TScripted,
                     _tcfg(tconfig.ServeConfig, SERVE_CFG), REQUESTS[:1]),
             timeout=60)
    assert graphs.CAPTURES == n0
