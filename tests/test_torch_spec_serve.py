"""The port's speculative serving against the JAX package's, on the tiny
stack in f32 on the CPU: the adaptive depth controller (the port's copy of
``serve/spec_control.py``), the pool's spec rungs and ladder, the engine's
spec path under the scheduler, and the draft-head initialiser."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.codec.codec import init_codec_params
from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.serve import pool as jpool
from llmvox_tpu.serve.engine import TTSEngine as JTTSEngine
from llmvox_tpu.serve.scheduler import StreamingScheduler as JScheduler
from llmvox_tpu.serve.spec_control import SpecController as JSpecController
from llmvox_tpu.streams.scripted import ScriptedStream as JScripted
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.engine import TTSEngine as TTTSEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler as TScheduler
from llmvox_tpu_torch.serve.spec_control import (SpecController,
                                                 expected_commits, solve_p)
from llmvox_tpu_torch.streams.scripted import ScriptedStream as TScripted
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as tparams

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

CODEC_TOL = dict(atol=2e-3, rtol=1e-3)


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)


def _run(coro, timeout=600):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ---------------------------------------------------------------------------
# the controller's model and decisions (tests/test_spec_control.py:25-110)
# ---------------------------------------------------------------------------

def test_expected_commits_matches_enumeration():
    rng = np.random.default_rng(0)
    for k in (1, 2, 5):
        for p in (0.0, 0.3, 0.9, 1.0):
            e = sum((i + 1) * (p ** i) * (1 - p) for i in range(k)) \
                + (k + 1) * p ** k
            assert abs(expected_commits(p, k) - e) < 1e-12
    assert expected_commits(rng.random(), 0) == 1.0


def test_solve_p_inverts_expected_commits():
    for k in (1, 3, 8):
        for p in (0.05, 0.5, 0.95):
            assert abs(solve_p(expected_commits(p, k), k) - p) < 1e-3
    assert solve_p(0.5, 4) == pytest.approx(0.0, abs=1e-3)
    assert solve_p(99.0, 4) == pytest.approx(1.0, abs=1e-3)


def _ctl(cls=SpecController, **kw):
    kw.setdefault("ladder", (0, 4, 8))
    kw.setdefault("cost_ms", {0: 1.0, 4: 1.6, 8: 2.0})
    kw.setdefault("dwell", 2)
    kw.setdefault("probe_every", 100)
    return cls(**kw)


def test_controller_moves_to_best_rung():
    for commits, want in ((4.9, 8), (1.02, 0)):
        ctls = [_ctl(cls, k0=4) for cls in (SpecController, JSpecController)]
        for ctl in ctls:
            for _ in range(6):
                ctl.next_k()
                ctl.observe(4, commits=commits, iters=1.0)
        assert ctls[0].k == want
        assert ctls[0].stats() == ctls[1].stats()


def test_controller_hysteresis_and_dwell():
    ctl = _ctl(k0=0, cost_ms={0: 1.0, 4: expected_commits(0.5, 4) / 1.08,
                              8: 100.0})
    ctl.p = 0.5
    for _ in range(10):
        k = ctl.next_k()
    assert k == 0 and ctl.switches == 0
    ctl = _ctl(k0=0, cost_ms={0: 1.0, 4: 0.1, 8: 100.0}, dwell=5)
    ctl.p = 0.5
    ks = [ctl.next_k() for _ in range(8)]
    assert ks[:4] == [0, 0, 0, 0] and ks[-1] == 4


def test_controller_probes_when_parked_on_greedy():
    ctl = _ctl(k0=0, probe_every=4)
    ctl.p = 0.01
    seen = [ctl.next_k() for _ in range(9)]
    assert ctl.probes >= 2 and any(k > 0 for k in seen)
    for _ in range(15):
        k = ctl.next_k()
        if k > 0:
            ctl.observe(k, commits=(k + 0.98), iters=1.0)
    assert ctl.k > 0


def test_controller_no_signal_no_costs_is_safe():
    ctl = SpecController((0, 4), k0=4, cost_ms=None)
    assert ctl.next_k() == 4
    ctl.observe(4, commits=2.0, iters=1.0)
    for _ in range(30):
        assert ctl.next_k() == 4
    assert ctl.switches == 0


# ---------------------------------------------------------------------------
# the pool's spec rungs (tests/test_spec_control.py:164-252)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec_stack():
    """tests/test_spec_control.py's pool fixture: the tiny decoder with
    three random draft heads, as numpy arrays for both sides."""
    cfg = dataclasses.replace(DEC_CFG, n_draft_heads=3)
    params = jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(7),
                                                     cfg))
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    table = rng.standard_normal(
        (cfg.text_vocab_size, cfg.text_embed_dim)).astype(np.float32)
    codec = jax.device_get(init_codec_params(jax.random.PRNGKey(8),
                                             CODEC_CFG))
    scfg = dataclasses.replace(SERVE_CFG, pool_merge_blocks=False,
                               pool_decode_block=8)
    return cfg, params, table, codec, scfg


def _pool(spec_stack, side, **serve):
    cfg, params, table, codec, scfg = spec_stack
    scfg = dataclasses.replace(scfg, **serve)
    if side == "jax":
        return jpool.DecodePool(
            params, table, JWavCodec(codec, CODEC_CFG,
                                     buckets=scfg.chunk_buckets),
            capacity=2, dcfg=cfg, scfg=scfg, cache_dtype=jnp.float32,
            param_dtype=jnp.float32)
    return tpool.DecodePool(
        params, table, TWavCodec(codec, T_CODEC, buckets=scfg.chunk_buckets,
                                 device="cpu"),
        capacity=2, dcfg=_tcfg(tconfig.DecoderConfig, cfg),
        scfg=_tcfg(tconfig.ServeConfig, scfg), device="cpu",
        cache_dtype=torch.float32)


def _drive_pool(pool, n_steps, text_vocab):
    """One slot, n sequential block submits; returns the token stream."""
    win = np.arange(pool.block, dtype=np.int32) % min(text_vocab, 7)

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


@pytest.fixture(scope="module")
def greedy_tokens(spec_stack):
    """12 steps of the JAX greedy pool; a shorter drive is its prefix."""
    pool = _pool(spec_stack, "jax")
    return _drive_pool(pool, 12, spec_stack[0].text_vocab_size)


def test_adaptive_pool_switches_and_stays_exact(spec_stack, greedy_tokens):
    """With an honest cost table the controller parks on greedy, with a
    near-free one on the deepest rung; either way the stream is the JAX
    greedy pool's, and the controller moves as the JAX test pins."""
    n_steps, vocab = 10, spec_stack[0].text_vocab_size
    want = greedy_tokens[:n_steps * 8]
    serve = dict(spec_decode=True, spec_k_draft=3, spec_k_ladder=(0, 2, 3))
    for k0, costs, k_end in ((3, {0: 1.0, 2: 3.0, 3: 3.0}, 0),
                             (2, {0: 1.0, 2: 0.2, 3: 0.1}, 3)):
        pool = _pool(spec_stack, "port", **serve)
        assert pool._spec and pool._spec_ctl is not None
        assert sorted(pool._decode_fns) == [(8, 0), (8, 2), (8, 3)]
        pool._spec_ctl = SpecController((0, 2, 3), k0=k0, cost_ms=costs,
                                        dwell=2, probe_every=1000)
        assert _drive_pool(pool, n_steps, vocab) == want
        ctl = pool._spec_ctl
        assert ctl.k == k_end and ctl.switches == 1
        assert ctl.p is not None and ctl.p < 0.9
        st = pool.stats()
        assert st["spec"]["k"] == k_end and st["steps"] == n_steps


def test_adaptive_pool_probe_cycle_stays_exact(spec_stack, greedy_tokens):
    pool = _pool(spec_stack, "port", spec_decode=True, spec_k_draft=2,
                 spec_k_ladder=(0, 2))
    pool._spec_ctl = SpecController((0, 2), k0=2, cost_ms={0: 1.0, 2: 4.0},
                                    dwell=1, probe_every=3)
    got = _drive_pool(pool, 12, spec_stack[0].text_vocab_size)
    assert got == greedy_tokens
    assert pool._spec_ctl.k == 0 and pool._spec_ctl.probes >= 2


def test_fixed_k_pool_matches_jax_greedy_pool(spec_stack, greedy_tokens):
    """Without a ladder every step is the speculative block at
    ``spec_k_draft``; the stats report the fixed rung."""
    pool = _pool(spec_stack, "port", spec_decode=True, spec_k_draft=3)
    assert sorted(pool._decode_fns) == [(8, 3)] and pool._spec_ctl is None
    assert _drive_pool(pool, 12, spec_stack[0].text_vocab_size) \
        == greedy_tokens
    assert pool.stats()["spec"] == {"k": 3, "ladder": [3]}


def test_pool_calibration_produces_costs(spec_stack):
    pool = _pool(spec_stack, "port", spec_decode=True, spec_k_draft=2,
                 spec_k_ladder=(0, 2))
    costs = pool._calibrate_spec_costs(repeats=1)
    assert set(costs) == {0, 2} and all(v > 0 for v in costs.values())
    # warmup calibrates once, and the pool's own state is left reset
    pool.warmup()
    assert set(pool._spec_ctl.cost_ms) == {0, 2}
    assert not pool.states.pos.any() and not pool.states.done.any()


# ---------------------------------------------------------------------------
# under the scheduler: the pool and the dedicated engines
# ---------------------------------------------------------------------------

REQUESTS = [["Speculative request one", "with two deltas."],
            ["Second concurrent request."],
            ["And a third one", "arriving too."]]


def _pooled_audio(pool, side, scfg):
    """tests/test_pool.py:357's traffic: three concurrent requests, two
    pooled engines each; returns each request's chunk list."""
    mod, sched_cls, stream_cls = (
        (jpool, JScheduler, JScripted) if side == "jax"
        else (tpool, TScheduler, TScripted))

    async def one(deltas):
        engines = [mod.PooledEngine(pool, scfg), mod.PooledEngine(pool, scfg)]
        stream = stream_cls(deltas, eos_token=scfg.eos_token)
        out = [c async for c in sched_cls(engines, scfg).run(
            stream.predict({}), trace=None)]
        for e in engines:
            e.close()
        return out

    async def go():
        res = await asyncio.gather(*[one(d) for d in REQUESTS])
        pool.stop()
        return res

    return _run(go())


def test_spec_pool_matches_greedy_pool(spec_stack):
    """The port of tests/test_pool.py:357: a pool speculating with random
    draft heads streams the greedy pool's audio byte for byte, under the
    scheduler's merge and fused-first-chunk traffic, and both match the
    JAX greedy pool's chunks."""
    cfg, params, table, codec, _ = spec_stack
    jscfg = SERVE_CFG
    tscfg = _tcfg(tconfig.ServeConfig, jscfg)
    tdcfg = _tcfg(tconfig.DecoderConfig, cfg)

    def port_pool(scfg):
        return tpool.DecodePool(
            params, table, TWavCodec(codec, T_CODEC,
                                     buckets=scfg.chunk_buckets,
                                     device="cpu"),
            capacity=8, dcfg=tdcfg, scfg=scfg, device="cpu",
            cache_dtype=torch.float32)

    want = _pooled_audio(jpool.DecodePool(
        params, table, JWavCodec(codec, CODEC_CFG,
                                 buckets=jscfg.chunk_buckets),
        capacity=8, dcfg=cfg, scfg=jscfg, cache_dtype=jnp.float32,
        param_dtype=jnp.float32), "jax", jscfg)
    greedy = _pooled_audio(port_pool(tscfg), "port", tscfg)
    spec_cfg = dataclasses.replace(tscfg, spec_decode=True, spec_k_draft=3)
    spec_pool = port_pool(spec_cfg)
    assert spec_pool._spec
    spec = _pooled_audio(spec_pool, "port", spec_cfg)
    for i, (g, s, w) in enumerate(zip(greedy, spec, want)):
        assert b"".join(s) == b"".join(g), f"request {i}"
        assert [len(c) for c in s] == [len(c) for c in w] and len(s) >= 2
        np.testing.assert_allclose(np.frombuffer(b"".join(s), "<f4"),
                                   np.frombuffer(b"".join(w), "<f4"),
                                   **CODEC_TOL)
    assert spec_pool.stats()["spec"]["k"] == 3


def test_engine_spec_decode_serves_identical_audio():
    """The port of tests/test_decoder_spec.py:161: engines with draft heads
    under ``spec_decode`` stream the greedy engines' waveform through the
    scheduler, and the JAX spec engines' within the codec's tolerance."""
    dcfg = dataclasses.replace(DEC_CFG, n_draft_heads=2)
    params = jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(5),
                                                     dcfg))
    rng = np.random.default_rng(6)
    table = rng.standard_normal(
        (dcfg.text_vocab_size, dcfg.text_embed_dim)).astype(np.float32)
    codec_params = jax.device_get(init_codec_params(jax.random.PRNGKey(7),
                                                    CODEC_CFG))
    deltas = ["Spec decode test one.", "And two."]

    def run(spec: bool, side: str):
        scfg = dataclasses.replace(SERVE_CFG, spec_decode=spec,
                                   spec_k_draft=2, fused_first_chunk=False,
                                   first_decode_block=0, decode_block_large=0)
        if side == "jax":
            engines = [JTTSEngine(params, table,
                                  JWavCodec(codec_params, CODEC_CFG,
                                            buckets=scfg.chunk_buckets),
                                  dcfg, scfg, cache_dtype=jnp.float32)
                       for _ in range(2)]
            sched, stream = JScheduler(engines, scfg), JScripted(
                deltas, eos_token=scfg.eos_token)
        else:
            tscfg = _tcfg(tconfig.ServeConfig, scfg)
            engines = [TTTSEngine(params, table,
                                  TWavCodec(codec_params, T_CODEC,
                                            buckets=scfg.chunk_buckets,
                                            device="cpu"),
                                  _tcfg(tconfig.DecoderConfig, dcfg), tscfg,
                                  device="cpu", cache_dtype=torch.float32)
                       for _ in range(2)]
            sched, stream = TScheduler(engines, tscfg), TScripted(
                deltas, eos_token=tscfg.eos_token)
        assert engines[0]._spec == spec

        async def go():
            return b"".join([c async for c in sched.run(stream.predict({}))])

        return np.frombuffer(_run(go(), timeout=300), "<f4")

    plain, spec = run(False, "port"), run(True, "port")
    np.testing.assert_array_equal(spec, plain)
    want = run(True, "jax")
    assert spec.shape == want.shape and spec.size > 0
    np.testing.assert_allclose(spec, want, **CODEC_TOL)


def test_engine_spec_tts_matches_greedy_and_refuses_short_heads():
    """``TTSEngine.tts`` with spec on gives the greedy engine's tokens;
    heads too few for ``spec_k_draft`` raise at construction."""
    dcfg = _tcfg(tconfig.DecoderConfig,
                 dataclasses.replace(DEC_CFG, n_draft_heads=2))
    params = tparams.init_decoder_params(3, dcfg)
    table = tparams.random_text_table(4, dcfg)
    codec = TWavCodec(tparams.init_codec_params(5, T_CODEC), T_CODEC,
                      device="cpu")
    scfg = _tcfg(tconfig.ServeConfig, SERVE_CFG)
    spec = dataclasses.replace(scfg, spec_decode=True, spec_k_draft=2)
    toks = [TTTSEngine(params, table, codec, dcfg, c, device="cpu",
                       cache_dtype=torch.float32).tts("Hello there.",
                                                      max_tokens=30)[1]
            for c in (scfg, spec)]
    assert len(toks[0]) == 30 and toks[1] == toks[0]
    with pytest.raises(ValueError, match="draft_heads"):
        TTTSEngine(params, table, codec, dcfg,
                   dataclasses.replace(spec, spec_k_draft=3), device="cpu")


# ---------------------------------------------------------------------------
# the draft-head initialiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deployed", [False, True])
def test_init_decoder_params_with_draft_heads_matches_jax(deployed):
    from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
    jd = dataclasses.replace(JDecoderConfig() if deployed else DEC_CFG,
                             n_draft_heads=4)
    td = _tcfg(tconfig.DecoderConfig, jd)
    jtree = jax.eval_shape(
        lambda: jdec.init_decoder_params(jax.random.PRNGKey(0), jd))
    got = tparams.init_decoder_params(0, td)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}/{k}"))
            else:
                out[f"{prefix}/{k}"] = tuple(np.shape(v))
        return out

    assert shapes(got) == shapes(jtree)
    assert got["draft_heads"].shape == (4, jd.n_embd, jd.vocab_size)
    if deployed:
        assert abs(got["draft_heads"].std() - 0.02) < 1e-3
        # the other weights do not depend on the head count
        plain = tparams.init_decoder_params(
            0, dataclasses.replace(td, n_draft_heads=0))
        np.testing.assert_array_equal(plain["head"], got["head"])
