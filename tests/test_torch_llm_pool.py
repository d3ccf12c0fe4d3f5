"""The port's continuous-batching LLM pool against the JAX package's, on
the CPU in f32 from the same numpy parameters: the pooled programs of
``llmvox_tpu_torch/models/llama.py`` (per-row sampling, ``prefix_kv``,
``prefill_slots``, ``prefill_slots_continue``, ``decode_block_pooled``)
against ``llmvox_tpu/models/llama.py``'s, ``serve/llm_pool.py::LLMPool``
against JAX's ``LLMPool`` (each test of ``tests/test_llm_pool.py`` and the
rows tests of ``tests/test_llama_rows.py`` has its counterpart here, on
both sides), the pooled stream model, the padding rows that must write
nothing, the warmup set against the calls JAX's ``LLMPool.warmup`` makes
(the graph path stubbed to run on the CPU) and the launches on the
dispatch thread."""
import asyncio
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.serve import llm_pool as jlp
from llmvox_tpu.streams import jax_llm
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.serve import llm_pool as tlp
from llmvox_tpu_torch.streams import llm as tllm
from llmvox_tpu_torch.utils import graphs
from llmvox_tpu_torch.utils.params import to_torch

from tests.test_llama import _ToyTokenizer
from tests.test_torch_engine import weights  # noqa: F401 (a fixture)
from tests.test_torch_llm_stream import stub_graphs  # noqa: F401 (a fixture)

CFG = jl.LlamaConfig(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
                     n_embd=32, intermediate_size=64, max_seq_len=96)
CFG2 = dataclasses.replace(CFG, max_seq_len=512)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[5, 9, 2], [7, 11, 13, 17, 19, 23, 29], [3] * 12, [42]]
PREFIX = [9, 4, 7, 1, 8, 3, 6, 2, 11, 5, 13, 10]    # a 12-token "system"


def _tc(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _np(jcfg, seed=0):
    return jax.device_get(jl.init_llama_params(jax.random.PRNGKey(seed),
                                               jcfg))


@pytest.fixture(scope="module")
def params():
    return _np(CFG)


def _pools(params, jcfg=CFG, **kw):
    """The JAX pool and the port's, on the same numpy params."""
    return (jlp.LLMPool(jax.tree.map(jnp.asarray, params), jcfg, **kw),
            tlp.LLMPool(params, _tc(jcfg), device="cpu", **kw))


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=600))


def _b1_greedy(params, ids, n_tokens, jcfg=CFG):
    """JAX's B=1 serving path (prefill_padded + decode_block): the first
    sampled token and n_tokens - 1 more."""
    bucket = 16
    while bucket < len(ids):
        bucket *= 2
    bucket = min(bucket, jcfg.max_seq_len - 1)
    padded = list(ids) + [0] * (bucket - len(ids))
    st = jl.init_llama_decode_state(jcfg, batch=1)
    lg, st = jl.prefill_padded(params, jnp.asarray([padded], jnp.int32),
                               jnp.asarray(len(ids), jnp.int32), st, jcfg)
    out = [int(jnp.argmax(lg, axis=-1)[0])]
    tok = jnp.asarray([out[-1]], jnp.int32)
    while len(out) < n_tokens:
        toks, st = jl.decode_block(params, tok, st, jax.random.PRNGKey(0),
                                   jcfg, block=4)
        out.extend(int(t) for t in np.asarray(toks)[0])
        tok = jnp.asarray([out[-1]], jnp.int32)
    return out[:n_tokens]


def _generate(pool, prompts, n, sampling=None):
    """Concurrent ``generate`` streams; each its tokens."""
    async def one(ids):
        out = []
        async for toks in pool.generate(ids, max_tokens=n,
                                        sampling=sampling):
            out.extend(toks)
        return out

    async def go():
        try:
            return await asyncio.gather(*[one(p) for p in prompts])
        finally:
            pool.stop()
    return _run(go())


def _both(params, scenario, jcfg=CFG, **kw):
    """``scenario(pool)`` on the JAX pool, then on the port's."""
    jpool, tpool = _pools(params, jcfg, **kw)
    return scenario(jpool), scenario(tpool), tpool


def _states_equal(js, ts):
    """The port's pool state against JAX's: positions and tokens exact,
    caches to ``LOGIT_TOL``."""
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
    for a, b in ((ts.k, js.k), (ts.v, js.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOGIT_TOL)


def _prefill_inputs(prompts, tpad):
    tokens = np.zeros((len(prompts), tpad), np.int32)
    valid = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
        valid[i] = len(p)
    return tokens, valid


def _jprefill(params, state, tokens, valid, slots, active, jcfg=CFG,
              **kw):
    return jl.prefill_slots(
        params, jnp.asarray(tokens), jnp.asarray(valid), state,
        jnp.asarray(slots, jnp.int32), jnp.asarray(active),
        jax.random.PRNGKey(1), jcfg, **kw)


def _tprefill(tp, state, tokens, valid, slots, active, jcfg=CFG, **kw):
    return tl.prefill_slots(
        tp, torch.from_numpy(np.asarray(tokens)),
        torch.from_numpy(np.asarray(valid)), state,
        torch.as_tensor(np.asarray(slots, np.int32)),
        torch.as_tensor(np.asarray(active)), _tc(jcfg), **kw)


# ---------------------------------------------------------------------------
# the pooled programs
# ---------------------------------------------------------------------------

def test_prefill_slots_mixed_lengths_one_program(params):
    """Mixed-length prompts prefill in one program into scattered slots;
    first tokens, positions and caches equal JAX's, and each slot's pooled
    greedy block continues its B=1 chain."""
    tp = to_torch(params, "cpu")
    tokens, valid = _prefill_inputs(PROMPTS, 16)
    slots = np.asarray([5, 0, 2, 4], np.int32)
    act = np.ones((4,), bool)
    jf, js = _jprefill(params, jl.init_llama_pool_state(CFG, 6), tokens,
                       valid, slots, act)
    tf, ts = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 6), tokens,
                       valid, slots, act)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _states_equal(js, ts)
    assert ts.pos.numpy()[slots].tolist() == valid.tolist()
    active = np.zeros((6,), bool)
    active[slots] = True
    jt, js = jl.decode_block_pooled(params, js, jnp.asarray(active),
                                    jax.random.PRNGKey(2), CFG, block=8)
    tt, ts = tl.decode_block_pooled(tp, ts, torch.from_numpy(active),
                                    _tc(CFG), block=8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _states_equal(js, ts)
    for i, p in enumerate(PROMPTS):
        got = [int(tf[i])] + tt.numpy()[slots[i]].tolist()
        assert got == _b1_greedy(params, p, 9), i


def test_prefill_slots_inactive_rows_are_dropped(params):
    """A padding row aimed at the same slot as a real row writes nothing:
    the state equals the real row's prefill alone, as in JAX."""
    tp = to_torch(params, "cpu")
    tokens = np.zeros((2, 8), np.int32)
    tokens[0, :3] = PROMPTS[0]
    valid = np.asarray([3, 1], np.int32)
    act = np.asarray([True, False])
    _, js = _jprefill(params, jl.init_llama_pool_state(CFG, 3), tokens,
                      valid, [1, 1], act)
    _, ts = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 3), tokens,
                      valid, [1, 1], act)
    _, ts1 = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 3),
                       tokens[:1], valid[:1], [1], act[:1])
    _states_equal(js, ts)
    for a, b in zip(ts, ts1):
        assert torch.equal(a, b)


def test_padding_rows_beside_a_real_row_in_slot_0_write_nothing(params):
    """An arrival batch whose real row lands in slot 0 beside three
    padding rows that also name slot 0 (garbage prompts, in any order):
    slot 0 holds the real prompt exactly as a one-row prefill leaves it,
    every other slot stays untouched, and JAX's state agrees."""
    tp = to_torch(params, "cpu")
    real = PROMPTS[1]
    base_t = tl.init_llama_pool_state(_tc(CFG), 4)
    _, base_t = _tprefill(tp, base_t, *_prefill_inputs([PROMPTS[2]], 16),
                          [2], [True])
    _, base_j = _jprefill(params, jl.init_llama_pool_state(CFG, 4),
                          *_prefill_inputs([PROMPTS[2]], 16), [2], [True])
    want = tl.LlamaPoolState(*(t.clone() for t in base_t))
    wf, want = _tprefill(tp, want, *_prefill_inputs([real], 16), [0],
                         [True])
    garbage = [[99] * 16, [7] * 5, [120, 3]]
    for order in ([0, 1, 2, 3], [3, 0, 1, 2], [1, 2, 3, 0]):
        rows = [real] + garbage
        prompts = [rows[i] for i in order]
        active = [i == 0 for i in order]
        tokens, valid = _prefill_inputs(prompts, 16)
        ts = tl.LlamaPoolState(*(t.clone() for t in base_t))
        tf, ts = _tprefill(tp, ts, tokens, valid, [0] * 4, active)
        for a, b in zip(ts, want):
            assert torch.equal(a, b), order
        assert int(tf[order.index(0)]) == int(wf[0])
        jf, js = _jprefill(params, jax.tree.map(jnp.copy, base_j), tokens,
                           valid, [0] * 4, np.asarray(active))
        _states_equal(js, ts)
        assert int(np.asarray(jf)[order.index(0)]) == int(wf[0])


def test_decode_block_pooled_freezes_inactive_rows(params):
    """An inactive row keeps its pos and tok while active rows decode
    (its cache row at pos is rewritten, as JAX's is); reactivated, it
    continues its own chain."""
    tp = to_torch(params, "cpu")
    js = jl.init_llama_pool_state(CFG, 2)
    ts = tl.init_llama_pool_state(_tc(CFG), 2)
    for i, p in enumerate(PROMPTS[:2]):
        tokens, valid = _prefill_inputs([p], 16)
        _, js = _jprefill(params, js, tokens, valid, [i], [True])
        _, ts = _tprefill(tp, ts, tokens, valid, [i], [True])
    outs = []
    for act in ([True, False], [True, True]):
        jt, js = jl.decode_block_pooled(params, js, jnp.asarray(act),
                                        jax.random.PRNGKey(5), CFG, block=4)
        tt, ts = tl.decode_block_pooled(tp, ts, torch.tensor(act),
                                        _tc(CFG), block=4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        _states_equal(js, ts)
        outs.append(tt.numpy())
        if act == [True, False]:
            assert int(ts.pos[1]) == len(PROMPTS[1])
    assert (outs[0][0].tolist() + outs[1][0].tolist()
            == _b1_greedy(params, PROMPTS[0], 9)[1:])
    assert outs[1][1].tolist() == _b1_greedy(params, PROMPTS[1], 5)[1:]


def test_attn_window_bucket_matches_full_cache():
    """A block at attn_len 128 (every row's pos + block inside it) gives
    the full cache's tokens, chained twice, on both sides."""
    params2 = _np(CFG2)
    tp = to_torch(params2, "cpu")
    tokens, valid = _prefill_inputs([PROMPTS[1]], 16)
    act = [True, False]
    got = {}
    for attn in (None, 128):
        js = jl.init_llama_pool_state(CFG2, 2)
        ts = tl.init_llama_pool_state(_tc(CFG2), 2)
        _, js = _jprefill(params2, js, tokens, valid, [0], [True], CFG2)
        _, ts = _tprefill(tp, ts, tokens, valid, [0], [True], CFG2)
        rows = []
        for _ in range(2):
            jt, js = jl.decode_block_pooled(
                params2, js, jnp.asarray(act), jax.random.PRNGKey(5), CFG2,
                block=8, attn_len=attn)
            tt, ts = tl.decode_block_pooled(tp, ts, torch.tensor(act),
                                            _tc(CFG2), block=8,
                                            attn_len=attn)
            np.testing.assert_array_equal(tt.numpy()[0], np.asarray(jt)[0])
            rows.append(tt.numpy()[0].tolist())
        got[attn] = rows
    assert got[None] == got[128]


def test_prefix_prefill_matches_full_prefill(params):
    """``prefix_kv`` + a suffix prefill equals one prefill of the whole
    prompt (first token, pos, caches, continuation), and the port's
    prefix rows and suffix prefill equal JAX's."""
    tp = to_torch(params, "cpu")
    sfx = [21, 22, 23, 24, 25]
    full = PREFIX + sfx
    jpk, jpv = jl.prefix_kv(params, jnp.asarray([PREFIX], jnp.int32), CFG)
    tpk, tpv = tl.prefix_kv(tp, torch.tensor([PREFIX]), _tc(CFG))
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), **LOGIT_TOL)
    np.testing.assert_allclose(tpv.numpy(), np.asarray(jpv), **LOGIT_TOL)
    _, tw = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 2),
                      *_prefill_inputs([full], 32), [1], [True])
    tokens, valid = _prefill_inputs([sfx], 8)
    jf, js = _jprefill(params, jl.init_llama_pool_state(CFG, 2), tokens,
                       valid, [1], [True], prefix_k=jpk, prefix_v=jpv)
    tf, ts = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 2), tokens,
                       valid, [1], [True], prefix_k=tpk, prefix_v=tpv)
    assert int(tf[0]) == int(np.asarray(jf)[0]) == int(tw.tok[1])
    _states_equal(js, ts)
    n = len(full)
    assert int(ts.pos[1]) == n
    np.testing.assert_allclose(ts.k[:, 1, :n].numpy(),
                               tw.k[:, 1, :n].numpy(), atol=2e-5, rtol=2e-5)
    act = torch.tensor([False, True])
    toks, _ = tl.decode_block_pooled(tp, ts, act, _tc(CFG), block=8)
    toks_w, _ = tl.decode_block_pooled(tp, tw, act, _tc(CFG), block=8)
    assert torch.equal(toks[1], toks_w[1])


def test_chunked_prefill_device_op_matches_single_program(params):
    """A ragged first chunk through ``prefill_slots`` and a continuation
    chunk equal one prefill of the whole prompt, and JAX's chain: the
    continuation writes the chunk's rows in place where JAX scatters the
    window back."""
    tp = to_torch(params, "cpu")
    full = [(i * 7 + 3) % 100 for i in range(40)]
    _, tw = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 2),
                      *_prefill_inputs([full], 64), [1], [True])
    js = jl.init_llama_pool_state(CFG, 2)
    ts = tl.init_llama_pool_state(_tc(CFG), 2)
    t0 = np.asarray([full[:8]], np.int32)
    _, js = _jprefill(params, js, t0, [8], [1], [True])
    _, ts = _tprefill(tp, ts, t0, np.asarray([8], np.int32), [1], [True])
    jf, js = jl.prefill_slots_continue(
        params, jnp.asarray([full[8:]], jnp.int32),
        jnp.asarray([32], jnp.int32), js, jnp.asarray([1], jnp.int32),
        jnp.ones((1,), bool), jnp.asarray([8], jnp.int32),
        jax.random.PRNGKey(1), CFG, final=True, attn_len=96)
    tf, ts = tl.prefill_slots_continue(
        tp, torch.tensor([full[8:]]), torch.tensor([32]), ts,
        torch.tensor([1]), torch.tensor([True]), torch.tensor([8]),
        _tc(CFG), final=True, attn_len=96)
    assert int(tf[0]) == int(np.asarray(jf)[0]) == int(tw.tok[1])
    _states_equal(js, ts)
    n = len(full)
    assert int(ts.pos[1]) == n
    np.testing.assert_allclose(ts.k[:, 1, :n].numpy(),
                               tw.k[:, 1, :n].numpy(), atol=2e-5, rtol=2e-5)
    act = torch.tensor([False, True])
    toks, _ = tl.decode_block_pooled(tp, ts, act, _tc(CFG), block=8)
    toks_w, _ = tl.decode_block_pooled(tp, tw, act, _tc(CFG), block=8)
    assert torch.equal(toks[1], toks_w[1])


@pytest.mark.parametrize("final", [True, False])
def test_chunked_continue_inactive_rows_dropped(params, final):
    """A continuation chunk with active=False (the warmup's) leaves the
    whole state untouched; a middle chunk (final=False) returns zeros."""
    tp = to_torch(params, "cpu")
    ts = tl.init_llama_pool_state(_tc(CFG), 2)
    _, ts = _tprefill(tp, ts, *_prefill_inputs([PROMPTS[0]], 8), [0],
                      [True])
    before = [t.clone() for t in ts]
    first, ts2 = tl.prefill_slots_continue(
        tp, torch.zeros((1, 32), dtype=torch.int32), torch.tensor([32]), ts,
        torch.tensor([0]), torch.tensor([False]), torch.tensor([3]),
        _tc(CFG), final=final, attn_len=96)
    for a, b in zip(before, ts2):
        assert torch.equal(a, b)
    if not final:
        assert first.tolist() == [0]


# ---------------------------------------------------------------------------
# per-row sampling (tests/test_llama_rows.py)
# ---------------------------------------------------------------------------

CONFIGS = [(0.0, 0, 1.0), (0.8, 0, 1.0), (0.7, 5, 1.0), (1.1, 0, 0.9),
           (0.9, 8, 0.85)]


def _logits(b=6, v=64, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, v))
            .astype(np.float32) * 3.0)


def _rows(t, k, p, b=None):
    if b is not None:
        t, k, p = [t] * b, [k] * b, [p] * b
    return (np.asarray(t, np.float32), np.asarray(k, np.int32),
            np.asarray(p, np.float32))


def test_filtered_rows_matches_static_per_config():
    lg = _logits()
    for (t, k, p) in CONFIGS[1:]:
        rows = _rows(t, k, p, b=6)
        want = np.asarray(jl._filtered_logits_rows(
            jnp.asarray(lg), *map(jnp.asarray, rows)))
        got = tl._filtered_logits_rows(torch.from_numpy(lg),
                                       *map(torch.from_numpy, rows)).numpy()
        static = tl._filtered_logits(torch.from_numpy(lg), t, k, p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, static, rtol=1e-6, atol=1e-6)


def test_sample_rows_matches_static_with_same_rng():
    """Given JAX's Gumbel noise the port's rows sampler draws JAX's rows
    tokens, which equal the static sampler's for uniform rows."""
    lg = _logits(seed=1)
    for (t, k, p) in CONFIGS:
        key = jax.random.PRNGKey(7)
        rows = _rows(t, k, p, b=6)
        want = np.asarray(jl._sample_rows(jnp.asarray(lg), key,
                                          *map(jnp.asarray, rows)))
        noise = torch.tensor(np.asarray(
            jax.random.gumbel(key, lg.shape, jnp.float32)))
        got = tl._sample_rows(torch.from_numpy(lg),
                              *map(torch.from_numpy, rows),
                              gumbel=noise).numpy()
        static = tl._sample(torch.from_numpy(lg), t, k, p,
                            gumbel=noise).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, static)


def test_mixed_rows_filter_each_row_independently():
    """Row i filtered under config i equals the static filter of that
    row; greedy rows are one-hot at the argmax."""
    lg = _logits(seed=2, b=len(CONFIGS))
    rows = _rows(*zip(*CONFIGS))
    got = tl._filtered_logits_rows(torch.from_numpy(lg),
                                   *map(torch.from_numpy, rows)).numpy()
    want = np.asarray(jl._filtered_logits_rows(jnp.asarray(lg),
                                               *map(jnp.asarray, rows)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for i, (tc, kc, pc) in enumerate(CONFIGS):
        if tc == 0.0:
            assert np.argmax(got[i]) == np.argmax(lg[i])
            continue
        ref = tl._filtered_logits(torch.from_numpy(lg[i:i + 1]), tc, kc,
                                  pc).numpy()[0]
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-5)


ROW_PROMPTS = [[5, 9, 2], [7, 11, 13, 17], [3] * 6, [42, 43]]


def _rows_state(params, tp, b):
    tokens, valid = _prefill_inputs(ROW_PROMPTS[:b], 8)
    slots, act = np.arange(b, dtype=np.int32), np.ones((b,), bool)
    jf, js = _jprefill(params, jl.init_llama_pool_state(CFG, b), tokens,
                       valid, slots, act)
    tf, ts = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), b), tokens,
                       valid, slots, act)
    return (jf, js), (tf, ts)


def test_pooled_decode_rows_greedy_matches_static():
    params = _np(CFG)
    tp = to_torch(params, "cpu")
    (_, js), (_, ts) = _rows_state(params, tp, 4)
    ts2 = tl.LlamaPoolState(*(t.clone() for t in ts))
    act = torch.ones(4, dtype=torch.bool)
    rows = _rows(0.0, 0, 1.0, b=4)
    jt, _ = jl.decode_block_pooled(params, js, jnp.ones((4,), bool),
                                   jax.random.PRNGKey(2), CFG, block=8,
                                   rows=tuple(map(jnp.asarray, rows)))
    want, st = tl.decode_block_pooled(tp, ts, act, _tc(CFG), block=8)
    got, st_r = tl.decode_block_pooled(tp, ts2, act, _tc(CFG), block=8,
                                       rows=tuple(map(torch.from_numpy,
                                                      rows)))
    assert torch.equal(got, want) and torch.equal(st_r.pos, st.pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt))


def test_pooled_decode_mixed_rows_greedy_rows_exact():
    """Greedy rows of a mixed batch follow the all-greedy chain; given
    JAX's noise at every step, the sampled rows draw JAX's tokens too."""
    params = _np(CFG, 3)
    tp = to_torch(params, "cpu")
    (_, js), (_, ts) = _rows_state(params, tp, 4)
    ts2 = tl.LlamaPoolState(*(t.clone() for t in ts))
    act = torch.ones(4, dtype=torch.bool)
    rows = _rows([0.0, 0.9, 0.0, 1.2], [0, 5, 0, 0], [1.0, 0.9, 1.0, 1.0])
    key = jax.random.PRNGKey(2)
    jt, _ = jl.decode_block_pooled(params, js, jnp.ones((4,), bool), key,
                                   CFG, block=8,
                                   rows=tuple(map(jnp.asarray, rows)))
    noise, rng = [], key
    for _ in range(8):
        rng, sub = jax.random.split(rng)
        noise.append(np.asarray(jax.random.gumbel(sub, (4, CFG.vocab_size),
                                                  jnp.float32)))
    got, _ = tl.decode_block_pooled(
        tp, ts, act, _tc(CFG), block=8, rows=tuple(map(torch.from_numpy,
                                                       rows)),
        gumbel=torch.from_numpy(np.stack(noise)))
    ref, _ = tl.decode_block_pooled(tp, ts2, act, _tc(CFG), block=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt))
    for i in (0, 2):
        assert torch.equal(got[i], ref[i])


def test_prefill_slots_rows_greedy_matches_static():
    params = _np(CFG, 4)
    tp = to_torch(params, "cpu")
    (jf, _), (tf, _) = _rows_state(params, tp, 4)
    tokens, valid = _prefill_inputs(ROW_PROMPTS, 8)
    rows = _rows(0.0, 0, 1.0, b=4)
    got, _ = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 4), tokens,
                       valid, np.arange(4), np.ones(4, bool),
                       rows=tuple(map(torch.from_numpy, rows)))
    assert torch.equal(got, tf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf))


def test_sampled_prefill_with_jax_noise_draws_jax_tokens(params):
    """A sampled arrival batch (per-row knobs) given JAX's noise draws the
    first tokens JAX's ``prefill_slots`` draws with that key."""
    tp = to_torch(params, "cpu")
    tokens, valid = _prefill_inputs(PROMPTS, 16)
    rows = _rows([1.3, 0.0, 0.8, 2.0], [0, 0, 7, 0], [0.95, 1.0, 1.0, 0.5])
    key = jax.random.PRNGKey(11)
    jf, _ = jl.prefill_slots(
        params, jnp.asarray(tokens), jnp.asarray(valid),
        jl.init_llama_pool_state(CFG, 4), jnp.arange(4, dtype=jnp.int32),
        jnp.ones((4,), bool), key, CFG, rows=tuple(map(jnp.asarray, rows)))
    noise = torch.tensor(np.asarray(
        jax.random.gumbel(key, (4, CFG.vocab_size), jnp.float32)))
    tf, _ = _tprefill(tp, tl.init_llama_pool_state(_tc(CFG), 4), tokens,
                      valid, np.arange(4), np.ones(4, bool),
                      rows=tuple(map(torch.from_numpy, rows)), gumbel=noise)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


# ---------------------------------------------------------------------------
# the pool, against JAX's
# ---------------------------------------------------------------------------

def test_pool_generate_concurrent_matches_b1(params):
    want, got, _ = _both(params, lambda p: _generate(p, PROMPTS, 13),
                         capacity=4, block=4, prefill_buckets=(8, 16, 32))
    assert got == want
    for p, toks in zip(PROMPTS, got):
        assert toks[:13] == _b1_greedy(params, p, 13) and len(toks) >= 13


def test_pool_staggered_arrivals_and_slot_reuse(params):
    """Three requests on two slots: the third waits for a free slot and
    reuses it while the second is mid-flight."""
    def scenario(pool):
        async def one(ids, n, delay=0.0):
            if delay:
                await asyncio.sleep(delay)
            out = []
            async for toks in pool.generate(ids, max_tokens=n):
                out.extend(toks)
                if len(out) >= n:
                    break
            return out

        async def go():
            try:
                return await asyncio.gather(
                    one(PROMPTS[0], 5), one(PROMPTS[1], 13, delay=0.01),
                    one(PROMPTS[2], 9, delay=0.02))
            finally:
                pool.stop()
        return _run(go())

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8, 16))
    for n, (w, g, p) in zip((5, 13, 9), zip(want, got, PROMPTS)):
        assert g[:n] == w[:n] == _b1_greedy(params, p, n)


def test_pool_warmup_does_not_disturb_generation(params):
    def scenario(pool):
        pool.warmup()
        assert pool.prefill_calls == 0
        return _generate(pool, [PROMPTS[0]], 9)[0]

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8,))
    assert got == want and got[:9] == _b1_greedy(params, PROMPTS[0], 9)


def _stream_model(side, pool, tok=None, **kw):
    cls = (jax_llm.PooledJAXStreamModel if side == "jax"
           else tllm.PooledLlamaStreamModel)
    return cls(pool, tok or _ToyTokenizer(), **kw)


def _drain(agen):
    async def go():
        return [d async for d in agen]
    return go()


def test_cancelled_stream_releases_slot(params):
    """A consumer that abandons its stream releases the slot: on a
    one-slot pool the next request is served, with JAX's text."""
    def scenario(pool, side):
        model = _stream_model(side, pool, max_tokens=64)

        async def go():
            gen = model.predict({"system": "s", "prompt": "hello"})
            async for _ in gen:
                break
            await gen.aclose()
            out = await _drain(model.predict({"system": "s",
                                              "prompt": "again"}))
            pool.stop()
            return out
        return _run(go())

    jpool, tpool = _pools(params, capacity=1, block=4,
                          prefill_buckets=(8, 16, 32))
    want, got = scenario(jpool, "jax"), scenario(tpool, "port")
    assert got == want and len("".join(got)) > 0


def test_pool_step_loop_crash_fails_waiters(params, monkeypatch):
    """A program that fails on the dispatch thread fails every waiter of
    its iteration: the request raises instead of hanging."""
    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tl, "prefill_slots", boom)
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8,), device="cpu")

    async def go():
        with pytest.raises(RuntimeError, match="injected"):
            async for _ in pool.generate(PROMPTS[0], max_tokens=9):
                pass
        pool.stop()

    _run(go())


def test_pool_planning_crash_fails_queued_waiters(params, monkeypatch):
    """A crash of the step loop itself (in planning, on the event loop)
    fails the popped and the queued requests alike."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8,), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected planning failure")

    monkeypatch.setattr(pool, "_run_prefills", boom)

    async def go():
        with pytest.raises(RuntimeError, match="injected"):
            async for _ in pool.generate(PROMPTS[0], max_tokens=9):
                pass
        for _ in range(10):     # the crash handler runs as a callback
            await asyncio.sleep(0)
        assert pool._task is None
        pool.stop()

    _run(go())


def test_pool_mixed_dtype_params_and_cache(params):
    """bf16 params with the default f32 cache: the residual keeps bf16
    through the layers while the cache stays f32, and the tokens equal
    JAX's for the same bf16 params."""
    jb = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), params)
    tb = to_torch(params, "cpu", torch.bfloat16)
    jpool = jlp.LLMPool(jb, CFG, capacity=2, block=4, prefill_buckets=(8,))
    tpool = tlp.LLMPool(tb, _tc(CFG), capacity=2, block=4,
                        prefill_buckets=(8,), device="cpu")
    assert tpool.state.k.dtype == torch.float32
    jpool.warmup()
    tpool.warmup()
    want = _generate(jpool, [PROMPTS[0]], 9)[0]
    got = _generate(tpool, [PROMPTS[0]], 9)[0]
    assert len(got) >= 9 and all(0 <= t < CFG.vocab_size for t in got)
    assert got[:9] == want[:9]


def test_pooled_stream_model_text_deltas(params):
    """The pooled stream yields the B=1 JAX stream's text, twice
    concurrently, ending with the eos text, as JAX's pooled stream."""
    tok = _ToyTokenizer()
    b1 = jax_llm.JAXStreamModel(params, CFG, tok, block=4, max_tokens=12)
    want = "".join(b1.predict({"system": "s", "prompt": "hello"}))

    def scenario(pool, side):
        model = _stream_model(side, pool, tok, max_tokens=12)
        model.load()

        async def go():
            out = await asyncio.gather(
                _drain(model.predict({"system": "s", "prompt": "hello"})),
                _drain(model.predict({"system": "s", "prompt": "hello"})))
            pool.stop()
            return out
        return _run(go())

    jpool, tpool = _pools(params, capacity=2, block=4,
                          prefill_buckets=(8, 16, 32))
    jres, tres = scenario(jpool, "jax"), scenario(tpool, "port")
    assert tres == jres
    for got in tres:
        assert "".join(got) == want and got[-1] == tok.eos_token


def test_llm_pool_restart_after_stop_serves_new_loop(params):
    """``stop`` clears the pipelined in-flight iterations: a restart on a
    new event loop serves JAX's tokens."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8,), device="cpu")

    async def first():
        gen = pool.generate(PROMPTS[0], max_tokens=64)
        await gen.__anext__()
        for _ in range(500):
            if pool._inflight:
                break
            await asyncio.sleep(0)
        pool.stop()
        await gen.aclose()

    _run(first())
    assert pool._inflight is None
    got = _generate(pool, [PROMPTS[1]], 9)[0]
    assert got[:9] == _b1_greedy(params, PROMPTS[1], 9)


def test_llm_pool_picks_attn_bucket():
    params2 = _np(CFG2)
    want, got, tpool = _both(params2, lambda p: (
        p.attn_buckets, p._attn_bucket(20), p._attn_bucket(129),
        p._attn_bucket(513), _generate(p, [PROMPTS[0]], 9)[0], list(p._ub)),
        CFG2, capacity=2, block=8, prefill_buckets=(16, 32))
    assert got == want
    assert got[:4] == ((128, 256, 512), 128, 256, 512)
    assert max(got[5]) <= 128


def _burst(pool, prompts, block_after=True):
    """A simultaneous burst: every prefill queued before the step loop's
    first dispatch, then one block per slot."""
    async def go():
        pool.start()
        slots = [await pool.acquire() for _ in prompts]
        futs = [pool.submit_prefill(s, list(p))
                for s, p in zip(slots, prompts)]
        firsts = await asyncio.gather(*futs)
        blocks = [[] for _ in prompts]
        if block_after:
            blocks = await asyncio.gather(*[pool.submit_block(s)
                                            for s in slots])
        for s in slots:
            pool.release(s)
        pool.stop()
        return list(firsts), [list(b) for b in blocks]
    return _run(go())


def test_prefill_merge_burst_fewer_programs_same_tokens(params):
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[2], [8] * 20]
    for merge, calls in ((True, 1), (False, 3)):
        want, got, tpool = _both(params, lambda p: _burst(p, prompts),
                                 capacity=4, block=4,
                                 prefill_buckets=(8, 16, 32),
                                 prefill_merge=merge)
        assert got == want and tpool.prefill_calls == calls
    for p, first, blk in zip(prompts, *got):
        assert [first] + blk == _b1_greedy(params, p, 5)


def test_prefill_merge_chunks_stay_bucket_tight(params, monkeypatch):
    """Sorting by length: two length classes of PREFILL_BATCH prompts run
    as one program each, the short one at the small bucket."""
    short = [[3 + i] * 4 for i in range(4)]
    long = [[5 + i] * 25 for i in range(4)]
    order = [short[0], long[0], short[1], long[1], short[2], long[2],
             short[3], long[3]]
    seen = []
    real = tl.prefill_slots
    monkeypatch.setattr(tl, "prefill_slots", lambda p, tokens, *a, **k: (
        seen.append(tuple(tokens.shape)) or real(p, tokens, *a, **k)))
    want, got, tpool = _both(params, lambda p: _burst(p, order, False),
                             capacity=8, block=4, prefill_buckets=(8, 32))
    assert got == want and tpool.prefill_calls == 2
    assert sorted(seen) == [(4, 8), (4, 32)]


def test_pool_prefix_cache_matches_plain_pool(params):
    prompts = [PREFIX + [30 + i] for i in range(3)] + [[55, 56]]
    plain = _generate(tlp.LLMPool(params, _tc(CFG), capacity=4, block=4,
                                  prefill_buckets=(32,), device="cpu"),
                      prompts, 9)

    def scenario(pool):
        pool.set_prefix(PREFIX)
        assert pool._prefix_ids == PREFIX
        return (_generate(pool, prompts, 9),
                [pool._plan(list(p))[0] for p in prompts])

    want, got, _ = _both(params, scenario, capacity=4, block=4,
                         prefill_buckets=(32,))
    assert got == want and got[0] == plain
    assert got[1] == [True, True, True, False]


def test_pool_prefix_edge_cases(params):
    """Prompt == prefix, too short a prefix, a prefix that leaves no room;
    then warmup with a prefix and a prefix request, as in JAX."""
    def scenario(pool):
        pool.set_prefix(PREFIX)
        res = [pool._plan(list(PREFIX))]
        pool.set_prefix([1, 2, 3])
        res += [pool._prefix_ids, pool._plan([1, 2, 3, 4])[0]]
        pool.set_prefix(list(range(1, 90)))
        res.append(pool._prefix_ids)
        pool.set_prefix(PREFIX)
        pool.warmup()
        res.append(_generate(pool, [PREFIX + [33]], 9)[0])
        return res

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(32,))
    assert got == want
    assert got[0] == (False, PREFIX, len(PREFIX)) and got[1:4] == [None,
                                                                    False,
                                                                    None]
    assert got[4][:9] == _b1_greedy(params, PREFIX + [33], 9)


def test_set_prefix_after_capture_is_refused(params, stub_graphs):
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(32,), device="cpu", graphs=True)
    pool.set_prefix(PREFIX)
    pool.warmup()
    with pytest.raises(RuntimeError, match="before warmup"):
        pool.set_prefix(PREFIX)


def test_pooled_stream_model_prefix_autodetect():
    """``enable_prefix_cache`` pins the system preamble's ids found from
    the tokenizer; the streamed text is unchanged and equals JAX's."""
    bcfg = dataclasses.replace(CFG, vocab_size=384, max_seq_len=256)
    bparams = _np(bcfg)
    tok = tllm.ByteTokenizer()
    system = "You are a concise voice assistant."

    def run(side, use_prefix):
        jpool, tpool = _pools(bparams, bcfg, capacity=2, block=8,
                              prefill_buckets=(64,))
        pool = jpool if side == "jax" else tpool
        model = _stream_model(side, pool, tok, max_tokens=24, eos_text="")
        if use_prefix:
            model.enable_prefix_cache(system)
            assert pool._prefix_ids == tok.encode(system + "\n\n")

        async def go():
            out = await _drain(model.predict({"system": system,
                                              "prompt": "hello there"}))
            pool.stop()
            return "".join(out)
        return _run(go())

    want = run("jax", True)
    assert run("port", True) == run("port", False) == want


@pytest.mark.parametrize("n", [33, 40, 64, 80])
def test_pool_long_prompt_matches_b1(params, n):
    """Prompts over the top bucket chunk-prefill up to the context cap:
    JAX's tokens and the B=1 chain."""
    ids = [(i * 11 + 5) % 100 for i in range(n)]

    def scenario(pool):
        return pool._plan(list(ids)), _generate(pool, [ids], 9)[0]

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8, 16, 32))
    assert got == want and got[0] == (False, ids, n)
    assert got[1][:9] == _b1_greedy(params, ids, 9)


def test_pool_chunked_disabled_truncates(params):
    ids = [(i * 11 + 5) % 100 for i in range(40)]
    want, got, _ = _both(params, lambda p: (p._plan(list(ids)),
                                            _generate(p, [ids], 9)[0]),
                         capacity=2, block=4, prefill_buckets=(8, 16, 32),
                         chunked_prefill=False)
    assert got == want and got[0] == (False, ids[-32:], 32)
    assert got[1][:9] == _b1_greedy(params, ids[-32:], 9)


def test_pool_long_and_short_prompts_concurrent(params):
    long_ids = [(i * 13 + 2) % 100 for i in range(50)]
    prompts = [PROMPTS[0], long_ids, PROMPTS[1]]
    want, got, _ = _both(params, lambda p: _generate(p, prompts, 9),
                         capacity=4, block=4, prefill_buckets=(8, 16, 32))
    assert got == want
    for p, toks in zip(prompts, got):
        assert toks[:9] == _b1_greedy(params, p, 9), len(p)


def test_pool_prefix_with_long_suffix_chunks(params):
    sfx = [(i * 17 + 4) % 100 for i in range(40)]
    full = PREFIX + sfx
    plain = _generate(tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                                  prefill_buckets=(8, 16, 32),
                                  device="cpu"), [full], 9)[0]

    def scenario(pool):
        pool.set_prefix(PREFIX)
        return pool._plan(list(full)), _generate(pool, [full], 9)[0]

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8, 16, 32))
    assert got == want and got[0] == (True, sfx, len(full))
    assert got[1] == plain


def test_pool_warmup_compiles_chunk_programs(params):
    ids = [(i * 19 + 7) % 100 for i in range(40)]

    def scenario(pool):
        pool.warmup()
        assert pool.prefill_calls == 0
        return _generate(pool, [ids], 9)[0], pool.prefill_calls

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8, 16, 32))
    assert got == want and got[1] == 2
    assert got[0][:9] == _b1_greedy(params, ids, 9)


def test_pool_per_request_sampling_mixed(params):
    """One pool serves greedy and sampled requests at once: the greedy
    ones equal JAX's and the B=1 chains; the sampled one's override takes
    effect (it leaves the greedy chain within a few tries)."""
    samplings = [{"temperature": 0.0}, {"temperature": 1.3, "top_p": 0.95},
                 None]

    def scenario(pool):
        assert pool.stats()["per_request_sampling"] is True

        async def one(ids, sampling):
            out = []
            async for toks in pool.generate(ids, max_tokens=13,
                                            sampling=sampling):
                out.extend(toks)
            return out

        async def go():
            return await asyncio.gather(*[one(p, s) for p, s in
                                          zip(PROMPTS, samplings)])
        res = _run(go())
        greedy1 = _b1_greedy(params, PROMPTS[1], 13)
        diverged = res[1][:13] != greedy1
        for _ in range(4):
            if diverged:
                break
            diverged = _run(one(PROMPTS[1], samplings[1]))[:13] != greedy1
        pool.stop()
        assert diverged, "temperature override never changed the output"
        return res[0], res[2]

    want, got, _ = _both(params, scenario, capacity=4, block=4,
                         prefill_buckets=(8, 16, 32),
                         per_request_sampling=True)
    assert got == want
    assert got[0][:13] == _b1_greedy(params, PROMPTS[0], 13)
    assert got[1][:13] == _b1_greedy(params, PROMPTS[2], 13)


def test_pool_per_request_sampling_slot_reuse_resets(params):
    def scenario(pool):
        async def one(ids, sampling):
            out = []
            async for toks in pool.generate(ids, max_tokens=9,
                                            sampling=sampling):
                out.extend(toks)
            return out

        async def go():
            await one(PROMPTS[0], {"temperature": 1.5})
            return await one(PROMPTS[3], None)
        out = _run(go())
        pool.stop()
        return out

    want, got, _ = _both(params, scenario, capacity=1, block=4,
                         prefill_buckets=(8, 16), per_request_sampling=True)
    assert got[:9] == want[:9] == _b1_greedy(params, PROMPTS[3], 9)


def test_pool_first_block_identity_and_widths(params):
    """A fresh request's first step runs at ``first_block`` and the
    tokens equal the plain pool's; a step with any established row runs
    at the full block (the width rule at the dispatch level)."""
    async def chunks_of(pool, ids, n):
        out = []
        try:
            async for toks in pool.generate(ids, max_tokens=n):
                out.append(list(toks))
        finally:
            pool.stop()
        return out

    plain = tlp.LLMPool(params, _tc(CFG), capacity=4, block=8,
                        prefill_buckets=(16,), device="cpu")
    want = _run(chunks_of(plain, PROMPTS[1], 13))
    jfb, tfb = _pools(params, capacity=4, block=8, first_block=4,
                      prefill_buckets=(16,))
    assert tfb.first_block == 4
    got = _run(chunks_of(tfb, PROMPTS[1], 13))
    assert got == _run(chunks_of(jfb, PROMPTS[1], 13))
    flat, flatw = sum(got, []), sum(want, [])
    n = min(len(flat), len(flatw))
    assert n >= 13 and flat[:n] == flatw[:n]
    assert [len(c) for c in got][:3] == [1, 4, 8]

    def widths(pool, width_of):
        async def go():
            i0 = await pool.acquire()
            i1 = await pool.acquire()
            pool.submit_prefill(i0, PROMPTS[0])
            pool.submit_prefill(i1, PROMPTS[1])
            pool.submit_block(i0)
            pool.submit_block(i1)
            recs = [pool._dispatch()]          # both rows fresh
            pool.submit_block(i0)
            recs.append(pool._dispatch())      # row 0 established
            i2 = await pool.acquire()
            pool.submit_prefill(i2, PROMPTS[2])
            pool.submit_block(i2)
            pool.submit_block(i0)
            recs.append(pool._dispatch())      # fresh row 2 + row 0
            return [width_of(r) for r in recs]
        return _run(go())

    jfb, tfb = _pools(params, capacity=4, block=8, first_block=4,
                      prefill_buckets=(16,))
    assert (widths(tfb, lambda r: r.width) == widths(jfb, lambda r: r[5])
            == [4, 8, 8])


async def _aiter(items):
    for it in items:
        await asyncio.sleep(0)
        yield it


@pytest.mark.parametrize("splits", [
    [3], [1], [1, 1, 1, 1, 1, 1], [5, 5, 5, 5, 5, 5, 5, 5], [30, 10]])
def test_pool_streaming_prompt_matches_generate(params, splits):
    """A prompt fed in parts generates exactly what the whole prompt
    does (the head, the trickle, the flush threshold, an extension over
    the top bucket), as in JAX."""
    rng = np.random.default_rng(7)
    total = max(sum(splits) + 3, 12)
    prompt = [int(t) for t in rng.integers(1, 120, total)]
    parts, i = [], 0
    for s in splits:
        parts.append(prompt[i: i + s])
        i += s
    parts.append(prompt[i:])

    def scenario(pool):
        async def go():
            want, got = [], []
            async for toks in pool.generate(prompt, max_tokens=13):
                want.extend(toks)
            async for toks in pool.generate_streaming_prompt(
                    _aiter(parts), max_tokens=13):
                got.extend(toks)
            pool.stop()
            return want, got
        return _run(go())

    want, got, _ = _both(params, scenario, capacity=2, block=4,
                         prefill_buckets=(8, 16, 32))
    assert got == want and got[0] == got[1]
    assert got[0][:13] == _b1_greedy(params, prompt, 13)


def test_pool_streaming_prompt_restart_matches_generate(params):
    final = [9, 8, 7, 6, 5, 4, 3, 2]

    def scenario(pool, restart_cls):
        async def parts():
            yield [1, 2, 3, 4, 5]
            await asyncio.sleep(0)
            raise restart_cls(final)

        async def go():
            want, got = [], []
            async for toks in pool.generate(final, max_tokens=9):
                want.extend(toks)
            async for toks in pool.generate_streaming_prompt(
                    parts(), max_tokens=9):
                got.extend(toks)
            pool.stop()
            return want, got
        return _run(go())

    jpool, tpool = _pools(params, capacity=2, block=4,
                          prefill_buckets=(8, 16, 32))
    want = scenario(jpool, jlp.PromptRestart)
    got = scenario(tpool, tlp.PromptRestart)
    assert got == want and got[0] == got[1]


def test_pool_streaming_prompt_edge_cases(params):
    def scenario(pool):
        async def drain(gen):
            return [t async for toks in gen for t in toks]

        async def go():
            res = [await drain(pool.generate([], max_tokens=6)),
                   await drain(pool.generate_streaming_prompt(
                       _aiter([]), max_tokens=6)),
                   await drain(pool.generate([42], max_tokens=6))]
            res += await asyncio.gather(
                drain(pool.generate_streaming_prompt(_aiter([[42]]),
                                                     max_tokens=6)),
                drain(pool.generate(PROMPTS[1], max_tokens=6)))
            pool.stop()
            return res
        return _run(go())

    want, got, _ = _both(params, scenario, capacity=3, block=4,
                         prefill_buckets=(8, 16, 32))
    assert got == want
    assert got[1] == got[0] and got[3] == got[2]
    assert got[4][:6] == _b1_greedy(params, PROMPTS[1], 6)


def _streaming_vs_predict(params, tok, full, cum, max_tokens):
    """predict(full) and predict_streaming(cumulative texts) on each side;
    the texts of each side."""
    def scenario(pool, side):
        model = _stream_model(side, pool, tok, max_tokens=max_tokens)

        async def go():
            want = await _drain(model.predict({"system": "s",
                                               "prompt": full}))
            got = await _drain(model.predict_streaming({"system": "s"},
                                                       _aiter(cum)))
            got2 = await _drain(model.predict_streaming(
                {"system": "s"}, _aiter([(c, c is cum[-1]) for c in cum])))
            pool.stop()
            return "".join(want), "".join(got), "".join(got2)
        return _run(go())

    jpool, tpool = _pools(params, capacity=2, block=4,
                          prefill_buckets=(8, 16, 32))
    return scenario(jpool, "jax"), scenario(tpool, "port")


def test_pooled_stream_model_predict_streaming_matches_predict(params):
    full = "hello there, how are you"
    jres, tres = _streaming_vs_predict(
        params, _ToyTokenizer(), full,
        [full[:5], full[:9], full[:17], full], 12)
    assert tres == jres and len(set(tres)) == 1


def test_pooled_stream_model_predict_streaming_tokenizer_revision(params):
    """A tokenizer that revises earlier ids once the text grows trips the
    restart: the text still equals predict(final text)'s."""
    class RevisingTokenizer(_ToyTokenizer):
        def encode(self, text):
            ids = super().encode(text)
            return ([99] + ids) if len(text) > 24 else ids

    full = "hello there, how are you today"
    tok = RevisingTokenizer()
    assert tok.encode("s\n\n" + full + "\n")[0] == 99
    jres, tres = _streaming_vs_predict(params, tok, full,
                                       [full[:8], full[:16], full], 12)
    assert tres == jres and len(set(tres)) == 1


def test_pooled_stream_model_streaming_over_cap_matches_plain(params):
    """A streaming prompt over the context cap keeps the plain path's
    tail, through the restart."""
    full = "x" * 120
    jres, tres = _streaming_vs_predict(params, _ToyTokenizer(), full,
                                       [full[:40], full[:90], full], 8)
    assert tres == jres and len(set(tres)) == 1


# ---------------------------------------------------------------------------
# the warmup set, CUDA graphs (stubbed) and the dispatch thread
# ---------------------------------------------------------------------------

def _jax_warmup_calls(pool):
    """The programs JAX's ``LLMPool.warmup`` runs, as the port's keys."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _record_jax_programs(mp, calls)
        pool.warmup()
    return calls


def _record_jax_programs(mp, calls):
    for name, key in (
            ("prefill_slots", lambda p, tokens, *a, prefix_k=None, **k: (
                "prefill", tokens.shape[1], tokens.shape[0],
                prefix_k is not None)),
            ("prefill_slots_continue", lambda *a, final=True,
             attn_len=None, **k: ("continue", attn_len, final)),
            ("decode_block_pooled", lambda *a, block=16, attn_len=None,
             **k: ("block", attn_len, block))):
        real = getattr(jl, name)

        def rec(*a, _real=real, _key=key, **k):
            calls.append(_key(*a, **k))
            return _real(*a, **k)
        mp.setattr(jl, name, rec)


@pytest.mark.parametrize("kw", [
    dict(first_block=4, prefix=True),
    dict(first_block=0, prefix=False, chunked_prefill=False)],
    ids=["first block and prefix", "plain"])
def test_warmup_captures_the_programs_jax_warmup_compiles(stub_graphs, kw):
    """On the (stubbed) graph path warmup captures one graph per program
    JAX's warmup compiles (JAX runs each twice): every prefill bucket at
    both arrival sizes and each prefix bucket, the continuation rungs,
    every block rung at both widths.  Nothing is captured while serving,
    the tokens equal the eager pool's, and a shape warmup did not capture
    raises."""
    params2 = _np(CFG2)
    prefix = kw.pop("prefix")
    opts = dict(capacity=2, block=8, prefill_buckets=(16, 32), **kw)
    jpool = jlp.LLMPool(jax.tree.map(jnp.asarray, params2), CFG2, **opts)
    tpool = tlp.LLMPool(params2, _tc(CFG2), device="cpu", graphs=True,
                        **opts)
    if prefix:
        jpool.set_prefix(PREFIX)
        tpool.set_prefix(PREFIX)
    want = set(_jax_warmup_calls(jpool))
    n0 = graphs.CAPTURES
    tpool.warmup()
    assert set(tpool._graphs.graphs) == want
    assert graphs.CAPTURES - n0 == len(want) == len(tpool.warmup_keys())
    assert stub_graphs[-len(want):] == [()] * len(want)
    ids = [(i * 19 + 7) % 100 for i in range(70)]
    prompts = [PREFIX + [33], ids, PROMPTS[0]]
    eager = tlp.LLMPool(params2, _tc(CFG2), device="cpu", **opts)
    if prefix:
        eager.set_prefix(PREFIX)
    if not kw.get("chunked_prefill", True):
        prompts = prompts[::2]
    assert _generate(tpool, prompts, 20) == _generate(eager, prompts, 20)
    assert graphs.CAPTURES - n0 == len(want)
    del tpool._graphs.graphs[("block", 128, 8)]
    with pytest.raises(RuntimeError, match=r"no CUDA graph for "
                                           r"\('block', 128, 8\)"):
        _generate(tpool, [PROMPTS[1]], 20)


def test_sampled_pool_registers_its_generator(params, stub_graphs):
    """A sampling pool registers its device generator with every capture,
    and two requests from one pool draw different tokens."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8, 16), temperature=1.5,
                       device="cpu", graphs=True)
    pool.warmup()
    n = len(pool.warmup_keys())
    assert stub_graphs[-n:] == [(pool.generator,)] * n
    a = _generate(pool, [PROMPTS[1]], 12)[0]
    b = _generate(pool, [PROMPTS[1]], 12)[0]
    assert a != b


def test_every_pool_launch_is_on_the_dispatch_thread(params, monkeypatch):
    """The pool's programs run on the device's dispatch thread, never on
    the event loop's thread."""
    threads = []
    for name in ("prefill_slots", "prefill_slots_continue",
                 "decode_block_pooled"):
        real = getattr(tl, name)

        def rec(*a, _real=real, **k):
            threads.append(threading.current_thread().name)
            return _real(*a, **k)
        monkeypatch.setattr(tl, name, rec)
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8, 16, 32), device="cpu")
    long_ids = [(i * 13 + 2) % 100 for i in range(50)]
    _generate(pool, [PROMPTS[0], long_ids], 13)
    assert len(threads) > 4
    assert all(t.startswith("dispatch-cpu") for t in threads), threads


# ---------------------------------------------------------------------------
# the factory and its refusals
# ---------------------------------------------------------------------------

MARGS = ("vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd",
         "intermediate_size", "max_seq_len")


def _npz(tmp_path, jcfg, **extra):
    from llmvox_tpu.train.checkpoint import save_params_npz
    path = str(tmp_path / "llama.npz")
    save_params_npz(path, _np(jcfg), meta={"model_args": {
        **{k: getattr(jcfg, k) for k in MARGS}, **extra}})
    return path


def _serve_cfg(npz, **kw):
    from llmvox_tpu_torch.utils.config import ServeConfig
    return dataclasses.replace(ServeConfig(), **{
        "llm_backend": "jax", "llm_jax_params": npz, "llm_checkpoint": "byte",
        "llm_block": 4, "llm_first_block": 2, "llm_temperature": 0.0,
        "llm_max_tokens": 16, "compute_dtype": "float32",
        "llm_pool_capacity": 3, "llm_prefill_buckets": (32, 64),
        "llm_spec_k": 2, **kw})


def test_factory_builds_the_pooled_stream(tmp_path):
    """``llm_pool_capacity > 0``: a PooledLlamaStreamModel over an LLMPool
    with the config's knobs and the system prompt's prefix cached, like
    JAX's ``build_jax_stream``; ``llm_spec_k`` without draft heads serves
    the plain block, as JAX's does; the text equals JAX's."""
    from llmvox_tpu.utils.config import ServeConfig as JServeConfig
    bcfg = dataclasses.replace(CFG, vocab_size=384, max_seq_len=256)
    npz = _npz(tmp_path, bcfg)
    cfg = _serve_cfg(npz, system_prompt="You are brief.")
    model = tllm.build_llama_stream(cfg, device="cpu")
    assert isinstance(model, tllm.PooledLlamaStreamModel)
    pool = model.pool
    assert (pool.B, pool.block, pool.first_block, pool.buckets) == (
        3, 4, 2, (32, 64))
    assert pool._prefix_ids == tllm.ByteTokenizer().encode(
        "You are brief.\n\n")
    assert pool.spec_stats() is None and pool.stats()["spec_k"] == 0
    jcfg = dataclasses.replace(JServeConfig(), **dataclasses.asdict(cfg))
    jmodel = jax_llm.build_jax_stream(jcfg)
    assert isinstance(jmodel, jax_llm.PooledJAXStreamModel)
    req = {"system": "You are brief.", "prompt": "hi"}

    async def go(m):
        out = "".join(await _drain(m.predict(req)))
        m.pool.stop()
        return out
    assert _run(go(model)) == _run(go(jmodel))


def test_draft_heads_and_experts_are_refused(tmp_path, capsys):
    """What this test once refused is ported: a pool over params with
    draft heads speculates (``spec_k``) and streams the plain pool's
    tokens; an MoE config pools with JAX's tokens; npz metas with experts
    or draft heads go through the factory (the CLI no longer refuses
    them).  Without a card the pool still refuses the default device."""
    params = _np(CFG)
    hcfg = dataclasses.replace(CFG, n_draft_heads=2)
    heads = _np(hcfg)
    spec = tlp.LLMPool(heads, _tc(hcfg), capacity=2, block=4,
                       prefill_buckets=(16,), spec_k=2, device="cpu")
    assert spec.use_spec and spec.stats()["spec"] == {"k": 2, "ladder": [2]}
    plain = tlp.LLMPool(heads, _tc(hcfg), capacity=2, block=4,
                        prefill_buckets=(16,), device="cpu")
    assert _generate(spec, PROMPTS[:2], 9) == _generate(plain, PROMPTS[:2],
                                                        9)
    mcfg = dataclasses.replace(CFG, n_experts=4, moe_capacity_factor=2.0)
    got, want, _ = _both(_np(mcfg), lambda pool: _generate(pool, PROMPTS,
                                                           9),
                         mcfg, capacity=4, block=4, prefill_buckets=(16,))
    assert got == want
    for kw in ({"n_experts": 2}, {"n_draft_heads": 2}):
        jcfg = dataclasses.replace(CFG, max_seq_len=256, vocab_size=384,
                                   **kw)
        from llmvox_tpu.train.checkpoint import save_params_npz
        npz = str(tmp_path / "llama.npz")
        save_params_npz(npz, _np(jcfg), meta={"model_args": {
            **{k: getattr(jcfg, k) for k in MARGS}, **kw}})
        model = tllm.build_llama_stream(_serve_cfg(npz), device="cpu")
        assert model.pool.cfg == _tc(jcfg)
        assert model.pool.use_spec == ("n_draft_heads" in kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlp.LLMPool(params, _tc(CFG))


def test_stats_report_the_jax_keys(params):
    jpool, tpool = _pools(params, capacity=2, block=4, first_block=2,
                          prefill_buckets=(8, 16))
    _generate(jpool, [PROMPTS[0]], 9)
    _generate(tpool, [PROMPTS[0]], 9)
    assert json.dumps(tpool.stats()) == json.dumps(jpool.stats())


# ---------------------------------------------------------------------------
# the pooled LLM behind the scheduler and the HTTP server
# ---------------------------------------------------------------------------

def test_pooled_stream_model_through_scheduler(params, weights):  # noqa: F811
    """Two concurrent requests drive the pooled LLM and a TTS scheduler
    each: the audio equals JAX's for the same requests."""
    from llmvox_tpu.serve.scheduler import StreamingScheduler as JSched
    from llmvox_tpu_torch.serve.scheduler import StreamingScheduler as TSched
    from llmvox_tpu_torch.utils import config as tconfig
    from tests.test_torch_engine import (CODEC_TOL, _jax_engines,
                                         _port_cfg, _port_engines)
    from tests.tiny_stack import SERVE_CFG

    tts = weights
    tok = _ToyTokenizer()
    tok.eos_token = SERVE_CFG.eos_token
    jpool, tpool = _pools(params, capacity=2, block=4,
                          prefill_buckets=(8, 16, 32))
    out = {}
    for side, pool in (("jax", jpool), ("port", tpool)):
        model = _stream_model(side, pool, tok, max_tokens=10)

        async def one(i, side=side, model=model):
            if side == "jax":
                sched = JSched(_jax_engines(tts, SERVE_CFG, 2), SERVE_CFG)
            else:
                sched = TSched(_port_engines(tts, SERVE_CFG, 2),
                               _port_cfg(tconfig.ServeConfig, SERVE_CFG))
            chunks = [c async for c in sched.run(model.predict(
                {"system": "s", "prompt": f"hi {i}"}))]
            return np.frombuffer(b"".join(chunks), dtype="<f4")

        async def go(pool=pool, one=one):
            res = await asyncio.gather(one(0), one(1))
            pool.stop()
            return res
        out[side] = _run(go())
    for want, got in zip(out["jax"], out["port"]):
        assert len(got) == len(want) > 0 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **CODEC_TOL)


def test_http_server_with_pooled_llm_and_pooled_tts(params):
    """Concurrent ``/tts`` over HTTP share one batched LLM program and one
    batched speech program on each side (``llm_backend`` jax with
    ``llm_pool_capacity``): each request's chunks equal the JAX server's,
    and ``GET /stats`` reports the LLM pool (``llm_pool``), as JAX's
    does, and the port's own counters of it (``llm_pool_host``)."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from llmvox_tpu.serve.server import TTSServer as JTTSServer
    from llmvox_tpu_torch.serve.client import post_chunks, to_wave
    from llmvox_tpu_torch.serve.server import TTSServer as TTTSServer
    from llmvox_tpu_torch.utils import config as tconfig
    from tests.test_torch_pool import (CODEC_TOL, _free_port, _jax_pool,
                                       _port_pool, _serve_pooled, _tcfg)
    from tests.tiny_stack import SERVE_CFG, make_engines

    jeng = make_engines(0, SERVE_CFG, n=1)[0]
    tok = _ToyTokenizer()
    tok.eos_token = SERVE_CFG.eos_token
    results, stats = {}, {}
    for side in ("jax", "port"):
        port = _free_port()
        cfg = dataclasses.replace(SERVE_CFG, api_host="127.0.0.1",
                                  api_port=port, pool_capacity=4)
        jllm, tllm_pool = _pools(params, capacity=2, block=4,
                                 prefill_buckets=(16, 32))
        if side == "jax":
            def make(cfg=cfg, llm_pool=jllm):
                return JTTSServer(None, cfg, stream_model=_stream_model(
                    "jax", llm_pool, tok, max_tokens=10),
                    pool=_jax_pool(jeng, 4, cfg))
        else:
            def make(cfg=cfg, llm_pool=tllm_pool):
                return TTTSServer(
                    None, _tcfg(tconfig.ServeConfig, cfg),
                    stream_model=_stream_model("port", llm_pool, tok,
                                               max_tokens=10),
                    pool=_port_pool(jeng, 4, cfg))
        stop = _serve_pooled(make, port)
        try:
            with ThreadPoolExecutor(max_workers=2) as ex:
                results[side] = list(ex.map(
                    lambda i: post_chunks("127.0.0.1", port, "/tts",
                                          {"text": f"question number {i}"},
                                          timeout=400), range(2)))
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/stats")
            stats[side] = json.loads(conn.getresponse().read())
        finally:
            stop()
    for want, got in zip(results["jax"], results["port"]):
        assert [len(c) for _, c in got] == [len(c) for _, c in want]
        wav = to_wave(got)
        assert wav.size > 0 and np.isfinite(wav).all()
        np.testing.assert_allclose(wav, to_wave(want), **CODEC_TOL)
    host = stats["port"]["llm_pool_host"]
    assert host["prefill_tokens"] > 0 and host["plan_s"] > 0
    assert 0 < host["prefill_s"] < host["launch_s"]
    tstats, jstats = stats["port"]["llm_pool"], stats["jax"]["llm_pool"]
    assert tstats.keys() == jstats.keys()
    # steps and prefill programs depend on how the arrivals interleave
    for k in ("steps", "prefill_calls"):
        assert tstats.pop(k) > 0 and jstats.pop(k) > 0
    assert tstats == jstats and tstats["capacity"] == 2


def test_warmup_cache_captures_the_llm_pool(tmp_path, capsys):
    """``tools/warmup_cache --llm_pool_capacity N`` builds the pooled LLM
    at the geometry of ``--llm_jax_params``' meta (random weights, the
    system prompt's prefix from the byte tokenizer) and warms every
    program JAX's warmup compiles, reporting them."""
    from llmvox_tpu_torch.tools import warmup_cache
    npz = _npz(tmp_path, dataclasses.replace(CFG, vocab_size=384,
                                             max_seq_len=512))
    warmup_cache.main([
        "--device", "cpu", "--n_layer", "1", "--n_head", "2", "--n_embd",
        "32", "--block_size", "128", "--vocab_size", "16",
        "--text_embed_dim", "12", "--speech_embed_dim", "20", "--vq_bins",
        "16", "--vq_dim", "20", "--backbone_input_channels", "20",
        "--backbone_dim", "32", "--backbone_intermediate_dim", "64",
        "--backbone_num_layers", "1", "--n_fft", "128", "--hop_length", "32",
        "--chunk_buckets", "[4, 8]", "--decode_block", "8",
        "--decode_block_large", "16", "--first_decode_block", "4",
        "--initial_dump_size_1", "4", "--compute_dtype", "float32",
        "--llm_pool_capacity", "2", "--llm_jax_params", npz,
        "--llm_checkpoint", "byte", "--llm_block", "8",
        "--llm_first_block", "4", "--llm_prefill_buckets", "[16, 32]"])
    out = capsys.readouterr().out
    # 2 buckets x 2 sizes x (plain, prefix) + 3 rungs over 32 x (final
    # or not) + 3 rungs x 2 widths
    assert ("LLM pool of 2 (20 programs: prefill buckets (16, 32), prefix "
            "buckets (16, 32), attn rungs (128, 256, 512), widths [4, 8])"
            in out), out


def test_pooled_logits_match_jax(params):
    """The logits every pooled program samples from, JAX's (run without
    jit, so its sampler sees them) against the port's, to 1e-5: a
    mixed-length prefill (the port's head at the last valid positions
    only), a prefix prefill, a continuation chunk and a decode block."""
    tp = to_torch(params, "cpu")
    seen = {"jax": [], "port": []}

    def spy(mod, side):
        real = mod._sample_maybe_rows

        def rec(logits, *a, **k):
            seen[side].append(np.asarray(logits, np.float32).copy())
            return real(logits, *a, **k)
        return rec

    full = [(i * 7 + 3) % 100 for i in range(40)]
    tokens, valid = _prefill_inputs(PROMPTS, 16)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jl, "_sample_maybe_rows", spy(jl, "jax"))
        mp.setattr(tl, "_sample_maybe_rows", spy(tl, "port"))
        js = jl.init_llama_pool_state(CFG, 6)
        ts = tl.init_llama_pool_state(_tc(CFG), 6)
        act = np.ones((4,), bool)
        _, js = _jprefill(params, js, tokens, valid, [5, 0, 2, 4], act)
        _, ts = _tprefill(tp, ts, tokens, valid, [5, 0, 2, 4], act)
        jpk, jpv = jl.prefix_kv(params, jnp.asarray([PREFIX], jnp.int32),
                                CFG)
        tpk, tpv = tl.prefix_kv(tp, torch.tensor([PREFIX]), _tc(CFG))
        sfx = _prefill_inputs([[21, 22, 23]], 8)
        _, js = _jprefill(params, js, *sfx, [1], [True], prefix_k=jpk,
                          prefix_v=jpv)
        _, ts = _tprefill(tp, ts, *sfx, [1], [True], prefix_k=tpk,
                          prefix_v=tpv)
        t0 = np.asarray([full[:8]], np.int32)
        _, js = _jprefill(params, js, t0, [8], [3], [True])
        _, ts = _tprefill(tp, ts, t0, np.asarray([8], np.int32), [3],
                          [True])
        _, js = jl.prefill_slots_continue(
            params, jnp.asarray([full[8:]], jnp.int32),
            jnp.asarray([32], jnp.int32), js, jnp.asarray([3], jnp.int32),
            jnp.ones((1,), bool), jnp.asarray([8], jnp.int32),
            jax.random.PRNGKey(1), CFG, final=True, attn_len=96)
        _, ts = tl.prefill_slots_continue(
            tp, torch.tensor([full[8:]]), torch.tensor([32]), ts,
            torch.tensor([3]), torch.tensor([True]), torch.tensor([8]),
            _tc(CFG), final=True, attn_len=96)
        active = np.ones((6,), bool)
        jl.decode_block_pooled(params, js, jnp.asarray(active),
                               jax.random.PRNGKey(2), CFG, block=3)
        tl.decode_block_pooled(tp, ts, torch.from_numpy(active), _tc(CFG),
                               block=3)
    # three prefills, the final chunk, three decode steps
    assert len(seen["port"]) == len(seen["jax"]) == 7
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_streaming_prompt_without_continuation_graphs(params, stub_graphs):
    """A card's pool without chunked prefill captures no continuation (as
    JAX's warmup compiles none): a streaming prompt then prefills once at
    its end, with ``generate``'s tokens and no continuation launched."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(8, 16, 32), chunked_prefill=False,
                       device="cpu", graphs=True)
    pool.warmup()
    assert not any(k[0] == "continue" for k in pool._graphs.graphs)
    prompt = [int(t) for t in np.random.default_rng(7).integers(1, 120, 40)]
    parts = [prompt[:5], prompt[5:30], prompt[30:]]

    async def go():
        want = [t async for toks in pool.generate(prompt, max_tokens=13)
                for t in toks]
        got = [t async for toks in pool.generate_streaming_prompt(
            _aiter(parts), max_tokens=13) for t in toks]
        pool.stop()
        return want, got

    want, got = _run(go())
    assert got == want and got[:13] == _b1_greedy(params, prompt[-32:], 13)
