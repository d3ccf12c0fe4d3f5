"""The port's pooled speculative Llama against the JAX package's, on the
CPU in f32 from the same numpy parameters (JAX's ``init_llama_params``
with draft heads): ``models/llama.py::decode_block_spec_pooled`` (greedy
token for token, ``iters`` under oracle and adversarial drafts, inactive
rows, the attention window, the cache's last rows, the draft heads'
chunked f32 product, sampled rejection sampling by distribution, per-row
sampling), ``llama_loss`` and its autograd gradients against
``jax.grad``, ``LLMPool`` speculating on its ladder (switches, parking on
rung 0, calibration, stats), speculation on a mixture-of-experts Llama,
and, with the stubbed graph path, the warmup set against the calls JAX's
warmup makes.  Every test of JAX's ``tests/test_llama_spec.py`` has its
counterpart here."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.serve import llm_pool as jlp
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.serve import llm_pool as tlp
from llmvox_tpu_torch.serve.spec_control import SpecController
from llmvox_tpu_torch.utils import graphs
from llmvox_tpu_torch.utils.params import to_torch

from tests.test_torch_llm_stream import stub_graphs  # noqa: F401 (a fixture)

CFG = jl.LlamaConfig(vocab_size=384, n_layer=2, n_head=4, n_kv_head=2,
                     n_embd=64, intermediate_size=128, max_seq_len=96,
                     n_draft_heads=3)
PROMPTS = [[5, 9, 2], [7, 11, 13, 17, 19, 23, 29], [3] * 12, [42]]
TOL = dict(atol=1e-5, rtol=1e-5)


def _tc(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _np(jcfg, seed=0):
    return jax.device_get(jl.init_llama_params(jax.random.PRNGKey(seed),
                                               jcfg))


@pytest.fixture(scope="module")
def params():
    p = _np(CFG)
    assert "draft_heads" in p
    return p


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=600))


def _inputs(prompts, tpad=16):
    tokens = np.zeros((len(prompts), tpad), np.int32)
    valid = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
        valid[i] = len(p)
    return tokens, valid


def _jprefill(params, prompts, batch, jcfg=CFG):
    tokens, valid = _inputs(prompts)
    n = len(prompts)
    state = jl.init_llama_pool_state(jcfg, batch=batch)
    _, state = jl.prefill_slots(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(valid), state, jnp.arange(n, dtype=jnp.int32),
        jnp.ones((n,), bool), jax.random.PRNGKey(1), jcfg)
    return state


def _tprefill(tp, prompts, batch, jcfg=CFG):
    tokens, valid = _inputs(prompts)
    n = len(prompts)
    state = tl.init_llama_pool_state(_tc(jcfg), batch)
    _, state = tl.prefill_slots(
        tp, torch.from_numpy(tokens), torch.from_numpy(valid), state,
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        _tc(jcfg))
    return state


def _jgreedy(params, state, active, block, nblocks, jcfg=CFG):
    outs = []
    for i in range(nblocks):
        toks, state = jl.decode_block_pooled(
            jax.tree.map(jnp.asarray, params), state, jnp.asarray(active),
            jax.random.PRNGKey(7 + i), jcfg, block=block)
        outs.append(np.asarray(toks))
    return np.concatenate(outs, axis=1), state


def _jspec(params, state, active, jcfg=CFG, **kw):
    toks, state, iters = jl.decode_block_spec_pooled(
        jax.tree.map(jnp.asarray, params), state, jnp.asarray(active), jcfg,
        **kw)
    return np.asarray(toks), state, np.asarray(iters)


def _tspec(tp, state, active, jcfg=CFG, **kw):
    if "draft_tokens" in kw:
        kw["draft_tokens"] = torch.from_numpy(np.asarray(
            kw["draft_tokens"], np.int32))
    toks, state, iters = tl.decode_block_spec_pooled(
        tp, state, torch.tensor(active), _tc(jcfg), **kw)
    return toks.numpy(), state, iters.numpy()


def _states_equal(js, ts):
    """Positions and tokens exact; each row's cache rows below its pos to
    ``TOL`` (above it, the port's one extra masked iteration has written
    rows JAX's loop does not reach: they are overwritten before any
    query attends them)."""
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
    for b, p in enumerate(ts.pos.tolist()):
        for x, y in ((ts.k, js.k), (ts.v, js.v)):
            np.testing.assert_allclose(x[:, b, :p].numpy(),
                                       np.asarray(y)[:, b, :p], **TOL)


# ---------------------------------------------------------------------------
# the pooled speculative block against JAX's
# ---------------------------------------------------------------------------

def test_spec_matches_greedy_random_heads(params):
    """Random draft heads (they almost never accept): two blocks of the
    port equal JAX's speculative blocks and JAX's greedy blocks token for
    token; the states (positions, tokens, each row's cache below its pos)
    and each row's iterations equal JAX's."""
    block, active = 8, [True] * 4
    want, _ = _jgreedy(params, _jprefill(params, PROMPTS, 4), active,
                       block, 2)
    js, ts = _jprefill(params, PROMPTS, 4), _tprefill(
        to_torch(params, "cpu"), PROMPTS, 4)
    tp = to_torch(params, "cpu")
    for b in range(2):
        jt, js, ji = _jspec(params, js, active, block=block, k_draft=3)
        tt, ts, ti = _tspec(tp, ts, active, block=block, k_draft=3)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tt, want[:, b * block:(b + 1) * block])
        np.testing.assert_array_equal(ti, ji)
        assert np.all(ti <= (block + 1) // 2)
        _states_equal(js, ts)


def test_spec_oracle_drafts_cut_iterations(params):
    """Drafts equal to the greedy continuation: every draft accepts, a
    block of 8 at k 3 takes ceil(8 / 4) = 2 iterations, as in JAX."""
    block, kd, active = 8, 3, [True] * 4
    want, _ = _jgreedy(params, _jprefill(params, PROMPTS, 4), active,
                       block, 1)
    jt, _, ji = _jspec(params, _jprefill(params, PROMPTS, 4), active,
                       block=block, k_draft=kd,
                       draft_tokens=jnp.asarray(want))
    tt, _, ti = _tspec(to_torch(params, "cpu"),
                       _tprefill(to_torch(params, "cpu"), PROMPTS, 4),
                       active, block=block, k_draft=kd, draft_tokens=want)
    np.testing.assert_array_equal(tt, want)
    assert ti.tolist() == ji.tolist() == [2] * 4


def test_spec_adversarial_drafts_exact_and_bounded(params):
    """Drafts that never match: greedy's tokens, and each iteration still
    commits the step and the correction (ceil(block / 2) iterations)."""
    block, kd, active = 8, 3, [True] * 4
    want, _ = _jgreedy(params, _jprefill(params, PROMPTS, 4), active,
                       block, 1)
    bad = (want + 1) % CFG.vocab_size
    jt, _, ji = _jspec(params, _jprefill(params, PROMPTS, 4), active,
                       block=block, k_draft=kd, draft_tokens=jnp.asarray(bad))
    tt, _, ti = _tspec(to_torch(params, "cpu"),
                       _tprefill(to_torch(params, "cpu"), PROMPTS, 4),
                       active, block=block, k_draft=kd, draft_tokens=bad)
    np.testing.assert_array_equal(tt, want)
    np.testing.assert_array_equal(jt, want)
    assert ti.tolist() == ji.tolist() == [(block + 1) // 2] * 4


def test_spec_inactive_rows_frozen(params):
    """An inactive row keeps its pos and tok and emits -1; reactivated, it
    continues its greedy chain; both sides as JAX."""
    block = 4
    tp = to_torch(params, "cpu")
    ts0 = _tprefill(tp, PROMPTS[:2], 2)
    pos0, tok0 = ts0.pos.clone(), ts0.tok.clone()
    tt, ts, _ = _tspec(tp, ts0, [True, False], block=block, k_draft=3)
    jt, js, _ = _jspec(params, _jprefill(params, PROMPTS[:2], 2),
                       [True, False], block=block, k_draft=3)
    assert np.all(tt[1] == -1) and np.array_equal(tt, jt)
    assert ts.pos[1] == pos0[1] and ts.tok[1] == tok0[1]
    want_a, jg = _jgreedy(params, _jprefill(params, PROMPTS[:2], 2),
                          [True, False], block, 1)
    want_b, _ = _jgreedy(params, jg, [True, True], block, 1)
    np.testing.assert_array_equal(tt[0], want_a[0])
    tt2, ts, _ = _tspec(tp, ts, [True, True], block=block, k_draft=3)
    np.testing.assert_array_equal(tt2, want_b)


def test_spec_attn_len_bucket_exact(params):
    """The attention window (pos + block + k + 1 <= attn_len) changes
    nothing."""
    block, kd, active = 8, 3, [True] * 4
    want, _ = _jgreedy(params, _jprefill(params, PROMPTS, 4), active,
                       block, 1)
    tp = to_torch(params, "cpu")
    ts = _tprefill(tp, PROMPTS, 4)
    assert int(ts.pos.max()) + block + kd + 1 <= 32
    tt, _, _ = _tspec(tp, ts, active, block=block, k_draft=kd, attn_len=32)
    np.testing.assert_array_equal(tt, want)


def test_spec_at_the_cache_last_rows_matches_jax(params):
    """Rows whose block ends at the cache's edge (pos + block + k + 1 =
    attn_len = S): the verify forward's probe rows land in the cache's
    last rows; tokens, positions and every cache row below each row's pos
    equal JAX's, and the tokens equal greedy's."""
    block, kd = 8, 3
    s = CFG.max_seq_len
    long = [(i * 7 + 3) % 300 for i in range(s - block - kd - 1)]
    prompts = [long[:-1], long, PROMPTS[1]]
    tp = to_torch(params, "cpu")

    def jpre():
        tokens, valid = _inputs(prompts, tpad=len(long))
        st = jl.init_llama_pool_state(CFG, batch=3)
        _, st = jl.prefill_slots(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
            jnp.asarray(valid), st, jnp.arange(3, dtype=jnp.int32),
            jnp.ones((3,), bool), jax.random.PRNGKey(1), CFG)
        return st

    tokens, valid = _inputs(prompts, tpad=len(long))
    ts = tl.init_llama_pool_state(_tc(CFG), 3)
    _, ts = tl.prefill_slots(tp, torch.from_numpy(tokens),
                             torch.from_numpy(valid), ts,
                             torch.arange(3, dtype=torch.int32),
                             torch.ones(3, dtype=torch.bool), _tc(CFG))
    active = [True] * 3
    want, _ = _jgreedy(params, jpre(), active, block, 1)
    jt, js, ji = _jspec(params, jpre(), active, block=block, k_draft=kd,
                        attn_len=s)
    tt, ts, ti = _tspec(tp, ts, active, block=block, k_draft=kd,
                        attn_len=s)
    assert int(valid[1]) + 1 + block + kd == s
    np.testing.assert_array_equal(tt, want)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ti, ji)
    for b in range(3):
        p = int(ts.pos[b])
        assert p == int(np.asarray(js.pos)[b])
        np.testing.assert_allclose(ts.k[:, b, :p].numpy(),
                                   np.asarray(js.k)[:, b, :p], **TOL)
        np.testing.assert_allclose(ts.v[:, b, :p].numpy(),
                                   np.asarray(js.v)[:, b, :p], **TOL)


def test_draft_logits_are_the_f32_einsum(params, monkeypatch):
    """The draft heads' logits, taken per head and vocabulary chunk (here
    chunks of 100, the last one short), are JAX's f32 einsum of the same
    hidden state and bf16 heads, to f32 sum-order noise; the heads are
    never copied whole to f32."""
    monkeypatch.setattr(tl, "DRAFT_CHUNK", 100)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((5, CFG.n_embd)).astype(np.float32)
    heads = jnp.asarray(params["draft_heads"]).astype(jnp.bfloat16)
    want = jnp.einsum("bc,kcv->bkv", jnp.asarray(hidden),
                      heads.astype(jnp.float32))
    th = torch.from_numpy(np.array(heads.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tl._draft_logits(torch.from_numpy(hidden), th)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# sampled speculation: the law of the plain sampler
# ---------------------------------------------------------------------------

SCFG = jl.LlamaConfig(vocab_size=32, n_layer=2, n_head=4, n_kv_head=2,
                      n_embd=32, intermediate_size=64, max_seq_len=64,
                      n_draft_heads=2)
SPROMPT = [5, 9, 2, 17, 3, 11]


@pytest.fixture(scope="module")
def sparams():
    return _np(SCFG, seed=2)


def _sprefill(tp, batch):
    """Every row prefilled with the same prompt, its first token greedy."""
    tokens = torch.tensor([SPROMPT] * batch, dtype=torch.int32)
    state = tl.init_llama_pool_state(_tc(SCFG), batch)
    first, state = tl.prefill_slots(
        tp, tokens, torch.full((batch,), len(SPROMPT), dtype=torch.int32),
        state, torch.arange(batch, dtype=torch.int32),
        torch.ones(batch, dtype=torch.bool), _tc(SCFG))
    return int(first[0]), state


def _exact_marginals(sparams, t0, temperature, top_k=0, top_p=1.0):
    """The model's conditionals from JAX's forward and filter: p1 = P(e1 |
    prompt, t0), p2 = sum_v p1(v) P(e2 | prompt, t0, v)."""
    p = jax.tree.map(jnp.asarray, sparams)
    seq = jnp.asarray([SPROMPT + [t0]], jnp.int32)
    logits = jl.apply_llama(p, seq, SCFG)[0, -1]
    p1 = jax.nn.softmax(jl._filtered_logits(logits, temperature, top_k,
                                            top_p))
    seqs = jnp.asarray([SPROMPT + [t0, v] for v in range(SCFG.vocab_size)],
                       jnp.int32)
    logits2 = jl.apply_llama(p, seqs, SCFG)[:, -1]
    p2c = jax.nn.softmax(jl._filtered_logits(logits2, temperature, top_k,
                                             top_p), axis=-1)
    return np.asarray(p1), np.asarray(p1 @ p2c)


def _tv(samples, exact):
    emp = np.bincount(samples, minlength=len(exact)) / len(samples)
    return 0.5 * float(np.abs(emp - exact).sum())


def _spec_samples(sparams, trials, temperature, top_k=0, top_p=1.0,
                  batch=32, block=3, kd=2, draft_tokens=None, rows=None):
    tp = to_torch(sparams, "cpu")
    gen = torch.Generator().manual_seed(1000)
    outs, its = [], []
    for _ in range(trials):
        _, state = _sprefill(tp, batch)
        toks, _, iters = tl.decode_block_spec_pooled(
            tp, state, torch.ones(batch, dtype=torch.bool), _tc(SCFG),
            block=block, k_draft=kd, draft_tokens=draft_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, rows=rows,
            generator=gen)
        outs.append(toks.numpy())
        its.append(iters.numpy())
    return np.concatenate(outs), np.concatenate(its)


def test_spec_sampled_distribution_exact(sparams):
    """Rejection sampling keeps the model's law: the first two emitted
    tokens' marginals over 2560 samples match the enumerated
    conditionals, and both the accept and the correction paths run."""
    t0, _ = _sprefill(to_torch(sparams, "cpu"), 1)
    p1, p2 = _exact_marginals(sparams, t0, temperature=1.0)
    toks, iters = _spec_samples(sparams, 80, temperature=1.0)
    assert toks.shape == (2560, 3) and np.all(toks >= 0)
    assert _tv(toks[:, 0], p1) < 0.08
    assert _tv(toks[:, 1], p2) < 0.08
    assert 1.0 < iters.mean() < 3.0, iters.mean()


def test_spec_sampled_adversarial_proposal_exact(sparams):
    """A one-hot proposal at the least likely token (explicit drafts): an
    always-accept fault would emit it with probability ~1; the emitted
    law is still the model's."""
    t0, _ = _sprefill(to_torch(sparams, "cpu"), 1)
    p1, p2 = _exact_marginals(sparams, t0, temperature=1.0)
    y = int(np.argmin(p2))
    drafts = torch.full((32, 3), y, dtype=torch.int32)
    toks, _ = _spec_samples(sparams, 80, temperature=1.0,
                            draft_tokens=drafts)
    assert _tv(toks[:, 1], p2) < 0.08
    assert abs(1.0 - p2[y]) > 0.5


def test_spec_sampled_filtering_invariant(sparams):
    """With top-k and top-p on, every emitted token lies in the filtered
    support of its teacher-forced conditional, and the first token's
    marginal is the filtered law."""
    t0, _ = _sprefill(to_torch(sparams, "cpu"), 1)
    temperature, top_k, top_p = 0.8, 6, 0.9
    p1, _ = _exact_marginals(sparams, t0, temperature, top_k, top_p)
    toks, _ = _spec_samples(sparams, 40, temperature, top_k, top_p,
                            block=4)
    assert _tv(toks[:, 0], p1) < 0.08
    seqs = np.concatenate([np.tile(SPROMPT + [t0], (len(toks), 1)),
                           toks[:, :-1]], axis=1)
    logits = jl.apply_llama(jax.tree.map(jnp.asarray, sparams),
                            jnp.asarray(seqs), SCFG)
    start = len(SPROMPT)
    for j in range(toks.shape[1]):
        f = jl._filtered_logits(logits[:, start + j], temperature, top_k,
                                top_p)
        ok = np.take_along_axis(np.asarray(f), toks[:, j:j + 1], axis=1)
        assert np.all(np.isfinite(ok)), j


def test_spec_sampled_cache_consistency(sparams):
    """After a sampled block the state equals the teacher-forced rebuild
    of the emitted sequence: pos, last token, KV rows below pos."""
    batch, block, kd = 4, 6, 2
    tp = to_torch(sparams, "cpu")
    t0, state = _sprefill(tp, batch)
    toks, state, _ = tl.decode_block_spec_pooled(
        tp, state, torch.ones(batch, dtype=torch.bool), _tc(SCFG),
        block=block, k_draft=kd, temperature=1.0,
        generator=torch.Generator().manual_seed(5))
    toks = toks.numpy()
    want_pos = len(SPROMPT) + 1 + (block - 1)
    assert np.all(state.pos.numpy() == want_pos)
    np.testing.assert_array_equal(state.tok.numpy(), toks[:, -1])
    seqs = np.concatenate([np.tile(SPROMPT + [t0], (batch, 1)),
                           toks[:, :-1]], axis=1)
    ref = tl.init_llama_pool_state(_tc(SCFG), batch)
    _, ref = tl.prefill_slots(
        tp, torch.from_numpy(seqs.astype(np.int32)),
        torch.full((batch,), seqs.shape[1], dtype=torch.int32), ref,
        torch.arange(batch, dtype=torch.int32),
        torch.ones(batch, dtype=torch.bool), _tc(SCFG))
    for a, b in ((state.k, ref.k), (state.v, ref.v)):
        np.testing.assert_allclose(a[:, :, :want_pos].numpy(),
                                   b[:, :, :want_pos].numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_spec_rows_greedy_rows_exact_beside_sampled(params):
    """Per-row sampling: greedy rows (t <= 0) take the exact argmax test
    and emit greedy's tokens while sampled rows beside them draw."""
    block, kd, active = 8, 3, [True] * 4
    want, _ = _jgreedy(params, _jprefill(params, PROMPTS, 4), active,
                       block, 1)
    tp = to_torch(params, "cpu")
    rows = (torch.tensor([0.0, 1.2, 0.0, 0.9]),
            torch.tensor([0, 20, 0, 0], dtype=torch.int32),
            torch.tensor([1.0, 0.9, 1.0, 1.0]))
    toks, _, _ = tl.decode_block_spec_pooled(
        tp, _tprefill(tp, PROMPTS, 4), torch.tensor(active), _tc(CFG),
        block=block, k_draft=kd, rows=rows,
        generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(toks.numpy()[[0, 2]], want[[0, 2]])
    assert np.all((toks.numpy() >= 0) & (toks.numpy() < CFG.vocab_size))
    assert not np.array_equal(toks.numpy()[1], want[1])


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _jgrad_and_loss(jparams, toks, jcfg):
    return jax.value_and_grad(jl.llama_loss)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(toks), jcfg)


def test_llama_mtp_loss_trains_draft_heads(params):
    """``llama_loss`` with the draft heads' terms equals JAX's, and its
    autograd gradients equal ``jax.grad``'s (the heads' among them, not
    zero); without heads it is the plain next-token cross-entropy."""
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 24))
    jloss, jgrads = _jgrad_and_loss(params, toks, CFG)
    tp = {k: v for k, v in to_torch(params, "cpu").items()}
    leaves = {"draft_heads": tp["draft_heads"], "head": tp["head"],
              "wq": tp["h"]["wq"], "wdown": tp["h"]["wdown"]}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tl.llama_loss(tp, torch.from_numpy(toks), _tc(CFG))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = {"draft_heads": jgrads["draft_heads"], "head": jgrads["head"],
          "wq": jgrads["h"]["wq"], "wdown": jgrads["h"]["wdown"]}
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    assert float(t.grad.abs().max()) > 0
    assert float(leaves["draft_heads"].grad.abs().max()) > 0
    no_heads = {k: v for k, v in params.items() if k != "draft_heads"}
    base = tl.llama_loss(to_torch(no_heads, "cpu"), torch.from_numpy(toks),
                         _tc(CFG))
    np.testing.assert_allclose(float(base), float(jl.llama_loss(
        jax.tree.map(jnp.asarray, no_heads), jnp.asarray(toks), CFG)),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# LLMPool speculating
# ---------------------------------------------------------------------------

def _generate(pool, prompts, n):
    async def one(ids):
        toks = []
        async for chunk in pool.generate(ids, max_tokens=n):
            toks.extend(chunk)
        return toks

    async def go():
        try:
            return await asyncio.gather(*(one(p) for p in prompts))
        finally:
            pool.stop()
    return _run(go())


def _pools(params, jcfg=CFG, **kw):
    return (jlp.LLMPool(jax.tree.map(jnp.asarray, params), jcfg, **kw),
            tlp.LLMPool(params, _tc(jcfg), device="cpu", **kw))


def test_llm_pool_spec_e2e_matches_plain_pool(params):
    """``spec_k=3``: concurrent streams equal the plain pool's, on both
    sides; the stats carry JAX's keys."""
    opts = dict(capacity=4, block=4, prefill_buckets=(16,))
    want = _generate(tlp.LLMPool(params, _tc(CFG), device="cpu", **opts),
                     PROMPTS, 9)
    jpool, tpool = _pools(params, spec_k=3, **opts)
    assert tpool.use_spec and tpool._spec_margin == 4
    assert _generate(tpool, PROMPTS, 9) == _generate(jpool, PROMPTS, 9) \
        == want
    assert tpool.stats() == jpool.stats()


def test_llm_pool_adaptive_ladder_token_identity_across_switches(params):
    """The ladder (0, 2, 3) forced through a rung switch at every block:
    the streams equal the plain pool's."""
    opts = dict(capacity=4, block=4, prefill_buckets=(16,))
    want = _generate(tlp.LLMPool(params, _tc(CFG), device="cpu", **opts),
                     PROMPTS, 17)
    pool = tlp.LLMPool(params, _tc(CFG), device="cpu",
                       spec_ladder=(0, 2, 3), **opts)
    assert pool._adaptive and pool._spec_rungs == (0, 2, 3)
    cycle, calls = [0, 3, 2], []
    pool._spec_ctl.next_k = lambda: (
        calls.append(None) or cycle[(len(calls) - 1) % 3])
    assert _generate(pool, PROMPTS, 17) == want
    assert len(calls) >= 3


def test_llm_pool_adaptive_parks_on_greedy_when_heads_never_accept(params):
    """Random heads with injected costs (a spec iteration 2.5 greedy
    tokens): the controller measures the low accept rate and parks on
    rung 0; the stream is greedy's; /stats shows the ladder."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(16,), spec_ladder=(0, 3),
                       device="cpu")
    pool._spec_ctl = SpecController(
        (0, 3), k0=3, cost_ms={0: 1.0, 3: 2.5}, dwell=2, probe_every=50)
    plain = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                        prefill_buckets=(16,), device="cpu")
    got = _generate(pool, [PROMPTS[1]], 40)[0]
    assert got[:40] == _generate(plain, [PROMPTS[1]], 40)[0][:40]
    ctl = pool._spec_ctl
    assert ctl.k == 0 and ctl.switches >= 1
    assert ctl.p is not None and ctl.p < 0.6
    st = pool.stats()["spec"]
    assert st["k"] == 0 and st["ladder"] == [0, 3]


def test_llm_pool_adaptive_calibration_fills_costs(params):
    """``warmup`` costs every rung (ms a token for rung 0, ms an
    iteration for the others) and leaves the slots fresh."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                       prefill_buckets=(16,), spec_ladder=(0, 3),
                       device="cpu")
    pool.warmup()
    costs = pool._spec_ctl.cost_ms
    assert set(costs) == {0, 3} and all(v > 0 for v in costs.values())
    assert not pool.state.pos.any() and not pool.state.tok.any()


def test_llm_pool_spec_requires_heads(params):
    """Speculation engages only with draft heads, greedy or sampled; a
    rung deeper than the heads raises."""
    sampled = tlp.LLMPool(params, _tc(CFG), capacity=2, block=4,
                          temperature=0.8, spec_k=3, device="cpu")
    assert sampled.use_spec
    no_heads = {k: v for k, v in params.items() if k != "draft_heads"}
    plain = tlp.LLMPool(no_heads, _tc(CFG), capacity=2, block=4, spec_k=3,
                        device="cpu")
    assert not plain.use_spec and plain.spec_stats() is None
    with pytest.raises(ValueError, match="draft_heads"):
        tlp.LLMPool(params, _tc(CFG), capacity=2, block=4, spec_k=4,
                    device="cpu")


def test_llm_pool_sampled_spec_e2e(params):
    """A sampled pool at spec_k=3 streams complete in-vocabulary
    sequences through the rejection-sampling block."""
    pool = tlp.LLMPool(params, _tc(CFG), capacity=4, block=4,
                       temperature=0.9, top_p=0.95, prefill_buckets=(16,),
                       spec_k=3, device="cpu")
    for seq in _generate(pool, PROMPTS, 9):
        assert len(seq) == 9 and all(0 <= t < CFG.vocab_size for t in seq)


# ---------------------------------------------------------------------------
# speculation on a mixture-of-experts Llama
# ---------------------------------------------------------------------------

MOE_CFG = dataclasses.replace(CFG, n_experts=8, moe_top_k=2,
                              moe_capacity_factor=0.25)


@pytest.fixture(scope="module")
def moe_params():
    p = _np(MOE_CFG, seed=3)
    assert "draft_heads" in p and "moe_wgate" in p["h"]
    return p


def test_spec_matches_greedy_on_moe_llama(moe_params):
    """E = 8 at a drop-prone capacity factor: speculative blocks (random
    heads, then oracle drafts) equal greedy pooled blocks and JAX's, the
    verify forward routing drop-free; oracle drafts take 2 iterations."""
    block, kd, active = 8, 3, [True] * 4
    want, _ = _jgreedy(moe_params, _jprefill(moe_params, PROMPTS, 4,
                                             MOE_CFG), active, block, 2,
                       MOE_CFG)
    tp = to_torch(moe_params, "cpu")
    ts = _tprefill(tp, PROMPTS, 4, MOE_CFG)
    got = []
    for _ in range(2):
        tt, ts, _ = _tspec(tp, ts, active, MOE_CFG, block=block, k_draft=kd)
        got.append(tt)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    jt, _, _ = _jspec(moe_params, _jprefill(moe_params, PROMPTS, 4,
                                            MOE_CFG), active, MOE_CFG,
                      block=block, k_draft=kd)
    np.testing.assert_array_equal(got[0], jt)
    tt, _, ti = _tspec(tp, _tprefill(tp, PROMPTS, 4, MOE_CFG), active,
                       MOE_CFG, block=block, k_draft=kd,
                       draft_tokens=want[:, :block])
    np.testing.assert_array_equal(tt, want[:, :block])
    assert ti.tolist() == [2] * 4


def test_spec_moe_row_independent_of_cohort(moe_params):
    """Row 0 alone equals row 0 beside three busy rows (drop-free
    routing: no capacity to compete for)."""
    block, kd = 8, 3
    tp = to_torch(moe_params, "cpu")
    t4, _, _ = _tspec(tp, _tprefill(tp, PROMPTS, 4, MOE_CFG), [True] * 4,
                      MOE_CFG, block=block, k_draft=kd)
    t1, _, _ = _tspec(tp, _tprefill(tp, PROMPTS[:1], 4, MOE_CFG),
                      [True, False, False, False], MOE_CFG, block=block,
                      k_draft=kd)
    np.testing.assert_array_equal(t1[0], t4[0])


def test_llm_pool_spec_e2e_moe(moe_params):
    """The MoE pool at spec_k=3 streams the plain MoE pool's tokens, and
    JAX's."""
    opts = dict(capacity=4, block=4, prefill_buckets=(16,))
    want = _generate(tlp.LLMPool(moe_params, _tc(MOE_CFG), device="cpu",
                                 **opts), PROMPTS, 9)
    jpool, tpool = _pools(moe_params, MOE_CFG, spec_k=3, **opts)
    assert tpool.use_spec
    assert _generate(tpool, PROMPTS, 9) == want == _generate(jpool,
                                                             PROMPTS, 9)


# ---------------------------------------------------------------------------
# the warmup set and the graph path (stubbed on the CPU)
# ---------------------------------------------------------------------------

def _jax_warmup_calls(pool):
    """The programs JAX's ``LLMPool.warmup`` runs, as the port's keys: a
    speculative block (attn, width, rung) is the port's iteration key and
    its (width, rung) start."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name, key in (
                ("prefill_slots", lambda p, tokens, *a, prefix_k=None, **k:
                 [("prefill", tokens.shape[1], tokens.shape[0],
                   prefix_k is not None)]),
                ("prefill_slots_continue", lambda *a, final=True,
                 attn_len=None, **k: [("continue", attn_len, final)]),
                ("decode_block_pooled", lambda *a, block=16, attn_len=None,
                 **k: [("block", attn_len, block)]),
                ("decode_block_spec_pooled", lambda *a, block=16, k_draft=4,
                 attn_len=None, **k: [("spec_start", block, k_draft),
                                      ("spec_iter", attn_len, block,
                                       k_draft)])):
            real = getattr(jl, name)

            def rec(*a, _real=real, _key=key, **k):
                calls.extend(_key(*a, **k))
                return _real(*a, **k)
            mp.setattr(jl, name, rec)
        pool.warmup()
    return calls


def test_warmup_captures_the_programs_jax_warmup_compiles(params,
                                                          stub_graphs):
    """On the (stubbed) graph path a ladder pool captures exactly the
    programs JAX's warmup compiles (per attention rung, spec rung and
    width a block or a speculative start and iteration), calibrates, and
    serves greedy's tokens with nothing captured; a rung warmup did not
    capture raises."""
    opts = dict(capacity=2, block=8, first_block=4, prefill_buckets=(16,),
                spec_ladder=(0, 2))
    jcfg = dataclasses.replace(CFG, max_seq_len=256)
    p256 = _np(jcfg)
    jpool = jlp.LLMPool(jax.tree.map(jnp.asarray, p256), jcfg, **opts)
    want = set(_jax_warmup_calls(jpool))
    tpool = tlp.LLMPool(p256, _tc(jcfg), device="cpu", graphs=True, **opts)
    n0 = graphs.CAPTURES
    tpool.warmup()
    assert set(tpool._graphs.graphs) == want == set(tpool.warmup_keys())
    assert graphs.CAPTURES - n0 == len(want)
    assert set(tpool._spec_ctl.cost_ms) == {0, 2}
    eager = tlp.LLMPool(p256, _tc(jcfg), device="cpu",
                        **{**opts, "spec_ladder": ()})
    assert _generate(tpool, PROMPTS[:2], 20) == _generate(eager,
                                                          PROMPTS[:2], 20)
    assert graphs.CAPTURES - n0 == len(want)
    tpool._spec_ctl.next_k = lambda: 2
    del tpool._graphs.graphs[("spec_iter", 128, 8, 2)]
    with pytest.raises(RuntimeError, match=r"no CUDA graph for "
                                           r"\('spec_iter', 128, 8, 2\)"):
        _generate(tpool, [PROMPTS[1]], 20)


def test_warmup_cache_captures_the_spec_rungs(tmp_path, capsys):
    """``tools/warmup_cache --llm_pool_capacity N --llm_spec_ladder`` on
    an npz whose meta has draft heads warms the speculative rungs too
    (random heads drawn with the random weights), and reports them."""
    from llmvox_tpu.train.checkpoint import save_params_npz
    from llmvox_tpu_torch.tools import warmup_cache
    jcfg = dataclasses.replace(CFG, n_draft_heads=2, max_seq_len=512)
    npz = str(tmp_path / "llama.npz")
    save_params_npz(npz, _np(jcfg), meta={"model_args": {
        k: getattr(jcfg, k) for k in (
            "vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd",
            "intermediate_size", "max_seq_len", "n_draft_heads")}})
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
        "--llm_first_block", "4", "--llm_prefill_buckets", "[16, 32]",
        "--llm_spec_ladder", "[0, 2]"])
    out = capsys.readouterr().out
    # 8 prefills, 6 continuations, per attention rung (3) and width (2) a
    # block and an iteration at rung 2, and 2 starts (one a width)
    assert ("LLM pool of 2 (28 programs: prefill buckets (16, 32), prefix "
            "buckets (16, 32), attn rungs (128, 256, 512), widths [4, 8], "
            "spec rungs [0, 2])" in out), out


@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_quantize_llama_params_keeps_the_draft_heads_dense(params, mode):
    """The draft heads stay full precision under every mode, as JAX's
    ``quantize_llama_params`` keeps them, and a quantized pool still
    speculates with them (greedy: the quantized plain pool's tokens)."""
    from llmvox_tpu.ops import quant as jq
    from llmvox_tpu_torch.ops import quant as tq
    tp = to_torch(params, "cpu")
    got = tq.quantize_llama_params(tp, mode)
    want = jq.quantize_llama_params(jax.tree.map(jnp.asarray, params), mode)
    assert isinstance(got["draft_heads"], torch.Tensor)
    assert not isinstance(want["draft_heads"], (jq.QuantizedTensor,
                                                jq.Int4Tensor))
    assert torch.equal(got["draft_heads"], tp["draft_heads"])
    opts = dict(capacity=2, block=4, prefill_buckets=(16,), device="cpu")
    spec = tlp.LLMPool(got, _tc(CFG), spec_k=3, **opts)
    plain = tlp.LLMPool(got, _tc(CFG), **opts)
    assert spec.use_spec
    assert _generate(spec, PROMPTS[:2], 9) == _generate(plain, PROMPTS[:2],
                                                        9)
