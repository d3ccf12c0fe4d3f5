"""The port's pipeline-parallel Llama (models/llama_pp.py) against the JAX
package's ``make_pp_decode`` / ``make_pp_prefill`` on the virtual mesh
and the port's one-process pooled programs, in f32 on the CPU: the
config and prompts of ``tests/test_llama_pp.py``.

Four gloo ranks are spawned once for the module (``pp`` fixture,
``tests/torch_pp_ranks.py::pp_checks``): two pp 2 groups or one pp 4
group run the decode at (pp, n_micro) in {(2, 2), (2, 4), (4, 4), (4,
8)} from the prefilled pool, a second chained block, the pp prefill then
pp decode, inactive rows, a sampled step by distribution and the
n_micro < pp assertion; meanwhile the parent runs JAX's side."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.models import llama_pp as jpp
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.models import llama_pp as tpp
from llmvox_tpu_torch.parallel.launch import spawn

from tests import torch_pp_ranks as ranks
from tests.torch_tp_ranks import _torch_tree

CFG = jl.LlamaConfig(vocab_size=128, n_layer=4, n_head=4, n_kv_head=2,
                     n_embd=32, intermediate_size=64, max_seq_len=96)
PROMPTS = [[5, 9, 2], [7, 11, 13, 17, 19], [3] * 9, [42, 43], [8] * 6,
           [21, 22, 23], [60], [2, 4, 6, 8]]
LAYOUTS = [(2, 2), (2, 4), (4, 4), (4, 8)]
BLOCK = 4
TPAD = 16
# the sampled step: rows of one prompt, each one draw of a top-k filter
SAMPLED_ROWS = 256
SAMPLED_TOP_K = 8
# a category's frequency may stray this many standard deviations
SAMPLED_SIGMAS = 5.0


def _inputs(prompts):
    tokens = np.zeros((len(prompts), TPAD), np.int32)
    valid = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        valid[i] = len(p)
    return tokens, valid


def _port_prefill(params, cfg, tokens, valid):
    b = tokens.shape[0]
    st = tl.init_llama_pool_state(cfg, batch=b)
    with torch.no_grad():
        first, st = tl.prefill_slots(
            params, torch.from_numpy(tokens).long(),
            torch.from_numpy(valid), st, torch.arange(b),
            torch.ones(b, dtype=torch.bool), cfg)
    return first, st


def _np_state(st):
    return {n: getattr(st, n).numpy().copy() for n in ("k", "v", "pos",
                                                       "tok")}


def _mesh(pp):
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:pp]).reshape(pp), (jpp.PP_AXIS,))


def _jax_side(params, tokens, valid, active):
    """JAX's pp decode at every layout (two chained blocks), its pp
    prefill then pp decode at (4, 4) and the inactive rows at (2, 4)."""
    b = tokens.shape[0]
    ones = jnp.ones((b,), bool)

    def prefilled(mesh):
        st = jl.init_llama_pool_state(CFG, batch=b)
        _, st = jl.prefill_slots(params, jnp.asarray(tokens),
                                 jnp.asarray(valid), st,
                                 jnp.arange(b, dtype=jnp.int32), ones,
                                 jax.random.PRNGKey(1), CFG)
        return jax.device_put(st, jpp.llama_pp_state_shardings(mesh))
    out = {"decode": {}}
    for pp, m in LAYOUTS:
        mesh = _mesh(pp)
        pparams = jax.device_put(
            params, jpp.llama_pp_param_shardings(mesh, params))
        decode = jpp.make_pp_decode(mesh, CFG, block=BLOCK, n_micro=m)
        st = prefilled(mesh)
        t1, st = decode(pparams, st, ones, jax.random.PRNGKey(2))
        s1 = (np.asarray(st.pos), np.asarray(st.tok))
        t2, st = decode(pparams, st, ones, jax.random.PRNGKey(3))
        out["decode"][pp, m] = (np.asarray(t1), s1, np.asarray(t2),
                                (np.asarray(st.pos), np.asarray(st.tok)))
    mesh = _mesh(4)
    pparams = jax.device_put(params,
                             jpp.llama_pp_param_shardings(mesh, params))
    st = jax.device_put(jl.init_llama_pool_state(CFG, batch=b),
                        jpp.llama_pp_state_shardings(mesh))
    first, st = jpp.make_pp_prefill(mesh, CFG, n_micro=4)(
        pparams, jnp.asarray(tokens), jnp.asarray(valid), st,
        jax.random.PRNGKey(1))
    pos = np.asarray(st.pos)
    toks, _ = jpp.make_pp_decode(mesh, CFG, block=BLOCK, n_micro=4)(
        pparams, st, ones, jax.random.PRNGKey(2))
    out["prefill"] = (np.asarray(first), pos, np.asarray(toks))
    mesh = _mesh(2)
    pparams = jax.device_put(params,
                             jpp.llama_pp_param_shardings(mesh, params))
    toks, st = jpp.make_pp_decode(mesh, CFG, block=BLOCK, n_micro=4)(
        pparams, prefilled(mesh), jnp.asarray(active),
        jax.random.PRNGKey(2))
    out["inactive"] = (np.asarray(toks), np.asarray(st.pos),
                       np.asarray(st.tok))
    return out


@pytest.fixture(scope="module")
def pp():
    jparams = jl.init_llama_params(jax.random.PRNGKey(0), CFG)
    params = jax.tree.map(lambda a: np.array(a, np.float32), jparams)
    cfg = tl.LlamaConfig(**dataclasses.asdict(CFG))
    tokens, valid = _inputs(PROMPTS)
    tparams = _torch_tree(params)
    first, st = _port_prefill(tparams, cfg, tokens, valid)
    active = np.zeros((len(PROMPTS),), bool)
    active[::2] = True
    stokens, svalid = _inputs([PROMPTS[1]] * SAMPLED_ROWS)
    _, sst = _port_prefill(tparams, cfg, stokens, svalid)
    case = dict(cfg=cfg, params=params, block=BLOCK, layouts=LAYOUTS,
                state=_np_state(st), tokens=tokens, valid=valid,
                active=active,
                sampled={"state": _np_state(sst), "top_k": SAMPLED_TOP_K})
    res = {}
    thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.pp_checks, 4, case, threads=1, timeout_s=300)))
    thread.start()
    jax_out = _jax_side(jparams, tokens, valid, active)
    thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(ranks=res["r"], jax=jax_out, case=case, tparams=tparams,
                cfg=cfg, first=first.numpy(), sst=sst)


def _pooled(pp, active=None, blocks=2):
    """The one process's decode_block_pooled chain from the prefilled
    pool: [(tokens, pos, tok)] a block."""
    c = pp["case"]
    st = tl.LlamaPoolState(*(torch.from_numpy(c["state"][n].copy())
                             for n in ("k", "v", "pos", "tok")))
    act = (torch.ones(len(PROMPTS), dtype=torch.bool) if active is None
           else torch.from_numpy(active))
    out = []
    with torch.no_grad():
        for _ in range(blocks):
            toks, st = tl.decode_block_pooled(pp["tparams"], st, act,
                                              pp["cfg"], block=BLOCK)
            out.append((toks.numpy(), st.pos.numpy(), st.tok.numpy()))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pp_decode_matches_jax_and_pooled(pp, layout):
    """Two chained pp decode blocks from the prefilled pool: the tokens,
    pos and tok of JAX's make_pp_decode and of decode_block_pooled, on
    every stage; each stage holds L/pp layers of the caches."""
    j = pp["jax"]["decode"][layout]
    one = _pooled(pp)
    for r in pp["ranks"]:
        got = r["decode"][layout]
        assert got["layers"] == CFG.n_layer // layout[0]
        for b, (toks, st) in enumerate((got["first"], got["second"])):
            np.testing.assert_array_equal(toks, j[2 * b])
            np.testing.assert_array_equal(st["pos"], j[2 * b + 1][0])
            np.testing.assert_array_equal(st["tok"], j[2 * b + 1][1])
            np.testing.assert_array_equal(toks, one[b][0])
            np.testing.assert_array_equal(st["pos"], one[b][1])
            np.testing.assert_array_equal(st["tok"], one[b][2])


def test_pp_prefill_then_decode_matches_jax_and_prefill_slots(pp):
    """The pp prefill of the whole fresh pool (first tokens, pos = the
    valid lengths, tok) then a pp decode block at (4, 4): JAX's
    make_pp_prefill / make_pp_decode chain and the one process's
    prefill_slots + decode_block_pooled."""
    first, pos, toks = pp["jax"]["prefill"]
    one = _pooled(pp, blocks=1)[0]
    np.testing.assert_array_equal(pp["first"], first)
    for r in pp["ranks"]:
        got = r["prefill"]
        np.testing.assert_array_equal(got["first"], first)
        np.testing.assert_array_equal(got["state"]["pos"], pos)
        np.testing.assert_array_equal(got["state"]["pos"],
                                      pp["case"]["valid"])
        np.testing.assert_array_equal(got["state"]["tok"], first)
        np.testing.assert_array_equal(got["toks"], toks)
        np.testing.assert_array_equal(got["toks"], one[0])
        np.testing.assert_array_equal(got["after"]["pos"], one[1])


def test_pp_decode_freezes_inactive_rows(pp):
    """Every other row inactive at (2, 4): the active rows' tokens, and
    every row's pos and tok (frozen where inactive), those of JAX and of
    decode_block_pooled."""
    active = pp["case"]["active"]
    toks, pos, tok = pp["jax"]["inactive"]
    one = _pooled(pp, active, blocks=1)[0]
    for r in pp["ranks"]:
        got = r["inactive"]
        for want in ((toks, pos, tok), one):
            np.testing.assert_array_equal(got["toks"][active],
                                          want[0][active])
            np.testing.assert_array_equal(got["state"]["pos"], want[1])
            np.testing.assert_array_equal(got["state"]["tok"], want[2])
        assert (got["state"]["pos"][~active]
                == pp["case"]["valid"][~active]).all()


def test_pp_sampled_step_has_the_filtered_distribution(pp):
    """A sampled pp step (temperature 1, top-k 8) on 256 rows of one
    prompt: the draws' frequencies are the filtered softmax of the one
    process's logits (and of JAX's filter on them), each within
    SAMPLED_SIGMAS standard deviations; every stage holds the same
    draws.  The port draws from the last stage's generator where JAX
    folds the tick into its key, so only the law is shared."""
    sst = pp["sst"]
    st = tl.LlamaPoolState(sst.k[:, :1].clone(), sst.v[:, :1].clone(),
                           sst.pos[:1].clone(), sst.tok[:1].clone())
    with torch.no_grad():
        x = tl._scan_layers_rows(pp["tparams"], st.tok[:, None], st.k,
                                 st.v, st.pos, pp["cfg"])
        logits = tl.nn.linear(tl.rms_norm(x[:, -1], pp["tparams"]["lnf_s"],
                                          CFG.rms_eps),
                              tl._head(pp["tparams"]))[0]
    probs = torch.softmax(tl._filtered_logits(logits, 1.0, SAMPLED_TOP_K),
                          dim=-1).numpy()
    jprobs = np.asarray(jax.nn.softmax(jl._filtered_logits(
        jnp.asarray(logits.numpy()), 1.0, SAMPLED_TOP_K)))
    np.testing.assert_allclose(probs, jprobs, atol=1e-6)
    draws = pp["ranks"][0]["sampled"][:, 0]
    for r in pp["ranks"]:
        np.testing.assert_array_equal(r["sampled"][:, 0], draws)
    n = len(draws)
    freq = np.bincount(draws, minlength=CFG.vocab_size) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(probs))
    sd = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= SAMPLED_SIGMAS * sd + 1.0 / n).all(), (
        freq[probs > 0], probs[probs > 0])
    assert len(np.unique(draws)) > 1


def test_pp_needs_enough_microbatches(pp):
    """JAX's assertion on n_micro < pp (and on layers that do not split)."""
    for r in pp["ranks"]:
        assert r["refused"] == "need n_micro >= pp (2 < 4)"
    with pytest.raises(AssertionError):
        jpp.make_pp_decode(_mesh(4), CFG, n_micro=2)
    with pytest.raises(AssertionError, match="layers must split"):
        tpp.shard_llama_pp(pp["tparams"], dataclasses.replace(
            pp["cfg"], n_layer=3), 2, 0)


def test_pp_shards(pp):
    """A stage holds its layers of every stacked leaf and the rest whole;
    its state its layers of the caches and the whole pos and tok."""
    cfg, params = pp["cfg"], pp["tparams"]
    for s in range(2):
        shard = tpp.shard_llama_pp(params, cfg, 2, s)
        for k, v in shard["h"].items():
            assert torch.equal(v, params["h"][k][2 * s:2 * s + 2])
        assert shard["tok_emb"] is params["tok_emb"]
        st = tpp.shard_pp_state(pp["sst"], cfg, 2, s)
        assert torch.equal(st.k, pp["sst"].k[2 * s:2 * s + 2])
        assert torch.equal(st.pos, pp["sst"].pos)
