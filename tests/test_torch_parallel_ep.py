"""The port's expert parallelism (parallel/mesh.py's ep axis and
``all_to_all``, ops/moe.py's ``moe_ffn(ep_group=, dp_group=)``,
``moe_ffn_a2a`` and ``make_moe_a2a``, parallel/sharding.py's
``LLAMA_FSDP_SPECS``, the Llama's ``ep`` / ``dp`` / ``fsdp`` paths) and
the tp continuation and speculative block, against the JAX package's
GSPMD and ``shard_map`` runs on the 8-device virtual mesh, in f32 on the
CPU.

Eight gloo ranks are spawned once for the module (``ep`` fixture,
``tests/torch_ep_ranks.py::ep_checks``): the MoE Llama of
``tests/test_moe.py::_moe_cfg`` at (ep 4, tp 1) and (ep 4, tp 2), its
greedy chains at ep 2, ``make_moe_a2a`` at ep 4 on the inputs of
``test_moe.py::_a2a_setup`` (forward, aux and gradients), one AdamW step
of ``llama_loss`` at dp 2 x ep 4 under ``LLAMA_FSDP_SPECS`` (JAX's
``test_moe_fsdp_expert_sharded_train_step``, and at capacities that drop
tokens across the dp shards), and a chunked prefill and a speculative
block at tp 2.  Meanwhile the parent runs JAX's side of each."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.ops import moe as jmoe
from llmvox_tpu.parallel import sharding as jsh
from llmvox_tpu.parallel.mesh import DP_AXIS
from llmvox_tpu.parallel.mesh import create_mesh as jcreate_mesh
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.ops import moe as tmoe
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel.launch import spawn

from tests import torch_ep_ranks as ranks
from tests.torch_tp_ranks import _torch_tree

# JAX's own bounds (tests/test_moe.py)
MOE_TOL = dict(atol=2e-5, rtol=2e-4)
A2A_TOL = dict(rtol=2e-5, atol=2e-6)
AUX_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LAYOUTS = [(4, 1), (4, 2)]
# (drop_free, capacity_factor, masked): test_moe_a2a_matches_single_program
A2A_CASES = {"drop_free": (True, 0.0, False), "capped": (False, 1.0, False),
             "masked": (False, 1.0, True)}
# the FSDP step's configs: JAX's test's, then capacities at which tokens
# drop, in one routing group over the whole batch and in groups of 22
FSDP_CASES = {"cf 8": {}, "cf 1": dict(moe_capacity_factor=1.0),
              "cf 0.5, groups of 22": dict(moe_capacity_factor=0.5,
                                           moe_group_size=22)}


def _moe_cfg(**kw):
    base = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2,
                n_embd=32, intermediate_size=48, max_seq_len=64,
                n_experts=4, moe_top_k=2, moe_capacity_factor=8.0)
    base.update(kw)
    return jl.LlamaConfig(**base)


def _port_cfg(cfg):
    return tl.LlamaConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _a2a_setup(seed=0, e=8, c=16, i=32, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    rw = rng.normal(size=(c, e)).astype(np.float32)
    wg = (rng.normal(size=(e, c, i)) / np.sqrt(c)).astype(np.float32)
    wu = (rng.normal(size=(e, c, i)) / np.sqrt(c)).astype(np.float32)
    wd = (rng.normal(size=(e, i, c)) / np.sqrt(i)).astype(np.float32)
    return dict(x=x, rw=rw, wg=wg, wu=wu, wd=wd)


def _pool_inputs(prompts, width):
    tokens = np.zeros((len(prompts), width), np.int32)
    valid = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        valid[i] = len(p)
    return tokens, valid


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------

def _jax_logits(params, ids, cfg):
    out = {}
    for ep, tp in LAYOUTS:
        mesh = jcreate_mesh(dp_size=8 // (ep * tp), ep_size=ep, tp_size=tp)
        sh = jax.device_put(params, jsh.llama_param_shardings(mesh, params))
        out[ep, tp] = np.asarray(jax.jit(jl.apply_llama, static_argnums=2)(
            sh, jnp.asarray(ids, jnp.int32), cfg))
    return out


def _jax_a2a(case):
    ep = 4
    mesh = jcreate_mesh(dp_size=8 // ep, ep_size=ep)
    a = {k: jnp.asarray(v) for k, v in case["a2a"].items() if k != "mask"}
    n = a["x"].shape[0]
    mask = jnp.asarray(case["a2a"]["mask"])
    out = {}
    for name, (drop_free, cf, masked) in A2A_CASES.items():
        m = mask if masked else None
        ref = jmoe.moe_ffn(a["x"], a["rw"], a["wg"], a["wu"], a["wd"],
                           top_k=2, capacity_factor=cf, token_mask=m,
                           group_size=n // ep, drop_free=drop_free)
        moe = jmoe.make_moe_a2a(mesh, top_k=2, capacity_factor=cf,
                                drop_free=drop_free)
        got = moe(a["x"], a["rw"], a["wg"], a["wu"], a["wd"], token_mask=m)
        out[name] = {"ref": (np.asarray(ref[0]), float(ref[1])),
                     "a2a": (np.asarray(got[0]), float(got[1]))}
    g = {k: jnp.asarray(v) for k, v in case["a2a_grad"].items()}
    moe = jmoe.make_moe_a2a(mesh, top_k=2, drop_free=True)

    def loss_ref(p):
        y, aux = jmoe.moe_ffn(g["x"], p["rw"], p["wg"], p["wu"], p["wd"],
                              top_k=2, group_size=n // ep, drop_free=True)
        return jnp.sum(y * y) + aux

    def loss_a2a(p):
        y, aux = moe(g["x"], p["rw"], p["wg"], p["wu"], p["wd"])
        return jnp.sum(y * y) + aux
    p = {k: g[k] for k in ("rw", "wg", "wu", "wd")}
    for name, fn in (("grad_ref", loss_ref), ("grad_a2a", loss_a2a)):
        loss, grads = jax.value_and_grad(fn)(p)
        out[name] = (float(loss), {k: np.asarray(v) for k, v in
                                   grads.items()})
    return out


def _jax_fsdp(params, toks):
    """JAX's test_moe_fsdp_expert_sharded_train_step for each config: the
    replicated step and the one over ``llama_fsdp_shardings`` on a dp 2 x
    ep 4 mesh (loss, params)."""
    tx = optax.adamw(1e-3)
    mesh = jcreate_mesh(dp_size=2, ep_size=4)
    p0 = jax.tree.map(jnp.asarray, params)
    out = {}
    for name, kw in FSDP_CASES.items():
        cfg = _moe_cfg(**kw)

        def step(p, s, batch, cfg=cfg):
            loss, grads = jax.value_and_grad(jl.llama_loss)(p, batch, cfg)
            upd, s = tx.update(grads, s, p)
            return optax.apply_updates(p, upd), s, loss
        ref_p, _, ref_loss = step(p0, tx.init(p0), jnp.asarray(toks))
        sh = jsh.llama_fsdp_shardings(mesh, p0)
        sp = jax.device_put(p0, sh)
        osh = jsh.opt_state_shardings(mesh, tx, p0, sh)
        st = jax.jit(tx.init, out_shardings=osh)(sp)
        stoks = jax.device_put(jnp.asarray(toks), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(DP_AXIS, None)))
        got_p, _, got_loss = jax.jit(step)(sp, st, stoks)
        out[name] = {"loss": float(got_loss), "params": _np(got_p),
                     "ref_loss": float(ref_loss), "ref_params": _np(ref_p)}
    return out


def _jax_spec(params, chunks, cfg):
    """prefill_slots, prefill_slots_continue and decode_block_spec_pooled
    over ``llama_param_shardings`` on a tp 2 mesh."""
    mesh = jcreate_mesh(dp_size=1, tp_size=2)
    sh = jax.device_put(params, jsh.llama_param_shardings(mesh, params))
    key = jax.random.PRNGKey(0)
    st = jl.init_llama_pool_state(cfg, batch=3)
    slots, act = jnp.asarray([0, 2], jnp.int32), jnp.ones((2,), bool)
    _, st = jl.prefill_slots(sh, jnp.asarray(chunks["t0"]),
                             jnp.asarray(chunks["v0"]), st, slots, act, key,
                             cfg)
    first, st = jl.prefill_slots_continue(
        sh, jnp.asarray(chunks["t1"]), jnp.asarray(chunks["v1"]), st, slots,
        act, jnp.asarray(chunks["v0"]), key, cfg, attn_len=32)
    toks, st, iters = jl.decode_block_spec_pooled(
        sh, st, jnp.asarray([True, False, True]), cfg, block=6, k_draft=3)
    return {"first": np.asarray(first), "toks": np.asarray(toks),
            "pos": np.asarray(st.pos), "tok": np.asarray(st.tok),
            "iters": np.asarray(iters)}


@pytest.fixture(scope="module")
def ep():
    moe_cfg = _moe_cfg()
    moe_params = _np(jl.init_llama_params(jax.random.PRNGKey(0), moe_cfg))
    spec_cfg = jl.LlamaConfig(vocab_size=128, n_layer=2, n_head=4,
                              n_kv_head=2, n_embd=32, intermediate_size=64,
                              max_seq_len=64, n_draft_heads=3)
    spec_params = _np(jl.init_llama_params(jax.random.PRNGKey(4), spec_cfg))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, 9))
    crng = np.random.default_rng(9)
    chunks = {"t0": crng.integers(0, 128, (2, 8)).astype(np.int32),
              "v0": np.asarray([8, 8], np.int32),
              "t1": crng.integers(0, 128, (2, 8)).astype(np.int32),
              "v1": np.asarray([6, 3], np.int32)}
    a2a = _a2a_setup()
    a2a["mask"] = np.random.default_rng(3).random(64) > 0.25
    pool_tokens, pool_valid = _pool_inputs([[5, 9, 13, 2, 7, 44, 3],
                                            [17, 1, 60, 23, 8]], 16)
    toks = np.random.default_rng(7).integers(0, 64, (8, 12))
    case = dict(
        moe_cfg=_port_cfg(moe_cfg), moe_params=moe_params, moe_ids=ids,
        b1_ids=np.random.default_rng(3).integers(0, 64, (1, 5)),
        pool_tokens=pool_tokens, pool_valid=pool_valid,
        a2a=a2a, a2a_cases=A2A_CASES, a2a_grad=_a2a_setup(seed=1),
        fsdp_params=moe_params, fsdp_tokens=toks,
        fsdp_cfgs={k: _port_cfg(_moe_cfg(**kw))
                   for k, kw in FSDP_CASES.items()},
        spec_cfg=_port_cfg(spec_cfg), spec_params=spec_params,
        chunks=chunks)
    res = {}
    thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.ep_checks, 8, case, threads=1, timeout_s=420)))
    thread.start()
    jax_out = {"logits": _jax_logits(moe_params, ids, moe_cfg),
               "a2a": _jax_a2a(case), "fsdp": _jax_fsdp(moe_params, toks),
               "spec": _jax_spec(spec_params, chunks, spec_cfg)}
    thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(ranks=res["r"], jax=jax_out, case=case)


# ---------------------------------------------------------------------------
# the ep axis and the all-to-all
# ---------------------------------------------------------------------------

def test_ranks_split_dp_ep_tp_with_tp_innermost(ep):
    """Rank r is tp index r % tp, ep index (r // tp) % ep and dp index
    r // (tp * ep) (JAX's create_mesh order); each holds E/ep experts and
    I/tp of their columns."""
    for r, out in enumerate(ep["ranks"]):
        for (e, t), res in out["logits"].items():
            assert res["layout"] == (8 // (e * t), e, t, r // (t * e),
                                     (r // t) % e, r % t)
            assert res["experts"] == (2, 4 // e, 32, 48 // t)
        assert out["fsdp"]["layout"] == (2, 4, r // 4, r % 4)


@pytest.mark.parametrize("group", ["ep", "world"])
def test_all_to_all_routes_are_bitwise_equal(ep, group):
    """On CPU tensors gloo carries ``all_to_all_single`` (the native
    route); the all-reduce route (gloo's on CUDA tensors) forced on the
    CPU gives the same bits; along dim 1 it exchanges the transposes."""
    for out in ep["ranks"]:
        c = out["a2a"]["collectives"][group]
        assert c["route"] == pmesh.NATIVE
        a, b = c[pmesh.NATIVE], c[pmesh.ALL_REDUCE]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(c["dim1"], a.T)


@pytest.mark.parametrize("group", ["ep", "world"])
def test_all_to_all_values_and_gradient(ep, group):
    """Rank i's block j is rank j's block i; the gradient of
    sum(all_to_all(x) * w) is the inverse exchange of w: block j of rank
    i's is rank j's w."""
    outs = ep["ranks"]
    for r, out in enumerate(outs):
        c = out["a2a"]["collectives"][group]
        n, i = c["n"], c["i"]
        members = [s for s, o in enumerate(outs) if group == "world"
                   or s // 4 == r // 4]
        assert len(members) == n and members[i] == r

        def x_of(rank):
            return (np.arange(n * 6, dtype=np.float32).reshape(n * 2, 3)
                    + 100.0 * rank)
        want = np.concatenate([x_of(m)[2 * i:2 * i + 2] for m in members])
        np.testing.assert_array_equal(c[pmesh.NATIVE], want)
        np.testing.assert_array_equal(
            c["grad"], np.concatenate([np.full((2, 3), m + 1.0)
                                       for m in members]))


# ---------------------------------------------------------------------------
# experts over ep on replicated tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_ep_logits_match_jax_sharded(ep, layout):
    """apply_llama with each rank's E/ep experts (and I/tp columns),
    summed over the groups, against JAX's apply_llama over
    llama_param_shardings on create_mesh(dp, ep, tp)."""
    for r in ep["ranks"]:
        np.testing.assert_allclose(r["logits"][layout]["logits"],
                                   ep["jax"]["logits"][layout], **MOE_TOL)


def test_ep_chains_equal_one_process(ep):
    """The B=1 greedy chain and the pooled chain (an inactive middle
    slot) at ep 2 equal the one process's, pos and tok too."""
    case = ep["case"]
    cfg, params = case["moe_cfg"], _torch_tree(case["moe_params"])
    with torch.no_grad():
        st = tl.init_llama_decode_state(cfg, batch=1)
        lg, st = tl.prefill(params, torch.from_numpy(case["b1_ids"]).long(),
                            st, cfg)
        first = torch.argmax(lg, dim=-1).to(torch.int32)
        toks, _ = tl.decode_block(params, first, st, cfg, block=6)
        pst = tl.init_llama_pool_state(cfg, batch=3)
        pf, pst = tl.prefill_slots(
            params, torch.from_numpy(case["pool_tokens"]).long(),
            torch.from_numpy(case["pool_valid"]), pst, torch.tensor([0, 2]),
            torch.ones(2, dtype=torch.bool), cfg)
        pt, pst = tl.decode_block_pooled(
            params, pst, torch.tensor([True, False, True]), cfg, block=6)
    for r in ep["ranks"]:
        got = r["chains"]
        np.testing.assert_array_equal(got["b1"][0], first.numpy())
        np.testing.assert_array_equal(got["b1"][1], toks.numpy())
        np.testing.assert_array_equal(got["pooled"][0], pf.numpy())
        np.testing.assert_array_equal(got["pooled"][1][[0, 2]],
                                      pt.numpy()[[0, 2]])
        np.testing.assert_array_equal(got["pooled"][2], pst.pos.numpy())
        np.testing.assert_array_equal(got["pooled"][3], pst.tok.numpy())


# ---------------------------------------------------------------------------
# the hand-written all-to-all MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(A2A_CASES))
def test_moe_a2a_matches_jax(ep, name):
    """Each rank's rows of y, and aux, against JAX's make_moe_a2a and
    moe_ffn(group_size=n/ep) (test_moe_a2a_matches_single_program's
    cases and bounds)."""
    j = ep["jax"]["a2a"][name]
    n = j["ref"][0].shape[0]
    for r in ep["ranks"]:
        i = r["a2a"]["rank_in_group"]
        rows = slice(i * n // 4, (i + 1) * n // 4)
        y, aux = r["a2a"]["fwd"][name]
        for want in (j["ref"], j["a2a"]):
            np.testing.assert_allclose(y, want[0][rows], **A2A_TOL)
            np.testing.assert_allclose(aux, want[1], rtol=AUX_RTOL)


@pytest.mark.parametrize("oracle", ["grad_ref", "grad_a2a"])
def test_moe_a2a_grads_match_jax(ep, oracle):
    """The gradients of every parameter, the router's included, of each
    rank's sum(y * y) + aux summed over the ep group (aux counted once:
    its statistics' all-reduce passes the gradient to each rank's own
    tokens), against jax.grad of the global loss."""
    loss, grads = ep["jax"]["a2a"][oracle]
    for r in ep["ranks"]:
        got = r["a2a"]["grad"]
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        for k, want in grads.items():
            np.testing.assert_allclose(got["grads"][k], want, **GRAD_TOL,
                                       err_msg=k)


def test_moe_a2a_refuses_rows_that_do_not_split():
    """JAX's ValueError on N % ep; at one rank the exchange is the
    identity and the result moe_ffn's."""
    a = {k: torch.from_numpy(v) for k, v in _a2a_setup(n=16).items()}
    y, aux = tmoe.make_moe_a2a(pmesh.LOCAL, top_k=2, drop_free=True)(
        a["x"], a["rw"], a["wg"], a["wu"], a["wd"])
    want = tmoe.moe_ffn(a["x"], a["rw"], a["wg"], a["wu"], a["wd"], 2,
                        drop_free=True)
    np.testing.assert_allclose(y.numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux), float(want[1]), rtol=1e-6)
    with pytest.raises(ValueError, match="local experts"):
        tmoe.moe_ffn_a2a(a["x"], a["rw"], a["wg"][:4], a["wu"][:4],
                         a["wd"][:4], 2, pmesh.LOCAL)


# ---------------------------------------------------------------------------
# the ep-aware FSDP step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_step_matches_jax(ep, name):
    """One AdamW step of llama_loss at dp 2 x ep 4 under
    LLAMA_FSDP_SPECS (the batch's rows split over dp, one routing group
    over the whole batch) against JAX's jitted step over
    llama_fsdp_shardings and its replicated twin: the loss and every
    parameter after the step, at capacities that drop tokens too."""
    j = ep["jax"]["fsdp"][name]
    assert abs(j["loss"] - j["ref_loss"]) <= LOSS_RTOL * abs(j["ref_loss"])
    for r in ep["ranks"]:
        got = r["fsdp"][name]
        np.testing.assert_allclose(got["loss"], j["loss"], rtol=LOSS_RTOL)
        want = _flat(j["params"])
        assert got["params"].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, **PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["cf 1", "cf 0.5, groups of 22"])
def test_fsdp_capacities_drop_across_the_shards(ep, monkeypatch, name):
    """At the capped configs the one process's routing (the step's
    oracle) drops routes of the second dp shard's tokens; in one routing
    group over the batch (cf 1) some of them only because the first
    shard's routes took the slots: routing each shard's 44 tokens alone
    keeps a different set."""
    case = ep["case"]
    params = _torch_tree(case["fsdp_params"])
    toks = torch.from_numpy(case["fsdp_tokens"]).long()
    keeps = []
    slots = tmoe._slots

    def spy(topi, w, slot, keep, *a):
        keeps.append(keep.clone())
        return slots(topi, w, slot, keep, *a)
    monkeypatch.setattr(tmoe, "_slots", spy)
    cfg = case["fsdp_cfgs"][name]
    with torch.no_grad():
        tl.llama_loss(params, toks, cfg)
        whole = keeps[:]
        del keeps[:]
        tl.llama_loss(params, toks, dataclasses.replace(
            cfg, moe_group_size=44))
    n = toks.shape[0] * (toks.shape[1] - 1)
    assert all(k.shape == (n, 2) for k in whole)
    assert any(not bool(k[n // 2:].all()) for k in whole)
    if name == "cf 1":
        assert any(not torch.equal(a[n // 2:], b[n // 2:])
                   for a, b in zip(whole, keeps))


def test_fsdp_shards_and_moments(ep):
    """Each rank holds E/ep experts, half of their C (or I for wdown) and
    of every dense matrix's dp dimension; the AdamW moments take their
    parameter's shard and spec (opt_state_specs)."""
    for r in ep["ranks"]:
        first = r["fsdp"]["cf 8"]
        s = first["shapes"]
        assert s["h/moe_wgate"] == (2, 1, 16, 48)
        assert s["h/moe_wdown"] == (2, 1, 48, 16)
        assert s["h/wq"] == (2, 16, 32)
        assert s["h/wo"] == (2, 32, 16)
        assert s["tok_emb"] == (32, 32) and s["head"] == (16, 64)
        assert s["h/router"] == (2, 32, 4) and s["lnf_s"] == (32,)
        assert first["mu_shapes"] == s
        assert first["mu_specs"] == first["specs"]
    names = set(ep["ranks"][0]["fsdp"]["cf 8"]["shapes"])
    table = psh.LLAMA_FSDP_SPECS
    mesh = jcreate_mesh(dp_size=2, ep_size=4)
    jtree = jl.init_llama_params(jax.random.PRNGKey(0), _moe_cfg())
    for path, sh in jax.tree_util.tree_leaves_with_path(
            jsh.llama_fsdp_shardings(mesh, jtree)):
        node = table
        for p in path:
            node = node[p.key]
        assert tuple(sh.spec) == node, path
        assert "/".join(p.key for p in path) in names


def test_shard_llama_checks_ep_and_dp():
    cfg = _port_cfg(_moe_cfg())
    params = _torch_tree(_np(jl.init_llama_params(jax.random.PRNGKey(0),
                                                  _moe_cfg())))
    with pytest.raises(ValueError, match="n_experts=4"):
        psh.shard_llama(params, cfg, 1, 0, ep=3)
    with pytest.raises(ValueError, match="dp=3"):
        psh.shard_llama(params, cfg, 1, 0, dp=3)
    shard = psh.shard_llama(params, cfg, 1, 0, ep=2, ep_rank=1)
    np.testing.assert_array_equal(shard["h"]["moe_wup"].numpy(),
                                  params["h"]["moe_wup"][:, 2:].numpy())


# ---------------------------------------------------------------------------
# tp in the continuation and the speculative block
# ---------------------------------------------------------------------------

def test_tp_continue_and_spec_match_jax_and_one_process(ep):
    """A first chunk, its continuation (prefill_slots_continue) and a
    greedy speculative block on the draft heads at tp 2 (each rank's KV
    heads; the heads whole, reading the all-reduced hidden state): the
    first tokens, tokens, pos, tok and iterations of JAX's GSPMD run and
    of the one process."""
    case = ep["case"]
    cfg, params = case["spec_cfg"], _torch_tree(case["spec_params"])
    c = case["chunks"]
    with torch.no_grad():
        st = tl.init_llama_pool_state(cfg, batch=3)
        _, st = tl.prefill_slots(params, torch.from_numpy(c["t0"]).long(),
                                 torch.from_numpy(c["v0"]), st,
                                 torch.tensor([0, 2]),
                                 torch.ones(2, dtype=torch.bool), cfg)
        first, st = tl.prefill_slots_continue(
            params, torch.from_numpy(c["t1"]).long(),
            torch.from_numpy(c["v1"]), st, torch.tensor([0, 2]),
            torch.ones(2, dtype=torch.bool), torch.from_numpy(c["v0"]), cfg,
            attn_len=32)
        toks, st, iters = tl.decode_block_spec_pooled(
            params, st, torch.tensor([True, False, True]), cfg, block=6,
            k_draft=3)
    one = {"first": first.numpy(), "toks": toks.numpy(),
           "pos": st.pos.numpy(), "tok": st.tok.numpy(),
           "iters": iters.numpy()}
    j = ep["jax"]["spec"]
    for r in ep["ranks"]:
        got = r["spec"]
        assert got["kv_heads"] == 1
        for want in (j, one):
            np.testing.assert_array_equal(got["first"], want["first"])
            np.testing.assert_array_equal(got["toks"][[0, 2]],
                                          want["toks"][[0, 2]])
            for k in ("pos", "tok", "iters"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
