"""The port's mixture-of-experts FFN (``llmvox_tpu_torch/ops/moe.py``) and
MoE Llama against the JAX package's (``llmvox_tpu/ops/moe.py``,
``llmvox_tpu/models/llama.py``), on the CPU in f32 from the same numpy
parameters: ``moe_ffn`` drop-free, capped, masked and grouped,
``moe_capacity``, the top-k tie rule, ``expert_matmul`` for every
container (the w4 experts through K4's function beside JAX's group
einsum, whose gap is recorded), the MoE Llama's logits, B=1 and pooled
chains, its loss and gradients, ``quantize_llama_params`` on the stacked
experts, a tiny ``MixtralForCausalLM`` converted by JAX's converter
against HF's logits and greedy generation, and a w4 MoE served through
the factory.  Every non-mesh test of JAX's ``tests/test_moe.py`` has its
counterpart here (the expert-parallel ones wait for the port's mesh)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.ops import moe as jmoe
from llmvox_tpu.ops import quant as jq
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.ops import cuda_int4_mm
from llmvox_tpu_torch.ops import moe as tmoe
from llmvox_tpu_torch.ops import quant as tq
from llmvox_tpu_torch.utils.params import to_torch

TOL = dict(atol=1e-5, rtol=1e-5)
# the w4 experts through K4's function against JAX's group einsum (f32):
# K4 rounds x and each dequantized weight to bf16, JAX's einsum does
# neither (ROADMAP §3); measured 2.3e-3 of the output's norm here
W4_EINSUM_GAP = 1e-2

CFG = jl.LlamaConfig(vocab_size=384, n_layer=2, n_head=4, n_kv_head=2,
                     n_embd=64, intermediate_size=128, max_seq_len=96,
                     n_experts=4, moe_top_k=2, moe_capacity_factor=8.0)


def _tc(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _np(jcfg, seed=0):
    return jax.device_get(jl.init_llama_params(jax.random.PRNGKey(seed),
                                               jcfg))


def _weights(seed=0, c=16, i=24, e=4):
    rng = np.random.default_rng(seed)
    rw = rng.standard_normal((c, e)).astype(np.float32) * 0.5
    wg = rng.standard_normal((e, c, i)).astype(np.float32) * 0.2
    wu = rng.standard_normal((e, c, i)).astype(np.float32) * 0.2
    wd = rng.standard_normal((e, i, c)).astype(np.float32) * 0.2
    return rw, wg, wu, wd


def _both_moe(x, ws, top_k, dtype=torch.float32, **kw):
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    mask = kw.pop("token_mask", None)
    jy, jaux = jmoe.moe_ffn(
        jnp.asarray(x, jdt), *(jnp.asarray(w, jdt) for w in ws), top_k,
        token_mask=None if mask is None else jnp.asarray(mask), **kw)
    ty, taux = tmoe.moe_ffn(
        torch.from_numpy(x).to(dtype),
        *(torch.from_numpy(w).to(dtype) for w in ws), top_k,
        token_mask=None if mask is None else torch.from_numpy(mask), **kw)
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            ty.float().numpy(), float(taux))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

MOE_CASES = {
    "drop-free": dict(drop_free=True),
    "capped, no drops": dict(capacity_factor=8.0),
    "capped, drops": dict(capacity_factor=0.5),
    "masked": dict(capacity_factor=0.75, masked=True),
    "group 3": dict(group_size=3, drop_free=True),
    "group 7 capped": dict(group_size=7, capacity_factor=1.0),
    "group 5 masked": dict(group_size=5, capacity_factor=1.0, masked=True),
}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case, top_k):
    """Outputs to 1e-5 and the load-balancing statistic to 1e-6, in every
    routing form: drop-free, capped with and without drops (the same
    tokens drop, earlier tokens winning), padding masked out of routing,
    groups (with a ragged last group)."""
    kw = dict(MOE_CASES[case])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    if kw.pop("masked", False):
        kw["token_mask"] = rng.random((3, 7)) > 0.3
    jy, jaux, ty, taux = _both_moe(x, _weights(), top_k, **kw)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(taux, jaux, atol=1e-6, rtol=1e-6)
    if "token_mask" in kw:
        assert not ty[~kw["token_mask"]].any()


def test_moe_ffn_bf16_rounds_combine_weights_as_jax():
    """bf16 activations: the one-hots and the combine weights are bf16
    (the weights rounded before the product, as JAX rounds them), so the
    outputs agree to a bf16 ulp."""
    x = np.random.default_rng(2).standard_normal((2, 9, 16)).astype(
        np.float32)
    jy, jaux, ty, taux = _both_moe(x, _weights(3), 2, dtype=torch.bfloat16,
                                   drop_free=True)
    np.testing.assert_allclose(ty, jy, atol=2e-2, rtol=2 ** -7)
    np.testing.assert_allclose(taux, jaux, rtol=1e-2)


def test_moe_grouped_drop_free_is_group_size_invariant():
    """Drop-free outputs do not depend on the group size (both sides)."""
    x = np.random.default_rng(4).standard_normal((21, 16)).astype(
        np.float32)
    ws = _weights(5)
    ref = tmoe.moe_ffn(torch.from_numpy(x),
                       *(torch.from_numpy(w) for w in ws), 2,
                       drop_free=True)[0]
    for g in (3, 7, 0):
        y = tmoe.moe_ffn(torch.from_numpy(x),
                         *(torch.from_numpy(w) for w in ws), 2,
                         group_size=g, drop_free=True)[0]
        np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("n, e, k, cf", [(1, 8, 2, 2.0), (16, 8, 2, 2.0),
                                         (640, 8, 2, 4.0), (7, 4, 1, 0.5),
                                         (33, 4, 2, 1.25)])
def test_moe_capacity_equals_jax(n, e, k, cf):
    assert tmoe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(n, e, k, cf)


def test_top_k_ties_go_to_the_lower_index():
    """``jax.lax.top_k`` breaks ties to the lower index; the port's
    stable selection does too, and a router with two identical columns
    routes as JAX's."""
    vals = np.random.default_rng(6).integers(0, 3, (50, 8)).astype(
        np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(vals), 3)
    tv, ti = tmoe.top_k_lower_index(torch.from_numpy(vals), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rw, wg, wu, wd = _weights(7)
    rw[:, 2] = rw[:, 1]                       # experts 1 and 2 always tie
    x = np.random.default_rng(8).standard_normal((12, 16)).astype(
        np.float32)
    jy, _, ty, _ = _both_moe(x, (rw, wg, wu, wd), 1, drop_free=True)
    np.testing.assert_allclose(ty, jy, **TOL)


# ---------------------------------------------------------------------------
# expert_matmul per container
# ---------------------------------------------------------------------------

def _expert_inputs(seed=9, e=3, r=5, cin=64, cout=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, r, cin)).astype(np.float32)
    w = (0.05 * rng.standard_normal((e, cin, cout))).astype(np.float32)
    return x, w


def _tq_of(jw):
    """A JAX container as the port's (``to_torch`` on the tree)."""
    return to_torch({"w": jax.device_get(jw)}, "cpu")["w"]


@pytest.mark.parametrize("mode", ["dense", "w8", "w8a8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_matches_jax(mode, dtype):
    """Dense, w8 (per-(expert, channel) scales out of the f32 product)
    and w8a8 (per-(expert, row) activation scales, exact int32 sums):
    the port's expert_matmul equals JAX's (f32 to 1e-5, bf16 to an
    ulp)."""
    x, w = _expert_inputs()
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    if mode == "dense":
        jw, tw = jnp.asarray(w, jdt), torch.from_numpy(w).to(dtype)
    else:
        cls = jq.QuantizedTensor if mode == "w8" else jq.Int8Linear
        jw = jq.quantize_weight(jnp.asarray(w), cls=cls)
        tw = _tq_of(jw)
        tw = type(tw)(q=tw.q, s=tw.s.to(dtype))
        jw = type(jw)(jw.q, jw.s.astype(jdt))
        assert type(tw).__name__ == cls.__name__
    want = np.asarray(jmoe.expert_matmul(
        jnp.asarray(x, jdt), jw, jax.lax.Precision.HIGHEST).astype(
            jnp.float32))
    got = tmoe.expert_matmul(torch.from_numpy(x).to(dtype), tw)
    assert got.dtype == dtype
    tol = TOL if dtype is torch.float32 else dict(atol=4e-3, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("group", [16, 64])
def test_expert_matmul_w4_is_k4_per_expert_beside_jax_einsum(group):
    """w4 experts: the port runs each expert through K4's function
    (``int4_matmul``, here its plain version); JAX's group-batched
    einsum, which the port keeps as ``expert_matmul_einsum``, equals
    JAX's to 1e-5; the K4 route parts from it by the bf16 rounding of x
    and the weights (under ``W4_EINSUM_GAP`` of the output's norm)."""
    x, w = _expert_inputs()
    jw = jq.quantize_weight4(jnp.asarray(w), group)
    tw = _tq_of(jw)
    assert type(tw) is tq.Int4Tensor and tw.s.shape == (3, 64 // group, 1,
                                                        48)
    want = np.asarray(jmoe.expert_matmul(jnp.asarray(x), jw, None))
    einsum = tmoe.expert_matmul_einsum(torch.from_numpy(x), tw)
    np.testing.assert_allclose(einsum.numpy(), want, **TOL)
    got = tmoe.expert_matmul(torch.from_numpy(x), tw)
    for e in range(3):
        assert torch.equal(got[e], cuda_int4_mm.plain_int4_matmul(
            torch.from_numpy(x[e]), tw.q[e], tw.s[e]))
    gap = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert 0 < gap < W4_EINSUM_GAP, gap


def test_w4_experts_launch_k4_once_per_expert_and_matrix(monkeypatch):
    """Each w4 expert matmul is one K4 call per expert at M = the expert's
    rows: a drop-free MoE FFN over N tokens makes 3 * E calls at M = N."""
    calls = []
    real = cuda_int4_mm.int4_matmul

    def counted(x, q, s):
        calls.append(tuple(x.shape))
        return real(x, q, s)
    monkeypatch.setattr(cuda_int4_mm, "int4_matmul", counted)
    rw, wg, wu, wd = _weights(10, c=32, i=48)
    q = {k: tq.quantize_weight4(torch.from_numpy(w), 16)
         for k, w in (("g", wg), ("u", wu), ("d", wd))}
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    tmoe.moe_ffn(x, torch.from_numpy(rw), q["g"], q["u"], q["d"], 2,
                 drop_free=True)
    assert calls == [(6, 32)] * 8 + [(6, 48)] * 4


# ---------------------------------------------------------------------------
# the MoE Llama
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return _np(CFG)


def test_moe_llama_forward_matches_jax(params):
    """``apply_llama`` with experts (the training routing, capped at the
    config's factor, here with drops at 0.5) equals JAX's logits, and its
    load-balancing statistic."""
    ids = np.random.default_rng(2).integers(0, 384, (2, 9))
    for cf in (8.0, 0.5):
        jcfg = dataclasses.replace(CFG, moe_capacity_factor=cf)
        jlog, jaux = jl.apply_llama(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(ids, jnp.int32), jcfg,
                                    return_moe_aux=True)
        tlog, taux = tl.apply_llama(to_torch(params, "cpu"),
                                    torch.from_numpy(ids), _tc(jcfg),
                                    return_moe_aux=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _jb1(params, prompt, n, jcfg=CFG):
    st = jl.init_llama_decode_state(jcfg, batch=1)
    lg, st = jl.prefill(jax.tree.map(jnp.asarray, params),
                        jnp.asarray([prompt], jnp.int32), st, jcfg)
    first = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    toks, _ = jl.decode_block(jax.tree.map(jnp.asarray, params), first, st,
                              jax.random.PRNGKey(0), jcfg, block=n - 1)
    return [int(first[0])] + np.asarray(toks)[0].tolist()


def _tb1(tp, prompt, n, tcfg):
    st = tl.init_llama_decode_state(tcfg)
    lg, st = tl.prefill(tp, torch.tensor([prompt]), st, tcfg)
    first = torch.argmax(lg, dim=-1).to(torch.int32)
    toks, _ = tl.decode_block(tp, first, st, tcfg, block=n - 1)
    return [int(first[0])] + toks[0].tolist()


def test_moe_greedy_decode_matches_jax_and_full_context(params):
    """B=1 prefill + decode block (drop-free, each token routed alone)
    equals JAX's chain and the teacher-forced argmax chain."""
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 384, 5)]
    tp = to_torch(params, "cpu")
    got = _tb1(tp, prompt, 7, _tc(CFG))
    assert got == _jb1(params, prompt, 7)
    seq = list(prompt)
    for t in got:
        lg = tl.apply_llama(tp, torch.tensor([seq]), _tc(CFG))
        assert int(lg[0, -1].argmax()) == t
        seq.append(t)


def test_moe_padded_prefill_masks_the_padding(params):
    """``prefill_padded`` routes only the valid positions: its logits
    equal the exact-length prefill's, at a capacity where padding would
    otherwise change routing (JAX's, too)."""
    jcfg = dataclasses.replace(CFG, moe_capacity_factor=0.5)
    tcfg = _tc(jcfg)
    tp = to_torch(params, "cpu")
    prompt = [5, 9, 2, 17, 3]
    exact, _ = tl.prefill(tp, torch.tensor([prompt]),
                          tl.init_llama_decode_state(tcfg), tcfg)
    padded, st = tl.prefill_padded(tp, torch.tensor([prompt + [0] * 11]), 5,
                                   tl.init_llama_decode_state(tcfg), tcfg)
    jlog, _ = jl.prefill_padded(
        jax.tree.map(jnp.asarray, params),
        jnp.asarray([prompt + [0] * 11], jnp.int32), jnp.asarray(5),
        jl.init_llama_decode_state(jcfg), jcfg)
    np.testing.assert_allclose(padded.numpy(), exact.numpy(), **TOL)
    np.testing.assert_allclose(padded.numpy(), np.asarray(jlog), **TOL)
    assert int(st.pos) == 5


def test_moe_pooled_decode_matches_b1(params):
    """One active MoE row of a pool equals its B=1 chain."""
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, 384, 5)]
    tcfg = _tc(CFG)
    tp = to_torch(params, "cpu")
    ref = _tb1(tp, prompt, 7, tcfg)
    st = tl.init_llama_pool_state(tcfg, 3)
    first, st = tl.prefill_slots(
        tp, torch.tensor([prompt], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32), st,
        torch.tensor([1], dtype=torch.int32), torch.tensor([True]), tcfg)
    toks, _ = tl.decode_block_pooled(tp, st, torch.tensor([False, True,
                                                           False]),
                                     tcfg, block=6)
    assert [int(first[0])] + toks[1].tolist() == ref


def test_moe_pooled_decode_matches_b1_at_drop_prone_capacity():
    """E = 8, top-2 at capacity factor 2: co-scheduled rows (a mixed-length
    prefill, one pooled block) each equal their B=1 chains and JAX's
    pooled tokens: inference routes drop-free, padding masked out."""
    jcfg = dataclasses.replace(CFG, n_experts=8, moe_capacity_factor=2.0)
    tcfg = _tc(jcfg)
    params = _np(jcfg, seed=3)
    tp = to_torch(params, "cpu")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 384, n)] for n in (5, 3, 7)]
    refs = [_tb1(tp, p, 7, tcfg) for p in prompts]
    tokens = np.zeros((3, 8), np.int32)
    for j, p in enumerate(prompts):
        tokens[j, :len(p)] = p
    valid = np.asarray([5, 3, 7], np.int32)
    st = tl.init_llama_pool_state(tcfg, 4)
    first, st = tl.prefill_slots(
        tp, torch.from_numpy(tokens), torch.from_numpy(valid), st,
        torch.arange(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool),
        tcfg)
    toks, _ = tl.decode_block_pooled(
        tp, st, torch.tensor([True, True, True, False]), tcfg, block=6)
    jst = jl.init_llama_pool_state(jcfg, batch=4)
    jp = jax.tree.map(jnp.asarray, params)
    jfirst, jst = jl.prefill_slots(
        jp, jnp.asarray(tokens), jnp.asarray(valid), jst,
        jnp.arange(3, dtype=jnp.int32), jnp.ones((3,), bool),
        jax.random.PRNGKey(0), jcfg)
    jtoks, _ = jl.decode_block_pooled(
        jp, jst, jnp.asarray([True, True, True, False]),
        jax.random.PRNGKey(0), jcfg, block=6)
    for j in range(3):
        got = [int(first[j])] + toks[j].tolist()
        assert got == refs[j], j
        assert got == [int(jfirst[j])] + np.asarray(jtoks)[j].tolist()


def test_moe_loss_grads_reach_router(params):
    """``llama_loss`` with experts (the aux term weighted) equals JAX's;
    its autograd gradients equal ``jax.grad``'s, the router's among them
    (not zero); the aux weight is live."""
    jcfg = dataclasses.replace(CFG, moe_aux_weight=0.05,
                               moe_capacity_factor=2.0)
    toks = np.random.default_rng(6).integers(0, 384, (2, 10))
    jloss, jgrads = jax.value_and_grad(jl.llama_loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks), jcfg)
    tp = to_torch(params, "cpu")
    names = ("router", "moe_wgate", "moe_wdown", "wq")
    for k in names:
        tp["h"][k].requires_grad_(True)
    loss = tl.llama_loss(tp, torch.from_numpy(toks), _tc(jcfg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in names:
        np.testing.assert_allclose(tp["h"][k].grad.numpy(),
                                   np.asarray(jgrads["h"][k]), atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    assert float(tp["h"]["router"].grad.abs().max()) > 0
    loss0 = tl.llama_loss(to_torch(params, "cpu"), torch.from_numpy(toks),
                          dataclasses.replace(_tc(jcfg), moe_aux_weight=0.0))
    assert abs(loss.item() - loss0.item()) > 1e-9


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantize_llama_params_quantizes_the_experts_as_jax(params, mode):
    """The stacked (L, E, Cin, Cout) experts quantize key for key as JAX's:
    per-(expert, channel) w8 scales, (L, E, G, 1, C) w4 scales; the
    router stays dense."""
    want = jax.device_get(jq.quantize_llama_params(
        jax.tree.map(jnp.asarray, params), mode))
    got = tq.quantize_llama_params(to_torch(params, "cpu"), mode)
    assert isinstance(got["h"]["router"], torch.Tensor)
    for k in ("moe_wgate", "moe_wup", "moe_wdown"):
        jw, tw = want["h"][k], got["h"][k]
        assert type(tw).__name__ == type(jw).__name__, k
        assert tuple(tw.q.shape) == jw.q.shape
        assert tuple(tw.s.shape) == jw.s.shape
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_allclose(tw.s.numpy(), np.asarray(jw.s),
                                   rtol=1e-6)


def test_w4_moe_pooled_equals_b1_on_k4s_route(params):
    """A w4 MoE tree (experts and linears through K4's function, head
    int8): the pooled row equals its B=1 chain."""
    qp = tq.quantize_llama_params(to_torch(params, "cpu"), "w4")
    assert type(qp["h"]["moe_wup"]) is tq.Int4Tensor
    tcfg = _tc(CFG)
    prompt = [3, 1, 4, 1, 5, 9]
    ref = _tb1(qp, prompt, 7, tcfg)
    st = tl.init_llama_pool_state(tcfg, 2)
    first, st = tl.prefill_slots(
        qp, torch.tensor([prompt + [0] * 2], dtype=torch.int32),
        torch.tensor([6], dtype=torch.int32), st,
        torch.tensor([0], dtype=torch.int32), torch.tensor([True]), tcfg)
    toks, _ = tl.decode_block_pooled(qp, st, torch.tensor([True, False]),
                                     tcfg, block=6)
    assert [int(first[0])] + toks[0].tolist() == ref


# ---------------------------------------------------------------------------
# a Mixtral checkpoint through JAX's converter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral_pair():
    """A tiny random HF ``MixtralForCausalLM`` (built here from a config,
    nothing downloaded) and its params from JAX's converter."""
    from transformers import MixtralConfig, MixtralForCausalLM

    from llmvox_tpu.tools.convert import convert_llama_state_dict
    jcfg = dataclasses.replace(CFG, n_experts=8, moe_capacity_factor=4.0)
    hf = MixtralForCausalLM(MixtralConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.n_embd,
        intermediate_size=jcfg.intermediate_size,
        num_hidden_layers=jcfg.n_layer, num_attention_heads=jcfg.n_head,
        num_key_value_heads=jcfg.n_kv_head, num_local_experts=8,
        num_experts_per_tok=2, max_position_embeddings=jcfg.max_seq_len,
        rms_norm_eps=jcfg.rms_eps, rope_theta=jcfg.rope_theta,
        sliding_window=None, tie_word_embeddings=False,
        attn_implementation="eager"))
    torch.manual_seed(0)
    hf.eval()
    params = convert_llama_state_dict(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()},
        jcfg.n_layer)
    return hf, params, jcfg


def test_mixtral_full_pass_matches_hf(mixtral_pair):
    """The converted Mixtral's logits equal HF's (HF softmaxes every
    expert and renormalizes the top 2; the port softmaxes the top-2
    logits: the same weights) and JAX's."""
    hf, params, jcfg = mixtral_pair
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 11))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = tl.apply_llama(to_torch(params, "cpu"), torch.from_numpy(ids),
                             _tc(jcfg)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-3)
    jgot = np.asarray(jl.apply_llama(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(ids, jnp.int32), jcfg))
    np.testing.assert_allclose(got, jgot, atol=2e-5, rtol=2e-5)


def test_mixtral_greedy_decode_matches_hf_generate(mixtral_pair):
    hf, params, jcfg = mixtral_pair
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 6))
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompt), max_new_tokens=8,
                          do_sample=False).numpy()[0, 6:]
    got = _tb1(to_torch(params, "cpu"), prompt[0].tolist(), 8, _tc(jcfg))
    assert got == ref.tolist()


def test_convert_ckpt_mixtral_serves_through_the_factory(mixtral_pair,
                                                         tmp_path):
    """JAX's ``convert_ckpt llama`` on a Mixtral HF dir writes an npz whose
    meta names the experts; the port's factory serves it (B=1 and pooled,
    and pooled under w4 with the experts through K4's function), the B=1
    text equal to JAX's stream's."""
    from llmvox_tpu.streams.jax_llm import build_jax_stream
    from llmvox_tpu.tools import convert_ckpt
    from llmvox_tpu.utils.config import ServeConfig as JServeConfig
    from llmvox_tpu_torch.streams import llm as tllm
    from llmvox_tpu_torch.utils.config import ServeConfig

    hf, _, jcfg = mixtral_pair
    src, dst = tmp_path / "hf", tmp_path / "mixtral.npz"
    hf.save_pretrained(str(src))
    convert_ckpt.main(["llama", str(src), str(dst)])
    opts = dict(llm_backend="jax", llm_jax_params=str(dst),
                llm_checkpoint="byte", llm_block=4, llm_temperature=0.0,
                llm_max_tokens=10, compute_dtype="float32")
    req = {"system": "sys", "prompt": "hello"}
    port = tllm.build_llama_stream(
        dataclasses.replace(ServeConfig(), **opts), device="cpu")
    assert port.cfg.n_experts == 8 and port.cfg.moe_top_k == 2
    want = "".join(build_jax_stream(
        dataclasses.replace(JServeConfig(), **opts)).predict(req))
    assert "".join(port.predict(req)) == want and want
    import asyncio
    for q in ("", "w4"):
        pooled = tllm.build_llama_stream(dataclasses.replace(
            ServeConfig(), **opts, llm_pool_capacity=2, quantize=q,
            llm_prefill_buckets=(32, 64)), device="cpu")

        async def go(m=pooled):
            out = [d async for d in m.predict(req)]
            m.pool.stop()
            return "".join(out)
        text = asyncio.run(go())
        if not q:
            assert text == want
        assert text


def test_init_llama_params_draws_experts_and_heads_in_jax_layout():
    """``init_llama_params`` with experts and draft heads: JAX's keys and
    shapes (the router dense (C, E), the experts stacked (L, E, ...), the
    heads (n, C, V)), N(0, 0.02) draws; a dense tree's tensors are the
    same with heads added, an MoE tree's attention the dense tree's; the
    experts of layer i are the same whichever layers are drawn, and a
    tree drawn without its experts keeps the rest."""
    from llmvox_tpu_torch.utils import params as tparams
    jcfg = dataclasses.replace(CFG, n_draft_heads=2)
    want = _np(jcfg)
    got = tparams.init_llama_params(0, _tc(jcfg))
    assert got.keys() == want.keys() and got["h"].keys() == want["h"].keys()
    for k in ("tok_emb", "head", "draft_heads", "lnf_s"):
        assert tuple(got[k].shape) == want[k].shape, k
    for k, v in want["h"].items():
        assert tuple(got["h"][k].shape) == v.shape, k
    assert abs(float(got["h"]["moe_wup"].std()) - 0.02) < 1e-3
    dense = dataclasses.replace(_tc(jcfg), n_experts=0, n_draft_heads=0)
    d0 = tparams.init_llama_params(0, dense)
    d2 = tparams.init_llama_params(
        0, dataclasses.replace(dense, n_draft_heads=2))
    for k in ("tok_emb", "head"):
        assert torch.equal(d0[k], d2[k])
    for k in ("wq", "wdown"):
        assert torch.equal(d0["h"][k], d2["h"][k])
    assert torch.equal(d0["h"]["wo"], got["h"]["wo"])
    one = tparams.draw_llama_experts(1, _tc(jcfg), [1])
    assert torch.equal(one["moe_wgate"][0], got["h"]["moe_wgate"][1])
    none = tparams.init_llama_params(0, _tc(jcfg), experts=False)
    assert "router" not in none["h"]
    assert torch.equal(none["h"]["wq"], got["h"]["wq"])
