"""The port's Llama (``llmvox_tpu_torch/models/llama.py``) against the JAX
package's (``llmvox_tpu/models/llama.py``) and a local HF
``LlamaForCausalLM``, on tiny configs in f32 on the CPU, from the same
numpy parameters (JAX's ``init_llama_params``): the teacher-forced
logits, the prefill and the greedy decode chains at several attention
buckets, sampling, rope at long positions, quantization and the
configurations that are not ported."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import llama as jl
from llmvox_tpu.ops import quant as jq
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.ops import quant as tq
from llmvox_tpu_torch.utils import params as tparams
from llmvox_tpu_torch.utils.params import to_torch

from tests.test_torch_quant import jax_route

TINY = jl.LlamaConfig(vocab_size=384, n_layer=2, n_head=4, n_kv_head=2,
                      n_embd=64, intermediate_size=128, max_seq_len=256)
CONFIGS = {
    "gqa": TINY,
    "mha": dataclasses.replace(TINY, n_kv_head=4),
    "llama3 rope": dataclasses.replace(
        TINY, rope_theta=500000.0, rope_scaling_factor=8.0,
        rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_original_max_position=64),
}


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    return jax.device_get(jl.init_llama_params(jax.random.PRNGKey(seed),
                                               jcfg))


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]
    params = _params(jcfg)
    return jcfg, params, to_torch(params, "cpu")


def _hf(jcfg, params):
    """A local HF LlamaForCausalLM holding ``params`` (eager attention)."""
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM
    rope_scaling = None
    if jcfg.rope_scaling_factor:
        rope_scaling = {
            "rope_type": "llama3", "factor": jcfg.rope_scaling_factor,
            "low_freq_factor": jcfg.rope_low_freq_factor,
            "high_freq_factor": jcfg.rope_high_freq_factor,
            "original_max_position_embeddings":
                jcfg.rope_original_max_position}
    hf = LlamaForCausalLM(HFConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.n_embd,
        intermediate_size=jcfg.intermediate_size,
        num_hidden_layers=jcfg.n_layer, num_attention_heads=jcfg.n_head,
        num_key_value_heads=jcfg.n_kv_head,
        max_position_embeddings=jcfg.max_seq_len, rms_norm_eps=jcfg.rms_eps,
        rope_theta=jcfg.rope_theta, rope_scaling=rope_scaling,
        tie_word_embeddings=False, attn_implementation="eager")).eval()
    h = params["h"]
    sd = {"model.embed_tokens.weight": params["tok_emb"],
          "model.norm.weight": params["lnf_s"],
          "lm_head.weight": params["head"].T}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "wgate": "mlp.gate_proj", "wup": "mlp.up_proj",
             "wdown": "mlp.down_proj"}
    for i in range(jcfg.n_layer):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = h["ln1_s"][i]
        sd[p + "post_attention_layernorm.weight"] = h["ln2_s"][i]
        for k, name in names.items():
            sd[p + name + ".weight"] = h[k][i].T
    hf.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                       strict=False)
    return hf


def test_apply_llama_matches_jax_and_hf(model):
    jcfg, params, tp = model
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    got = tl.apply_llama(tp, torch.from_numpy(ids), _tcfg(jcfg)).numpy()
    want = np.asarray(jl.apply_llama(params, jnp.asarray(ids, jnp.int32),
                                     jcfg))
    with torch.no_grad():
        hf = _hf(jcfg, params)(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, hf, atol=2e-5)


# the stream's rule: the smallest ladder rung holding pos + block, so with
# S=256 (rungs 128, 256) and blocks of 60 after an 11-token prompt the
# second block crosses the edge at 128; the third attends the whole cache
BLOCKS = [(60, 128), (60, 256), (60, None)]


def test_prefill_and_decode_blocks_match_jax(model):
    jcfg, params, tp = model
    tcfg = _tcfg(jcfg)
    rng = np.random.default_rng(1)
    n, bucket = 11, 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = rng.integers(1, jcfg.vocab_size, n)
    js = jl.init_llama_decode_state(jcfg)
    jlog, js = jl.prefill_padded(params, jnp.asarray(padded), jnp.int32(n),
                                 js, jcfg, attn_len=bucket)
    ts = tl.init_llama_decode_state(tcfg)
    tlog, ts = tl.prefill_padded(tp, torch.from_numpy(padded), n, ts, tcfg,
                                 attn_len=bucket)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    assert int(ts.pos) == int(js.pos) == n
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)
    tt = torch.argmax(tlog, -1).to(torch.int32)
    assert int(tt[0]) == int(jt[0])
    key = jax.random.PRNGKey(0)
    for block, attn_len in BLOCKS:
        jtoks, js = jl.decode_block(params, jt, js, key, jcfg, block=block,
                                    attn_len=attn_len)
        ttoks, ts = tl.decode_block(tp, tt, ts, tcfg, block=block,
                                    attn_len=attn_len)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        assert int(ts.pos) == int(js.pos)
        jt, tt = jtoks[:, -1], ttoks[:, -1]
    np.testing.assert_allclose(ts.k.numpy(), np.asarray(js.k), atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=1e-5)
    jlog, _ = jl._forward_cached(params, jt[:, None], js, jcfg)
    tlog, _ = tl._forward_cached(tp, tt[:, None], ts, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)


def test_prefill_unpadded_matches_jax():
    params = _params(TINY)
    ids = np.random.default_rng(2).integers(0, TINY.vocab_size, (2, 9))
    jlog, js = jl.prefill(params, jnp.asarray(ids, jnp.int32),
                          jl.init_llama_decode_state(TINY, batch=2), TINY)
    tcfg = _tcfg(TINY)
    tlog, ts = tl.prefill(to_torch(params, "cpu"), torch.from_numpy(ids),
                          tl.init_llama_decode_state(tcfg, batch=2), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    assert int(ts.pos) == int(js.pos) == 9


@pytest.mark.parametrize("positions", [[0, 1, 8191], [65535, 131071]])
def test_rope_at_long_positions_matches_jax(positions):
    """Angles in f32, as JAX takes them (a float64 angle would differ from
    JAX's by up to half an f32 ulp of the angle, 0.004 rad at 131071)."""
    jcfg = dataclasses.replace(CONFIGS["llama3 rope"],
                               rope_original_max_position=8192)
    x = np.random.default_rng(3).standard_normal(
        (1, len(positions), 4, 128)).astype(np.float32)
    pos = np.asarray([positions], np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos),
                  _tcfg(jcfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_steps_follow_jax_to_one_ulp_ties():
    """bf16 params and caches on both sides, 64 steps teacher-forced on
    JAX's greedy chain: the logits agree to two bf16 ulps of the largest
    one, and where the argmaxes differ (XLA and torch round their bf16
    sums in another order) JAX's logits tie to one bf16 ulp."""
    tcfg = _tcfg(TINY)
    params = _params(TINY)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tp = to_torch(params, "cpu", torch.bfloat16)
    ids = np.random.default_rng(7).integers(1, TINY.vocab_size, (1, 11))
    jlog, js = jl.prefill(jp, jnp.asarray(ids, jnp.int32),
                          jl.init_llama_decode_state(TINY,
                                                     dtype=jnp.bfloat16),
                          TINY)
    tlog, ts = tl.prefill(tp, torch.from_numpy(ids),
                          tl.init_llama_decode_state(tcfg,
                                                     dtype=torch.bfloat16),
                          tcfg)
    step = jax.jit(jl._forward_cached, static_argnums=(3,))
    ties = 0
    for _ in range(64):
        want = np.asarray(jlog, np.float32)[0]
        got = tlog.float().numpy()[0]
        ulp = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= 2 * ulp
        w, g = int(want.argmax()), int(got.argmax())
        if w != g:
            ties += 1
            assert want[w] - want[g] <= 2.0 ** -7 * abs(want[w])
        tok = np.asarray([[w]], np.int32)
        jlog, js = step(jp, jnp.asarray(tok), js, TINY)
        tlog, ts = tl._forward_cached(tp, torch.from_numpy(tok), ts, tcfg)
    assert ties <= 2


SAMPLING = [(0.7, 40, 0.95), (1.0, 0, 0.5), (0.5, 7, 1.0), (1.3, 0, 1.0)]


@pytest.mark.parametrize("temperature, top_k, top_p", SAMPLING)
def test_filtered_logits_equal_jax(temperature, top_k, top_p):
    logits = 3 * np.random.default_rng(4).standard_normal(
        (3, 384)).astype(np.float32)
    want = np.asarray(jl._filtered_logits(jnp.asarray(logits), temperature,
                                          top_k, top_p))
    got = tl._filtered_logits(torch.from_numpy(logits), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature, top_k, top_p",
                         SAMPLING + [(0.0, 0, 1.0)])
def test_sample_with_jax_noise_equals_jax(temperature, top_k, top_p):
    """``jax.random.categorical`` is the argmax of the logits plus Gumbel
    noise: given JAX's own noise, the port draws JAX's token."""
    logits = np.random.default_rng(5).standard_normal(
        (64, 384)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jl._sample(jnp.asarray(logits), key, temperature,
                                 top_k, top_p))
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = tl._sample(torch.from_numpy(logits), temperature, top_k, top_p,
                     gumbel=torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_draws_the_filtered_distribution():
    """With its own generator: frequencies over 40000 draws within 0.015
    of the filtered softmax, nothing outside the filter drawn."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.3, -1.0, 0.0, 0.9, -3.0]])
    t, k, p = 0.8, 5, 0.9
    probs = torch.softmax(tl._filtered_logits(logits, t, k, p), -1)[0]
    gen = torch.Generator().manual_seed(0)
    draws = tl._sample(logits.expand(40000, -1), t, k, p, generator=gen)
    freq = torch.bincount(draws.long(), minlength=8).float() / 40000
    assert (freq[probs == 0] == 0).all()
    np.testing.assert_allclose(freq.numpy(), probs.numpy(), atol=0.015)
    again = tl._sample(logits.expand(40000, -1), t, k, p, generator=gen)
    assert not torch.equal(again, draws)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantize_llama_params_matches_jax(mode):
    params = _params(dataclasses.replace(TINY, n_layer=1, n_embd=512,
                                         n_head=8, n_kv_head=4,
                                         intermediate_size=768))
    want = jax.device_get(jq.quantize_llama_params(params, mode))
    got = tq.quantize_llama_params(params, mode)
    assert type(got["head"]) is tq.QuantizedTensor
    assert isinstance(got["tok_emb"], np.ndarray)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, tq.QUANTIZED):
            assert type(b).__name__ == type(a).__name__, path
            np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
            np.testing.assert_array_equal(b.s.numpy(), np.asarray(a.s))
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))

    walk(want, got, ())
    if mode == "w4":
        assert got["h"]["wdown"].s.shape == (1, 3, 1, 512)


def test_w4_chain_follows_the_k4_route():
    """At width 512 each w4 weight has 2 or 3 scale groups of 256: the
    port's greedy chain equals JAX's on its TPU route (K4 in interpret
    mode) and its caches agree to K4's bf16 rounding of the
    activations."""
    jcfg = dataclasses.replace(TINY, n_layer=1, n_embd=512, n_head=8,
                               n_kv_head=4, intermediate_size=768)
    params = _params(jcfg, 1)
    jp = jq.quantize_llama_params(params, "w4")
    tcfg = _tcfg(jcfg)
    tp = to_torch(tq.quantize_llama_params(params, "w4"), "cpu")
    ids = np.random.default_rng(6).integers(1, jcfg.vocab_size, (1, 16))
    with jax_route("w4"):
        jlog, js = jl.prefill(jp, jnp.asarray(ids, jnp.int32),
                              jl.init_llama_decode_state(jcfg), jcfg)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        want, js = jl.decode_block(jp, jt, js, jax.random.PRNGKey(0), jcfg,
                                   block=12, attn_len=128)
        want = np.asarray(want)
        jk = np.asarray(js.k)
    tlog, ts = tl.prefill(tp, torch.from_numpy(ids),
                          tl.init_llama_decode_state(tcfg), tcfg)
    tt = torch.argmax(tlog, -1).to(torch.int32)
    assert int(tt[0]) == int(jt[0])
    got, ts = tl.decode_block(tp, tt, ts, tcfg, block=12, attn_len=128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(ts.k.numpy() - jk).max() < 2e-3


def test_init_llama_params_has_jax_keys_shapes_and_scale():
    want = _params(TINY)
    got = tparams.init_llama_params(0, _tcfg(TINY))
    again = tparams.init_llama_params(0, _tcfg(TINY))
    assert got.keys() == want.keys() and got["h"].keys() == want["h"].keys()
    for k in ("tok_emb", "lnf_s", "head"):
        assert tuple(got[k].shape) == want[k].shape
    for k, v in want["h"].items():
        assert tuple(got["h"][k].shape) == v.shape, k
        assert torch.equal(got["h"][k], again["h"][k])
    assert abs(float(got["h"]["wup"].std()) - 0.02) < 1e-3
    assert torch.equal(got["h"]["ln1_s"], torch.ones(2, 64))


def test_unported_configurations_raise():
    tcfg = _tcfg(TINY)
    tp = to_torch(_params(TINY), "cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    for cfg in (dataclasses.replace(tcfg, n_experts=4),
                dataclasses.replace(tcfg, n_draft_heads=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.apply_llama(tp, ids, cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.prefill(tp, ids, tl.init_llama_decode_state(tcfg), cfg)
    for name in ("decode_block_pooled", "prefill_slots",
                 "decode_block_spec_pooled", "init_llama_pool_state"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(tl, name)
    with pytest.raises(AttributeError):
        tl.no_such_function
