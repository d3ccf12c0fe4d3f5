"""The port's Encodec LM, arithmetic coder and LM compression
(llmvox_tpu_torch/codec/{lm,entropy,compress}.py, tools/convert.py::
convert_lm_state_dict) against the JAX package's, on the same numpy params
(the port's seeded initialiser) and inputs, on the CPU.

Tolerances: the LM's probabilities to 2e-5 (JAX's own bound against its
torch oracle, tests/test_encodec_lm.py); the coder's bytes and the
converter's arrays exactly.  Arithmetic coding across packages: an f32
last-bit difference between torch and XLA can move a probability across a
1e-8 floor step of ``quantized_cdf``, so the bytes are held equal on the
same cdfs (JAX's coder fed the port's pdfs), and the round trip exact on
the port's own stepper."""
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import compress as jcompress
from llmvox_tpu.codec import entropy as jent
from llmvox_tpu.codec import lm as jlm
from llmvox_tpu.tools.convert import convert_lm_state_dict as jconvert
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu_torch.codec import compress as tcompress
from llmvox_tpu_torch.codec import entropy as tent
from llmvox_tpu_torch.codec import lm as tlm
from llmvox_tpu_torch.tools.convert import convert_lm_state_dict as tconvert
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import init_lm_params, to_torch

# tests/test_encodec_lm.py's CFG
JCFG = jlm.LMConfig(n_q=3, card=33, dim=32, num_layers=2, num_heads=4,
                    past_context=14)
TCFG = tlm.LMConfig(n_q=3, card=33, dim=32, num_layers=2, num_heads=4,
                    past_context=14)
SMALL_J = jlm.LMConfig(n_q=2, card=16, dim=8, num_layers=1, num_heads=2,
                       past_context=8)
SMALL_T = tlm.LMConfig(n_q=2, card=16, dim=8, num_layers=1, num_heads=2,
                       past_context=8)


@pytest.fixture(scope="module")
def params():
    return init_lm_params(0, TCFG)


# JAX's forward compiled once a shape (op by op it compiles every op)
japply = jax.jit(jlm.apply_lm, static_argnums=3)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# entropy coding
# ---------------------------------------------------------------------------

def test_bit_packer_writes_jax_bytes():
    bits = np.random.default_rng(3).integers(0, 2, 83).tolist()
    outs = []
    for mod in (jent, tent):
        fo = io.BytesIO()
        p = mod.BitPacker(fo)
        for b in bits:
            p.push(b)
        p.flush()
        outs.append(fo.getvalue())
    assert outs[0] == outs[1]
    u = tent.BitUnpacker(io.BytesIO(outs[1]))
    assert [u.pull() for _ in bits] == bits


def test_arithmetic_coder_writes_jax_bytes():
    """The same pdfs and symbols give the same cdfs and the same bytes;
    the port's decoder reads them back."""
    rng = np.random.default_rng(1234)
    for card in (2, 33, 1500):
        pdfs = [rng.dirichlet(np.ones(card) * 0.3) for _ in range(120)]
        syms = [int(rng.choice(card, p=p)) for p in pdfs]
        outs = []
        for mod in (jent, tent):
            fo = io.BytesIO()
            enc = mod.ArithmeticCoder(fo)
            for p, s in zip(pdfs, syms):
                enc.push(s, mod.quantized_cdf(p))
            enc.flush()
            outs.append(fo.getvalue())
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(tent.quantized_cdf(pdfs[0]),
                                      jent.quantized_cdf(pdfs[0]))
        dec = tent.ArithmeticDecoder(io.BytesIO(outs[1]))
        assert [dec.pull(tent.quantized_cdf(p)) for p in pdfs] == syms
    with pytest.raises(ValueError):
        tent.quantized_cdf(pdfs[0], min_range=1)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def test_lm_config_for_matches_jax():
    for jc in (JCodecConfig(), JCodecConfig(vq_bins=512, sample_rate=16000,
                                            downsamples=(2, 4, 5))):
        tc = tconfig.CodecConfig(**{f: getattr(jc, f) for f in
                                    tconfig.CodecConfig.__dataclass_fields__})
        assert (tlm.lm_config_for(tc).__dict__
                == jlm.lm_config_for(jc).__dict__)
    cfg = tlm.lm_config_for(tconfig.CodecConfig())
    assert (cfg.n_q, cfg.card, cfg.dim, cfg.num_layers, cfg.past_context) == (
        1, 4096, 200, 5, 262)


def test_initialiser_matches_jax_tree():
    want = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), JCFG))
    got = init_lm_params(0, TCFG)
    assert (jax.tree.map(lambda a: a.shape, want)
            == jax.tree.map(lambda a: a.shape, got))


def test_sin_embedding_matches_jax():
    pos = np.arange(300)[None] + 7
    np.testing.assert_allclose(
        tlm.sin_embedding(torch.from_numpy(pos), 200).numpy(),
        np.asarray(jlm.sin_embedding(jnp.asarray(pos), 200)), atol=2e-5)


def test_lm_forward_matches_jax(params):
    idx = np.random.default_rng(0).integers(0, TCFG.card + 1,
                                            (2, TCFG.n_q, 10))
    want, wstate = japply(_jtree(params), jnp.asarray(idx, jnp.int32),
                          jlm.init_stream_state(JCFG, 2), JCFG)
    got, gstate = tlm.apply_lm(to_torch(params, "cpu"), torch.from_numpy(idx),
                               tlm.init_stream_state(TCFG, 2), TCFG)
    assert got.shape == (2, TCFG.card, TCFG.n_q, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(gstate["bufs"].numpy(),
                               np.asarray(wstate["bufs"]), atol=2e-5)
    assert int(gstate["length"]) == int(wstate["length"]) == 11
    assert int(gstate["offset"]) == int(wstate["offset"]) == 10


def test_streaming_state_matches_jax(params):
    """Chunks of 4 + 6 + 8 frames, crossing past_context 14: each chunk's
    probabilities and the state after it (buffers, length, offset)."""
    rng = np.random.default_rng(1)
    jp, tp = _jtree(params), to_torch(params, "cpu")
    jstate = jlm.init_stream_state(JCFG, 1)
    tstate = tlm.init_stream_state(TCFG, 1)
    for t in (4, 6, 8):
        idx = rng.integers(0, TCFG.card + 1, (1, TCFG.n_q, t))
        want, jstate = japply(jp, jnp.asarray(idx, jnp.int32), jstate, JCFG)
        got, tstate = tlm.apply_lm(tp, torch.from_numpy(idx), tstate, TCFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(tstate["bufs"].numpy(),
                                   np.asarray(jstate["bufs"]), atol=2e-5)
        for k in ("length", "offset"):
            assert int(tstate[k]) == int(jstate[k])


def test_chunked_equals_full_pass_and_causal(params):
    tp = to_torch(params, "cpu")
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        0, TCFG.card + 1, (2, TCFG.n_q, 9)))
    full, _ = tlm.apply_lm(tp, idx, tlm.init_stream_state(TCFG, 2), TCFG)
    p1, st = tlm.apply_lm(tp, idx[..., :4], tlm.init_stream_state(TCFG, 2),
                          TCFG)
    p2, _ = tlm.apply_lm(tp, idx[..., 4:], st, TCFG)
    np.testing.assert_allclose(torch.cat([p1, p2], -1).numpy(), full.numpy(),
                               atol=1e-5)
    mut = idx.clone()
    mut[:, :, 5] = (mut[:, :, 5] + 1) % (TCFG.card + 1)
    moved, _ = tlm.apply_lm(tp, mut, tlm.init_stream_state(TCFG, 2), TCFG)
    np.testing.assert_allclose(moved[..., :5].numpy(), full[..., :5].numpy(),
                               atol=1e-6)
    assert not np.allclose(moved[..., 5:].numpy(), full[..., 5:].numpy())


def test_stepper_is_apply_lm_one_frame_at_a_time(params):
    """``LMStepper`` (the static-buffer step both directions drive) gives
    what T=1 ``apply_lm`` calls give, and ``reset`` starts over."""
    stepper = tlm.LMStepper(params, TCFG, device="cpu")
    tp = to_torch(params, "cpu")
    codes = np.random.default_rng(4).integers(0, TCFG.card, (TCFG.n_q, 20))
    state = tlm.init_stream_state(TCFG, 1)
    for rep in range(2):
        prev = np.zeros(TCFG.n_q, np.int64)
        for i in range(20):
            got = stepper.step(prev)
            want, state = tlm.apply_lm(
                tp, torch.from_numpy(prev).view(1, -1, 1), state, TCFG)
            np.testing.assert_array_equal(got, want[0, :, :, 0].double())
            prev = codes[:, i] + 1
        stepper.reset()
        state = tlm.init_stream_state(TCFG, 1)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _port_pdfs(params, cfg, codes):
    stepper = tlm.LMStepper(params, cfg, device="cpu")
    prev, pdfs = np.zeros(cfg.n_q, np.int64), []
    for i in range(codes.shape[1]):
        pdfs.append(stepper.step(prev))
        prev = codes[:, i] + 1
    return pdfs


def test_compress_round_trip_and_jax_bytes(params, monkeypatch):
    """The port's round trip is exact; JAX's compressor, fed the port's
    pdfs step by step, writes the port's bytes (the wire format and the
    coder); on JAX's own pdfs the stream is JAX's, and the count of
    quantized-cdf entries that differ between the packages is reported."""
    codes = np.random.default_rng(2).integers(0, TCFG.card, (TCFG.n_q, 25))
    stepper = tlm.LMStepper(params, TCFG, device="cpu")
    blob = tcompress.compress_codes(stepper, codes)
    np.testing.assert_array_equal(tcompress.decompress_codes(stepper, blob),
                                  codes)
    # another stepper on the same device: the same bytes
    assert tcompress.compress_codes(tlm.LMStepper(params, TCFG, "cpu"),
                                    codes) == blob

    pdfs = iter(_port_pdfs(params, TCFG, codes))
    with monkeypatch.context() as m:
        m.setattr(jlm, "lm_step", lambda p, i, s, c: (
            jnp.asarray(next(pdfs))[None, :, :, None], s))
        assert jcompress.compress_codes(_jtree(params), codes, JCFG) == blob

    jpdfs = []
    state, prev = jlm.init_stream_state(JCFG, 1), np.zeros((1, 3, 1),
                                                          np.int32)
    for i in range(codes.shape[1]):
        probs, state = jlm.lm_step(_jtree(params), jnp.asarray(prev), state,
                                   JCFG)
        jpdfs.append(np.asarray(probs[0, :, :, 0], np.float64))
        prev = codes[None, :, i:i + 1].astype(np.int32) + 1
    differ = sum(int((tent.quantized_cdf(a[:, q]) !=
                      tent.quantized_cdf(b[:, q])).any())
                 for a, b in zip(jpdfs, _port_pdfs(params, TCFG, codes))
                 for q in range(TCFG.n_q))
    jblob = jcompress.compress_codes(_jtree(params), codes, JCFG)
    if differ == 0:
        assert jblob == blob
    try:
        read = tcompress.decompress_codes(stepper, jblob)
        decoded = bool((read == codes).all())
    except (ValueError, RuntimeError):
        decoded = False
    print(f"quantized cdfs differing from JAX's: {differ} of {codes.size}; "
          f"JAX's stream decoded by the port: {decoded}")
    assert max(abs(a - b).max() for a, b in zip(
        jpdfs, _port_pdfs(params, TCFG, codes))) < 2e-5


def test_confident_lm_compresses_below_raw_bits():
    cfg = tlm.LMConfig(n_q=3, card=64, dim=16, num_layers=2, num_heads=4,
                       past_context=20)
    p = init_lm_params(0, cfg)
    p["heads"]["b"][:, 7] += 12.0
    codes = np.full((cfg.n_q, 40), 7, np.int32)
    stepper = tlm.LMStepper(p, cfg, device="cpu")
    blob = tcompress.compress_codes(stepper, codes)
    assert len(blob) * 8 < 0.25 * codes.size * math.log2(cfg.card)
    np.testing.assert_array_equal(tcompress.decompress_codes(stepper, blob),
                                  codes)


@pytest.mark.parametrize("t", [0, 1])
def test_compress_empty_and_single_frame(t):
    p = init_lm_params(0, SMALL_T)
    stepper = tlm.LMStepper(p, SMALL_T, "cpu")
    codes = np.zeros((SMALL_T.n_q, t), np.int32)
    blob = tcompress.compress_codes(stepper, codes)
    assert blob[:6] == jcompress.compress_codes(_jtree(p), codes,
                                                SMALL_J)[:6]
    rec = tcompress.decompress_codes(stepper, blob)
    assert rec.shape == (SMALL_T.n_q, t)
    np.testing.assert_array_equal(rec, codes)


@pytest.mark.parametrize("case", ["n_q", "high", "negative", "truncated",
                                  "stream_n_q"])
def test_compress_refusals(case):
    stepper = tlm.LMStepper(init_lm_params(0, SMALL_T), SMALL_T, "cpu")
    if case == "n_q":
        with pytest.raises(ValueError, match="codebooks"):
            tcompress.compress_codes(stepper, np.zeros((3, 4), np.int32))
    elif case in ("high", "negative"):
        bad = np.zeros((2, 4), np.int32)
        bad[1, 2] = 16 if case == "high" else -1
        with pytest.raises(ValueError, match=r"\[0, 16\)"):
            tcompress.compress_codes(stepper, bad)
    elif case == "truncated":
        codes = np.random.default_rng(1).integers(0, 16, (2, 12))
        blob = tcompress.compress_codes(stepper, codes)
        with pytest.raises(ValueError, match="ended early"):
            tcompress.decompress_codes(stepper, blob[: len(blob) // 3])
    else:
        blob = tcompress.compress_codes(
            tlm.LMStepper(init_lm_params(0, TCFG), TCFG, "cpu"),
            np.zeros((3, 2), np.int32))
        with pytest.raises(ValueError, match="codebooks"):
            tcompress.decompress_codes(stepper, blob)


def test_convert_lm_state_dict_matches_jax(params):
    """A reference-layout LMModel state dict (torch tensors, built here
    from the seeded tree) converts bitwise as JAX's converter does, and
    back to the tree."""
    layers = params["transformer"]["layers"]
    sd = {"transformer.norm_in.weight":
          params["transformer"]["norm_in"]["scale"],
          "transformer.norm_in.bias":
          params["transformer"]["norm_in"]["bias"]}
    for i in range(TCFG.num_layers):
        t = f"_orig_mod.transformer.layers.{i}."
        sd[t + "self_attn.in_proj_weight"] = layers["qkv"]["w"][i].T
        sd[t + "self_attn.in_proj_bias"] = layers["qkv"]["b"][i]
        sd[t + "self_attn.out_proj.weight"] = layers["out"]["w"][i].T
        sd[t + "self_attn.out_proj.bias"] = layers["out"]["b"][i]
        for name, key in (("linear1", "ff1"), ("linear2", "ff2")):
            sd[t + f"{name}.weight"] = layers[key]["w"][i].T
            sd[t + f"{name}.bias"] = layers[key]["b"][i]
        for n in ("norm1", "norm2"):
            sd[t + f"{n}.weight"] = layers[n]["scale"][i]
            sd[t + f"{n}.bias"] = layers[n]["bias"][i]
    for k in range(TCFG.n_q):
        sd[f"emb.{k}.weight"] = params["emb"][k]
        sd[f"linears.{k}.weight"] = params["heads"]["w"][k].T
        sd[f"linears.{k}.bias"] = params["heads"]["b"][k]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    got = tconvert(sd, TCFG.n_q, TCFG.num_layers)
    want = jconvert(sd, TCFG.n_q, TCFG.num_layers)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    jax.tree.map(np.testing.assert_array_equal, got, params)
