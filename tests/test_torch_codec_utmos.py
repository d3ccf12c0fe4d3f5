"""The port's UTMOS scorer (llmvox_tpu_torch/codec/utmos.py) and its
converter (tools/convert.py::convert_utmos_state_dict, convert_ckpt's
``utmos`` mode) against the JAX package's, on the same numpy params (the
port's seeded initialiser, tests/test_utmos.py's CFG) and inputs, on the
CPU.

Tolerances: the encoder features and each LSTM direction to 1e-5, the
scores and frame scores to 2e-5 (tighter than the 2e-4 JAX holds its own
forward to against its torch oracle); the converter's arrays exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import utmos as jutmos
from llmvox_tpu.tools.convert import convert_utmos_state_dict as jconvert
from llmvox_tpu.train.checkpoint import load_params_npz as jload
from llmvox_tpu_torch.codec import metrics as tmetrics
from llmvox_tpu_torch.codec import utmos as tutmos
from llmvox_tpu_torch.tools import convert_ckpt
from llmvox_tpu_torch.tools.convert import convert_utmos_state_dict as tconvert
from llmvox_tpu_torch.utils.params import init_utmos_params, to_torch

JCFG = jutmos.UTMOSConfig(
    conv_layers=((16, 10, 5), (16, 3, 2)), encoder_dim=32,
    encoder_layers=2, encoder_heads=2, encoder_ffn=48,
    pos_conv_kernel=16, pos_conv_groups=4, n_domains=3, domain_dim=8,
    num_judges=10, judge_dim=8, lstm_hidden=16, proj_hidden=24,
    domain_id=0, judge_id=7)
TCFG = tutmos.UTMOSConfig(**dataclasses.asdict(JCFG))


def _wav(seed, b=2, t=3200):
    return (np.random.default_rng(seed).standard_normal((b, t)) * 0.3
            ).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    p = init_utmos_params(0, TCFG)
    # non-trivial norms and biases, so every term of the forward shows
    rng = np.random.default_rng(1)
    for path in (("conv0_gn", "b"), ("fp_ln", "s"), ("enc_ln", "b"),
                 ("pos_conv", "b"), ("lstm_fwd", "bi"), ("lstm_bwd", "bh")):
        node = p[path[0]]
        node[path[1]] = node[path[1]] + 0.1 * rng.standard_normal(
            node[path[1]].shape).astype(np.float32)
    p["layers"]["b1"] += 0.1 * rng.standard_normal(
        p["layers"]["b1"].shape).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def jax_fwd():
    return jax.jit(lambda p, w: jutmos.apply_utmos(p, w, JCFG))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_initialiser_builds_the_converted_layout(params):
    """The port's initialiser gives the tree JAX's converter makes (JAX's
    own ``init_utmos_params`` draws 17 arrays from 16 keys and raises
    StopIteration at any config, so the converter is the reference)."""
    with pytest.raises(StopIteration):
        jax.eval_shape(lambda: jutmos.init_utmos_params(
            jax.random.PRNGKey(0), JCFG))
    want = jconvert(_lightning_sd(params, True))
    assert (jax.tree.map(lambda a: a.shape, want)
            == jax.tree.map(lambda a: a.shape, params))
    full = init_utmos_params(0, tutmos.UTMOSConfig())
    n = sum(a.size for a in jax.tree.leaves(full))
    assert 90e6 < n < 110e6, n


def test_forward_matches_jax(params, jax_fwd):
    wav = _wav(0)
    tp = to_torch(params, "cpu")
    feats = tutmos.encoder_features(tp, torch.from_numpy(wav), TCFG)
    want_feats = jax.jit(jutmos._encoder_features, static_argnums=2)(
        _j(params), jnp.asarray(wav), JCFG)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats),
                               atol=1e-5)
    got = tutmos.apply_utmos(tp, torch.from_numpy(wav), TCFG)
    want = jax_fwd(_j(params), jnp.asarray(wav))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    frames = tutmos.frame_scores(tp, torch.from_numpy(wav), TCFG)
    np.testing.assert_allclose((frames.mean(1) * 2 + 3).numpy(), got.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_direction_matches_jax(params, reverse):
    name = "lstm_bwd" if reverse else "lstm_fwd"
    x = np.random.default_rng(2).standard_normal(
        (2, 13, params[name]["wi"].shape[0])).astype(np.float32)
    got = tutmos.lstm_direction(to_torch(params[name], "cpu"),
                                torch.from_numpy(x), reverse)
    want = jutmos._lstm_dir(_j(params[name]), jnp.asarray(x), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_scorer_trims_to_the_grid_and_registers(params):
    wav = _wav(3, 1, 4100)[0]
    exact = tutmos.make_scorer(params, TCFG, exact=True, device="cpu")
    jexact = jutmos.make_scorer(_j(params), JCFG, exact=True)
    assert abs(exact(wav) - jexact(wav)) < 2e-5
    grid = tutmos.make_scorer(params, TCFG, grid=2000, device="cpu")
    jgrid = jutmos.make_scorer(_j(params), JCFG, grid=2000)
    # trimmed to 4000 samples, never padded
    assert abs(grid(wav) - exact(wav[:4000])) < 1e-6
    assert abs(grid(wav) - jgrid(wav)) < 2e-5
    # a clip under the grid is scored whole
    assert abs(grid(wav[:1500]) - exact(wav[:1500])) < 1e-6
    tutmos.register(params, TCFG, device="cpu")
    try:
        got = tmetrics.utmos_score(wav, sr=16000)
        assert got == tutmos.make_scorer(params, TCFG, device="cpu")(wav)
    finally:
        tmetrics.register_plugin("utmos", None)
    assert tmetrics.utmos_score(wav) is None


def _lightning_sd(p, legacy: bool):
    """A UTMOS Lightning checkpoint's state dict (fairseq key names,
    torch layouts) holding the tree ``p``; the positional conv weight-
    normed along its kernel axis (fairseq's dim=2), under the legacy
    ``weight_g``/``weight_v`` or the ``parametrizations`` names."""
    pre = "model.feature_extractors.0.ssl_model."
    sd = {}
    for i, c in enumerate(p["conv"]):
        sd[f"{pre}feature_extractor.conv_layers.{i}.0.weight"] = \
            c["w"].transpose(2, 1, 0)
    sd[pre + "feature_extractor.conv_layers.0.2.weight"] = p["conv0_gn"]["s"]
    sd[pre + "feature_extractor.conv_layers.0.2.bias"] = p["conv0_gn"]["b"]
    sd[pre + "layer_norm.weight"] = p["fp_ln"]["s"]
    sd[pre + "layer_norm.bias"] = p["fp_ln"]["b"]
    sd[pre + "post_extract_proj.weight"] = p["fp_w"].T
    sd[pre + "post_extract_proj.bias"] = p["fp_b"]
    v = p["pos_conv"]["w"].transpose(2, 1, 0)          # (Cout, Cin/g, K)
    g = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True)) * 1.5
    names = (("weight_g", "weight_v") if legacy else
             ("parametrizations.weight.original0",
              "parametrizations.weight.original1"))
    sd[pre + "encoder.pos_conv.0." + names[0]] = g
    sd[pre + "encoder.pos_conv.0." + names[1]] = v
    sd[pre + "encoder.pos_conv.0.bias"] = p["pos_conv"]["b"]
    sd[pre + "encoder.layer_norm.weight"] = p["enc_ln"]["s"]
    sd[pre + "encoder.layer_norm.bias"] = p["enc_ln"]["b"]
    lay = p["layers"]
    for i in range(lay["wq"].shape[0]):
        t = f"{pre}encoder.layers.{i}."
        for proj, w, b in (("self_attn.q_proj", "wq", "bq"),
                           ("self_attn.k_proj", "wk", "bk"),
                           ("self_attn.v_proj", "wv", "bv"),
                           ("self_attn.out_proj", "wo", "bo"),
                           ("fc1", "w1", "b1"), ("fc2", "w2", "b2")):
            sd[t + proj + ".weight"] = lay[w][i].T
            sd[t + proj + ".bias"] = lay[b][i]
        for ln, s_, b_ in (("self_attn_layer_norm", "ln1_s", "ln1_b"),
                           ("final_layer_norm", "ln2_s", "ln2_b")):
            sd[t + ln + ".weight"] = lay[s_][i]
            sd[t + ln + ".bias"] = lay[b_][i]
    sd["model.feature_extractors.1.embedding.weight"] = p["domain_emb"]
    sd["model.output_layers.0.judge_embedding.weight"] = p["judge_emb"]
    rnn = "model.output_layers.0.decoder_rnn."
    for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
        sd[rnn + f"weight_ih_l0{sfx}"] = p[f"lstm_{d}"]["wi"].T
        sd[rnn + f"weight_hh_l0{sfx}"] = p[f"lstm_{d}"]["wh"].T
        sd[rnn + f"bias_ih_l0{sfx}"] = p[f"lstm_{d}"]["bi"]
        sd[rnn + f"bias_hh_l0{sfx}"] = p[f"lstm_{d}"]["bh"]
    sd["model.output_layers.1.net.0.weight"] = p["proj1_w"].T
    sd["model.output_layers.1.net.0.bias"] = p["proj1_b"]
    sd["model.output_layers.1.net.3.weight"] = p["proj2_w"].T
    sd["model.output_layers.1.net.3.bias"] = p["proj2_b"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


@pytest.mark.parametrize("legacy", [True, False])
def test_convert_utmos_state_dict_matches_jax(params, legacy):
    sd = _lightning_sd(params, legacy)
    got, want = tconvert(sd), jconvert(sd)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    # the tree comes back, the positional conv scaled by its g
    np.testing.assert_allclose(got["pos_conv"]["w"],
                               1.5 * params["pos_conv"]["w"], rtol=1e-5,
                               atol=1e-7)
    got["pos_conv"]["w"] = params["pos_conv"]["w"]
    jax.tree.map(np.testing.assert_array_equal, got, params)
    assert tconvert(sd, n_layer=1)["layers"]["wq"].shape[0] == 1


def test_convert_ckpt_utmos_is_read_by_jax(params, jax_fwd, tmp_path):
    """``convert_ckpt utmos``: a Lightning .ckpt -> an npz that JAX's
    ``apply_utmos`` scores as the port scores the same tree."""
    src = tmp_path / "utmos.ckpt"
    torch.save({"state_dict": _lightning_sd(params, True)}, str(src))
    dst = tmp_path / "utmos.npz"
    convert_ckpt.main(["utmos", str(src), str(dst)])
    loaded = jload(str(dst))
    wav = _wav(4, 1)
    want = jax_fwd(_j(loaded), jnp.asarray(wav))
    got = tutmos.apply_utmos(to_torch(loaded, "cpu"), torch.from_numpy(wav),
                             TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    import json
    assert json.load(open(str(dst) + ".json")) == {
        "model_args": {"encoder_layers": 2}}
