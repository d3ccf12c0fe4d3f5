"""The port's converters (llmvox_tpu_torch/tools/convert.py,
tools/convert_ckpt.py, models/gpt2_import.py) against the JAX package's,
bitwise, on state dicts and HF models built here (no download)."""
import os

import numpy as np
import pytest
import torch

from llmvox_tpu.models import gpt2_import as jgpt2
from llmvox_tpu.tools import convert as jconvert
from llmvox_tpu.tools import convert_ckpt as jconvert_ckpt
from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu_torch.models import gpt2_import as tgpt2
from llmvox_tpu_torch.tools import convert as tconvert
from llmvox_tpu_torch.tools import convert_ckpt as tconvert_ckpt
from llmvox_tpu_torch.utils import params as tparams

from tests.test_convert import CFG as DEC_SD_CFG, _make_decoder_sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: tree}


def assert_same_tree(got, want):
    """The same keys, shapes, dtypes and values, bit for bit."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _rand(shape, gen):
    return torch.from_numpy(
        0.1 * gen.standard_normal(shape).astype(np.float32))


def _wn(sd, base, shape, gen, new_style):
    """A weight-normed conv weight, in the legacy or the
    parametrizations naming."""
    g = _rand((shape[0],) + (1,) * (len(shape) - 1), gen).abs() + 0.5
    v = _rand(shape, gen)
    if new_style:
        sd[base + "parametrizations.weight.original0"] = g
        sd[base + "parametrizations.weight.original1"] = v
    else:
        sd[base + "weight_g"] = g
        sd[base + "weight_v"] = v
    sd[base + "bias"] = _rand((shape[0],), gen)


def _codec_sd(gen, dim=16, n_layers=2, encoder=True):
    """A WavTokenizer Lightning state dict: codebook, backbone, head, a
    discriminator key to be filtered out, and a weight-normed SEANet
    encoder (ratios 2, 4, 5, 8; one residual block a stage; 2 LSTM
    layers) in both weight-norm namings."""
    sd = {"feature_extractor.encodec.quantizer.vq.layers.0._codebook.embed":
          _rand((8, 12), gen)}
    b = "backbone"
    sd[f"{b}.embed.weight"] = _rand((dim, 12, 7), gen)
    sd[f"{b}.embed.bias"] = _rand((dim,), gen)
    for blk in (0, 1, 3, 4):
        p = f"{b}.pos_net.{blk}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = _rand((dim,), gen)
            sd[f"{p}.{n}.bias"] = _rand((dim,), gen)
        for c in ("conv1", "conv2"):
            sd[f"{p}.{c}.weight"] = _rand((dim, dim, 3), gen)
            sd[f"{p}.{c}.bias"] = _rand((dim,), gen)
    p = f"{b}.pos_net.2"
    sd[f"{p}.norm.weight"] = _rand((dim,), gen)
    sd[f"{p}.norm.bias"] = _rand((dim,), gen)
    for n in ("q", "k", "v", "proj_out"):
        sd[f"{p}.{n}.weight"] = _rand((dim, dim, 1), gen)
        sd[f"{p}.{n}.bias"] = _rand((dim,), gen)
    sd[f"{b}.pos_net.5.weight"] = _rand((dim,), gen)
    sd[f"{b}.pos_net.5.bias"] = _rand((dim,), gen)
    sd[f"{b}.norm.scale.weight"] = _rand((4, dim), gen)
    sd[f"{b}.norm.shift.weight"] = _rand((4, dim), gen)
    for i in range(n_layers):
        p = f"{b}.convnext.{i}"
        sd[f"{p}.dwconv.weight"] = _rand((dim, 1, 7), gen)
        sd[f"{p}.dwconv.bias"] = _rand((dim,), gen)
        sd[f"{p}.norm.scale.weight"] = _rand((4, dim), gen)
        sd[f"{p}.norm.shift.weight"] = _rand((4, dim), gen)
        sd[f"{p}.pwconv1.weight"] = _rand((3 * dim, dim), gen)
        sd[f"{p}.pwconv1.bias"] = _rand((3 * dim,), gen)
        sd[f"{p}.pwconv2.weight"] = _rand((dim, 3 * dim), gen)
        sd[f"{p}.pwconv2.bias"] = _rand((dim,), gen)
        sd[f"{p}.gamma"] = _rand((dim,), gen)
    sd[f"{b}.final_layer_norm.weight"] = _rand((dim,), gen)
    sd[f"{b}.final_layer_norm.bias"] = _rand((dim,), gen)
    sd["head.out.weight"] = _rand((18, dim), gen)
    sd["head.out.bias"] = _rand((18,), gen)
    sd["multiperioddisc.foo"] = _rand((3,), gen)
    if encoder:
        e = "feature_extractor.encodec.encoder.model."
        _wn(sd, e + "0.conv.conv.", (4, 1, 7), gen, False)
        idx = 1
        for s in range(4):
            _wn(sd, f"{e}{idx}.block.1.conv.conv.", (2, 4, 3), gen, s % 2)
            _wn(sd, f"{e}{idx}.block.3.conv.conv.", (4, 2, 1), gen, s % 2)
            _wn(sd, f"{e}{idx}.shortcut.conv.conv.", (4, 4, 1), gen, False)
            idx += 2
            _wn(sd, f"{e}{idx}.conv.conv.", (4, 4, 4), gen, True)
            idx += 1
        for li in range(2):
            p = f"{e}{idx}.lstm."
            sd[p + f"weight_ih_l{li}"] = _rand((16, 4), gen)
            sd[p + f"weight_hh_l{li}"] = _rand((16, 4), gen)
            sd[p + f"bias_ih_l{li}"] = _rand((16,), gen)
            sd[p + f"bias_hh_l{li}"] = _rand((16,), gen)
        _wn(sd, f"{e}{idx + 2}.conv.conv.", (6, 4, 7), gen, False)
    return sd


def test_decoder_and_weight_norm_converters_are_jax_bitwise(tmp_path):
    gen = np.random.default_rng(0)
    for bias in (False, True):
        sd = _make_decoder_sd(DEC_SD_CFG, gen, prefix="_orig_mod.")
        if bias:
            c = DEC_SD_CFG.n_embd
            for i in range(DEC_SD_CFG.n_layer):
                p = f"_orig_mod.transformer.h.{i}"
                for name, n in (("ln_1", c), ("attn.c_attn", 3 * c),
                                ("attn.c_proj", c), ("ln_2", c),
                                ("mlp.c_fc", 4 * c), ("mlp.c_proj", c)):
                    sd[f"{p}.{name}.bias"] = _rand((n,), gen)
            sd["_orig_mod.transformer.ln_f.bias"] = _rand((c,), gen)
        assert_same_tree(
            tconvert.convert_decoder_state_dict(sd, DEC_SD_CFG.n_layer, bias),
            jconvert.convert_decoder_state_dict(sd, DEC_SD_CFG.n_layer, bias))
    path = str(tmp_path / "dec.pt")
    torch.save({"model": sd, "model_args": {"n_layer": 2, "bias": True}},
               path)
    (tp, targs), (jp, jargs) = (tconvert.convert_decoder_ckpt(path),
                                jconvert.convert_decoder_ckpt(path))
    assert targs == jargs
    assert_same_tree(tp, jp)
    sd = {}
    _wn(sd, "a.", (5, 3, 4), gen, False)
    _wn(sd, "b.", (6, 2, 3), gen, True)
    sd["c.weight"] = _rand((2, 2), gen)
    assert_same_tree(tconvert.fold_weight_norm(sd),
                     jconvert.fold_weight_norm(sd))


def test_codec_converters_are_jax_bitwise(tmp_path):
    gen = np.random.default_rng(1)
    sd = _codec_sd(gen)
    assert_same_tree(tconvert.convert_codec_state_dict(sd, n_layers=2),
                     jconvert.convert_codec_state_dict(sd, n_layers=2))
    assert_same_tree(tconvert.convert_seanet_encoder_state_dict(sd),
                     jconvert.convert_seanet_encoder_state_dict(sd))
    path = str(tmp_path / "wt.ckpt")
    # the checkpoint converter reads the deployed 12 ConvNeXt layers
    full = _codec_sd(np.random.default_rng(2), n_layers=12)
    torch.save({"state_dict": full}, path)
    for enc in (True, False):
        assert_same_tree(
            tconvert.convert_wavtokenizer_ckpt(path, with_encoder=enc),
            jconvert.convert_wavtokenizer_ckpt(path, with_encoder=enc))
    no_enc = _codec_sd(np.random.default_rng(3), n_layers=12, encoder=False)
    torch.save({"state_dict": no_enc}, path)
    got = tconvert.convert_wavtokenizer_ckpt(path)
    assert "encoder" not in got
    assert_same_tree(got, jconvert.convert_wavtokenizer_ckpt(path))


def test_byt5_embeddings_are_jax_bitwise():
    gen = np.random.default_rng(4)
    for rows in (384, 386, 400):
        w = _rand((rows, 8), gen)
        got = tconvert.convert_byt5_embeddings(w)
        assert got.shape == (386, 8)
        np.testing.assert_array_equal(got, jconvert.convert_byt5_embeddings(w))


def _tiny_llama(moe: bool):
    from transformers import (LlamaConfig, LlamaForCausalLM, MixtralConfig,
                              MixtralForCausalLM)
    torch.manual_seed(5)
    if moe:
        return MixtralForCausalLM(MixtralConfig(
            vocab_size=64, hidden_size=16, intermediate_size=24,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, max_position_embeddings=64))
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=64, hidden_size=16, intermediate_size=24,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64))


@pytest.mark.parametrize("moe", [False, True])
def test_llama_converter_is_jax_bitwise(moe):
    sd = _tiny_llama(moe).state_dict()
    assert_same_tree(tconvert.convert_llama_state_dict(sd, 2),
                     jconvert.convert_llama_state_dict(sd, 2))


def test_gpt2_import_is_jax_bitwise():
    from transformers import GPT2Config, GPT2LMHeadModel
    torch.manual_seed(6)
    sd = GPT2LMHeadModel(GPT2Config(n_layer=2, n_head=2, n_embd=16,
                                    n_positions=32, vocab_size=50)
                         ).state_dict()
    for head_seed in (0, 3):
        assert_same_tree(
            tgpt2.convert_gpt2_state_dict(sd, 2, 40, head_seed=head_seed),
            jgpt2.convert_gpt2_state_dict(sd, 2, 40, head_seed=head_seed))
    assert tgpt2.GPT2_ARCH == jgpt2.GPT2_ARCH


def _save_t5(path):
    from transformers import T5Config, T5ForConditionalGeneration
    torch.manual_seed(7)
    T5ForConditionalGeneration(T5Config(
        vocab_size=384, d_model=8, d_kv=4, d_ff=16, num_layers=1,
        num_heads=2)).save_pretrained(path)


def _npz(path):
    tree = tparams.load_params_npz(path)
    meta = (tparams.load_meta(path) if os.path.exists(path + ".json")
            else None)
    return tree, meta


@pytest.mark.parametrize("kind", ["decoder", "codec", "byt5", "llama",
                                  "whisper"])
def test_convert_ckpt_cli_writes_what_jax_writes(tmp_path, kind):
    """Each mode of ``python -m llmvox_tpu_torch.tools.convert_ckpt`` on a
    local input writes the npz (arrays and meta) that the JAX CLI writes,
    and JAX's loader reads it."""
    gen = np.random.default_rng(8)
    src = str(tmp_path / "src")
    if kind == "decoder":
        src += ".pt"
        torch.save({"model": _make_decoder_sd(DEC_SD_CFG, gen),
                    "model_args": {"n_layer": 2, "n_head": 2, "n_embd": 32,
                                   "bias": False}}, src)
    elif kind == "codec":
        src += ".ckpt"
        torch.save({"state_dict": _codec_sd(gen, n_layers=12)}, src)
    elif kind == "byt5":
        _save_t5(src)
    elif kind == "llama":
        _tiny_llama(moe=False).save_pretrained(src)
    else:
        from tests.tiny_hf import build_tiny_whisper
        build_tiny_whisper(src)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tconvert_ckpt.main([kind, src, ours])
    jconvert_ckpt.main([kind, src, theirs])
    got, got_meta = _npz(ours)
    want, want_meta = _npz(theirs)
    assert_same_tree(got, want)
    assert got_meta == want_meta
    assert_same_tree(jckpt.load_params_npz(ours), want)
    if kind == "byt5":
        assert got["table"].shape == (386, 8)
