"""The port's weight bridge and initialisers (llmvox_tpu_torch/utils/params)
against the JAX package's checkpoint files and init trees, and the rule
that the port imports neither JAX nor the JAX package."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import init_codec_params as j_init_codec
from llmvox_tpu.models.decoder import init_decoder_params as j_init_decoder
from llmvox_tpu.train.checkpoint import save_params_npz
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as tparams

from tests.tiny_stack import CODEC_CFG, DEC_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/#{i}")
    else:
        yield prefix, tree


def test_npz_round_trip_through_the_jax_checkpoint_writer(tmp_path):
    rng = np.random.default_rng(41)
    tree = jax.device_get(j_init_decoder(jax.random.PRNGKey(41), DEC_CFG))
    tree["blocks"] = [{"w": rng.standard_normal((3, 2)).astype(np.float32)},
                      {"w": rng.standard_normal((3, 2)).astype(np.float32)}]
    tree["steps"] = np.arange(5, dtype=np.int32)
    path = str(tmp_path / "ckpt.npz")
    save_params_npz(path, tree, meta={"model_args": {"n_layer": 2}})

    loaded = tparams.load_params_npz(path)
    assert tparams.load_meta(path) == {"model_args": {"n_layer": 2}}
    want, got = list(_leaves(tree)), list(_leaves(loaded))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)

    tt = tparams.to_torch(loaded, "cpu", torch.bfloat16)
    for (_, a), (_, t) in zip(want, _leaves(tt)):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(), torch.tensor(a).bfloat16().float())
        else:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), a)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in _leaves(tree)}


@pytest.mark.parametrize("deployed", [False, True])
def test_initialisers_match_the_jax_trees(deployed):
    """Same keys and shapes as the JAX initialisers, at the tiny and the
    deployed configs (the JAX side only traced, never materialised)."""
    jd = JDecoderConfig() if deployed else DEC_CFG
    jc = JCodecConfig() if deployed else CODEC_CFG
    td = tconfig.DecoderConfig(**{k: getattr(jd, k) for k in
                                  tconfig.DecoderConfig.__dataclass_fields__})
    tc = tconfig.CodecConfig(**{k: getattr(jc, k) for k in
                                tconfig.CodecConfig.__dataclass_fields__})
    key = jax.random.PRNGKey(0)
    jdec = jax.eval_shape(lambda: j_init_decoder(key, jd))
    jcod = jax.eval_shape(lambda: j_init_codec(key, jc))
    assert _shapes(tparams.init_decoder_params(0, td)) == _shapes(jdec)
    assert _shapes(tparams.init_codec_params(0, tc)) == _shapes(jcod)


def test_initialiser_distributions():
    cfg = tconfig.DecoderConfig()
    p = tparams.init_decoder_params(3, cfg)
    assert abs(p["h"]["wqkv"].std() - 0.02) < 1e-3
    assert abs(p["h"]["wo"].std() - 0.02 / np.sqrt(2 * cfg.n_layer)) < 1e-3
    c = tparams.init_codec_params(3, tconfig.CodecConfig())
    w = c["backbone"]["convnext"]["pw1_w"]
    assert np.abs(w).max() <= 0.04 + 1e-7           # truncated at 2 std
    assert (c["backbone"]["convnext"]["gamma"] == 1.0 / 12).all()
    # same seed, same weights
    np.testing.assert_array_equal(
        tparams.init_decoder_params(3, cfg)["head"], p["head"])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of llmvox_tpu_torch, chip_smoke.py and the tests'
    rank helpers (a rank is a fresh interpreter with the port only)
    import in a fresh interpreter where importing jax or llmvox_tpu
    raises."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "llmvox_tpu"):
            sys.modules[name] = None   # any import of them now raises
        import llmvox_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            llmvox_tpu_torch.__path__, "llmvox_tpu_torch.")]
        for n in ("serve.pool", "serve.batch", "ops.cuda_batched_attn",
                  "serve.spec_control", "ops.cuda_verify_attn", "ops.quant",
                  "ops.cuda_int4_mm", "models.llama", "streams.llm",
                  "streams.hf_llm", "models.whisper", "codec.mel",
                  "streams.asr", "streams.remote", "streams.hf_vlm",
                  "streams.hf_multimodal", "serve.demo_page", "utils.audio",
                  "tools.convert", "tools.convert_ckpt", "train.data",
                  "train.optim", "train.checkpoint", "train.trainer",
                  "train.__main__", "models.gpt2_import", "utils.logging",
                  "codec.seanet", "codec.discriminators", "codec.losses",
                  "train.vq_train", "train.codec_trainer", "train.codec_data",
                  "train.codec_main", "tools.prepare_data",
                  "tools.copy_synthesis", "utils.native", "codec.pesq",
                  "codec.stoi", "codec.metrics", "codec.eval",
                  "codec.utmos", "codec.entropy", "codec.lm",
                  "codec.compress", "parallel", "parallel.mesh",
                  "parallel.sharding", "parallel.launch",
                  "parallel.tensor_parallel", "utils.runtime",
                  "tools.validate_parity", "serve.ui", "ops.ring_attention",
                  "models.llama_pp"):
            assert "llmvox_tpu_torch." + n in names, n
        for n in names + ["chip_smoke", "tests.torch_dp_ranks",
                          "tests.torch_tp_ranks", "tests.torch_sp_ranks",
                          "tests.torch_ep_ranks", "tests.torch_pp_ranks",
                          "tests.torch_ckpt_ranks"]:
            importlib.import_module(n)
        bad = [m for m, v in sys.modules.items() if v is not None and (
            m in ("jax", "jaxlib", "llmvox_tpu")
            or m.startswith(("jax.", "jaxlib.", "llmvox_tpu.")))]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
