"""The port's codec decode path (llmvox_tpu_torch/codec) against the JAX
codec, in f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import backbone as jbb
from llmvox_tpu.codec import codec as jcodec
from llmvox_tpu.codec import heads as jheads
from llmvox_tpu.codec import vq as jvq
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu_torch.codec import backbone as tbb
from llmvox_tpu_torch.codec import codec as tcodec
from llmvox_tpu_torch.codec import heads as thead
from llmvox_tpu_torch.codec import vq as tvq
from llmvox_tpu_torch.utils import params as tparams
from llmvox_tpu_torch.utils.config import CodecConfig as TCodecConfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.tiny_stack import CODEC_CFG

TCFG = TCodecConfig(**{k: getattr(CODEC_CFG, k)
                       for k in TCodecConfig.__dataclass_fields__})
CODEC_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def params():
    """The JAX init with noise on every leaf, so unit norms and zero
    biases do not hide a wrong term."""
    rng = np.random.default_rng(21)
    p = jax.device_get(jcodec.init_codec_params(jax.random.PRNGKey(21),
                                                CODEC_CFG))
    return jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        p)


def _codes(rng, b, l, bins):
    return rng.integers(0, bins, (b, l)).astype(np.int32)


def test_codes_to_features(params):
    codes = _codes(np.random.default_rng(0), 2, 9, CODEC_CFG.vq_bins)
    ref = jvq.codes_to_features(jnp.asarray(params["codebooks"]),
                                jnp.asarray(codes))
    got = tvq.codes_to_features(torch.from_numpy(params["codebooks"]),
                                torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("valid_len", [None, 7])
def test_apply_backbone(params, valid_len):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(
        (1, 11, CODEC_CFG.backbone_input_channels)).astype(np.float32)
    ref = jbb.apply_backbone(
        jax.tree.map(jnp.asarray, params["backbone"]), jnp.asarray(feats),
        jnp.int32(1), CODEC_CFG,
        None if valid_len is None else jnp.int32(valid_len))
    got = tbb.apply_backbone(to_torch(params["backbone"], "cpu"),
                             torch.from_numpy(feats), 1, TCFG, valid_len)
    keep = valid_len or 11
    np.testing.assert_allclose(got.numpy()[:, :keep],
                               np.asarray(ref)[:, :keep], atol=1e-4)


def test_apply_istft_head(params):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 10, CODEC_CFG.backbone_dim)).astype(
        np.float32) * 0.3
    ref = jheads.apply_istft_head(jax.tree.map(jnp.asarray, params["head"]),
                                  jnp.asarray(x), CODEC_CFG, jnp.int32(8))
    got = thead.apply_istft_head(to_torch(params["head"], "cpu"),
                                 torch.from_numpy(x), TCFG, 8)
    keep = 8 * CODEC_CFG.hop_length
    np.testing.assert_allclose(got.numpy()[:, :keep],
                               np.asarray(ref)[:, :keep], atol=1e-4)


def test_wavcodec_decode_codes_matches_jax(params):
    codes = _codes(np.random.default_rng(3), 1, 11, CODEC_CFG.vq_bins)
    ref = jcodec.WavCodec(params, CODEC_CFG, buckets=(8, 16)).decode_codes(
        codes)
    got = tcodec.WavCodec(params, TCFG, buckets=(8, 16),
                          device="cpu").decode_codes(codes)
    assert got.shape == ref.shape == (1, 11 * CODEC_CFG.hop_length)
    np.testing.assert_allclose(got, ref, **CODEC_TOL)


def test_bucket_padding_matches_exact_length(params):
    codec = tcodec.WavCodec(params, TCFG, buckets=(8, 16), device="cpu")
    codes = _codes(np.random.default_rng(4), 1, 11, CODEC_CFG.vq_bins)
    padded = codec.decode_codes(codes)                  # 11 -> bucket 16
    exact = codec.decode_codes(codes, pad_to_bucket=False)
    assert padded.shape == exact.shape
    np.testing.assert_allclose(padded, exact, atol=1e-5, rtol=1e-5)


def test_decode_codes_at_deployed_config():
    """16 codes through the deployed codec (dim 768, 12 ConvNeXt layers,
    n_fft 1280, hop 320), with the port's numpy initialiser's weights."""
    jcfg, tcfg = JCodecConfig(), TCodecConfig()
    p = tparams.init_codec_params(5, tcfg)
    codes = _codes(np.random.default_rng(5), 1, 16, tcfg.vq_bins)
    ref = jcodec._decode_codes(jax.tree.map(jnp.asarray, p),
                               jnp.asarray(codes), jnp.int32(0),
                               jnp.int32(16), jcfg)
    got = tcodec._decode_codes(to_torch(p, "cpu"), torch.from_numpy(codes),
                               0, 16, tcfg)
    assert got.shape == (1, 16 * 320)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CODEC_TOL)


def test_golden_codec_waveform():
    """The JAX package's golden anchor (tests/test_golden.py) reached by
    the port on the same seed-7 parameters, at the golden tolerance."""
    from tests.test_golden import GOLD_WAV_64_72
    p = jax.device_get(jcodec.init_codec_params(jax.random.PRNGKey(7),
                                                CODEC_CFG))
    codec = tcodec.WavCodec(p, TCFG, buckets=(8,), device="cpu")
    codes = np.arange(8, dtype=np.int32)[None] % CODEC_CFG.vq_bins
    wav = codec.decode_codes(codes, pad_to_bucket=False)
    assert wav.shape == (1, 8 * CODEC_CFG.hop_length)
    np.testing.assert_allclose(wav[0, 64:72], GOLD_WAV_64_72,
                               atol=1e-6, rtol=1e-5)
