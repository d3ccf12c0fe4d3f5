"""The port's segmented encode/decode (WavCodec.segment_geometry,
encode_frames, decode_frames, linear_overlap_add), the inverse MDCT and
the IMDCT heads, and the ResNet backbone, against the JAX package's on
the same numpy params (the port's seeded initialisers) and inputs, on the
CPU, at tests/test_encodec_frames.py's tiny codec.

Tolerances: the overlap-add and the geometry exactly (the same numpy);
the codes exactly and the scales to 1e-6 relative; a whole SEANet decode
(the frames overlap-added) to rtol 2e-3 / atol 1e-3, the codec tests'
bound for a full decode; the IMDCT, the heads and the backbone to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import backbone as jbb
from llmvox_tpu.codec import codec as jcodec
from llmvox_tpu.codec import heads as jheads
from llmvox_tpu.codec import seanet as jseanet
from llmvox_tpu.ops import istft as jistft
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu_torch.codec import backbone as tbb
from llmvox_tpu_torch.codec import codec as tcodec
from llmvox_tpu_torch.codec import heads as theads
from llmvox_tpu_torch.codec import seanet as tseanet
from llmvox_tpu_torch.ops import istft as tistft
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as tparams

TINY = JCodecConfig(downsamples=(2, 2), n_filters=4, seanet_dimension=16,
                    vq_dim=16, vq_bins=32, backbone_input_channels=16,
                    backbone_dim=32, backbone_intermediate_dim=96,
                    backbone_num_layers=1, n_fft=16, hop_length=4)
TTINY = tconfig.CodecConfig(**{f: getattr(TINY, f) for f in
                               tconfig.CodecConfig.__dataclass_fields__})
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def jax_encoder_compiled():
    """JAX's SEANet encoder compiled once a shape (op by op, as
    ``WavCodec.encode_infer`` calls it, every op compiles)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jseanet, "apply_seanet_encoder",
                  jax.jit(jseanet.apply_seanet_encoder, static_argnums=2))
        yield


@pytest.fixture(scope="module")
def codecs():
    params = tparams.init_codec_params(0, TTINY)
    params["encoder"] = tseanet.init_seanet_encoder(1, TTINY)
    params["seanet_decoder"] = tseanet.init_seanet_decoder(2, TTINY)
    buckets = (8, 16, 32, 64, 128)
    return (jcodec.WavCodec(jax.tree.map(jnp.asarray, params), TINY, buckets),
            tcodec.WavCodec(params, TTINY, buckets, device="cpu"),
            tcodec.WavCodec(params, TTINY, buckets, device="cpu",
                            dtype=torch.float64))


@pytest.mark.parametrize("frames,stride", [(4, 60), (2, 60), (3, 97),
                                           (1, 50)])
def test_linear_overlap_add_matches_jax(frames, stride):
    rng = np.random.default_rng(frames * stride)
    chunks = [rng.standard_normal((2, 100)).astype(np.float32)
              for _ in range(frames - 1)]
    chunks.append(rng.standard_normal((2, 70)).astype(np.float32))
    got = tcodec.linear_overlap_add(chunks, stride)
    np.testing.assert_array_equal(got, jcodec.linear_overlap_add(chunks,
                                                                 stride))
    const = tcodec.linear_overlap_add(
        [np.full((1, 100), 3.0, np.float32)] * 4, 60)
    np.testing.assert_allclose(const, 3.0, rtol=1e-6)


def test_segment_geometry_matches_jax(codecs):
    jc, tc, _ = codecs
    for seg, overlap in ((0.01, 0.25), (0.01, 0.01), (1.0, 0.01),
                         (None, 0.01), (1e-4, 0.999)):
        assert tc.segment_geometry(seg, overlap) == jc.segment_geometry(
            seg, overlap)


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_and_decode_frames_match_jax(codecs, normalize):
    jc, tc, _ = codecs
    wav = (RNG.standard_normal((2, 600)) * 0.3).astype(np.float32)
    seg_s = 240 / TINY.sample_rate
    want = jc.encode_frames(wav, segment_s=seg_s, overlap=0.25,
                            normalize=normalize)
    got = tc.encode_frames(wav, segment_s=seg_s, overlap=0.25,
                           normalize=normalize)
    assert len(got) == len(want) == 4
    for (gc, gs), (wc, ws) in zip(got, want):
        np.testing.assert_array_equal(gc, np.asarray(wc))
        if normalize:
            np.testing.assert_allclose(gs, ws, rtol=1e-6)
            assert gs.shape == (2, 1)
        else:
            assert gs is None and ws is None
    # the same frames through both decoders
    out = tc.decode_frames(want, segment_s=seg_s, overlap=0.25)
    ref = jc.decode_frames(want, segment_s=seg_s, overlap=0.25)
    assert out.shape == ref.shape and out.shape[1] >= wav.shape[1]
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=1e-3)


def test_whole_signal_frame_f64_and_refusal(codecs):
    """One frame for the whole signal; the f64 codec (the card's referee
    in chip_smoke.py) gives f32's codes and its decode to 1e-5 of the
    peak; decoding without SEANet decoder weights is refused."""
    jc, tc, tc64 = codecs
    wav = (RNG.standard_normal((1, 333)) * 0.3).astype(np.float32)
    got = tc.encode_frames(wav)
    want = jc.encode_frames(wav)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0][0], np.asarray(want[0][0]))
    np.testing.assert_allclose(tc.decode_frames(got), jc.decode_frames(want),
                               rtol=2e-3, atol=1e-3)
    got64 = tc64.encode_frames(wav)
    np.testing.assert_array_equal(got64[0][0], got[0][0])
    y32, y64 = tc.decode_frames(got), tc64.decode_frames(got)
    assert np.abs(y32 - y64).max() <= 1e-5 * np.abs(y64).max()
    assert tc64.params["codebooks"].dtype == torch.float64
    bare = tcodec.WavCodec(tparams.init_codec_params(0, TTINY), TTINY,
                           device="cpu")
    with pytest.raises(ValueError, match="decoder"):
        bare.decode_frames([(np.zeros((1, 4), np.int32), None)])


@pytest.mark.parametrize("frame_len,padding", [(64, "same"), (32, "same"),
                                               (64, "center")])
def test_imdct_matches_jax(frame_len, padding):
    x = RNG.standard_normal((2, 9, frame_len // 2)).astype(np.float32)
    got = tistft.imdct(torch.from_numpy(x), frame_len=frame_len,
                       padding=padding)
    want = jistft.imdct(jnp.asarray(x), frame_len=frame_len, padding=padding)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(tistft.cosine_window(frame_len),
                                  jistft.cosine_window(frame_len))


@pytest.mark.parametrize("head", ["symexp", "symexp_mel", "cos"])
def test_imdct_heads_match_jax(head):
    dim, frame_len = 16, 32
    x = (RNG.standard_normal((2, 7, dim)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(0)
    if head == "cos":
        p = tparams.init_imdct_cos_head(3, dim, frame_len)
        shape = jax.eval_shape(lambda: jheads.init_imdct_cos_head(
            key, dim, frame_len))
        tfn, jfn = theads.apply_imdct_cos_head, jheads.apply_imdct_cos_head
    else:
        sr = 24000 if head == "symexp_mel" else None
        p = tparams.init_imdct_symexp_head(3, dim, frame_len, sr)
        shape = jax.eval_shape(lambda: jheads.init_imdct_symexp_head(
            key, dim, frame_len, sr))
        tfn = theads.apply_imdct_symexp_head
        jfn = jheads.apply_imdct_symexp_head
    assert jax.tree.map(lambda a: a.shape, shape) == jax.tree.map(
        lambda a: a.shape, p)
    for clip in (False, True):
        got = tfn(tparams.to_torch(p, "cpu"), torch.from_numpy(x), frame_len,
                  clip_audio=clip)
        want = jfn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), frame_len,
                   clip_audio=clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_resnet_backbone_matches_jax():
    dim, cin, num_blocks = 12, 8, 2
    p = tparams.init_resnet_backbone(5, cin, dim, num_blocks)
    shape = jax.eval_shape(lambda: jbb.init_resnet_backbone(
        jax.random.PRNGKey(0), cin, dim, num_blocks))
    assert jax.tree.map(lambda a: a.shape, shape) == jax.tree.map(
        lambda a: a.shape, p)
    assert float(p["blocks"][0]["gamma"][0][0]) == np.float32(1 / 6)
    x = RNG.standard_normal((2, 17, cin)).astype(np.float32)
    got = tbb.apply_resnet_backbone(tparams.to_torch(p, "cpu"),
                                    torch.from_numpy(x))
    want = jbb.apply_resnet_backbone(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
