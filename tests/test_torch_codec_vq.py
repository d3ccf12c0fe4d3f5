"""The port's codec encoder and EMA VQ (llmvox_tpu_torch/codec/vq.py's
nearest_code, WavCodec.encode_infer, train/vq_train.py) against the JAX
package's, in f32 on the CPU, with JAX's own draws passed in: k-means on
both branches, the straight-through step, dead-code expiry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import codec as jcodec
from llmvox_tpu.codec import vq as jvq
from llmvox_tpu.train import vq_train as jvt
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu_torch.codec import codec as tcodec
from llmvox_tpu_torch.codec import vq as tvq
from llmvox_tpu_torch.train import vq_train as tvt
from llmvox_tpu_torch.utils.config import CodecConfig as TCodecConfig
from llmvox_tpu_torch.codec.seanet import init_seanet_encoder
from llmvox_tpu_torch.utils.params import (init_codec_params, vq_from_numpy,
                                           vq_to_numpy)

ENC_CFG = JCodecConfig(downsamples=(2, 2), n_filters=4, seanet_dimension=16,
                       vq_dim=16, vq_bins=32, backbone_input_channels=16,
                       backbone_dim=64, backbone_intermediate_dim=96,
                       backbone_num_layers=2, n_fft=16, hop_length=4)


def _tcfg(jcfg):
    return TCodecConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TCodecConfig)})


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _jax_draws(key, n, bins):
    """The rows JAX's vq_train_step draws from ``key``: k-means' initial
    rows and the dead codes' replacements."""
    if n >= bins:
        init = jax.random.permutation(key, n)[:bins]
    else:
        init = jax.random.randint(key, (bins,), 0, n)
    dead = jax.random.randint(jax.random.fold_in(key, 1), (bins,), 0, n)
    return (torch.from_numpy(np.array(init)).long(),
            torch.from_numpy(np.array(dead)).long())


def _state_close(t, j, atol=1e-5):
    tn, jn = vq_to_numpy(t), vq_to_numpy(j._asdict())
    assert set(tn) == set(jn)
    for k in tn:
        np.testing.assert_allclose(tn[k], jn[k], atol=atol, rtol=1e-5,
                                   err_msg=k)


def _clustered(rng, n, dim, centers=6):
    """Vectors around a few centres, so k-means has clusters to find and
    no assignment is a near tie."""
    c = _rand(rng, (centers, dim), 3.0)
    return c[rng.integers(0, centers, n)] + _rand(rng, (n, dim), 0.3)


# ---------------------------------------------------------------------------
# nearest_code and encode_infer
# ---------------------------------------------------------------------------

def test_nearest_code_matches_jax_ties_to_the_first_index():
    rng = np.random.default_rng(0)
    book = _rand(rng, (40, 8))
    book[7] = book[3]           # an exact duplicate: the tie goes to 3
    x = _rand(rng, (2, 9, 8))
    x[1, 4] = book[3]
    got = tvq.nearest_code(torch.from_numpy(book), torch.from_numpy(x))
    want = jvq.nearest_code(jnp.asarray(book), jnp.asarray(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1, 4]) == 3


def test_encode_infer_matches_jax_and_needs_the_encoder():
    params = init_codec_params(0, _tcfg(ENC_CFG))
    params["encoder"] = init_seanet_encoder(1, _tcfg(ENC_CFG))
    wav = _rand(np.random.default_rng(1), (2, 203), 0.3)
    jc = jcodec.WavCodec(params, ENC_CFG)
    tc = tcodec.WavCodec(params, _tcfg(ENC_CFG), device="cpu", graphs=False)
    jf, jcodes = jc.encode_infer(wav)
    tf, tcodes = tc.encode_infer(wav)
    assert tcodes.shape == (2, 51) and tcodes.dtype == np.int32
    np.testing.assert_array_equal(tcodes, np.asarray(jcodes))
    np.testing.assert_allclose(tf, np.asarray(jf), atol=1e-5, rtol=1e-5)
    no_enc = {k: v for k, v in params.items() if k != "encoder"}
    with pytest.raises(ValueError, match="encoder"):
        jcodec.WavCodec(no_enc, ENC_CFG).encode_infer(wav)
    with pytest.raises(ValueError, match="encoder"):
        tcodec.WavCodec(no_enc, _tcfg(ENC_CFG), device="cpu",
                        graphs=False).encode_infer(wav)


# ---------------------------------------------------------------------------
# k-means and the training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [96, 12])
def test_kmeans_matches_jax_on_both_branches(n):
    """n >= bins draws a permutation, n < bins draws with replacement
    (duplicate means: their ties go to the first index on both sides)."""
    rng = np.random.default_rng(2)
    bins, dim = 16, 4
    data = _clustered(rng, n, dim)
    key = jax.random.PRNGKey(3)
    init_idx, _ = _jax_draws(key, n, bins)
    jm, jc = jvt.kmeans(key, jnp.asarray(data), bins, 7)
    tm, tc = tvt.kmeans(torch.from_numpy(data), bins, 7, init_idx)
    assert tm.shape == (bins, dim)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_vq_train_steps_match_jax_through_init_and_expiry():
    """Three passes with JAX's draws: the k-means init on the first batch,
    then the EMA with dead codes expiring (the codebook has more codes
    than the batch fills), against JAX's state, codes, commitment and
    straight-through output."""
    rng = np.random.default_rng(4)
    bins, dim = 32, 6
    jstate = jvt.init_vq_state(jax.random.PRNGKey(0), bins, dim)
    tstate = vq_from_numpy(jax.device_get(jstate), "cpu")
    assert not bool(tstate.inited)
    expired_seen = 0
    for step in range(3):
        x = _clustered(rng, 80, dim)
        key = jax.random.PRNGKey(10 + step)
        init_idx, dead_idx = _jax_draws(key, 80, bins)
        jstate_in = jstate
        jq, jcodes, jcommit, jstate = jvt.vq_train_step(
            jstate, jnp.asarray(x), key, kmeans_iters=4)
        xt = torch.from_numpy(x).requires_grad_(True)
        tq, tcodes, tcommit, tstate = tvt.vq_train_step(
            tstate, xt, init_idx, dead_idx, kmeans_iters=4)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tcommit.detach()), float(jcommit),
                                   rtol=1e-5)
        _state_close(tstate, jstate)
        expired_seen += int((np.asarray(jstate.cluster_size) == 2.0).sum())
        # the straight-through gradient and the commitment's
        (tq.sum() + tcommit).backward()
        jg = jax.grad(lambda v, s=jstate_in: (
            lambda out: jnp.sum(out[0]) + out[2])(jvt.vq_train_step(
                s, v, key, kmeans_iters=4)))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                                   atol=1e-7)
    assert bool(tstate.inited)
    assert expired_seen > 0


def test_vq_infer_ignores_inited_as_jax():
    rng = np.random.default_rng(5)
    jstate = jvt.init_vq_state(jax.random.PRNGKey(1), 16, 4)
    tstate = vq_from_numpy(jax.device_get(jstate), "cpu")
    x = _rand(rng, (30, 4))
    jq, jc = jvt.vq_infer(jstate, jnp.asarray(x))
    tq, tc = tvt.vq_infer(tstate, torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq))


def test_draw_indices_branches_and_distribution():
    g = torch.Generator()
    g.manual_seed(0)
    init, dead = tvt.draw_indices(g, 100, 32)
    assert init.shape == dead.shape == (32,)
    assert len(set(init.tolist())) == 32          # a permutation's rows
    init, _ = tvt.draw_indices(g, 5, 32)
    assert init.shape == (32,) and int(init.max()) < 5
    # uniform over the rows, as JAX's randint
    counts = np.bincount(np.concatenate([tvt.draw_indices(g, 7, 64)[1].numpy()
                                         for _ in range(200)]), minlength=7)
    assert counts.min() > 0.8 * counts.mean()
    # the uninitialised codebook is uniform(-1, 1)
    st = tvt.init_vq_state(3, 64, 8)
    assert float(st.embed.abs().max()) <= 1.0
    assert abs(float(st.embed.mean())) < 0.05
    assert torch.equal(st.embed, st.embed_avg) and not bool(st.inited)
