"""The port's codec-training ops (llmvox_tpu_torch/ops/nn.py's convs and
weight norm, codec/mel.py, codec/seanet.py, codec/discriminators.py,
codec/losses.py) against the JAX package's, in f32 on the CPU, on the same
numpy inputs drawn from a seed: layouts at non-square shapes, every
feature map, and gradients against ``jax.grad``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec import discriminators as jdisc
from llmvox_tpu.codec import losses as jlosses
from llmvox_tpu.codec import mel as jmel
from llmvox_tpu.codec import seanet as jseanet
from llmvox_tpu.ops import nn as jnn
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu_torch.codec import discriminators as tdisc
from llmvox_tpu_torch.codec import losses as tlosses
from llmvox_tpu_torch.codec import mel as tmel
from llmvox_tpu_torch.codec import seanet as tseanet
from llmvox_tpu_torch.ops import nn as tnn
from llmvox_tpu_torch.utils.config import CodecConfig as TCodecConfig

SEANET_CFG = JCodecConfig(downsamples=(2, 3), n_filters=4,
                          seanet_dimension=16, seanet_n_residual_layers=2)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _tree(tree, grad=False):
    return jax.tree.map(lambda x: _t(x, grad), tree)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=1e-5, rtol=1e-5, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _tcfg(jcfg):
    return TCodecConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TCodecConfig)})


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _grads_close(tleaves, jgrads, tol=1e-4, what=""):
    """Each gradient tensor within ``tol`` of its largest element."""
    for i, (t, j) in enumerate(zip(tleaves, jax.tree.leaves(jgrads))):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-30)
        err = float(np.abs(_np(t.grad) - j).max())
        assert err <= tol * scale, (what, i, err, scale)


# ---------------------------------------------------------------------------
# ops/nn.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 3])
def test_conv1d_transpose_takes_jax_kernel_layout(stride):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, (2, 9, 5)), _rand(rng, (4, 3, 5)), _rand(rng, (3,))
    want = jnn.conv1d_transpose(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), stride=stride)
    got = tnn.conv1d_transpose(_t(x), _t(w), _t(b), stride=stride)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("case", [
    dict(stride=(3, 1), padding=(2, 0), kshape=(5, 1)),
    dict(stride=(2, 1), padding=[(1, 3), (0, 2)], kshape=(3, 2)),
    dict(stride=(1, 2), padding=(1, 4), kshape=(3, 9), groups=2),
])
def test_conv2d_is_nhwc_hwio_at_non_square_shapes(case):
    rng = np.random.default_rng(1)
    groups = case.get("groups", 1)
    x = _rand(rng, (2, 13, 7, 4))
    w = _rand(rng, (*case["kshape"], 4 // groups, 6))
    b = _rand(rng, (6,))
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=case["stride"], padding=case["padding"],
                      groups=groups)
    got = tnn.conv2d(_t(x), _t(w), _t(b), stride=case["stride"],
                     padding=case["padding"], groups=groups)
    assert got.shape == want.shape
    _close(got, want)


def test_conv2d_kernel_dilation_matches_lax():
    rng = np.random.default_rng(2)
    x, w = _rand(rng, (1, 11, 17, 2)), _rand(rng, (3, 9, 2, 5))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(1, 2),
        padding=[(2, 2), (4, 4)], rhs_dilation=(2, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    got = tnn.conv2d(_t(x), _t(w), stride=(1, 2), padding=(2, 4),
                     rhs_dilation=(2, 1))
    _close(got, want)


def test_weight_norm_and_leaky_relu_match_jax():
    rng = np.random.default_rng(3)
    w = _rand(rng, (3, 4, 5, 6))
    jp = jnn.weight_norm_init(jnp.asarray(w))
    tp = tnn.weight_norm_init(_t(w))
    _close(tp["g"], jp["g"])
    jp = {"g": jnp.asarray(_rand(rng, (1, 1, 1, 6))), "v": jp["v"]}
    _close(tnn.effective_weight({"g": _t(jp["g"]), "v": _t(w)}),
           jnn.effective_weight(jp))
    zero = {"g": _t(np.ones((1, 6))), "v": torch.zeros(4, 6)}
    assert torch.isfinite(tnn.effective_weight(zero)).all()
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
    _close(tnn.leaky_relu(_t(x), 0.1), jnn.leaky_relu(jnp.asarray(x), 0.1))
    # the gradient at 0 is 1 on both sides
    xt = _t(x, grad=True)
    tnn.leaky_relu(xt, 0.1).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnn.leaky_relu(v, 0.1)))(jnp.asarray(x))
    _close(xt.grad, jg)


# ---------------------------------------------------------------------------
# codec/mel.py
# ---------------------------------------------------------------------------

def test_spectrogram_mel_and_safe_log_match_jax():
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 3000), 0.3)
    for kw in (dict(n_fft=256, hop_length=64),
               dict(n_fft=512, hop_length=128, win_length=384,
                    windowed=False),
               dict(n_fft=256, hop_length=64, power=2.0)):
        _close(tmel.spectrogram(_t(x), **kw),
               jmel.spectrogram(jnp.asarray(x), **kw), atol=2e-4, rtol=1e-4)
    _close(tmel.mel_spectrogram(_t(x)), jmel.mel_spectrogram(jnp.asarray(x)),
           atol=2e-4, rtol=1e-4)
    s = np.array([0.0, 1e-9, 1e-7, 0.5], np.float32)
    _close(tmel.safe_log(_t(s)), jmel.safe_log(jnp.asarray(s)))


@pytest.mark.parametrize("padding", ["center", "same"])
def test_mel_features_match_jax(padding):
    x = _rand(np.random.default_rng(5), (2, 4000), 0.3)
    got = tmel.mel_spectrogram_features(_t(x), padding=padding)
    want = jmel.mel_spectrogram_features(jnp.asarray(x), padding=padding)
    assert got.shape == want.shape
    _close(got, want, atol=1e-3, rtol=1e-4)


# ---------------------------------------------------------------------------
# codec/seanet.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,left,right", [(9, 3, 4), (4, 2, 7),
                                               (3, 5, 1)])
def test_pad_reflect_on_a_middle_axis_matches_numpy(length, left, right):
    x = _rand(np.random.default_rng(6), (2, length, 3))
    want = np.pad(x, ((0, 0), (left, right), (0, 0)), mode="reflect")
    _close(tseanet.pad_reflect(_t(x), left, right), want, atol=0, rtol=0)
    x4 = _rand(np.random.default_rng(7), (2, length, 2, 1))
    want4 = np.pad(x4, ((0, 0), (left, right), (0, 0), (0, 0)),
                   mode="reflect")
    _close(tseanet.pad_reflect(_t(x4), left, right), want4, atol=0, rtol=0)


def test_sconv_padding_and_sconv1d_match_jax():
    rng = np.random.default_rng(8)
    for length, k, stride, dil in ((17, 7, 1, 1), (23, 6, 3, 1),
                                   (30, 3, 1, 4), (11, 16, 8, 1)):
        assert (tseanet.sconv_padding(length, k, stride, dil) ==
                jseanet._sconv_padding(length, k, stride, dil))
        x = _rand(rng, (2, length, 3))
        p = {"g": _rand(rng, (1, 1, 5)), "v": _rand(rng, (k, 3, 5)),
             "b": _rand(rng, (5,))}
        _close(tseanet.sconv1d(_t(x), _tree(p), stride=stride,
                               dilation=dil),
               jseanet.sconv1d(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               stride=stride, dilation=dil))


def test_lstm_layer_matches_jax_scan_and_its_gradient():
    rng = np.random.default_rng(9)
    h = 6
    p = {"wi": _rand(rng, (h, 4 * h), 0.4), "wh": _rand(rng, (h, 4 * h), 0.4),
         "bi": _rand(rng, (4 * h,), 0.2), "bh": _rand(rng, (4 * h,), 0.2)}
    x = _rand(rng, (3, 11, h))
    want = jseanet._lstm_layer(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _tree(p, grad=True)
    got = tseanet.lstm_layer(tp, _t(x))
    _close(got, want)
    cot = _rand(rng, want.shape)
    (got * _t(cot)).sum().backward()
    jg = jax.grad(lambda q: jnp.sum(jseanet._lstm_layer(q, jnp.asarray(x)) *
                                    cot))(jax.tree.map(jnp.asarray, p))
    for k in p:
        _close(tp[k].grad, jg[k], atol=1e-5, rtol=1e-4, what=k)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_seanet_encoder_and_decoder_match_jax(weight_norm):
    """Biases randomized so a bias bug cannot hide; the tolerance of
    tests/test_seanet.py."""
    rng = np.random.default_rng(10)
    cfg = SEANET_CFG

    def jitter(tree):
        return jax.tree.map(lambda x: np.asarray(x) + 0.05 * _rand(
            rng, np.shape(x)), tree)

    enc = jitter(tseanet.init_seanet_encoder(0, _tcfg(cfg), weight_norm))
    dec = jitter(tseanet.init_seanet_decoder(1, _tcfg(cfg), weight_norm))
    wav = _rand(rng, (2, 150))
    want = jseanet.apply_seanet_encoder(jax.tree.map(jnp.asarray, enc),
                                        jnp.asarray(wav), cfg)
    got = tseanet.apply_seanet_encoder(_tree(enc), _t(wav), _tcfg(cfg))
    assert got.shape == want.shape == (2, 25, 16)
    _close(got, want, atol=2e-4, rtol=1e-3)
    z = _rand(rng, (2, 5, 16))
    want = jseanet.apply_seanet_decoder(jax.tree.map(jnp.asarray, dec),
                                        jnp.asarray(z), cfg)
    got = tseanet.apply_seanet_decoder(_tree(dec), _t(z), _tcfg(cfg))
    assert got.shape == want.shape
    _close(got, want, atol=2e-4, rtol=1e-3)


def test_initialisers_have_jax_trees_and_distributions():
    """Keys, shapes and bounds equal to the JAX initialisers'; the values
    are numpy's draws."""
    cfg = SEANET_CFG
    key = jax.random.PRNGKey(0)
    for jfn, tfn in ((jseanet.init_seanet_encoder,
                      tseanet.init_seanet_encoder),
                     (jseanet.init_seanet_decoder,
                      tseanet.init_seanet_decoder)):
        for wn in (False, True):
            j = jax.eval_shape(lambda: jfn(key, cfg, weight_norm=wn))
            t = tfn(0, _tcfg(cfg), weight_norm=wn)
            assert jax.tree.structure(j) == jax.tree.structure(t)
            for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(t)):
                assert a.shape == b.shape and b.dtype == np.float32
    enc = tseanet.init_seanet_encoder(0, _tcfg(cfg), weight_norm=True)
    conv = enc["stages"][1]["down"]
    bound = np.sqrt(1.0 / np.prod(conv["v"].shape[:-1]))
    assert 0.9 * bound < np.abs(conv["v"]).max() <= bound
    assert not conv["b"].any()
    wh = enc["lstm"][0]["wh"]
    bound = 1 / np.sqrt(wh.shape[0])
    assert 0.9 * bound < np.abs(wh).max() <= bound
    periods, res, ffts = (2, 3), ((256, 64, 256),), (512,)
    key = jax.random.PRNGKey(1)
    for j, t in (
            (lambda: jdisc.init_mpd(key, periods), tdisc.init_mpd(1, periods)),
            (lambda: jdisc.init_mrd(key, res), tdisc.init_mrd(2, res)),
            (lambda: jdisc.init_dac(key, periods, ffts),
             tdisc.init_dac(3, periods, ffts)),
            (lambda: jdisc.init_msstft(key, (256,)),
             tdisc.init_msstft(4, (256,)))):
        j = jax.eval_shape(j)
        assert jax.tree.structure(j) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(t)):
            assert a.shape == b.shape and b.dtype == np.float32
    # every kernel within its fan-in bound, the gains its norm
    conv = t[0]["convs"][1]
    bound = np.sqrt(1.0 / np.prod(conv["v"].shape[:-1]))
    assert np.abs(conv["v"]).max() <= bound
    assert np.abs(conv["v"]).max() > 0.9 * bound
    np.testing.assert_allclose(conv["g"], np.sqrt(np.sum(
        conv["v"] ** 2, axis=(0, 1, 2), keepdims=True)), rtol=1e-6)
    # the seed fixes the draw
    a, b = tdisc.init_mpd(5, periods), tdisc.init_mpd(5, periods)
    np.testing.assert_array_equal(a[1]["convs"][2]["v"], b[1]["convs"][2]["v"])


# ---------------------------------------------------------------------------
# codec/discriminators.py and codec/losses.py
# ---------------------------------------------------------------------------

def _jitter_disc(tree, rng):
    """Random biases and gains, so every term is exercised."""
    return jax.tree.map(lambda x: np.asarray(x) * (
        1.0 + 0.1 * _rand(rng, np.shape(x))) + 0.02 * _rand(
            rng, np.shape(x)), tree)


def _family_case(name, rng):
    """(params, jax fn, torch fn) of one discriminator family, each fn
    (params, audio) -> list of score and feature tensors."""
    if name == "mpd":
        p = _jitter_disc(tdisc.init_mpd(0, (3,))[0], rng)

        def jf(q, x):
            s, f = jdisc.apply_discriminator_p(q, x, 3)
            return [s, *f]

        def tf(q, x):
            s, f = tdisc.apply_discriminator_p(q, x, 3)
            return [s, *f]
    elif name == "mrd":
        p = _jitter_disc(tdisc.init_mrd(0, ((256, 64, 256),))[0], rng)

        def jf(q, x):
            s, f = jdisc.apply_discriminator_r(q, x, (256, 64, 192))
            return [s, *f]

        def tf(q, x):
            s, f = tdisc.apply_discriminator_r(q, x, (256, 64, 192))
            return [s, *f]
    elif name == "dac":
        p = _jitter_disc(tdisc.init_dac(0, (5,), (256,)), rng)

        def jf(q, x):
            return [m for f in jdisc.apply_dac(q, x, (5,), (256,)) for m in f]

        def tf(q, x):
            return [m for f in tdisc.apply_dac(q, x, (5,), (256,)) for m in f]
    else:
        p = _jitter_disc(tdisc.init_msstft(0, (256,))[0], rng)

        def jf(q, x):
            s, f = jdisc.apply_msstft_one(q, x, 256)
            return [s, *f]

        def tf(q, x):
            s, f = tdisc.apply_msstft_one(q, x, 256)
            return [s, *f]
    return p, jf, tf


@pytest.mark.parametrize("name", ["mpd", "mrd", "dac", "msstft"])
def test_discriminator_scores_features_and_gradients_match_jax(name):
    """Every score and feature map (a length off the period multiple, so
    the reflect fold runs), then the gradient of a weighted sum of all of
    them with respect to every parameter and the audio."""
    rng = np.random.default_rng(11)
    p, jf, tf = _family_case(name, rng)
    x = _rand(rng, (2, 801), 0.3)
    jp = jax.tree.map(jnp.asarray, p)
    want = jax.jit(jf)(jp, jnp.asarray(x))
    tp = _tree(p, grad=True)
    xt = _t(x, grad=True)
    got = tf(tp, xt)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, atol=1e-5 * max(scale, 1.0), rtol=1e-4, what=str(i))
    cots = [_rand(rng, np.shape(w)) for w in want]
    sum(torch.sum(g * _t(c)) for g, c in zip(got, cots)).backward()
    jg = jax.jit(jax.grad(lambda q, v: sum(jnp.sum(m * c) for m, c in zip(
        jf(q, v), cots)), argnums=(0, 1)))(jp, jnp.asarray(x))
    _grads_close(jax.tree.leaves(tp), jg[0], what=name)
    _grads_close([xt], [jg[1]], what=name + " audio")


def test_losses_match_jax_with_gradients():
    rng = np.random.default_rng(12)
    real = [_rand(rng, (2, 7)), _rand(rng, (2, 5))]
    gen = [_rand(rng, (2, 7)), _rand(rng, (2, 5))]
    fr = [[_rand(rng, (2, 3, 4)), _rand(rng, (2, 6))] for _ in range(2)]
    fg = [[_rand(rng, (2, 3, 4)), _rand(rng, (2, 6))] for _ in range(2)]
    J = lambda v: jax.tree.map(jnp.asarray, v)  # noqa: E731
    T = lambda v: jax.tree.map(_t, v)  # noqa: E731
    for jfn, tfn, args in (
            (jlosses.discriminator_loss, tlosses.discriminator_loss,
             (real, gen)),
            (jlosses.generator_loss, tlosses.generator_loss, (gen,)),
            (jlosses.feature_matching_loss, tlosses.feature_matching_loss,
             (fr, fg)),
            (jlosses.dac_discriminator_loss, tlosses.dac_discriminator_loss,
             (fg, fr)),
            (lambda a, b: jlosses.dac_generator_loss(a, b)[0],
             lambda a, b: tlosses.dac_generator_loss(a, b)[0], (fg, fr)),
            (lambda a, b: jlosses.dac_generator_loss(a, b)[1],
             lambda a, b: tlosses.dac_generator_loss(a, b)[1], (fg, fr))):
        _close(tfn(*T(args)), jfn(*J(args)), atol=1e-6, rtol=1e-6)
    # the mel loss and its gradient through the STFT
    y, yh = _rand(rng, (2, 3000), 0.3), _rand(rng, (2, 3000), 0.3)
    yt = _t(yh, grad=True)
    got = tlosses.mel_loss(yt, _t(y))
    want, jg = jax.value_and_grad(lambda v: jlosses.mel_loss(
        v, jnp.asarray(y)))(jnp.asarray(yh))
    _close(got, want, atol=1e-6, rtol=1e-5)
    got.backward()
    _grads_close([yt], [jg], what="mel")
