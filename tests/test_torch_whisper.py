"""The port's Whisper (``llmvox_tpu_torch/models/whisper.py``) against the
JAX package's (``llmvox_tpu/models/whisper.py``) on the CPU, in f32, from
the same numpy params and audio made from a seed: the mel filters and
``log_mel`` (2e-4) at 80 and 128 mels, ``pad_or_trim`` at each context
bucket, ``encode``, ``make_cross_kv`` and the prefill logits (2e-5),
greedy ``decode_block`` tokens across chained blocks (EOS frozen,
``_suppress``), the cache's last rows, the param tree bridges
(``init_whisper_params``, ``to_torch``, ``convert_whisper_state_dict``,
``quantize_whisper_params``), and the reference's quantized failure beside
the port's refusal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import whisper as JW
from llmvox_tpu.ops import quant as jquant
from llmvox_tpu.tools.convert import convert_whisper_state_dict as jconvert
from llmvox_tpu_torch.models import whisper as TW
from llmvox_tpu_torch.ops import quant as tquant
from llmvox_tpu_torch.streams.asr import WhisperModelASR
from llmvox_tpu_torch.tools.convert import (
    convert_whisper_state_dict as tconvert)
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as tparams

FIELDS = dict(vocab_size=100, n_mels=16, d_model=32, enc_layers=2,
              dec_layers=2, enc_heads=2, dec_heads=2, enc_ffn=64,
              dec_ffn=64, max_source_positions=30, max_target_positions=32,
              decoder_start_token_id=98, eos_token_id=99)
JCFG, TCFG = JW.WhisperConfig(**FIELDS), TW.WhisperConfig(**FIELDS)
TOL = dict(atol=2e-5, rtol=0)
MEL_TOL = dict(atol=2e-4, rtol=0)


def _speechish(seed: int, seconds: float = 2.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 660 * t)
            + 0.1 * rng.normal(size=t.size)).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def params():
    """JAX's initialiser, perturbed (seeded) so that every weight, bias
    and norm matters and the greedy chains vary."""
    rng = np.random.default_rng(5)
    p = jax.device_get(JW.init_whisper_params(jax.random.PRNGKey(5), JCFG))
    return jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        p)


@pytest.fixture(scope="module")
def both(params):
    return jax.tree.map(jnp.asarray, params), tparams.to_torch(params, "cpu")


def _mel(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(2, JCFG.n_audio_frames, JCFG.n_mels)).astype(np.float32)


def _encoded(both, seed=0, cfgs=(JCFG, TCFG)):
    (jp, tp), (jcfg, tcfg) = both, cfgs
    mel = _mel(seed)
    jenc = JW.encode(jp, jnp.asarray(mel), jcfg)
    tenc = TW.encode(tp, torch.from_numpy(mel), tcfg)
    return jenc, tenc


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_filters_equal_jax(n_mels):
    np.testing.assert_array_equal(
        TW.whisper_mel_filters(16000, 400, n_mels),
        JW.whisper_mel_filters(16000, 400, n_mels))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("frames", [600, 1200, None])
def test_pad_or_trim_and_log_mel_match_jax(n_mels, frames):
    """At each context bucket (None: the full 30 s window), on a clip
    shorter than the bucket and one longer (trimmed), batched."""
    cfg_j = JW.WhisperConfig(n_mels=n_mels)
    cfg_t = TW.WhisperConfig(n_mels=n_mels)
    audio = np.stack([_speechish(0, 5.0), 0.5 * _speechish(1, 5.0)])
    for clip in (audio[:, :16000 * 2], audio):
        jpad = JW.pad_or_trim(clip, cfg_j, frames)
        tpad = TW.pad_or_trim(clip, cfg_t, frames)
        np.testing.assert_array_equal(tpad, jpad)
        assert tpad.shape[1] == (frames or 3000) * 160
        want = np.asarray(JW.log_mel(jnp.asarray(jpad), cfg_j))
        got = TW.log_mel(torch.from_numpy(tpad), cfg_t).numpy()
        assert got.shape == want.shape == (2, frames or 3000, n_mels)
        np.testing.assert_allclose(got, want, **MEL_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_mha_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, n, 2, 16)).astype(np.float32)
               for n in (3, 7, 7))
    mask = rng.random((3, 7)) > 0.3
    mask[:, 0] = True
    for m in (None, mask):
        want = np.asarray(JW._mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  None if m is None else jnp.asarray(m)))
        got = TW._mha(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v),
                      None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_encode_matches_jax(both):
    jenc, tenc = _encoded(both)
    assert tenc.shape == (2, JCFG.max_source_positions, JCFG.d_model)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)


def test_encode_at_a_short_bucket_matches_jax(both):
    """A bucket's window: the positional table is sliced to its length."""
    jp, tp = both
    mel = _mel(1)[:, :20]
    want = np.asarray(JW.encode(jp, jnp.asarray(mel), JCFG))
    got = TW.encode(tp, torch.from_numpy(mel), TCFG).numpy()
    assert got.shape == (2, 10, JCFG.d_model)
    np.testing.assert_allclose(got, want, **TOL)


def _prefilled(both, ids, cfgs=(JCFG, TCFG)):
    (jp, tp), (jcfg, tcfg) = both, cfgs
    jenc, tenc = _encoded(both, cfgs=cfgs)
    jcross = JW.make_cross_kv(jp, jenc, jcfg)
    tcross = TW.make_cross_kv(tp, tenc, tcfg)
    jst = JW.init_whisper_decode_state(jcfg, 2)
    tst = TW.init_whisper_decode_state(tcfg, 2)
    jl, jst = JW.prefill(jp, jnp.asarray(ids, jnp.int32), jst, jcross, jcfg)
    tl, tst = TW.prefill(tp, torch.from_numpy(ids.astype(np.int32)), tst,
                         tcross, tcfg)
    return (jcross, jst, jl), (tcross, tst, tl)


def test_cross_kv_and_prefill_logits_match_jax(both):
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 5))
    (jcross, jst, jl), (tcross, tst, tl) = _prefilled(both, ids)
    for j, t in ((jcross.k, tcross.k), (jcross.v, tcross.v)):
        assert t.shape == (2, 2, 30, 2, 16)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert tl.shape == (2, 5, JCFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tst.pos) == int(jst.pos) == 5
    np.testing.assert_allclose(tst.k.numpy(), np.asarray(jst.k), **TOL)


def _chain(both, ids, blocks, suppress=(), cfgs=(JCFG, TCFG)):
    """Greedy tokens of chained blocks after the prefill, each side."""
    (jcross, jst, jl), (tcross, tst, tl) = _prefilled(both, ids, cfgs)
    (jp, tp), (jcfg, tcfg) = both, cfgs
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32)
    jout, tout = [], []
    for b in blocks:
        jt, jst = JW.decode_block(jp, jtok, jst, jcross, jcfg, block=b,
                                  suppress=suppress)
        tt, tst = TW.decode_block(tp, ttok, tst, tcross, tcfg, block=b,
                                  suppress=suppress)
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
        jtok, ttok = jt[:, -1], tt[:, -1]
    return (np.concatenate(jout, 1), jst), (np.concatenate(tout, 1), tst)


def test_decode_blocks_equal_jax_and_chain(both):
    ids = np.random.default_rng(3).integers(0, JCFG.vocab_size, (2, 3))
    (jt, jst), (tt, tst) = _chain(both, ids, [6])
    np.testing.assert_array_equal(tt, jt)
    assert len({tuple(r) for r in tt}) == 2 and len(set(tt[0])) > 1
    (_, _), (tt2, tst2) = _chain(both, ids, [3, 3])
    np.testing.assert_array_equal(tt2, tt)
    assert int(tst2.pos) == int(jst.pos) == 9
    np.testing.assert_array_equal(tst2.done.numpy(), np.asarray(jst.done))
    np.testing.assert_allclose(tst2.k.numpy(), np.asarray(jst.k), **TOL)


def test_suppress_and_eos_freeze_equal_jax(both):
    """Suppressing a chain's tokens changes it as JAX's does; suppressing
    everything but EOS freezes both rows at EOS, and a frozen row keeps
    emitting EOS with no suppression."""
    ids = np.random.default_rng(4).integers(0, JCFG.vocab_size, (2, 3))
    (base, _), _ = _chain(both, ids, [5])
    sup = tuple(sorted(set(base.ravel().tolist()) - {JCFG.eos_token_id}))
    (jt, _), (tt, _) = _chain(both, ids, [5], suppress=sup)
    np.testing.assert_array_equal(tt, jt)
    assert not set(tt.ravel().tolist()) & set(sup)
    everything = tuple(i for i in range(JCFG.vocab_size)
                       if i != JCFG.eos_token_id)
    (jt, jst), (tt, tst) = _chain(both, ids, [4, 2],
                                  suppress=everything)
    np.testing.assert_array_equal(tt, jt)
    assert (tt == JCFG.eos_token_id).all() and tst.done.all()
    jp, tp = both
    (jcross, _, _), (tcross, _, _) = _prefilled(both, ids)
    tt2, _ = TW.decode_block(tp, torch.from_numpy(tt[:, -1]), tst, tcross,
                             TCFG, block=2)
    assert (tt2.numpy() == JCFG.eos_token_id).all()


@pytest.fixture(scope="module")
def deployed_rows():
    """A tiny Whisper with the family's 448 target positions."""
    fields = {**FIELDS, "max_target_positions": 448}
    jcfg, tcfg = JW.WhisperConfig(**fields), TW.WhisperConfig(**fields)
    rng = np.random.default_rng(7)
    p = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        jax.device_get(JW.init_whisper_params(jax.random.PRNGKey(7), jcfg)))
    return (jax.tree.map(jnp.asarray, p), tparams.to_torch(p, "cpu")), (
        jcfg, tcfg)


@pytest.mark.parametrize("rows,start", [(32, 28), (32, 30), (448, 444),
                                        (448, 446)])
def test_block_at_the_cache_end_matches_jax(both, deployed_rows, rows,
                                            start):
    """A 4-token block from pos ``rows`` - 4 writes the cache's last rows
    (ending exactly at row 448 with the family's 448 positions); from
    pos ``rows`` - 2 it would pass the end, and both sides clamp the
    write's start to ``rows`` - 4 (JAX's ``dynamic_update_slice``) and
    read the position table clamped: tokens and caches equal JAX's."""
    args = (both, (JCFG, TCFG)) if rows == 32 else deployed_rows
    rng = np.random.default_rng(6)
    ids = rng.integers(0, JCFG.vocab_size, (2, start))
    (jt, jst), (tt, tst) = _chain(args[0], ids, [4], cfgs=args[1])
    np.testing.assert_array_equal(tt, jt)
    assert int(tst.pos) == int(jst.pos) == start + 4
    assert tst.k.shape[2] == rows
    np.testing.assert_allclose(tst.k.numpy(), np.asarray(jst.k), **TOL)
    np.testing.assert_allclose(tst.v.numpy(), np.asarray(jst.v), **TOL)


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------

def test_init_whisper_params_is_the_jax_tree():
    """The same keys, shapes and dtypes as JAX's initialiser, and its
    scales: zero biases, unit norms, normal(0.02) elsewhere; a seed gives
    the same tree again.  ``to_torch`` carries a JAX tree key for key."""
    cfg = dataclasses.replace(TCFG, d_model=64, enc_heads=4, dec_heads=4)
    want = _flat(jax.device_get(JW.init_whisper_params(
        jax.random.PRNGKey(0), dataclasses.replace(JCFG, d_model=64,
                                                   enc_heads=4,
                                                   dec_heads=4))))
    got = _flat(tparams.init_whisper_params(3, cfg))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.float32
        name = k.split("/")[-1].removeprefix("x")   # cross-attention
        if name.endswith("_s"):
            assert (v == 1).all(), k
        elif name.startswith("b") or name.endswith("_b"):
            assert (v == 0).all(), k
        else:
            assert abs(float(v.std()) - 0.02) < 0.004, k
    again = _flat(tparams.init_whisper_params(3, cfg))
    assert all(torch.equal(again[k], got[k]) for k in got)
    carried = _flat(tparams.to_torch(
        jax.device_get(JW.init_whisper_params(jax.random.PRNGKey(0), JCFG)),
        "cpu"))
    jtree = _flat(jax.device_get(JW.init_whisper_params(
        jax.random.PRNGKey(0), JCFG)))
    assert sorted(carried) == sorted(jtree)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), jtree[k])


def test_convert_whisper_state_dict_equals_jax(tmp_path):
    """On a local tiny HF ``WhisperForConditionalGeneration``."""
    from transformers import WhisperForConditionalGeneration

    from tests.tiny_hf import build_tiny_whisper
    model = WhisperForConditionalGeneration.from_pretrained(
        build_tiny_whisper(str(tmp_path / "w")))
    sd, hc = model.state_dict(), model.config
    want = _flat(jconvert(sd, hc.encoder_layers, hc.decoder_layers))
    got = _flat(tconvert(sd, hc.encoder_layers, hc.decoder_layers))
    assert sorted(got) == sorted(want) and len(got) == 50
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantize_whisper_params_equals_jax(params, mode):
    """Key for key: the same leaves quantized into the same container
    classes, the same int8 values, the same scales."""
    want = _flat(jax.device_get(jquant.quantize_whisper_params(
        jax.tree.map(jnp.asarray, params), mode)))
    got = _flat(tquant.quantize_whisper_params(params, mode))
    assert sorted(got) == sorted(want)
    n = 0
    for k, g in got.items():
        w = want[k]
        assert type(g).__name__ == type(w).__name__, k
        if isinstance(g, tquant.QUANTIZED):
            n += 1
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_allclose(g.s.numpy(), np.asarray(w.s),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the encoder's 6 matmul weights and the decoder's 10
    assert n == 16 == sum(k.split("/")[-1] in tquant.WHISPER_MATMUL_KEYS
                          for k in got)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantized_whisper_fails_in_the_reference_and_is_refused(params,
                                                                  mode):
    """The reference: ``make_cross_kv`` hands the quantized ``xwk`` to
    ``jnp.einsum``, a TypeError in every mode.  The port refuses the
    combination when the ASR is built, naming that failure."""
    qp = jquant.quantize_whisper_params(jax.tree.map(jnp.asarray, params),
                                        mode)
    enc = jnp.zeros((1, JCFG.max_source_positions, JCFG.d_model))
    with pytest.raises(TypeError, match="einsum"):
        JW.make_cross_kv(qp, enc, JCFG)
    with pytest.raises(ValueError, match=r"whisper.py:346-349.*ROADMAP"):
        WhisperModelASR(tconfig.ServeConfig(asr_backend="jax",
                                            quantize=mode), device="cpu")
