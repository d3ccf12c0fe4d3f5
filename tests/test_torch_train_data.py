"""The port's training data and optimizer (llmvox_tpu_torch/train/data.py,
train/optim.py) and metrics logger (utils/logging.py) against the JAX
package's, on the same numpy inputs and seeds."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.train import data as jdata
from llmvox_tpu.train import optim as joptim
from llmvox_tpu.utils import logging as jlogging
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu.utils.config import TrainConfig as JTrainConfig
from llmvox_tpu_torch.train import data as tdata
from llmvox_tpu_torch.train import optim as toptim
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import logging as tlogging

TINY = JDecoderConfig(n_layer=2, n_head=2, n_embd=32, block_size=64,
                      vocab_size=16, bias=False, text_embed_dim=12,
                      speech_embed_dim=20, text_vocab_size=20,
                      pad_token_id=17, text_eos_id=18, eoa_token_id=7,
                      n_draft_heads=2)


def _port(cfg, cls):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def _samples(n, seed, max_codes=40):
    rng = np.random.default_rng(seed)
    return [jdata.Sample(
        text_ids=rng.integers(0, 16, int(rng.integers(2, 30))).astype(np.int32),
        codes=rng.integers(0, TINY.vocab_size,
                           int(rng.integers(1, max_codes))).astype(np.int32))
        for _ in range(n)]


def _tsamples(samples):
    return [tdata.Sample(s.text_ids, s.codes) for s in samples]


def test_collate_and_collate_packed_match_jax():
    samples = _samples(9, 0)
    tcfg = _port(TINY, tconfig.DecoderConfig)
    for bucket, max_len in ((8, None), (16, 24), (64, None)):
        want = jdata.collate(samples, TINY, bucket=bucket, max_len=max_len)
        got = tdata.collate(_tsamples(samples), tcfg, bucket=bucket,
                            max_len=max_len)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for rows, seq_len in ((2, 32), (3, 64), (1, 16)):
        want = jdata.collate_packed(samples, TINY, rows=rows, seq_len=seq_len)
        got = tdata.collate_packed(_tsamples(samples), tcfg, rows=rows,
                                   seq_len=seq_len)
        for w, g in zip(want[:4], got[:4]):
            np.testing.assert_array_equal(g, w)
        assert ([s.codes.tolist() for s in got[4]]
                == [s.codes.tolist() for s in want[4]])


@pytest.mark.parametrize("packed", [False, True])
def test_build_decoder_inputs_matches_jax(packed):
    rng = np.random.default_rng(3)
    samples = _samples(6, 1)
    tcfg = _port(TINY, tconfig.DecoderConfig)
    table = rng.standard_normal((TINY.text_vocab_size, TINY.text_embed_dim)
                                ).astype(np.float32)
    codebook = rng.standard_normal((TINY.vocab_size, TINY.speech_embed_dim)
                                   ).astype(np.float32)
    if packed:
        text, tgt, _, pos, _ = jdata.collate_packed(samples, TINY, rows=2,
                                                    seq_len=48)
    else:
        (text, tgt), pos = jdata.collate(samples, TINY, bucket=16), None
    want = jdata.build_decoder_inputs(
        jnp.asarray(table), jnp.asarray(codebook), jnp.asarray(text),
        jnp.asarray(tgt), TINY, pos_ids=None if pos is None
        else jnp.asarray(pos))
    got = tdata.build_decoder_inputs(
        torch.tensor(table), torch.tensor(codebook), torch.tensor(text),
        torch.tensor(tgt), tcfg, pos_ids=None if pos is None
        else torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=1e-6)


def test_iterators_yield_jax_batches_for_the_same_seed(tmp_path):
    """Both shuffle with numpy's default_rng(seed): the same batches, in
    order, across an epoch boundary; the datasets read the same npz and
    the same JSON manifest."""
    samples = _samples(11, 2)
    path = str(tmp_path / "data.npz")
    jdata.save_prepared(path, samples)
    tpath = str(tmp_path / "port.npz")
    tdata.save_prepared(tpath, _tsamples(samples))
    jds = jdata.SpeechDataset(path)
    tds = tdata.SpeechDataset(tpath)
    tcfg = _port(TINY, tconfig.DecoderConfig)
    jit = iter(jdata.BatchIterator(jds, TINY, 3, bucket=8, seed=5))
    tit = iter(tdata.BatchIterator(tds, tcfg, 3, bucket=8, seed=5))
    for _ in range(8):
        for w, g in zip(next(jit), next(tit)):
            np.testing.assert_array_equal(g, w)
    jit = iter(jdata.PackedBatchIterator(jds, TINY, 2, 48, seed=9))
    tit = iter(tdata.PackedBatchIterator(tds, tcfg, 2, 48, seed=9))
    for _ in range(8):
        for w, g in zip(next(jit), next(tit)):
            np.testing.assert_array_equal(g, w)
    manifest = [{"id": str(i), "answer_text": f"word {i} and more",
                 "codes": [3, 453, 5, i]} for i in range(4)]
    mpath = str(tmp_path / "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for a, b in zip(jdata.SpeechDataset(mpath).samples,
                    tdata.SpeechDataset(mpath).samples):
        np.testing.assert_array_equal(b.text_ids, a.text_ids)
        np.testing.assert_array_equal(b.codes, a.codes)
        assert 453 not in b.codes


# ---------------------------------------------------------------------------
# the schedule, the decay mask and the optimizer against optax
# ---------------------------------------------------------------------------

def test_lr_schedule_and_decay_mask_match_jax():
    for kw in (dict(warmup_iters=10, lr_decay_iters=100),
               dict(warmup_iters=0, lr_decay_iters=50),
               dict(decay_lr=False)):
        jc = JTrainConfig(learning_rate=3e-4, min_lr=3e-6, **kw)
        want, got = joptim.lr_schedule(jc), toptim.lr_schedule(
            _port(jc, tconfig.TrainConfig))
        for it in [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 500]:
            assert got(it) == float(want(it)), (kw, it)
    params = jax.device_get(jdec.init_decoder_params(
        jax.random.PRNGKey(0), dataclasses.replace(TINY, bias=True)))
    assert toptim.decay_mask(params) == joptim.decay_mask(params)


def _opt_case(k, clip, seed=0, n_updates=3, warmup=2):
    """JAX's make_optimizer against the port's AdamW over n_updates * k
    micro-steps of random gradients (one in three scaled up, so a clip at
    ``clip`` is active on some updates and not on others)."""
    jc = JTrainConfig(gradient_accumulation_steps=k, grad_clip=clip,
                      learning_rate=1e-2, warmup_iters=warmup,
                      lr_decay_iters=20, min_lr=1e-4, weight_decay=0.1)
    rng = np.random.default_rng(seed)
    params = jax.device_get(jdec.init_decoder_params(
        jax.random.PRNGKey(seed), dataclasses.replace(TINY, bias=True)))
    tx = joptim.make_optimizer(jc, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, params)
    flat = toptim.named_leaves(params)
    tp = [torch.tensor(np.asarray(v)) for _, v in flat]
    opt = toptim.AdamW(_port(jc, tconfig.TrainConfig), tp,
                       [d for _, d in toptim.named_leaves(
                           joptim.decay_mask(params))])
    history = []
    for i in range(n_updates * k):
        scale = 30.0 if i % 3 == 0 else 0.01
        grads = jax.tree.map(
            lambda x: (scale * rng.standard_normal(x.shape)
                       ).astype(np.float32), params)
        upd, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        applied = opt.step([torch.tensor(np.asarray(g)) for _, g in
                            toptim.named_leaves(grads)])
        assert applied == ((i + 1) % k == 0)
        history.append(([np.asarray(v) for _, v in
                         toptim.named_leaves(jax.device_get(jp))],
                        [t.numpy().copy() for t in tp]))
    return params, history


@pytest.mark.parametrize("k,clip", [(1, 1.0), (1, 1e9), (4, 1.0),
                                    (4, 1e9)])
def test_optimizer_updates_as_optax(k, clip):
    """Every micro-step's params equal optax's to 1e-6 (f32, lr 1e-2);
    with the warmup the first update moves nothing; micro-steps between
    updates move nothing."""
    params, history = _opt_case(k, clip)
    start = [np.asarray(v) for _, v in toptim.named_leaves(params)]
    for i, (want, got) in enumerate(history):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5,
                                       err_msg=f"micro-step {i}")
        if i < 2 * k - 1:
            # the first update uses lr_schedule(0) = 0 under warmup
            for s, g in zip(start, got):
                np.testing.assert_array_equal(g, s)
    assert any((g != s).any() for s, g in zip(start, history[-1][1]))


def test_grad_clip_zero_zeroes_the_update_as_optax():
    """optax's clip_by_global_norm(0) scales every gradient to 0 (the
    JAX trainer's ``grad_clip=0``), so only weight decay moves the
    params; the port does the same."""
    _, history = _opt_case(1, 0.0, warmup=0, n_updates=2)
    for want, got in history:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=1e-7, rtol=1e-6)


def test_optimizer_state_round_trip():
    p = [torch.ones(3), torch.zeros(2)]
    cfg = tconfig.TrainConfig(gradient_accumulation_steps=2,
                              warmup_iters=0)
    a = toptim.AdamW(cfg, p, [True, False])
    a.step([torch.ones(3), torch.ones(2)])
    a.step([torch.ones(3), 2 * torch.ones(2)])
    a.step([torch.ones(3), torch.ones(2)])
    b = toptim.AdamW(cfg, [t.clone() for t in p], [True, False])
    b.load_state_dict({k: ([t.numpy() for t in v] if isinstance(v, list)
                           else v) for k, v in a.state_dict().items()})
    assert (b.count, b.mini_step) == (1, 1)
    for g in ("mu", "nu", "acc"):
        for x, y in zip(getattr(a, g), getattr(b, g)):
            np.testing.assert_array_equal(y.numpy(), x.numpy())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_logger_writes_jax_records(tmp_path):
    recs = []
    for mod, sub in ((jlogging, "jax"), (tlogging, "port")):
        lg = mod.MetricsLogger(str(tmp_path / sub), "run")
        lg.log(1, {"train/loss": 2.5, "lr": 1e-4})
        lg.log(2, {"val/loss": 2.25})
        lg.log_audio(2, "sample", np.zeros(100), 24000)
        lg.close()
        with open(tmp_path / sub / "run.metrics.jsonl") as f:
            recs.append([json.loads(line) for line in f])
    for r in recs:
        for rec in r:
            rec.pop("time")
    assert recs[0] == recs[1] == [
        {"step": 1, "train/loss": 2.5, "lr": 1e-4},
        {"step": 2, "val/loss": 2.25}]


def test_spectrogram_image_matches_jax():
    """On noise (a pure tone's silent bins sit at the f32 FFT's noise
    floor, where the logs of two FFTs part): the log-mel to 1e-4, and the
    uint8 image a rounding step apart at most."""
    from llmvox_tpu.codec.mel import mel_spectrogram_features as jmel
    from llmvox_tpu_torch.codec.mel import mel_spectrogram_features as tmel
    wav = np.random.default_rng(0).standard_normal(6000).astype(np.float32)
    np.testing.assert_allclose(
        tmel(torch.tensor(wav[None])).numpy(),
        np.asarray(jmel(jnp.asarray(wav[None]))), atol=1e-4, rtol=1e-5)
    want = jlogging.spectrogram_image(wav, 24000)
    got = tlogging.spectrogram_image(wav, 24000)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
