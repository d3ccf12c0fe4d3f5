"""The port's decoder trainer (llmvox_tpu_torch/train/trainer.py,
checkpoint.py, __main__.py) against the JAX package's, in f32 on the CPU:
step for step, checkpoints read across, resume, and the CLI."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import data as jdata
from llmvox_tpu.train.trainer import Trainer as JTrainer
from llmvox_tpu.train.trainer import estimate_mfu as j_estimate_mfu
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu.utils.config import TrainConfig as JTrainConfig
from llmvox_tpu_torch.train import __main__ as train_main
from llmvox_tpu_torch.train import checkpoint as tckpt
from llmvox_tpu_torch.train import trainer as ttrainer
from llmvox_tpu_torch.train.data import Sample, save_prepared
from llmvox_tpu_torch.utils import config as tconfig

TINY = JDecoderConfig(n_layer=2, n_head=2, n_embd=32, block_size=64,
                      vocab_size=16, bias=False, text_embed_dim=12,
                      speech_embed_dim=20, text_vocab_size=20,
                      pad_token_id=17, text_eos_id=18, eoa_token_id=7,
                      n_draft_heads=2)


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((TINY.text_vocab_size, TINY.text_embed_dim)
                                ).astype(np.float32)
    codebook = rng.standard_normal((TINY.vocab_size, TINY.speech_embed_dim)
                                   ).astype(np.float32)
    return table, codebook


def _batches(packed, n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        samples = [jdata.Sample(
            rng.integers(0, 16, int(rng.integers(3, 20))).astype(np.int32),
            rng.integers(0, 16, int(rng.integers(3, 28))).astype(np.int32))
            for _ in range(3)]
        if packed:
            out.append(jdata.collate_packed(samples, TINY, rows=2,
                                            seq_len=32)[:4])
        else:
            out.append(jdata.collate(samples[:2], TINY, bucket=16))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if hasattr(tree, "detach")
                                    else tree)}


def _pair(tcfg_kw, mcfg=TINY):
    jt = JTrainConfig(**{"dp_size": 1, "eval_interval": 1000, **tcfg_kw})
    table, codebook = _tables()
    jtr = JTrainer(jt, mcfg, table, codebook, compute_dtype=jnp.float32)
    params = jax.device_get(jtr.state.params)
    ttr = ttrainer.Trainer(_port(jt, tconfig.TrainConfig),
                           _port(mcfg, tconfig.DecoderConfig), table,
                           codebook, compute_dtype=torch.float32,
                           device="cpu", params=params)
    return jtr, ttr, params


@pytest.mark.parametrize("packed,k,clip", [(False, 1, 1e9), (True, 4, 0.3),
                                           (False, 4, 0.3)])
def test_trainer_matches_jax_step_for_step(packed, k, clip):
    """Draft heads, packed or bucketed batches, accumulation k, clipping
    active (0.3 against gradient norms of 0.4-0.5) or not: each micro-step's
    loss to 1e-5 relative, the params after every micro-step to 2e-6
    (f32, lr 1e-2); the first update (lr_schedule(0) = 0 under warmup)
    leaves the params as they were, as optax's does."""
    jtr, ttr, start = _pair(dict(
        batch_size=2, gradient_accumulation_steps=k, learning_rate=1e-2,
        warmup_iters=2, lr_decay_iters=20, min_lr=1e-4, grad_clip=clip))
    start = _leaves(start)
    for i, batch in enumerate(_batches(packed, 3 * k)):
        lj = jtr.step(*batch)
        lt = ttr.step(*batch)
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        pj, pt = _leaves(jax.device_get(jtr.state.params)), \
            _leaves(ttr.params)
        for name in pj:
            np.testing.assert_allclose(pt[name], pj[name], atol=2e-6,
                                       rtol=1e-5, err_msg=f"{i} {name}")
        if i < 2 * k - 1:
            for name in pt:
                np.testing.assert_array_equal(pt[name], start[name])
    assert ttr.iter_num == jtr.iter_num == 3 * k
    assert not np.array_equal(pt["h/wqkv"], start["h/wqkv"])


def test_accumulation_equals_a_big_batch():
    """k=2 micro-batches of 2 rows update as one batch of 4 (full rows,
    so every micro-batch's mean weighs its rows as the big batch does)."""
    table, codebook = _tables()
    mcfg = _port(TINY, tconfig.DecoderConfig)
    rng = np.random.default_rng(2)
    text = rng.integers(0, 16, (4, 16)).astype(np.int32)
    tgt = rng.integers(0, 16, (4, 16)).astype(np.int32)
    base = tconfig.TrainConfig(batch_size=4, gradient_accumulation_steps=1,
                               grad_clip=1e9, warmup_iters=0,
                               lr_decay_iters=100, learning_rate=1e-2)
    big = ttrainer.Trainer(base, mcfg, table, codebook,
                           compute_dtype=torch.float32, device="cpu")
    acc = ttrainer.Trainer(dataclasses.replace(
        base, batch_size=2, gradient_accumulation_steps=2), mcfg, table,
        codebook, compute_dtype=torch.float32, device="cpu")
    big.step(text, tgt)
    acc.step(text[:2], tgt[:2])
    acc.step(text[2:], tgt[2:])
    pb, pa = _leaves(big.params), _leaves(acc.params)
    for name in pb:
        np.testing.assert_allclose(pa[name], pb[name], atol=2e-6, rtol=1e-5,
                                   err_msg=name)


def test_checkpoints_read_across(tmp_path):
    """The port's checkpoint in JAX's load_params_npz / load_meta and
    JAX's Trainer.load_checkpoint (no optax state beside it: a fresh
    optimizer); JAX's checkpoint in the port's Trainer."""
    jtr, ttr, _ = _pair(dict(batch_size=2, gradient_accumulation_steps=1,
                             warmup_iters=0, out_dir=str(tmp_path / "port")))
    for batch in _batches(True, 2):
        ttr.step(*batch)
    path = ttr.save_checkpoint()
    assert path == str(tmp_path / "port" / "ckpt.npz")
    loaded = jckpt.load_params_npz(path)
    meta = jckpt.load_meta(path)
    assert meta["iter_num"] == 2
    assert meta["model_args"]["n_draft_heads"] == 2
    want = _leaves(ttr.params)
    got = _leaves(loaded)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # the JAX npz's keys, in JAX's flattening order
    with np.load(path) as data:
        assert data.files == list(jckpt.flatten_pytree(loaded))
    jtr.load_checkpoint(path)
    assert jtr.iter_num == 2
    for name, v in _leaves(jax.device_get(jtr.state.params)).items():
        np.testing.assert_array_equal(v, want[name])
    jtr.step(*_batches(True, 1, seed=7)[0])

    jtr.tcfg = dataclasses.replace(jtr.tcfg, out_dir=str(tmp_path / "jax"))
    jpath = jtr.save_checkpoint()
    _, fresh, _ = _pair(dict(batch_size=2, gradient_accumulation_steps=1))
    fresh.load_checkpoint(jpath)
    assert fresh.iter_num == 3
    assert fresh.opt.count == 0          # optax's state is not read
    for name, v in _leaves(jax.device_get(jtr.state.params)).items():
        np.testing.assert_array_equal(_leaves(fresh.params)[name], v)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """A checkpoint in the middle of an accumulation (k=2, after 3
    micro-steps), resumed in a new trainer, ends where one trainer that
    never stopped ends: the same params bit for bit."""
    kw = dict(batch_size=2, gradient_accumulation_steps=2, warmup_iters=1,
              learning_rate=1e-2, lr_decay_iters=20, grad_clip=0.5)
    batches = _batches(True, 6)
    _, whole, params = _pair(dict(kw, out_dir=str(tmp_path)))
    for b in batches:
        whole.step(*b)
    _, first, _ = _pair(dict(kw, out_dir=str(tmp_path)))
    for b in batches[:3]:
        first.step(*b)
    path = first.save_checkpoint("mid")
    assert os.path.exists(str(tmp_path / "mid.adamw.npz"))
    _, second, _ = _pair(dict(kw, out_dir=str(tmp_path)))
    second.load_checkpoint(path)
    assert (second.iter_num, second.opt.count, second.opt.mini_step) == \
        (3, 1, 1)
    for b in batches[3:]:
        second.step(*b)
    pw, ps = _leaves(whole.params), _leaves(second.params)
    for name in pw:
        np.testing.assert_array_equal(ps[name], pw[name])


def test_average_and_partial_checkpoints_match_jax(tmp_path):
    t1 = {"a": {"w": np.ones((2, 2), np.float32)},
          "b": [np.full((3,), 2.0, np.float32)]}
    t2 = {"a": {"w": np.full((2, 2), 3.0, np.float32)},
          "b": [np.full((3,), 6.0, np.float32)]}
    p1, p2 = str(tmp_path / "c1.npz"), str(tmp_path / "c2.npz")
    tckpt.save_params_npz(p1, t1)
    jckpt.save_params_npz(p2, t2)
    for mod in (jckpt, tckpt):
        avg = mod.average_checkpoints([p1, p2])
        np.testing.assert_array_equal(avg["a"]["w"], np.full((2, 2), 2.0))
        np.testing.assert_array_equal(avg["b"][0], np.full((3,), 4.0))
    template = {"a": {"w": np.zeros((2, 2), np.float64)},
                "b": [np.zeros((3,), np.float32)]}
    for keep in (["a"], None):
        want = jckpt.load_partial(template, p2, keep=keep)
        got = tckpt.load_partial(template, p2, keep=keep)
        assert got["a"]["w"].dtype == want["a"]["w"].dtype == np.float64
        np.testing.assert_array_equal(got["a"]["w"], want["a"]["w"])
        np.testing.assert_array_equal(got["b"][0], want["b"][0])


def test_estimate_mfu_and_refusals():
    """JAX's formula against the H100's dense bf16 peak (989e12); a
    tp_size or sp_size that does not split the launch's world, an
    sp_layout that is neither "ring" nor "zigzag", a dp_size that is not
    the launch's world size, and a card that is not there refused.  FSDP
    on one process runs, over a dp group of one: every leaf whole."""
    cfg = _port(TINY, tconfig.DecoderConfig)
    assert ttrainer.H100_PEAK_FLOPS == 989e12
    for t in (16, 0):
        np.testing.assert_allclose(
            ttrainer.estimate_mfu(cfg, 1234, 64, 0.5, seq_len=t),
            j_estimate_mfu(TINY, 1234, 64, 0.5, peak=989e12, seq_len=t),
            rtol=1e-12)
    table, codebook = _tables()
    for bad, match in ((dict(dp_size=2), "world of 1"),
                       (dict(tp_size=2), "tp_size=2"),
                       (dict(sp_size=2), "sp_size=2"),
                       (dict(sp_layout="diagonal"), "sp_layout")):
        with pytest.raises(ValueError, match=match):
            ttrainer.Trainer(tconfig.TrainConfig(**bad), cfg, table,
                             codebook, device="cpu")
    tr = ttrainer.Trainer(tconfig.TrainConfig(fsdp=True), cfg, table,
                          codebook, device="cpu")
    assert not tr.fsdp and tr.split == [()] * len(tr.names)
    assert tr.params["h"]["wqkv"].shape == (cfg.n_layer, cfg.n_embd,
                                            3 * cfg.n_embd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrainer.Trainer(tconfig.TrainConfig(), cfg, table, codebook)


def test_train_loop_logs_and_evaluates(tmp_path):
    """``train`` as JAX's: eval and a checkpoint every eval_interval, the
    loss, lr (by iter_num) and MFU every log_interval (dt spanning the
    micro-steps since the last log)."""
    table, codebook = _tables()
    tcfg = tconfig.TrainConfig(batch_size=2, gradient_accumulation_steps=1,
                               eval_interval=3, log_interval=2,
                               warmup_iters=2, lr_decay_iters=10,
                               out_dir=str(tmp_path))
    tr = ttrainer.Trainer(tcfg, _port(TINY, tconfig.DecoderConfig), table,
                          codebook, compute_dtype=torch.float32, device="cpu")
    logged, lines = [], []

    class Cap:
        def log(self, it, d):
            logged.append((it, d))

    tr.train(iter(_batches(False, 12)), max_iters=6, log=lines.append,
             logger=Cap())
    assert tr.iter_num == 6
    assert [it for it, _ in logged] == [2, 3, 4, 6]
    assert "val/loss" in logged[1][1]
    lr = [d["lr"] for it, d in logged if "lr" in d]
    assert lr == [ttrainer.lr_schedule(tcfg)(i) for i in (2, 4, 6)]
    assert os.path.exists(tmp_path / "ckpt.npz")
    assert any("eval loss" in line for line in lines)


def _dataset(tmp_path, n=6, seed=0):
    rng = np.random.default_rng(seed)
    samples = [Sample(text_ids=rng.integers(0, 384, 12).astype(np.int32),
                      codes=rng.integers(0, 16, int(rng.integers(8, 30))
                                         ).astype(np.int32))
               for _ in range(n)]
    path = str(tmp_path / "data.npz")
    save_prepared(path, samples)
    return path


TINY_FLAGS = ["--n_layer", "2", "--n_head", "2", "--n_embd", "32",
              "--block_size", "64", "--vocab_size", "16",
              "--text_embed_dim", "12", "--speech_embed_dim", "20",
              "--eoa_token_id", "15", "--n_draft_heads", "2",
              "--device", "cpu"]


@pytest.mark.parametrize("pack", [False, True])
def test_train_cli_on_the_cpu(tmp_path, capsys, pack):
    """``python -m llmvox_tpu_torch.train --device cpu``: trains, writes a
    checkpoint JAX reads and the JSONL metrics, resumes from it with
    iter_num carried across, and evaluates only with ``--eval_only``."""
    data = _dataset(tmp_path)
    out = tmp_path / "out"
    common = ["--data_path", data, "--out_dir", str(out), "--batch_size", "2",
              "--gradient_accumulation_steps", "2", "--eval_interval", "2",
              "--eval_iters", "1", "--log_interval", "1",
              "--dtype", "float32", "--warmup_iters", "1"] + TINY_FLAGS
    common += (["--pack", "--pack_len", "48"] if pack else
               ["--bucket", "32"])
    train_main.main(common + ["--max_iters", "3"])
    ckpt = out / "ckpt.npz"
    meta = jckpt.load_meta(str(ckpt))
    assert meta["iter_num"] == 2
    assert set(_leaves(jckpt.load_params_npz(str(ckpt)))) >= {
        "wpe", "head", "draft_heads", "h/wqkv"}
    with open(out / "run.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2, 3]
    train_main.main(common + ["--max_iters", "5", "--init_from", "resume"])
    text = capsys.readouterr().out
    assert "resumed at iter 2" in text
    assert jckpt.load_meta(str(ckpt))["iter_num"] == 4
    train_main.main(common + ["--eval_only", "true"])
    assert "eval loss:" in capsys.readouterr().out
