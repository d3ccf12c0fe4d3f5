"""The port's data-parallel decoder trainer (train/trainer.py under a
process group; parallel/mesh.py's collectives) against JAX's Trainer on a
dp=2 mesh and the port's one-process Trainer, in f32 on the CPU.

Two gloo ranks are spawned once for the module (``dp`` fixture): each
runs the same four global micro-batches (accumulation 2, so two updates,
clipping active) and reports its losses, the bitwise lockstep of params,
moments and accumulators after each update, and rank 0's params; rank 0
writes a checkpoint.  The batches give the two ranks different numbers
of valid targets (short rows beside long ones; packed rows whose draft
heads' shifted targets end at sentence ends), which a mean of per-rank
means would weigh wrongly."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import data as jdata
from llmvox_tpu.train.trainer import Trainer as JTrainer
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu.utils.config import TrainConfig as JTrainConfig
from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.train import __main__ as train_main
from llmvox_tpu_torch.train import trainer as ttrainer
from llmvox_tpu_torch.train.data import Sample, save_prepared
from llmvox_tpu_torch.utils import config as tconfig

from tests import torch_dp_ranks as ranks

TINY = JDecoderConfig(n_layer=2, n_head=2, n_embd=32, block_size=64,
                      vocab_size=16, bias=False, text_embed_dim=12,
                      speech_embed_dim=20, text_vocab_size=20,
                      pad_token_id=17, text_eos_id=18, eoa_token_id=7,
                      n_draft_heads=2)
TRAIN = dict(batch_size=4, gradient_accumulation_steps=2,
             learning_rate=1e-2, warmup_iters=0, lr_decay_iters=20,
             min_lr=1e-4, grad_clip=0.3, eval_interval=1000)
# f32, lr 1e-2: the loss to 1e-5 relative, params to 2e-6 (as the
# one-process trainer is held to JAX's step for step)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=2e-6, rtol=1e-5)


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((TINY.text_vocab_size, TINY.text_embed_dim)
                                ).astype(np.float32),
            rng.standard_normal((TINY.vocab_size, TINY.speech_embed_dim)
                                ).astype(np.float32))


def _batches():
    """Two bucketed batches whose first two rows are short and last two
    long, then two packed batches of 4 rows."""
    rng = np.random.default_rng(5)

    def sample(lo, hi):
        return jdata.Sample(
            rng.integers(0, 16, int(rng.integers(3, 12))).astype(np.int32),
            rng.integers(0, 16, int(rng.integers(lo, hi))).astype(np.int32))
    out = []
    for _ in range(2):
        out.append(jdata.collate([sample(2, 5), sample(2, 6),
                                  sample(20, 30), sample(18, 31)], TINY,
                                 bucket=16))
    for _ in range(2):
        out.append(jdata.collate_packed([sample(3, 10) for _ in range(12)],
                                        TINY, rows=4, seq_len=24)[:4])
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_FLAGS = ["--batch_size", "4", "--gradient_accumulation_steps", "1",
             "--eval_interval", "2", "--eval_iters", "1", "--log_interval",
             "1", "--dtype", "float32", "--warmup_iters", "1",
             "--max_iters", "3", "--bucket", "32", "--n_layer", "2",
             "--n_head", "2", "--n_embd", "32", "--block_size", "64",
             "--vocab_size", "16", "--text_embed_dim", "12",
             "--speech_embed_dim", "20", "--eoa_token_id", "15",
             "--n_draft_heads", "2", "--device", "cpu"]


def _cli_data(path) -> str:
    rng = np.random.default_rng(0)
    samples = [Sample(text_ids=rng.integers(0, 384, 12).astype(np.int32),
                      codes=rng.integers(0, 16, int(rng.integers(8, 30))
                                         ).astype(np.int32))
               for _ in range(8)]
    save_prepared(str(path / "data.npz"), samples)
    return str(path / "data.npz")


def _leaves(tree):
    """Name -> a copy of the leaf (a live parameter moves on)."""
    return {k: v.numpy().copy() for k, v in ranks._leaves(tree).items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """JAX's dp=2 trainer's losses and params after each update, the two
    ranks' results, the port's one-process run, and the inputs."""
    # the CLI under torchrun (two gloo ranks), while the rest runs
    cli_dir = tmp_path_factory.mktemp("cli")
    cli_flags = CLI_FLAGS + ["--data_path", _cli_data(cli_dir)]
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "llmvox_tpu_torch.train",
         "--out_dir", str(cli_dir / "dp")] + cli_flags, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    jt = JTrainConfig(dp_size=2, **TRAIN)
    table, codebook = _tables()
    jtr = JTrainer(jt, TINY, table, codebook, compute_dtype=jnp.float32)
    assert jtr.mesh.shape["dp"] == 2
    # a copy: the steps donate their state
    params = jax.tree.map(np.array, jax.device_get(jtr.state.params))
    batches = _batches()
    tcfg = _port(jt, tconfig.TrainConfig, dp_size=-1)
    mcfg = _port(TINY, tconfig.DecoderConfig)
    out = str(tmp_path_factory.mktemp("dp"))
    # the ranks run while JAX compiles
    res = {}
    ranks_thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.decoder_trainer, 2, tcfg, mcfg, table, codebook, params,
        batches, out, threads=1, timeout_s=240)))
    ranks_thread.start()
    jl, jp = [], []
    for i, b in enumerate(batches):
        jl.append(jtr.step(*b))
        if i % 2 == 1:
            jp.append(_leaves(jax.device_get(jtr.state.params)))
    one = ttrainer.Trainer(dataclasses.replace(tcfg, dp_size=1), mcfg, table,
                           codebook, compute_dtype=torch.float32,
                           device="cpu", params=params)
    ol, op = [], []
    for i, b in enumerate(batches):
        ol.append(one.step(*b))
        if i % 2 == 1:
            op.append(_leaves(one.params))
    ranks_thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(jax=(jl, jp), ranks=res["r"], one=(ol, op), params=params,
                table=table, codebook=codebook, tcfg=tcfg, mcfg=mcfg,
                jtr=jtr, cli=(cli, cli_dir, cli_flags))


def test_ranks_hold_different_valid_counts(dp):
    """Trap 1 is exercised: in every batch the ranks' valid targets (the
    loss's and each draft head's) differ."""
    c0, c1 = (r["counts"] for r in dp["ranks"])
    for a, b in zip(c0, c1):
        assert a != b and all(x > 0 for x in a + b)
    assert [r["dp"] for r in dp["ranks"]] == [2, 2]


def test_dp_losses_match_jax_dp2_and_one_process(dp):
    jl, _ = dp["jax"]
    ol, _ = dp["one"]
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"], ol, rtol=LOSS_RTOL)
    assert dp["ranks"][0]["losses"] == dp["ranks"][1]["losses"]


@pytest.mark.parametrize("update", [0, 1])
def test_dp_params_match_jax_dp2_and_one_process(dp, update):
    """Rank 0's params after each update against JAX's dp=2 Trainer's and
    the one-process Trainer's on the same global batches."""
    got = dp["ranks"][0]["updates"][update]
    for want in (dp["jax"][1][update], dp["one"][1][update]):
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **PARAM_TOL,
                                       err_msg=f"{update} {name}")
    start = _leaves(dp["params"])
    assert not np.array_equal(got["h/wqkv"], start["h/wqkv"])


def test_ranks_stay_bitwise_equal(dp):
    """After each update every rank's params, AdamW moments and
    accumulators equal rank 0's bit for bit (a broadcast from rank 0 and
    an exact compare on each rank)."""
    for r in dp["ranks"]:
        assert r["lockstep"] == [True, True]
        assert (r["iter_num"], r["count"]) == (4, 2)


def test_dp_checkpoint_loads_in_one_process_and_jax(dp):
    """Rank 0's checkpoint (the ranks hold the same bits) loads into the
    port's one-process Trainer, moments included, and into JAX's
    load_checkpoint."""
    path = dp["ranks"][0]["path"]
    assert path == dp["ranks"][1]["path"]
    want = dp["ranks"][0]["updates"][1]
    one = ttrainer.Trainer(dataclasses.replace(dp["tcfg"], dp_size=1),
                           dp["mcfg"], dp["table"], dp["codebook"],
                           compute_dtype=torch.float32, device="cpu",
                           params=dp["params"])
    one.load_checkpoint(path)
    assert (one.iter_num, one.opt.count) == (4, 2)
    for name, v in _leaves(one.params).items():
        np.testing.assert_array_equal(v, want[name])
    loaded = jckpt.load_params_npz(path)
    for name, v in _leaves(loaded).items():
        np.testing.assert_array_equal(v, want[name])
    jtr = dp["jtr"]
    jtr.load_checkpoint(path)
    assert jtr.iter_num == 4
    for name, v in _leaves(jax.device_get(jtr.state.params)).items():
        np.testing.assert_array_equal(v, want[name])


def test_dp_refusals(dp):
    """A dp_size that is not the launch's world is refused on the ranks
    and on one process (tp, sp and FSDP compose with dp:
    test_torch_parallel_tp.py, test_torch_parallel_sp_fsdp.py)."""
    for r in dp["ranks"]:
        assert "world of 2" in r["refused"]
    table, codebook = dp["table"], dp["codebook"]
    with pytest.raises(ValueError, match="world of 1"):
        ttrainer.Trainer(tconfig.TrainConfig(dp_size=2), dp["mcfg"], table,
                         codebook, device="cpu")


def test_cli_under_torchrun_trains_as_one_process(dp, capsys):
    """``torchrun --nproc_per_node 2 -m llmvox_tpu_torch.train --device
    cpu``: two gloo ranks, rank 0 alone printing and writing the metrics
    and the checkpoint, whose params equal the one-process CLI's on the
    same flags (the same seeded batches) to the bound above."""
    cli, cli_dir, flags = dp["cli"]
    try:
        out, _ = cli.communicate(timeout=240)
    finally:
        cli.kill()
    assert cli.returncode == 0, out
    assert out.count("dataset:") == 1 and "rank 0 of 2" in out, out
    with open(cli_dir / "dp" / "run.metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f
                 if "train/loss" in line]
    assert steps == [1, 2, 3]
    train_main.main(flags + ["--out_dir", str(cli_dir / "one")])
    assert "rank" not in capsys.readouterr().out
    got = jckpt.load_params_npz(str(cli_dir / "dp" / "ckpt.npz"))
    want = jckpt.load_params_npz(str(cli_dir / "one" / "ckpt.npz"))
    assert jckpt.load_meta(str(cli_dir / "dp" / "ckpt.npz"))["iter_num"] == 2
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **PARAM_TOL,
                                   err_msg=name)
