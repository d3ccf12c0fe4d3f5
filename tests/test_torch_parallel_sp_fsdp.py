"""The port's sequence parallelism and FSDP in the decoder trainer
(train/{trainer,optim}.py, models/decoder.py's sequence share,
parallel/{mesh,sharding}.py) against the JAX package's ``Trainer`` at the
same layouts on the virtual 8-device mesh, and the port's one process, in
f32 on the CPU.

Eight gloo ranks are spawned once for the module (``sp`` fixture,
``tests/torch_sp_ranks.py::trainer_checks``).  Each trains the decoder of
``test_torch_parallel_tp.py`` (2 layers, 4 heads, width 64, biases, 2
draft heads) for two updates (accumulation 2, the clip active) at five
layouts of the eight ranks: sp 2 ring (dp 4), sp 4 zigzag (dp 2), FSDP
(dp 8), dp 2 x sp 2 x tp 2 with FSDP (JAX's
``tests/test_fsdp.py::test_fsdp_composes_with_tp_and_sp``), and sp 4
zigzag x tp 2 with dropout; writes a checkpoint at each, and resumes one
the one process wrote.  Meanwhile the parent runs JAX's ``Trainer`` at
the first four layouts."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.parallel import sharding as jsh
from llmvox_tpu.parallel.mesh import create_mesh as jcreate_mesh
from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import data as jdata
from llmvox_tpu.train.trainer import Trainer as JTrainer
from llmvox_tpu.utils.config import TrainConfig as JTrainConfig
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.train import trainer as ttrainer
from llmvox_tpu_torch.utils import config as tconfig

from tests import torch_sp_ranks as ranks
from tests.test_torch_parallel_tp import (DEC, LOSS_RTOL, PARAM_TOL, _leaves,
                                          _port)
from tests.torch_tp_ranks import _torch_tree

TRAIN = dict(batch_size=8, gradient_accumulation_steps=2,
             learning_rate=1e-2, warmup_iters=0, lr_decay_iters=20,
             min_lr=1e-4, grad_clip=0.3, eval_interval=1000)
DROPOUT = 0.1
# name -> (TrainConfig fields, DecoderConfig fields); JAX runs the first four
LAYOUTS = {
    "ring": (dict(sp_size=2), {}),
    "zigzag": (dict(sp_size=4, sp_layout="zigzag"), {}),
    "fsdp": (dict(fsdp=True), {}),
    "mix": (dict(dp_size=2, sp_size=2, tp_size=2, fsdp=True), {}),
    "dropout": (dict(sp_size=4, tp_size=2, sp_layout="zigzag"),
                dict(dropout=DROPOUT)),
}
JAX_LAYOUTS = ("ring", "zigzag", "fsdp", "mix")
WORLD = 8


def _jax_fields(tkw):
    sp, tp = tkw.get("sp_size", 1), tkw.get("tp_size", 1)
    return dict(tkw, dp_size=WORLD // (sp * tp), tp_size=tp)


def _batches():
    """Four bucketed batches of 8 rows at T = 32 (short rows beside long
    ones, so the sp ranks' shares hold different numbers of valid
    targets); a packed one and one at T = 36 for the refusals."""
    rng = np.random.default_rng(6)

    def sample(lo, hi):
        return jdata.Sample(
            rng.integers(0, 16, int(rng.integers(3, 12))).astype(np.int32),
            rng.integers(0, 16, int(rng.integers(lo, hi))).astype(np.int32))
    batches = [jdata.collate([sample(2, 6) for _ in range(4)]
                             + [sample(18, 31) for _ in range(4)], DEC,
                             bucket=16) for _ in range(4)]
    assert all(b[0].shape == (8, 32) for b in batches)
    packed = jdata.collate_packed([sample(3, 10) for _ in range(24)], DEC,
                                  rows=8, seq_len=32)[:4]
    odd = tuple(np.concatenate([a, a[:, :4]], axis=1) for a in batches[0])
    return batches, packed, odd


def _one_process(tcfg, mcfg, table, codebook, params, batches, out_dir):
    tr = ttrainer.Trainer(dataclasses.replace(tcfg, out_dir=out_dir), mcfg,
                          table, codebook, compute_dtype=torch.float32,
                          device="cpu", params=params)
    losses, updates = [], []
    for i, b in enumerate(batches):
        losses.append(tr.step(*b))
        if i % 2 == 1:
            updates.append(_leaves(tr.params))
    return tr, losses, updates


def _jax_runs(params, table, codebook, batches):
    """JAX's Trainer at each of JAX_LAYOUTS from the same params: each
    micro-step's loss and the params after each update."""
    out = {}
    for name in JAX_LAYOUTS:
        jt = JTrainConfig(**TRAIN, **_jax_fields(LAYOUTS[name][0]))
        jtr = JTrainer(jt, DEC, table, codebook, compute_dtype=jnp.float32)
        for a, b in zip(jax.tree.leaves(jax.device_get(jtr.state.params)),
                        jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), b)
        losses, updates = [], []
        for i, b in enumerate(batches):
            losses.append(jtr.step(*b))
            if i % 2 == 1:
                updates.append(_leaves(jax.device_get(jtr.state.params)))
        out[name] = (losses, updates, jtr)
    return out


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((DEC.text_vocab_size, DEC.text_embed_dim)
                                ).astype(np.float32)
    codebook = rng.standard_normal((DEC.vocab_size, DEC.speech_embed_dim)
                                   ).astype(np.float32)
    jt = JTrainConfig(**TRAIN)
    params = jax.tree.map(np.array, jax.device_get(JTrainer(
        jt, DEC, table, codebook, compute_dtype=jnp.float32).state.params))
    batches, packed, odd = _batches()
    tcfg = _port(jt, tconfig.TrainConfig, dp_size=-1)
    mcfg = _port(DEC, tconfig.DecoderConfig)
    one_dir = str(tmp_path_factory.mktemp("one"))
    one, ol, op = _one_process(tcfg, mcfg, table, codebook, params, batches,
                               one_dir)
    one_path = one.save_checkpoint("one")
    dec = dict(tcfg=tcfg, mcfg=mcfg, table=table, codebook=codebook,
               params=params, batches=batches, packed=packed, odd=odd,
               one_path=one_path)
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in LAYOUTS}
    res = {}
    thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.trainer_checks, WORLD, dec, LAYOUTS, dirs, threads=1,
        timeout_s=600)))
    thread.start()
    jax_runs = _jax_runs(params, table, codebook, batches)
    drop, dl, dp_ = _one_process(
        tcfg, dataclasses.replace(mcfg, dropout=DROPOUT), table, codebook,
        params, batches, one_dir)
    evals = {"one": one.estimate_loss(iter(batches[:1]), 1),
             "dropout": drop.estimate_loss(iter(batches[:1]), 1)}
    thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(ranks=res["r"], jax=jax_runs, one=(ol, op), one_tr=one,
                dropout_one=(dl, dp_), evals=evals, params=params,
                table=table, codebook=codebook, tcfg=tcfg, mcfg=mcfg)


# ---------------------------------------------------------------------------
# the updates against JAX's Trainer and the port's one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_and_lockstep(sp, layout):
    """Rank r's indices follow JAX's mesh order (tp innermost, then sp,
    then dp); after each update every rank's whole leaves (and moments)
    are bitwise equal across its dp x sp ranks, its dp shards across its
    sp group, and its leaves whole over tp across its tp group."""
    tkw = LAYOUTS[layout][0]
    s, t = tkw.get("sp_size", 1), tkw.get("tp_size", 1)
    for r, out in enumerate(sp["ranks"]):
        got = out[layout]["layout"]
        assert (got["dp"], got["sp"], got["tp"]) == (WORLD // (s * t), s, t)
        assert (got["dp_rank"], got["sp_rank"], got["tp_rank"]) == (
            r // (s * t), (r // t) % s, r % t)
        assert out[layout]["same"] == [True, True]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_losses_match_jax_and_one_process(sp, layout):
    wants = [sp["dropout_one"][0]] if layout == "dropout" else [
        sp["jax"][layout][0], sp["one"][0]]
    for r in sp["ranks"]:
        for want in wants:
            np.testing.assert_allclose(r[layout]["losses"], want,
                                       rtol=LOSS_RTOL)
    assert len({tuple(r[layout]["losses"]) for r in sp["ranks"]}) == 1


@pytest.mark.parametrize("update", [0, 1])
@pytest.mark.parametrize("oracle", ["jax", "one"])
@pytest.mark.parametrize("layout", list(JAX_LAYOUTS))
def test_params_match(sp, layout, oracle, update):
    """The gathered params after each update against JAX's Trainer at the
    same layout and the port's one process, at
    test_torch_parallel_tp.py::test_tp_params_match's bounds."""
    want = (sp["jax"][layout][1] if oracle == "jax"
            else sp["one"][1])[update]
    for r in sp["ranks"]:
        got = _leaves(_torch_tree(r[layout]["updates"][update]))
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **PARAM_TOL,
                                       err_msg=f"{layout} {update} {name}")
    start = _leaves(_torch_tree(sp["params"]))
    assert not np.array_equal(got["h/wqkv"], start["h/wqkv"])


@pytest.mark.parametrize("update", [0, 1])
def test_dropout_under_sp_and_tp_matches_one_process(sp, update):
    """dp 1 x sp 4 zigzag x tp 2 with dropout 0.1 against the one process
    with the same seed: each sp rank draws the whole sequence's masks
    from the dp index's generator and keeps its rows."""
    got_all = [_leaves(_torch_tree(r["dropout"]["updates"][update]))
               for r in sp["ranks"]]
    for name, want in sp["dropout_one"][1][update].items():
        for got in got_all:
            np.testing.assert_allclose(got[name], want, **PARAM_TOL,
                                       err_msg=f"{update} {name}")
    assert not np.allclose(sp["dropout_one"][0], sp["one"][0], rtol=1e-3)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_estimate_loss_runs_under_the_layout(sp, layout):
    """``estimate_loss`` (no dropout) at each layout after the updates
    against the one process's after its updates (with dropout for the
    dropout layout), on the same batch."""
    want = sp["evals"]["dropout" if layout == "dropout" else "one"]
    for r in sp["ranks"]:
        np.testing.assert_allclose(r[layout]["eval"], want, rtol=1e-4)


# ---------------------------------------------------------------------------
# FSDP's shares
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["fsdp", "mix"])
def test_each_rank_holds_its_share_of_params_and_moments(sp, layout):
    """Under FSDP each rank holds 1/dp (and under tp 1/tp) of every leaf
    that JAX's decoder_fsdp_shardings splits, and its AdamW moments take
    the same shard: its tensors equal the gathered tree's block, bit for
    bit; norms and biases whole over dp."""
    for r, out in enumerate(sp["ranks"]):
        run = out[layout]
        lay = run["layout"]
        dp, tp = lay["dp"], lay["tp"]
        full = _leaves(_torch_tree(run["updates"][-1]))
        names = list(run["shards"])
        for i, name in enumerate(names):
            spec = ttrainer._spec(name, True)
            fused = name.split("/")[-1] in psh.FUSED_QKV
            want = psh.shard_leaf(full[name], spec, tp, lay["tp_rank"],
                                  fused, dp, lay["dp_rank"])
            np.testing.assert_array_equal(run["shards"][name], want)
            mu = psh.shard_leaf(run["mu_full"][i], spec, tp, lay["tp_rank"],
                                fused, dp, lay["dp_rank"])
            np.testing.assert_array_equal(run["mu"][name], mu)
            cut = (dp if psh.dp_dim(spec) is not None else 1) * (
                tp if psh.tp_dim(spec) is not None else 1)
            assert run["shards"][name].size * cut == full[name].size, name
            assert ("dp" in lay["split"][i]) == (psh.dp_dim(spec)
                                                 is not None)
        assert run["shards"]["h/wqkv"].shape == (
            DEC.n_layer, DEC.n_embd // dp, 3 * DEC.n_embd // tp)
        assert run["shards"]["h/ln1_s"].shape == (DEC.n_layer, DEC.n_embd)


def test_fsdp_table_is_jaxs():
    """``decoder_fsdp_shardings`` is JAX's table leaf for leaf, and the
    optimizer state's specs put the params' specs on every moment (JAX's
    ``opt_state_shardings``: each subtree shaped like the params takes
    their shardings, the counts are replicated)."""
    from llmvox_tpu.train.optim import make_optimizer
    from llmvox_tpu_torch.train.optim import AdamW
    from llmvox_tpu_torch.utils.params import init_decoder_params
    tree = init_decoder_params(4, _port(DEC, tconfig.DecoderConfig))
    mesh = jcreate_mesh(dp_size=2, sp_size=2, tp_size=2)
    jtree = jax.tree.map(jnp.asarray, tree)
    want = jsh.decoder_fsdp_shardings(mesh, jtree)
    tmesh = pmesh.create_mesh(dp_size=2, sp_size=2, tp_size=2,
                              devices=["cpu"] * 8)
    got = _leaves_specs(psh.decoder_fsdp_shardings(tmesh, tree))
    for path, s in jax.tree_util.tree_leaves_with_path(want):
        name = "/".join(p.key for p in path)
        assert tuple(s.spec) == got[name] == ttrainer._spec(name, True), name
    jt = JTrainConfig(**TRAIN)
    jstate = jsh.opt_state_shardings(mesh, make_optimizer(jt, jtree),
                                     jtree, want)
    specs = [tuple(s.spec) for s in jax.tree.leaves(jstate)]
    n = len(got)
    assert sum(sp != () for sp in specs) == 3 * sum(
        s != () for s in got.values())
    names = list(got)
    opt = AdamW(_port(jt, tconfig.TrainConfig),
                [torch.zeros(1)] * n, [True] * n)
    state = psh.opt_state_specs(opt.state_dict(), [got[k] for k in names])
    for k in ("mu", "nu", "acc"):
        assert state[k] == [got[k2] for k2 in names]
    assert state["count"] == state["mini_step"] == ()


def _leaves_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.spec)
    return out


def test_batch_seq_sharding_is_the_trainers_split(sp):
    """``batch_seq_sharding``'s block for rank r of the (dp 4, sp 2) mesh
    is the trainer's: its dp index's rows and its sp index's contiguous
    block of T (``seq_share`` under the ring layout)."""
    tmesh = pmesh.create_mesh(dp_size=4, sp_size=2, devices=["cpu"] * 8)
    blocks = psh.batch_seq_sharding(tmesh).blocks((8, 32))
    for r, out in enumerate(sp["ranks"]):
        lay = out["ring"]["layout"]
        assert blocks[r] == (psh.dp_rows(8, lay["dp_rank"], 4),
                             psh.dp_rows(32, lay["sp_rank"], 2))
    share = tdec.seq_share(32, "cpu")
    np.testing.assert_array_equal(share.rows.numpy(), np.arange(32))


# ---------------------------------------------------------------------------
# checkpoints and refusals
# ---------------------------------------------------------------------------

def test_checkpoint_loads_in_jax_and_resumes_across_layouts(sp, tmp_path):
    """The checkpoint written at dp 2 x sp 2 x tp 2 with FSDP is the whole
    JAX layout: JAX's ``load_params_npz`` and its FSDP Trainer read it,
    and the port's one process resumes it with the moments (gathered into
    the port's file); the one process's checkpoint resumed at that
    layout gives back its params and moments bit for bit."""
    path = sp["ranks"][0]["mix"]["path"]
    assert all(r["mix"]["path"] == path for r in sp["ranks"])
    want = _leaves(_torch_tree(sp["ranks"][0]["mix"]["updates"][1]))
    for name, v in _leaves(jckpt.load_params_npz(path)).items():
        np.testing.assert_array_equal(v, want[name])
    jtr = sp["jax"]["mix"][2]
    jtr.load_checkpoint(path)
    for name, v in _leaves(jax.device_get(jtr.state.params)).items():
        np.testing.assert_array_equal(v, want[name])
    one = ttrainer.Trainer(dataclasses.replace(sp["tcfg"],
                                               out_dir=str(tmp_path)),
                           sp["mcfg"], sp["table"], sp["codebook"],
                           compute_dtype=torch.float32, device="cpu",
                           params=sp["params"])
    one.load_checkpoint(path)
    assert (one.iter_num, one.opt.count) == (4, 2)
    for name, v in _leaves(one.params).items():
        np.testing.assert_array_equal(v, want[name])
    for got, ref in zip(one.opt.mu, sp["ranks"][0]["mix"]["mu_full"]):
        np.testing.assert_array_equal(got.numpy(), ref)
    ref = sp["one_tr"]
    ref_params = _leaves(ref.params)
    for r in sp["ranks"]:
        res = r["resumed"]
        assert (res["count"], res["iter_num"]) == (2, 4)
        got = _leaves(_torch_tree(res["params"]))
        for name in ref_params:
            np.testing.assert_array_equal(got[name], ref_params[name])
        for a, b in zip(res["mu"], ref.opt.mu):
            np.testing.assert_array_equal(a, b.numpy())


def test_refusals_that_remain(sp):
    """Packed batches under sp (JAX's assertions), T not divisible by sp
    (ring) or by 2*sp (zigzag), as JAX's ValueErrors; FSDP's width not
    divisible by dp."""
    ref = sp["ranks"][0]["refused"]
    assert "not composable with packed" in ref["packed"]
    assert "T=36 not divisible by sp=8" in ref["t_ring"]
    assert "T=36 not divisible by 2*sp=8" in ref["t_zigzag"]
    with pytest.raises(ValueError, match="n_embd=64 does not split over "
                                         "dp=3"):
        psh.check_decoder_fsdp(sp["mcfg"], 3)
