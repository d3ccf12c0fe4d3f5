"""The port's Megatron tensor parallelism (parallel/{mesh,sharding,
tensor_parallel}.py, the tp paths of train/{trainer,optim}.py,
models/{decoder,llama}.py and ops/moe.py) against the JAX package's
GSPMD runs on the same numpy inputs, in f32 on the CPU.

Four gloo ranks are spawned once for the module (``tp`` fixture,
``tests/torch_tp_ranks.py``).  Each trains the decoder (2 layers, 4
heads, width 64, biases, 2 draft heads) at dp 2 x tp 2 with dropout off
(two updates, accumulation 2, the clip active), resumes a checkpoint the
one-process trainer wrote, trains at dp 1 x tp 4 with dropout on, and
then, in tp groups of 2, runs the Llama (the HF-pair size of
``tests/test_llama.py``: 4 heads, 2 KV heads) and the MoE Llama of
``tests/test_moe.py::_moe_cfg``.  Meanwhile the parent compiles JAX's
side: the trainer's step over ``decoder_param_shardings`` on a dp 2 x tp
2 mesh (``__graft_entry__.py``'s multichip dry run), JAX's
``Trainer(tp_size=2, dp_size=2)``, and ``llama_param_shardings`` runs of
``apply_llama``, the B=1 and pooled chains and the MoE forward."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from llmvox_tpu.models import llama as jl
from llmvox_tpu.ops import quant as jq
from llmvox_tpu.parallel.mesh import create_mesh as jcreate_mesh
from llmvox_tpu.parallel import sharding as jsh
from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import data as jdata
from llmvox_tpu.train.optim import make_optimizer
from llmvox_tpu.train.trainer import (Trainer as JTrainer, TrainState,
                                      make_train_step)
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu.utils.config import TrainConfig as JTrainConfig
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.ops import quant as tq
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel import tensor_parallel as tpar
from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.train import trainer as ttrainer
from llmvox_tpu_torch.utils import config as tconfig

from tests import torch_dp_ranks
from tests import torch_tp_ranks as ranks

DEC = JDecoderConfig(n_layer=2, n_head=4, n_embd=64, block_size=64,
                     vocab_size=16, bias=True, text_embed_dim=24,
                     speech_embed_dim=40, text_vocab_size=20,
                     pad_token_id=17, text_eos_id=18, eoa_token_id=7,
                     n_draft_heads=2)
TRAIN = dict(batch_size=4, gradient_accumulation_steps=2,
             learning_rate=1e-2, warmup_iters=0, lr_decay_iters=20,
             min_lr=1e-4, grad_clip=0.3, eval_interval=1000)
DROPOUT = 0.1
# f32, lr 1e-2: the bounds of the data-parallel tests
# (test_torch_parallel_train.py)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=2e-6, rtol=1e-5)
# JAX's own bounds for its sharded Llama (tests/test_llama.py,
# tests/test_moe.py)
LOGIT_ATOL = 2e-5
MOE_TOL = dict(atol=2e-5, rtol=2e-4)

LCFG = jl.LlamaConfig(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
                      n_embd=32, intermediate_size=64, max_seq_len=64)
MOE = jl.LlamaConfig(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2,
                     n_embd=32, intermediate_size=48, max_seq_len=64,
                     n_experts=4, moe_top_k=2, moe_capacity_factor=8.0)
PROMPTS = [[5, 9, 13, 2, 7, 44, 3], [17, 1, 90, 23, 8]]


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


def _leaves(tree):
    return {k: v.numpy().copy() for k, v in
            torch_dp_ranks._leaves(tree).items()}


def _batches():
    """Two bucketed batches (short rows beside long ones), then two
    packed ones, 4 rows each."""
    rng = np.random.default_rng(5)

    def sample(lo, hi):
        return jdata.Sample(
            rng.integers(0, 16, int(rng.integers(3, 12))).astype(np.int32),
            rng.integers(0, 16, int(rng.integers(lo, hi))).astype(np.int32))
    out = []
    for _ in range(2):
        out.append(jdata.collate([sample(2, 5), sample(2, 6),
                                  sample(20, 30), sample(18, 31)], DEC,
                                 bucket=16))
    for _ in range(2):
        out.append(jdata.collate_packed([sample(3, 10) for _ in range(12)],
                                        DEC, rows=4, seq_len=24)[:4])
    return out


def _llama_params(cfg, seed):
    """A Llama tree in the JAX layout, numpy f32, weights wide enough
    (std 0.2) that greedy picks sit far from ties."""
    rng = np.random.default_rng(seed)
    l, c, hd = cfg.n_layer, cfg.n_embd, cfg.head_dim

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)
    h = {"ln1_s": np.ones((l, c), np.float32),
         "ln2_s": np.ones((l, c), np.float32),
         "wq": w(l, c, cfg.n_head * hd), "wk": w(l, c, cfg.n_kv_head * hd),
         "wv": w(l, c, cfg.n_kv_head * hd), "wo": w(l, cfg.n_head * hd, c)}
    i, e = cfg.intermediate_size, cfg.n_experts
    if e:
        h.update(router=w(l, c, e), moe_wgate=w(l, e, c, i),
                 moe_wup=w(l, e, c, i), moe_wdown=w(l, e, i, c))
    else:
        h.update(wgate=w(l, c, i), wup=w(l, c, i), wdown=w(l, i, c))
    return {"tok_emb": w(cfg.vocab_size, c), "h": h,
            "lnf_s": np.ones((c,), np.float32),
            "head": w(c, cfg.vocab_size)}


def _pool_inputs():
    tokens = np.zeros((2, 16), np.int32)
    valid = np.zeros((2,), np.int32)
    for i, pr in enumerate(PROMPTS):
        tokens[i, :len(pr)] = pr
        valid[i] = len(pr)
    return tokens, valid


def _jax_llama(params, lin):
    """JAX's runs over ``llama_param_shardings`` on a tp=2 mesh, and the
    MoE forward on (dp 4, ep 1, tp 2)."""
    mesh = jcreate_mesh(dp_size=1, tp_size=2)
    sh = jax.device_put(params, jsh.llama_param_shardings(mesh, params))
    out = {"logits": np.asarray(jax.jit(jl.apply_llama, static_argnums=2)(
        sh, jnp.asarray(lin["ids"], jnp.int32), LCFG))}
    st = jl.init_llama_decode_state(LCFG, batch=1)
    lg, st = jl.prefill(sh, jnp.asarray(lin["b1_ids"], jnp.int32), st, LCFG)
    first = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    toks, _ = jl.decode_block(sh, first, st, jax.random.PRNGKey(0), LCFG,
                              block=6)
    out["b1"] = (np.asarray(first), np.asarray(toks))
    pst = jl.init_llama_pool_state(LCFG, batch=3)
    tokens, valid = _pool_inputs()
    pf, pst = jl.prefill_slots(sh, jnp.asarray(tokens), jnp.asarray(valid),
                               pst, jnp.asarray([0, 2], np.int32),
                               jnp.ones((2,), bool), jax.random.PRNGKey(0),
                               LCFG)
    ptoks, _ = jl.decode_block_pooled(sh, pst,
                                      jnp.asarray([True, False, True]),
                                      jax.random.PRNGKey(1), LCFG, block=6)
    out["pooled"] = (np.asarray(pf), np.asarray(ptoks))
    mmesh = jcreate_mesh(dp_size=4, ep_size=1, tp_size=2)
    mp = lin["moe_params"]
    msh = jax.device_put(mp, jsh.llama_param_shardings(mmesh, mp))
    out["moe_logits"] = np.asarray(jax.jit(
        jl.apply_llama, static_argnums=(2,))(
            msh, jnp.asarray(lin["moe_ids"], jnp.int32), MOE))
    return out


def _jax_sharded_steps(params, table, codebook, batches, jt):
    """JAX's train step over ``decoder_param_shardings`` on a dp 2 x tp 2
    mesh (the dry run's composition; JAX's table has no draft heads, so
    they are replicated): each micro-step's loss and the params after
    each update."""
    mesh = jcreate_mesh(dp_size=2, tp_size=2)
    body = {k: v for k, v in params.items() if k != "draft_heads"}
    shard = jsh.decoder_param_shardings(mesh, body)
    shard["draft_heads"] = NamedSharding(mesh, P())
    p = jax.device_put(jax.tree.map(jnp.asarray, params), shard)
    tx = make_optimizer(jt, p)
    state = TrainState(p, jax.jit(tx.init)(p), jnp.int32(0))
    rep, bsh = jsh.replicated(mesh), jsh.batch_sharding(mesh)
    tab, cb = jax.device_put(table, rep), jax.device_put(codebook, rep)
    step = jax.jit(make_train_step(DEC, tx, jnp.float32))
    losses, updates = [], []
    for i, b in enumerate(batches):
        dev = [jax.device_put(jnp.asarray(a), bsh) for a in b]
        extra = dev[2:] if len(dev) == 4 else (None, None)
        state, loss = step(state, tab, cb, dev[0], dev[1],
                           jax.random.PRNGKey(i), *extra)
        losses.append(float(loss))
        if i % 2 == 1:
            updates.append(_leaves(jax.device_get(state.params)))
    return losses, updates


def _one_process(tcfg, mcfg, table, codebook, params, batches, out_dir=None):
    tr = ttrainer.Trainer(dataclasses.replace(
        tcfg, dp_size=1, out_dir=out_dir or tcfg.out_dir), mcfg, table,
        codebook, compute_dtype=torch.float32, device="cpu", params=params)
    losses, updates = [], []
    for i, b in enumerate(batches):
        losses.append(tr.step(*b))
        if i % 2 == 1:
            updates.append(_leaves(tr.params))
    return tr, losses, updates


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    jt = JTrainConfig(dp_size=2, tp_size=2, **TRAIN)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((DEC.text_vocab_size, DEC.text_embed_dim)
                                ).astype(np.float32)
    codebook = rng.standard_normal((DEC.vocab_size, DEC.speech_embed_dim)
                                   ).astype(np.float32)
    jtr = JTrainer(jt, DEC, table, codebook, compute_dtype=jnp.float32)
    assert (jtr.mesh.shape["dp"], jtr.mesh.shape["tp"]) == (2, 2)
    params = jax.tree.map(np.array, jax.device_get(jtr.state.params))
    batches = _batches()
    tcfg = _port(jt, tconfig.TrainConfig, dp_size=-1, tp_size=1)
    mcfg = _port(DEC, tconfig.DecoderConfig)
    one_dir = str(tmp_path_factory.mktemp("one"))
    one, ol, op = _one_process(tcfg, mcfg, table, codebook, params, batches,
                               one_dir)
    one_path = one.save_checkpoint("one")
    one_mu = [m.numpy().copy() for m in one.opt.mu]
    dec = dict(tcfg=tcfg, mcfg=mcfg, table=table, codebook=codebook,
               params=params, batches=batches, one_path=one_path,
               dropout=DROPOUT)
    lrng = np.random.default_rng(3)
    lin = dict(cfg=tl.LlamaConfig(**dataclasses.asdict(LCFG)),
               params=_llama_params(LCFG, 1),
               ids=lrng.integers(0, LCFG.vocab_size, (2, 7)),
               b1_ids=lrng.integers(0, LCFG.vocab_size, (1, 6)),
               pool_tokens=_pool_inputs()[0], pool_valid=_pool_inputs()[1],
               prefix=lrng.integers(0, LCFG.vocab_size, (1, 5)),
               moe_cfg=tl.LlamaConfig(**dataclasses.asdict(MOE)),
               moe_params=_llama_params(MOE, 2),
               moe_ids=lrng.integers(0, 64, (2, 9)))
    dirs = {"tp": str(tmp_path_factory.mktemp("tp"))}
    res = {}
    thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.tp_checks, 4, dec, lin, dirs, threads=1, timeout_s=300)))
    thread.start()
    jl_, jp = [], []
    for i, b in enumerate(batches):
        jl_.append(jtr.step(*b))
        if i % 2 == 1:
            jp.append(_leaves(jax.device_get(jtr.state.params)))
    sl, sp = _jax_sharded_steps(params, table, codebook, batches, jt)
    jllama = _jax_llama(lin["params"], lin)
    _, dl, dp_ = _one_process(
        tcfg, dataclasses.replace(mcfg, dropout=DROPOUT), table, codebook,
        params, batches)
    thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(ranks=res["r"], jax_trainer=(jl_, jp), jax_sharded=(sl, sp),
                one=(ol, op), one_mu=one_mu, dropout_one=(dl, dp_),
                jllama=jllama, lin=lin, params=params, table=table,
                codebook=codebook, tcfg=tcfg, mcfg=mcfg, jtr=jtr)


# ---------------------------------------------------------------------------
# the decoder trainer
# ---------------------------------------------------------------------------

def test_ranks_split_dp_by_tp_with_tp_innermost(tp):
    """Rank r is tp index r % 2 and dp index r // 2 (JAX's create_mesh
    order); each holds half of the split leaves, the fused QKV too.  At
    dp 1 x tp 4 the dp group is this rank alone (``LOCAL``): the
    collectives over it leave a rank's values as they are, where None
    (every rank) sums them."""
    c = DEC.n_embd
    for r, out in enumerate(tp["ranks"]):
        assert out["local"] == {"is_local": True, "reduced": r,
                                "gathered": [r], "broadcast": r,
                                "world_sum": 6}
        assert out["a_layout"] == (2, 2, r // 2, r % 2)
        shapes = out["a_shapes"]
        assert shapes["h/wqkv"] == (2, c, 3 * c // 2)
        assert shapes["h/bqkv"] == (2, 3 * c // 2)
        assert shapes["h/wo"] == (2, c // 2, c)
        assert shapes["h/wfc"] == (2, c, 2 * c)
        assert shapes["h/wproj"] == (2, 2 * c, c)
        assert shapes["h/bo"] == shapes["h/bproj"] == (2, c)
        assert shapes["draft_heads"] == (2, c, DEC.vocab_size)


def test_tp_losses_match_jax_sharded_step_jax_trainer_and_one_process(tp):
    for r in tp["ranks"]:
        for want in (tp["jax_sharded"][0], tp["jax_trainer"][0],
                     tp["one"][0]):
            np.testing.assert_allclose(r["a"]["losses"], want,
                                       rtol=LOSS_RTOL)
    assert len({tuple(r["a"]["losses"]) for r in tp["ranks"]}) == 1


@pytest.mark.parametrize("update", [0, 1])
@pytest.mark.parametrize("oracle", ["jax_sharded", "jax_trainer", "one"])
def test_tp_params_match(tp, update, oracle):
    """The gathered params after each update (dp 2 x tp 2, clipping on:
    the norm summed over the tp group) against JAX's sharded step, JAX's
    Trainer(tp_size=2, dp_size=2) and the port's one process."""
    want = tp[oracle][1][update]
    for r in tp["ranks"]:
        got = r["a"]["updates"][update]
        got = _leaves(ranks._torch_tree(got))
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **PARAM_TOL,
                                       err_msg=f"{oracle} {update} {name}")
    start = _leaves(ranks._torch_tree(tp["params"]))
    assert not np.array_equal(got["h/wqkv"], start["h/wqkv"])


def test_the_clip_is_active(tp):
    """The first update's global norm is above grad_clip (so the clip
    scales it, and the tp sum of the sharded squares matters)."""
    tcfg = tp["tcfg"]
    tr = ttrainer.Trainer(tcfg, tp["mcfg"], tp["table"], tp["codebook"],
                          compute_dtype=torch.float32, device="cpu",
                          params=tp["params"])
    norms, norm = [], tr.opt._global_norm

    def spy(grads):
        norms.append(norm(grads))
        return norms[-1]
    tr.opt._global_norm = spy
    for b in _batches()[:2]:
        tr.step(*b)
    assert float(norms[0]) > tcfg.grad_clip


def test_replicated_leaves_are_bitwise_equal_across_the_tp_group(tp):
    """After each update the replicated leaves (norms, biases after the
    row-parallel matmuls, wpe, head, draft heads) are equal bit for bit
    on the ranks of each tp group, and every shard, moment and
    accumulator across each dp group; with dropout on (dp 1 x tp 4) too,
    because the ranks of a tp group draw the same masks."""
    for r in tp["ranks"]:
        for run in ("a", "b"):
            assert r[run]["tp_same"] == [True, True], run
            assert r[run]["dp_same"] == [True, True], run


@pytest.mark.parametrize("update", [0, 1])
def test_dropout_run_matches_one_process(tp, update):
    """dp 1 x tp 4 with dropout 0.1 against the one-process trainer with
    the same seed: the masks are the same draws."""
    dl, dp_ = tp["dropout_one"]
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["b"]["losses"], dl, rtol=LOSS_RTOL)
        got = _leaves(ranks._torch_tree(r["b"]["updates"][update]))
        for name, want in dp_[update].items():
            np.testing.assert_allclose(got[name], want, **PARAM_TOL,
                                       err_msg=f"{update} {name}")
    assert not np.allclose(dl, tp["one"][0], rtol=1e-3)


def test_tp_checkpoint_loads_in_jax_and_one_process(tp):
    """The checkpoint written at dp 2 x tp 2 is the full JAX layout: JAX's
    ``load_params_npz`` and ``Trainer.load_checkpoint`` read it, and the
    port resumes it at tp 1 with the optimizer's moments (gathered into
    the port's layout)."""
    path = tp["ranks"][0]["a_path"]
    assert all(r["a_path"] == path for r in tp["ranks"])
    want = _leaves(ranks._torch_tree(tp["ranks"][0]["a"]["updates"][1]))
    for name, v in _leaves(jckpt.load_params_npz(path)).items():
        np.testing.assert_array_equal(v, want[name])
    one = ttrainer.Trainer(tp["tcfg"], tp["mcfg"], tp["table"],
                           tp["codebook"], compute_dtype=torch.float32,
                           device="cpu", params=tp["params"])
    one.load_checkpoint(path)
    assert (one.iter_num, one.opt.count) == (4, 2)
    for name, v in _leaves(one.params).items():
        np.testing.assert_array_equal(v, want[name])
    for got, ref in zip(one.opt.mu, tp["one_mu"]):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-7, rtol=1e-4)
    jtr = tp["jtr"]
    jtr.load_checkpoint(path)
    for name, v in _leaves(jax.device_get(jtr.state.params)).items():
        np.testing.assert_array_equal(v, want[name])


def test_one_process_checkpoint_resumes_at_tp2(tp):
    """A checkpoint written at tp 1 loads at dp 2 x tp 2: the gathered
    params and moments are the file's, bit for bit."""
    one = _leaves(ranks._torch_tree(tp["one"][1][1]))
    for r in tp["ranks"]:
        res = r["resumed"]
        assert (res["count"], res["iter_num"]) == (2, 4)
        got = _leaves(ranks._torch_tree(res["params"]))
        for name in one:
            np.testing.assert_array_equal(got[name], one[name])
        for a, b in zip(res["mu"], tp["one_mu"]):
            np.testing.assert_array_equal(a, b)


def test_trainer_refusals(tp):
    """An sp_size that does not divide the world, an unknown sp_layout, a
    tp that does not divide the world, a dp_size that is not world / tp,
    and n_head % tp are refused; FSDP at dp 2 x tp 2 is built (it trains
    in test_torch_parallel_sp_fsdp.py)."""
    ref = tp["ranks"][0]["refused"]
    assert "sp_size=3" in ref["sp_size"]
    assert "sp_layout 'diagonal'" in ref["layout"]
    assert ref["fsdp"] is None
    assert "tp_size=3" in ref["tp3"]
    assert "world of 4" in ref["dp3"]
    with pytest.raises(ValueError, match="n_head=4"):
        psh.check_decoder_tp(tp["mcfg"], 3)
    with pytest.raises(ValueError, match="tp_size=2"):
        ttrainer.Trainer(dataclasses.replace(tp["tcfg"], tp_size=2),
                         tp["mcfg"], tp["table"], tp["codebook"],
                         device="cpu")


# ---------------------------------------------------------------------------
# sharding: the tables, the round trip, the fused QKV by heads
# ---------------------------------------------------------------------------

def test_spec_tables_are_jaxs():
    """The port's tables are JAX's specs leaf for leaf (the decoder's
    draft heads, which JAX's table lacks, replicated)."""
    mesh = jcreate_mesh(dp_size=1, tp_size=2)
    tree = _dec_tree()
    del tree["draft_heads"]
    want = jax.tree_util.tree_leaves_with_path(
        jsh.decoder_param_shardings(mesh, tree))
    for path, s in want:
        name = "/".join(p.key for p in path)
        got = ttrainer._spec(name)
        assert tuple(s.spec) == got, name
    assert ttrainer._spec("draft_heads") == ()
    lp = _llama_params(MOE, 0)
    lp["h"].update({k: v for k, v in _llama_params(LCFG, 0)["h"].items()
                    if k in ("wgate", "wup", "wdown")})
    lp["draft_heads"] = np.zeros((2, MOE.n_embd, MOE.vocab_size),
                                 np.float32)
    want = jax.tree_util.tree_leaves_with_path(
        jsh.llama_param_shardings(mesh, lp))
    for path, s in want:
        node = psh.LLAMA_TP_SPECS
        for p in path:
            node = node[p.key]
        assert tuple(s.spec) == node, path


def _dec_tree():
    from llmvox_tpu_torch.utils.params import init_decoder_params
    return init_decoder_params(4, _port(DEC, tconfig.DecoderConfig))


@pytest.mark.parametrize("tree", ["decoder", "llama", "moe"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_gather_round_trip_is_exact(tree, n):
    """Every rank's shard gathered back is the tree, exactly, for numpy
    and torch leaves (4 KV heads, so tp 4 splits them too)."""
    lcfg = dataclasses.replace(LCFG, n_kv_head=4)
    full = (_dec_tree() if tree == "decoder" else _llama_params(
        lcfg if tree == "llama" else dataclasses.replace(MOE, n_kv_head=4),
        0))
    specs = psh.DECODER_TP_SPECS if tree == "decoder" else psh.LLAMA_TP_SPECS
    want = torch_dp_ranks._leaves(ranks._torch_tree(full))
    for as_torch in (False, True):
        src = ranks._torch_tree(full) if as_torch else full
        shards = [torch_dp_ranks._leaves(psh.shard_tree(src, specs, n, r))
                  for r in range(n)]
        for name, w in want.items():
            spec = specs
            for k in name.split("/"):
                spec = spec[k]
            if psh.tp_dim(spec) is None:
                # a replicated leaf: every rank's is the whole leaf
                assert all(torch.equal(s[name], w) for s in shards), name
                continue
            # each shard placed in a zero-filled leaf: the ranks' sum (the
            # trainer's all-reduce of its split leaves) is the leaf
            fused = name.split("/")[-1] in psh.FUSED_QKV
            total = sum(psh.place_shard(shards[r][name], w.shape, spec, n,
                                        r, fused) for r in range(n))
            assert torch.equal(total, w), (name, as_torch)


def test_fused_qkv_is_cut_by_heads_not_by_jaxs_blocks():
    """Rank r's wqkv shard is head block r of q, of k and of v; JAX's
    ``addressable_shards`` of the same spec (the port's ``Sharding.blocks``
    equal them) are contiguous blocks, rank 0's all of q at tp 2."""
    full = _dec_tree()
    c = DEC.n_embd
    w = np.asarray(full["h"]["wqkv"])
    mesh = jcreate_mesh(dp_size=1, tp_size=2)
    jspec = jsh.decoder_param_shardings(mesh, {"h": {"wqkv": w}})
    arr = jax.device_put(w, jspec["h"]["wqkv"])
    jblocks = [np.asarray(s.data) for s in arr.addressable_shards]
    tmesh = pmesh.create_mesh(dp_size=1, tp_size=2, devices=["cpu"] * 2)
    blocks = psh.Sharding(tmesh, psh.DECODER_TP_SPECS["h"]["wqkv"]).blocks(
        w.shape)
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_array_equal(w[b], jb)
    np.testing.assert_array_equal(jblocks[0], w[..., :c + c // 2])
    for r in range(2):
        got = psh.shard_leaf(w, psh.DECODER_TP_SPECS["h"]["wqkv"], 2, r,
                             fused=True)
        h = slice(r * c // 2, (r + 1) * c // 2)
        want = np.concatenate([w[..., :c][..., h], w[..., c:2 * c][..., h],
                               w[..., 2 * c:][..., h]], axis=-1)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, jblocks[r])


# ---------------------------------------------------------------------------
# the Llama and the MoE
# ---------------------------------------------------------------------------

def test_llama_logits_match_jax_sharded(tp):
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["llama"]["logits"],
                                   tp["jllama"]["logits"], atol=LOGIT_ATOL)


def test_llama_b1_chain_matches_jax_sharded(tp):
    """prefill + decode_block(block=6) on caches of the local KV heads:
    the greedy tokens JAX's sharded run picks."""
    f, t = tp["jllama"]["b1"]
    for r in tp["ranks"]:
        assert r["llama"]["b1_kv_heads"] == LCFG.n_kv_head // 2
        np.testing.assert_array_equal(r["llama"]["b1"][0], f)
        np.testing.assert_array_equal(r["llama"]["b1"][1], t)


def test_llama_padded_prefill_matches_one_process(tp):
    """prefill_padded (a bucket of 16, attn_len 16) at tp 2: the logits
    at the last valid position and pos, against the one process."""
    lin = tp["lin"]
    cfg, params = lin["cfg"], ranks._torch_tree(lin["params"])
    n = lin["b1_ids"].shape[1]
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :n] = torch.from_numpy(lin["b1_ids"])
    with torch.no_grad():
        want, st = tl.prefill_padded(params, padded, n,
                                     tl.init_llama_decode_state(cfg), cfg,
                                     attn_len=16)
    for r in tp["ranks"]:
        got, pos = r["llama"]["padded"]
        assert pos == int(st.pos) == n
        np.testing.assert_allclose(got, want.numpy(), atol=LOGIT_ATOL)


def test_llama_sampled_block_is_one_process_draw(tp):
    """A sampled block with the ranks' generators seeded alike: every
    rank picks the tokens the one-process run draws with that seed."""
    lin = tp["lin"]
    cfg, params = lin["cfg"], ranks._torch_tree(lin["params"])
    with torch.no_grad():
        st = tl.init_llama_decode_state(cfg, batch=1)
        lg, st = tl.prefill(params, torch.from_numpy(lin["b1_ids"]).long(),
                            st, cfg)
        first = torch.argmax(lg, dim=-1).to(torch.int32)
        want, _ = tl.decode_block(params, first, st, cfg, block=8,
                                  temperature=1.0, top_k=20,
                                  generator=torch.Generator().manual_seed(7))
    for r in tp["ranks"]:
        np.testing.assert_array_equal(r["llama"]["sampled"], want.numpy())


def test_llama_pooled_chain_matches_jax_sharded(tp):
    """prefill_slots + decode_block_pooled (an inactive middle slot):
    JAX's sharded run's first tokens and active rows."""
    f, t = tp["jllama"]["pooled"]
    for r in tp["ranks"]:
        np.testing.assert_array_equal(r["llama"]["pooled"][0], f)
        np.testing.assert_array_equal(r["llama"]["pooled"][1][[0, 2]],
                                      t[[0, 2]])


def test_llama_prefix_kv_under_tp_matches_one_process(tp):
    """prefix_kv's local heads seed prefill_slots: the chain equals the
    one-process pool's on the same prefix."""
    lin = tp["lin"]
    cfg, params = lin["cfg"], ranks._torch_tree(lin["params"])
    with torch.no_grad():
        pk, pv = tl.prefix_kv(params, torch.from_numpy(lin["prefix"]).long(),
                              cfg)
        st = tl.init_llama_pool_state(cfg, batch=3)
        f, st = tl.prefill_slots(
            params, torch.from_numpy(lin["pool_tokens"]).long(),
            torch.from_numpy(lin["pool_valid"]), st, torch.tensor([1, 0]),
            torch.ones(2, dtype=torch.bool), cfg, prefix_k=pk, prefix_v=pv)
        t, _ = tl.decode_block_pooled(params, st,
                                      torch.tensor([True, True, False]),
                                      cfg, block=4)
    for r in tp["ranks"]:
        np.testing.assert_array_equal(r["llama"]["prefixed"][0], f.numpy())
        np.testing.assert_array_equal(r["llama"]["prefixed"][1][:2],
                                      t.numpy()[:2])


def test_moe_logits_match_jax_ep1_tp2(tp):
    """The MoE Llama at ep 1, tp 2 (each expert's hidden split, one
    all-reduce after the combine) against JAX's apply_llama over
    llama_param_shardings on create_mesh(dp 4, ep 1, tp 2)."""
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["llama"]["moe_logits"],
                                   tp["jllama"]["moe_logits"], **MOE_TOL)


def test_llama_refusals(tp):
    """n_kv_head % tp is refused by the caches and ``check_llama_tp``; a
    tp state is no longer refused by prefill_slots_continue and the
    speculative pooled block: on the prefixed pool's state both run at tp
    2 and equal the one process."""
    assert "n_kv_head=2" in tp["ranks"][0]["llama"]["kv4"]
    with pytest.raises(ValueError, match="n_kv_head=2"):
        psh.check_llama_tp(tp["lin"]["cfg"], 4)
    lin = tp["lin"]
    cfg, params = lin["cfg"], ranks._torch_tree(lin["params"])
    with torch.no_grad():
        pk, pv = tl.prefix_kv(params, torch.from_numpy(lin["prefix"]).long(),
                              cfg)
        st = tl.init_llama_pool_state(cfg, batch=3)
        _, st = tl.prefill_slots(
            params, torch.from_numpy(lin["pool_tokens"]).long(),
            torch.from_numpy(lin["pool_valid"]), st, torch.tensor([1, 0]),
            torch.ones(2, dtype=torch.bool), cfg, prefix_k=pk, prefix_v=pv)
        tl.decode_block_pooled(params, st, torch.tensor([True, True, False]),
                               cfg, block=4)
        cf, st = tl.prefill_slots_continue(
            params, torch.from_numpy(lin["pool_tokens"][:, :4]).long(),
            torch.tensor([4, 2]), st, torch.tensor([1, 0]),
            torch.ones(2, dtype=torch.bool), st.pos[[1, 0]], cfg)
        toks, st, iters = tl.decode_block_spec_pooled(
            params, st, torch.tensor([True, True, False]), cfg, block=2,
            draft_tokens=torch.zeros((3, 2), dtype=torch.int32))
    for r in tp["ranks"]:
        got = r["llama"]["continued"]
        np.testing.assert_array_equal(got[0], cf.numpy())
        np.testing.assert_array_equal(got[1][:2], toks.numpy()[:2])
        np.testing.assert_array_equal(got[2], st.pos.numpy())
        np.testing.assert_array_equal(got[3], iters.numpy())


def test_quantized_tree_fails_in_jax_and_is_refused():
    """JAX's ``llama_param_shardings`` raises on a w4 tree (its walk reads
    ``.key`` of an Int4Tensor's fields); the port refuses it by name."""
    params = _llama_params(LCFG, 0)
    mesh = jcreate_mesh(dp_size=1, tp_size=2)
    jtree = jq.quantize_llama_params(jax.tree.map(jnp.asarray, params), "w4")
    with pytest.raises(AttributeError, match="key"):
        jsh.llama_param_shardings(mesh, jtree)
    ttree = tq.quantize_llama_params(params, "w4")
    cfg = tl.LlamaConfig(**dataclasses.asdict(LCFG))
    for tp in (1, 2):
        with pytest.raises(ValueError, match="quantized"):
            psh.shard_llama(ttree, cfg, tp, 0)


def test_experts_over_ep_shard_by_expert_blocks():
    """``shard_llama(..., ep=2)`` gives each ep rank its contiguous half
    of the experts (the router and the rest whole); a dense tree is whole
    over ep."""
    moe = tl.LlamaConfig(**dataclasses.asdict(MOE))
    full = _llama_params(MOE, 0)
    for r in range(2):
        shard = psh.shard_llama(full, moe, 1, 0, ep=2, ep_rank=r)
        for k in ("moe_wgate", "moe_wup", "moe_wdown"):
            np.testing.assert_array_equal(shard["h"][k],
                                          full["h"][k][:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(shard["h"]["router"],
                                      full["h"]["router"])
    dense = psh.shard_llama(_llama_params(LCFG, 0),
                            tl.LlamaConfig(**dataclasses.asdict(LCFG)), 1, 0,
                            ep=2, ep_rank=1)
    np.testing.assert_array_equal(dense["h"]["wgate"],
                                  _llama_params(LCFG, 0)["h"]["wgate"])


def test_operators_are_the_identity_without_a_group():
    x = torch.randn(3, 4, requires_grad=True)
    for group in (None, pmesh.LOCAL):
        for op in (tpar.copy_to_tp, tpar.reduce_from_tp):
            assert op(x, group) is x
        assert tpar.size(group) == 1 and not tpar.active(group)
