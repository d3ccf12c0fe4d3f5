"""The rank side of the tensor-parallel tests (test_torch_parallel_tp.py):
one function that ``llmvox_tpu_torch.parallel.launch.spawn`` runs on each
of four gloo ranks.  A rank is a fresh interpreter, so this module
imports the port only (no JAX); the test builds every input in numpy and
passes it in, and each rank returns numpy arrays."""
import dataclasses

import numpy as np
import torch

from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _equal_over(tensors, group) -> bool:
    """Every rank's tensors bitwise equal to its group's first rank's
    (``group`` None: every rank), agreed over every rank."""
    bad = 0
    for t in tensors:
        ref = t.detach().clone()
        pmesh.broadcast_from_master(ref, group=group)
        bad += int(not torch.equal(ref, t.detach()))
    flag = torch.tensor([float(bad)])
    pmesh.all_reduce_([flag])
    return float(flag[0]) == 0.0


def _train(tr, batches):
    """Micro-steps over ``batches``: the losses, the whole params after
    each update, and after each update whether the replicated leaves are
    bitwise equal across each tp group and every leaf (shard) across each
    dp group."""
    from llmvox_tpu_torch.train.trainer import Trainer
    assert isinstance(tr, Trainer)
    losses, updates, tp_same, dp_same = [], [], [], []
    rep = [p for p, sh in zip(tr.opt.params, tr.opt.sharded) if not sh]
    state = lambda: list(tr.opt.params) + tr.opt.mu + tr.opt.nu  # noqa
    for b in batches:
        losses.append(tr.step(*b))
        if tr.opt.mini_step == 0:
            full = _np_tree(tr.full_params())
            updates.append(full)
            tp_same.append(_equal_over(rep, tr.mp.tp_group))
            dp_same.append(_equal_over(state(), tr.mp.dp_group))
    return {"losses": losses, "updates": updates, "tp_same": tp_same,
            "dp_same": dp_same}


def _refusals(tcfg, mcfg, table, codebook):
    from llmvox_tpu_torch.train.trainer import Trainer
    out = {}
    for name, kw in (("sp_size", dict(sp_size=3)),
                     ("layout", dict(sp_size=2, sp_layout="diagonal")),
                     ("fsdp", dict(fsdp=True, tp_size=2)),
                     ("tp3", dict(tp_size=3)), ("dp3", dict(dp_size=3))):
        try:
            Trainer(dataclasses.replace(tcfg, **kw), mcfg, table, codebook,
                    device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _llama(rank, lin):
    """The Llama checks on this rank's tp=2 group: logits, the B=1 chain,
    a sampled block, the pooled chain (then a continuation chunk and a
    speculative block on its state), the MoE logits, and the
    refusals."""
    from llmvox_tpu_torch.models import llama as tl
    mp = pmesh.initialize_model_parallel(2)
    g, r = mp.tp_group, mp.tp_rank
    cfg, params = lin["cfg"], _torch_tree(lin["params"])
    shard = psh.shard_llama(params, cfg, 2, r)
    out = {}
    with torch.no_grad():
        ids = torch.from_numpy(lin["ids"]).long()
        out["logits"] = tl.apply_llama(shard, ids, cfg, tp=g).numpy()
        # B=1 prefill + a greedy block of 6
        st = tl.init_llama_decode_state(cfg, batch=1, tp=g)
        out["b1_kv_heads"] = int(st.k.shape[3])
        lg, st = tl.prefill(shard, torch.from_numpy(lin["b1_ids"]).long(),
                            st, cfg, tp=g)
        first = torch.argmax(lg, dim=-1).to(torch.int32)
        toks, st = tl.decode_block(shard, first, st, cfg, block=6, tp=g)
        out["b1"] = (first.numpy(), toks.numpy())
        # the bucketed prefill: the B=1 prompt right-padded to 16
        st = tl.init_llama_decode_state(cfg, batch=1, tp=g)
        padded = torch.zeros((1, 16), dtype=torch.long)
        padded[0, :lin["b1_ids"].shape[1]] = torch.from_numpy(lin["b1_ids"])
        lg, st = tl.prefill_padded(shard, padded, lin["b1_ids"].shape[1], st,
                                   cfg, attn_len=16, tp=g)
        out["padded"] = (lg.numpy(), int(st.pos))
        # a sampled block: the ranks' generators seeded alike
        st = tl.init_llama_decode_state(cfg, batch=1, tp=g)
        lg, st = tl.prefill(shard, torch.from_numpy(lin["b1_ids"]).long(),
                            st, cfg, tp=g)
        gen = torch.Generator().manual_seed(7)
        toks, _ = tl.decode_block(shard, first, st, cfg, block=8,
                                  temperature=1.0, top_k=20, generator=gen,
                                  tp=g)
        out["sampled"] = toks.numpy()
        # the pooled programs
        pst = tl.init_llama_pool_state(cfg, batch=3, tp=g)
        pf, pst = tl.prefill_slots(
            shard, torch.from_numpy(lin["pool_tokens"]).long(),
            torch.from_numpy(lin["pool_valid"]), pst,
            torch.tensor([0, 2]), torch.ones(2, dtype=torch.bool), cfg,
            tp=g)
        ptoks, pst = tl.decode_block_pooled(
            shard, pst, torch.tensor([True, False, True]), cfg, block=6,
            tp=g)
        out["pooled"] = (pf.numpy(), ptoks.numpy())
        # a shared prefix through prefix_kv, then its suffixes
        pre = torch.from_numpy(lin["prefix"]).long()
        pk, pv = tl.prefix_kv(shard, pre, cfg, tp=g)
        pst = tl.init_llama_pool_state(cfg, batch=3, tp=g)
        xf, pst = tl.prefill_slots(
            shard, torch.from_numpy(lin["pool_tokens"]).long(),
            torch.from_numpy(lin["pool_valid"]), pst,
            torch.tensor([1, 0]), torch.ones(2, dtype=torch.bool), cfg,
            prefix_k=pk, prefix_v=pv, tp=g)
        xt, _ = tl.decode_block_pooled(shard, pst,
                                       torch.tensor([True, True, False]),
                                       cfg, block=4, tp=g)
        out["prefixed"] = (xf.numpy(), xt.numpy())
        # a continuation chunk and a speculative block with explicit
        # drafts on the tp state
        cf, pst = tl.prefill_slots_continue(
            shard, torch.from_numpy(lin["pool_tokens"][:, :4]).long(),
            torch.tensor([4, 2]), pst, torch.tensor([1, 0]),
            torch.ones(2, dtype=torch.bool), pst.pos[[1, 0]], cfg, tp=g)
        st_toks, pst, iters = tl.decode_block_spec_pooled(
            shard, pst, torch.tensor([True, True, False]), cfg, block=2,
            draft_tokens=torch.zeros((3, 2), dtype=torch.int32), tp=g)
        out["continued"] = (cf.numpy(), st_toks.numpy(), pst.pos.numpy(),
                            iters.numpy())
        # the MoE Llama at ep 1, tp 2
        mcfg, mparams = lin["moe_cfg"], _torch_tree(lin["moe_params"])
        mshard = psh.shard_llama(mparams, mcfg, 2, r)
        out["moe_logits"] = tl.apply_llama(
            mshard, torch.from_numpy(lin["moe_ids"]).long(), mcfg,
            tp=g).numpy()
    # every rank of the world splits over tp 4: n_kv_head 2 is refused
    mp4 = pmesh.initialize_model_parallel(4)
    try:
        tl.init_llama_decode_state(cfg, tp=mp4.tp_group)
        out["kv4"] = None
    except ValueError as e:
        out["kv4"] = str(e)
    return out


def _local_group(group, rank):
    """The collectives over a one-rank group, and an all-reduce over
    None (every rank), of a value equal to the rank."""
    x = torch.tensor([float(rank)])
    pmesh.all_reduce_([x], group=group)
    rows = pmesh.gather_rows(torch.tensor([float(rank)]), group=group)
    b = pmesh.broadcast_from_master(torch.tensor([float(rank)]), group=group)
    w = torch.tensor([float(rank)])
    pmesh.all_reduce_([w])
    return {"is_local": group is pmesh.LOCAL, "reduced": int(x[0]),
            "gathered": [int(v) for v in rows], "broadcast": int(b[0]),
            "world_sum": int(w[0])}


def tp_checks(rank, dec, lin, out_dirs):
    """Every tensor-parallel check on one of four ranks: the decoder
    trainer at dp 2 x tp 2 (dropout off; a checkpoint written at tp 1
    resumed, and one written), at dp 1 x tp 4 with dropout, the refusals,
    then the Llama at tp 2."""
    from llmvox_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    tcfg, mcfg = dec["tcfg"], dec["mcfg"]
    table, codebook, params = dec["table"], dec["codebook"], dec["params"]
    out = {"refused": _refusals(tcfg, mcfg, table, codebook)}
    tr = Trainer(dataclasses.replace(tcfg, tp_size=2,
                                     out_dir=out_dirs["tp"]), mcfg, table,
                 codebook, compute_dtype=torch.float32, device="cpu",
                 params=params)
    out["a_layout"] = (tr.dp, tr.tp, tr.mp.dp_rank, tr.mp.tp_rank)
    out["a_shapes"] = {n: tuple(p.shape) for n, p in
                       zip(tr.names, tr.opt.params)}
    out["a"] = _train(tr, dec["batches"])
    out["a_path"] = tr.save_checkpoint("tp")
    # the one-process checkpoint resumed at dp 2 x tp 2
    tr.load_checkpoint(dec["one_path"])
    out["resumed"] = {"params": _np_tree(tr.full_params()),
                      "mu": [m.numpy().copy() for m in
                             tr._gather(tr.opt.mu)],
                      "count": tr.opt.count, "iter_num": tr.iter_num}
    del tr
    trb = Trainer(dataclasses.replace(tcfg, tp_size=4, dp_size=1),
                  dataclasses.replace(mcfg, dropout=dec["dropout"]), table,
                  codebook, compute_dtype=torch.float32, device="cpu",
                  params=params)
    out["b"] = _train(trb, dec["batches"])
    out["local"] = _local_group(trb.mp.dp_group, rank)
    del trb
    out["llama"] = _llama(rank, lin)
    return out
