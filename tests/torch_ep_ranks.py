"""The rank side of the expert-parallel tests (test_torch_parallel_ep.py):
one function that ``llmvox_tpu_torch.parallel.launch.spawn`` runs on each
of eight gloo ranks.  A rank is a fresh interpreter, so this module
imports the port only (no JAX); the test builds every input in numpy and
passes it in, and each rank returns numpy arrays."""
import numpy as np
import torch

from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel.sharding import dp_rows

from tests.torch_tp_ranks import _torch_tree


def _ep_logits(case):
    """The MoE Llama's logits at (ep 4, tp 1) and (ep 4, tp 2)."""
    from llmvox_tpu_torch.models import llama as tl
    cfg, params = case["moe_cfg"], _torch_tree(case["moe_params"])
    out = {}
    for ep, tp in ((4, 1), (4, 2)):
        mp = pmesh.initialize_model_parallel(tp, 1, ep)
        shard = psh.shard_llama(params, cfg, tp, mp.tp_rank, ep=ep,
                                ep_rank=mp.ep_rank)
        with torch.no_grad():
            out[ep, tp] = {
                "logits": tl.apply_llama(
                    shard, torch.from_numpy(case["moe_ids"]).long(), cfg,
                    tp=mp.tp_group, ep=mp.ep_group).numpy(),
                "experts": tuple(shard["h"]["moe_wgate"].shape),
                "layout": (mp.dp, mp.ep, mp.tp, mp.dp_rank, mp.ep_rank,
                           mp.tp_rank)}
    return out


def _ep_chains(case):
    """At ep 2: a B=1 prefill and greedy block, and the pooled prefill and
    block with an inactive middle slot."""
    from llmvox_tpu_torch.models import llama as tl
    cfg, params = case["moe_cfg"], _torch_tree(case["moe_params"])
    mp = pmesh.initialize_model_parallel(1, 1, 2)
    g = mp.ep_group
    shard = psh.shard_llama(params, cfg, 1, 0, ep=2, ep_rank=mp.ep_rank)
    with torch.no_grad():
        st = tl.init_llama_decode_state(cfg, batch=1)
        lg, st = tl.prefill(shard, torch.from_numpy(case["b1_ids"]).long(),
                            st, cfg, ep=g)
        first = torch.argmax(lg, dim=-1).to(torch.int32)
        toks, _ = tl.decode_block(shard, first, st, cfg, block=6, ep=g)
        pst = tl.init_llama_pool_state(cfg, batch=3)
        pf, pst = tl.prefill_slots(
            shard, torch.from_numpy(case["pool_tokens"]).long(),
            torch.from_numpy(case["pool_valid"]), pst, torch.tensor([0, 2]),
            torch.ones(2, dtype=torch.bool), cfg, ep=g)
        pt, pst = tl.decode_block_pooled(
            shard, pst, torch.tensor([True, False, True]), cfg, block=6,
            ep=g)
    return {"b1": (first.numpy(), toks.numpy()),
            "pooled": (pf.numpy(), pt.numpy(), pst.pos.numpy(),
                       pst.tok.numpy())}


def _collectives(rank, group):
    """``all_to_all_dim`` by both routes over ``group``, and the gradient
    of ``all_to_all``."""
    n = pmesh.group_size(group)
    x = (torch.arange(n * 6, dtype=torch.float32).reshape(n * 2, 3)
         + 100.0 * rank)
    res = {pmesh.NATIVE: pmesh.all_to_all_dim(x, group,
                                              via=pmesh.NATIVE).numpy(),
           pmesh.ALL_REDUCE: pmesh.all_to_all_dim(
               x, group, via=pmesh.ALL_REDUCE).numpy(),
           "dim1": pmesh.all_to_all_dim(x.t().contiguous(), group,
                                        dim=1).numpy(),
           "route": pmesh.route("cpu"), "n": n,
           "i": pmesh.group_rank(group)}
    xg = x.clone().requires_grad_()
    w = torch.full_like(x, float(rank + 1))
    (pmesh.all_to_all(xg, group) * w).sum().backward()
    res["grad"] = xg.grad.numpy()
    return res


def _a2a(rank, case):
    """``make_moe_a2a`` at ep 4 (two ep groups, dp 2): the three forward
    cases, then the gradients of every parameter (summed over the group)
    of sum(y * y) + aux on each rank."""
    from llmvox_tpu_torch.ops import moe
    mp = pmesh.initialize_model_parallel(1, 1, 4)
    g = mp.ep_group
    a = {k: torch.from_numpy(v) for k, v in case["a2a"].items()}
    out = {"collectives": {"ep": _collectives(rank, g),
                           "world": _collectives(rank, None)},
           "rank_in_group": pmesh.group_rank(g), "fwd": {}}
    for name, (drop_free, cf, masked) in case["a2a_cases"].items():
        fn = moe.make_moe_a2a(g, top_k=2, capacity_factor=cf,
                              drop_free=drop_free)
        with torch.no_grad():
            y, aux = fn(a["x"], a["rw"], a["wg"], a["wu"], a["wd"],
                        token_mask=a["mask"] if masked else None)
        out["fwd"][name] = (y.numpy(), float(aux))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in
         case["a2a_grad"].items() if k != "x"}
    fn = moe.make_moe_a2a(g, top_k=2, drop_free=True)
    y, aux = fn(torch.from_numpy(case["a2a_grad"]["x"]), p["rw"], p["wg"],
                p["wu"], p["wd"])
    loss = (y * y).sum() + aux
    loss.backward()
    grads = [p[k].grad for k in ("rw", "wg", "wu", "wd")]
    pmesh.all_reduce_(grads, group=g)
    total = torch.stack([(y * y).sum().detach()])
    pmesh.all_reduce_([total], group=g)
    out["grad"] = {"loss": float(total[0] + aux.detach()),
                   "grads": {k: t.numpy() for k, t in
                             zip(("rw", "wg", "wu", "wd"), grads)}}
    return out


def _fsdp_step(rank, case):
    """One AdamW step (optax.adamw(1e-3)'s update, ``train/optim.py``) of
    ``llama_loss`` at dp 2 x ep 4 with ``LLAMA_FSDP_SPECS`` for each
    config: the batch's loss, the whole params after the step (gathered)
    and, for the first, this rank's shard and moment shapes."""
    from llmvox_tpu_torch.models import llama as tl
    from llmvox_tpu_torch.train.optim import AdamW, named_leaves
    from llmvox_tpu_torch.utils.config import CodecTrainConfig
    mp = pmesh.initialize_model_parallel(1, 1, 4)
    params = case["fsdp_params"]
    toks = torch.from_numpy(case["fsdp_tokens"]).long()
    rows = dp_rows(toks.shape[0], mp.dp_rank, mp.dp)
    out = {"layout": (mp.dp, mp.ep, mp.dp_rank, mp.ep_rank)}
    for name, cfg in case["fsdp_cfgs"].items():
        shard = psh.shard_llama(_torch_tree(params), cfg, 1, 0, ep=mp.ep,
                                ep_rank=mp.ep_rank, dp=mp.dp,
                                dp_rank=mp.dp_rank)
        leaves = named_leaves(shard)
        for _, t in leaves:
            t.requires_grad_()
        fsdp = psh.llama_fsdp(shard, mp.dp_group)
        loss = tl.llama_loss(shard, toks[rows], cfg, ep=mp.ep_group,
                             fsdp=fsdp)
        loss.backward()
        specs = [_spec(n) for n, _ in leaves]
        grads = [t.grad for _, t in leaves]
        # a leaf whole over dp sums its ranks' gradients; a dp-split one
        # was summed by its gather's reduce-scatter
        pmesh.all_reduce_([g for g, s in zip(grads, specs)
                           if psh.dp_dim(s) is None], group=mp.dp_group)
        opt = AdamW(CodecTrainConfig(initial_learning_rate=1e-3,
                                     num_warmup_steps=0),
                    [t for _, t in leaves], [True] * len(leaves))
        opt.step(grads)
        total = loss.detach().clone()[None]
        pmesh.all_reduce_([total], group=mp.dp_group)
        full = []
        for (n, t), s in zip(leaves, specs):
            shape = list(t.shape)
            for ax, size in (("dp", mp.dp), ("ep", mp.ep)):
                d = psh.axis_dim(s, ax)
                if d is not None:
                    shape[d] *= size
            full.append(psh.place_shard(t.detach(), shape, s, 1, 0,
                                        dp=mp.dp, dp_rank=mp.dp_rank,
                                        ep=mp.ep, ep_rank=mp.ep_rank))
        for ax, group in (("dp", mp.dp_group), ("ep", mp.ep_group)):
            pmesh.all_reduce_([f for f, s in zip(full, specs)
                               if psh.axis_dim(s, ax) is not None],
                              group=group)
        res = {"loss": float(total[0]),
               "params": {n: f.numpy() for (n, _), f in zip(leaves, full)}}
        if not out.get("shapes"):
            state = opt.state_dict()
            res["shapes"] = {n: tuple(t.shape) for n, t in leaves}
            res["mu_shapes"] = {n: tuple(m.shape) for (n, _), m in
                                zip(leaves, state["mu"])}
            res["mu_specs"] = psh.opt_state_specs(state, specs)["mu"]
            res["specs"] = specs
            out["shapes"] = True
        out[name] = res
    return out


def _spec(name: str):
    node = psh.LLAMA_FSDP_SPECS
    for k in name.split("/"):
        node = node[k]
    return node


def _tp_continue_spec(case):
    """At tp 2: a first chunk (``prefill_slots``), its continuation
    (``prefill_slots_continue``) and the speculative pooled block on the
    draft heads."""
    from llmvox_tpu_torch.models import llama as tl
    cfg, params = case["spec_cfg"], _torch_tree(case["spec_params"])
    mp = pmesh.initialize_model_parallel(2)
    g = mp.tp_group
    shard = psh.shard_llama(params, cfg, 2, mp.tp_rank)
    c = case["chunks"]
    with torch.no_grad():
        st = tl.init_llama_pool_state(cfg, batch=3, tp=g)
        _, st = tl.prefill_slots(
            shard, torch.from_numpy(c["t0"]).long(),
            torch.from_numpy(c["v0"]), st, torch.tensor([0, 2]),
            torch.ones(2, dtype=torch.bool), cfg, tp=g)
        first, st = tl.prefill_slots_continue(
            shard, torch.from_numpy(c["t1"]).long(),
            torch.from_numpy(c["v1"]), st, torch.tensor([0, 2]),
            torch.ones(2, dtype=torch.bool), torch.from_numpy(c["v0"]), cfg,
            attn_len=32, tp=g)
        toks, st, iters = tl.decode_block_spec_pooled(
            shard, st, torch.tensor([True, False, True]), cfg, block=6,
            k_draft=3, tp=g)
    return {"first": first.numpy(), "toks": toks.numpy(),
            "pos": st.pos.numpy(), "tok": st.tok.numpy(),
            "iters": iters.numpy(), "kv_heads": int(st.k.shape[3])}


def ep_checks(rank, case):
    """Every expert-parallel check on one of eight ranks, each forming its
    own groups: the MoE logits at (ep 4, tp 1|2), the ep 2 chains, the
    all-to-all MoE and its collectives, the FSDP step at dp 2 x ep 4, and
    the tp continuation and speculative block."""
    torch.manual_seed(0)
    return {"logits": _ep_logits(case), "chains": _ep_chains(case),
            "a2a": _a2a(rank, case), "fsdp": _fsdp_step(rank, case),
            "spec": _tp_continue_spec(case)}
