"""The rank side of the pipeline-parallel tests (test_torch_llama_pp.py):
one function that ``llmvox_tpu_torch.parallel.launch.spawn`` runs on each
of four gloo ranks.  A rank is a fresh interpreter, so this module
imports the port only (no JAX); the test builds every input in numpy and
passes it in, and each rank returns numpy arrays."""
import torch
import torch.distributed as dist

from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.models import llama_pp as pp_mod
from llmvox_tpu_torch.parallel import mesh as pmesh

from tests.torch_tp_ranks import _torch_tree


def _pp_group(pp: int):
    """This rank's group of ``pp`` consecutive ranks (every rank forms
    every group, in order)."""
    mine = None
    for start in range(0, pmesh.world(), pp):
        g = dist.new_group(list(range(start, start + pp)))
        if start <= pmesh.rank() < start + pp:
            mine = g
    return mine


def _state(case):
    k, v, pos, tok = (torch.from_numpy(case["state"][n].copy())
                      for n in ("k", "v", "pos", "tok"))
    return tl.LlamaPoolState(k, v, pos, tok)


def _np_state(st):
    return {"pos": st.pos.numpy().copy(), "tok": st.tok.numpy().copy()}


def pp_checks(rank, case):
    """Decode at each (pp, n_micro) from the prefilled pool, twice
    chained; the pp prefill then pp decode at (4, 4); inactive rows at
    (2, 4); a sampled block by distribution at (2, 2); the n_micro < pp
    assertion."""
    cfg, params = case["cfg"], _torch_tree(case["params"])
    block = case["block"]
    groups = {pp: _pp_group(pp) for pp in (2, 4)}
    out = {"decode": {}}
    for pp, m in case["layouts"]:
        g = groups[pp]
        s = pmesh.group_rank(g)
        shard = pp_mod.shard_llama_pp(params, cfg, pp, s)
        st = pp_mod.shard_pp_state(_state(case), cfg, pp, s)
        decode = pp_mod.make_pp_decode(g, cfg, block=block, n_micro=m)
        act = torch.ones(st.tok.shape[0], dtype=torch.bool)
        toks, st = decode(shard, st, act)
        first = (toks.numpy(), _np_state(st))
        toks2, st = decode(shard, st, act)
        out["decode"][pp, m] = {"first": first, "second": (toks2.numpy(),
                                                           _np_state(st)),
                                "layers": int(st.k.shape[0])}
    g = groups[4]
    s = pmesh.group_rank(g)
    shard = pp_mod.shard_llama_pp(params, cfg, 4, s)
    fresh = tl.init_llama_pool_state(cfg, batch=case["tokens"].shape[0])
    st = pp_mod.shard_pp_state(fresh, cfg, 4, s)
    prefill = pp_mod.make_pp_prefill(g, cfg, n_micro=4)
    first, st = prefill(shard, torch.from_numpy(case["tokens"]).long(),
                        torch.from_numpy(case["valid"]), st)
    pst = _np_state(st)
    decode = pp_mod.make_pp_decode(g, cfg, block=block, n_micro=4)
    toks, st = decode(shard, st, torch.ones(st.tok.shape[0],
                                            dtype=torch.bool))
    out["prefill"] = {"first": first.numpy(), "state": pst,
                      "toks": toks.numpy(), "after": _np_state(st)}
    # inactive rows at (pp 2, n_micro 4)
    g = groups[2]
    s = pmesh.group_rank(g)
    shard = pp_mod.shard_llama_pp(params, cfg, 2, s)
    st = pp_mod.shard_pp_state(_state(case), cfg, 2, s)
    decode = pp_mod.make_pp_decode(g, cfg, block=block, n_micro=4)
    toks, st = decode(shard, st, torch.from_numpy(case["active"]))
    out["inactive"] = {"toks": toks.numpy(), "state": _np_state(st)}
    # sampled: every row the same prompt, one step each, by distribution
    scase = case["sampled"]
    st = pp_mod.shard_pp_state(tl.LlamaPoolState(*(
        torch.from_numpy(scase["state"][n].copy())
        for n in ("k", "v", "pos", "tok"))), cfg, 2, s)
    decode = pp_mod.make_pp_decode(g, cfg, block=1, n_micro=2,
                                   temperature=1.0, top_k=scase["top_k"])
    gen = torch.Generator().manual_seed(11)
    toks, _ = decode(shard, st, torch.ones(st.tok.shape[0],
                                           dtype=torch.bool), gen)
    out["sampled"] = toks.numpy()
    try:
        pp_mod.make_pp_decode(groups[4], cfg, n_micro=2)
        out["refused"] = None
    except AssertionError as e:
        out["refused"] = str(e)
    return out
