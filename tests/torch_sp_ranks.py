"""The rank side of the sequence-parallel and FSDP tests
(test_torch_ring_attention.py, test_torch_parallel_sp_fsdp.py): functions
that ``llmvox_tpu_torch.parallel.launch.spawn`` runs on each gloo rank.
A rank is a fresh interpreter, so this module imports the port only (no
JAX); the tests build every input in numpy and pass it in, and each rank
returns numpy arrays."""
import dataclasses

import numpy as np
import torch

from llmvox_tpu_torch.ops import ring_attention as ra
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel.sharding import dp_rows

from tests.torch_tp_ranks import _equal_over, _np_tree


def _ring_case(case, mp, layout):
    """This rank's share of the global (B, T, H, D) q/k/v in ``layout``:
    its dp block of rows and its sp block of T (of the zigzag
    permutation under "zigzag"); the forward and the gradients of
    sum(out * cot), local."""
    b, t = case["q"].shape[:2]
    rows = np.arange(b)[dp_rows(b, mp.dp_rank, mp.dp)]
    order = (ra.zigzag_permutation(t, mp.sp)[0] if layout == "zigzag"
             else np.arange(t))
    pos = order[dp_rows(t, mp.sp_rank, mp.sp)]
    q, k, v, cot = (torch.from_numpy(np.ascontiguousarray(
        case[n][rows][:, pos])) for n in ("q", "k", "v", "cot"))
    for x in (q, k, v):
        x.requires_grad_()
    out = ra.ring_attention(q, k, v, mp.sp_group, layout)
    (out * cot).sum().backward()
    return {"rows": rows, "pos": pos, "out": out.detach().numpy(),
            "grads": [x.grad.numpy() for x in (q, k, v)]}


def _collectives(rank, mp):
    """The rotation, all-gather and reduce-scatter by both routes over the
    world and over this rank's sp group, and the gradients of ``ppermute``
    and ``gather_shards``."""
    out = {}
    for name, group in (("world", None), ("sp", mp.sp_group)):
        n, i = pmesh.group_size(group), pmesh.group_rank(group)
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4) * (rank + 1)
        res = {"n": n, "i": i, "route": pmesh.route("cpu")}
        for via in (pmesh.NATIVE, pmesh.ALL_REDUCE):
            res[via] = {
                "rotate": pmesh.rotate(x, group, 1, via=via).numpy(),
                "rotate_back": pmesh.rotate(x, group, -1, via=via).numpy(),
                "gather": pmesh.all_gather_dim(x, 1, group, via=via).numpy(),
                "scatter": pmesh.reduce_scatter_dim(
                    torch.cat([x] * n, dim=1), 1, group, via=via).numpy()}
        xg = x.clone().requires_grad_()
        w = torch.full((3, 4), float(rank + 1))
        (pmesh.ppermute(xg, group) * w).sum().backward()
        res["ppermute_grad"] = xg.grad.numpy()
        xs = x.clone().requires_grad_()
        full = pmesh.gather_shards(xs, 0, group)
        (full * torch.arange(full.numel(), dtype=torch.float32).reshape(
            full.shape)).sum().backward()
        res["gather_grad"] = xs.grad.numpy()
        out[name] = res
    return out


def ring_checks(rank, case):
    """Every ring-attention check on one of four ranks: ring and zigzag at
    sp 2 (dp 2) and sp 4 (dp 1), the collectives, and the refusals."""
    torch.manual_seed(0)
    out = {"attn": {}}
    for sp in (2, 4):
        mp = pmesh.initialize_model_parallel(1, sp)
        for layout in ("ring", "zigzag"):
            out["attn"][sp, layout] = _ring_case(case, mp, layout)
        if sp == 2:
            out["collectives"] = _collectives(rank, mp)
            out["layout"] = (mp.dp, mp.sp, mp.dp_rank, mp.sp_rank)
    refused = {}
    q = torch.zeros((1, 3, 2, 4))
    for name, fn in (
            ("zigzag_odd", lambda: ra.ring_attention(q, q, q, mp.sp_group,
                                                     "zigzag")),
            ("layout", lambda: ra.ring_attention(q, q, q, mp.sp_group,
                                                 "diagonal"))):
        try:
            fn()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _train(tr, batches):
    """Micro-steps over ``batches``: the losses, the whole params after
    each update, whether every rank's leaves and moments are bitwise
    equal across each group that should hold copies of them, and this
    rank's shards of the params and moments at the end."""
    losses, updates, same = [], [], []
    whole = [i for i, s in enumerate(tr.split) if "dp" not in s]
    split = [i for i, s in enumerate(tr.split) if "dp" in s]
    tp_whole = [tr.opt.params[i] for i, s in enumerate(tr.split)
                if "tp" not in s]

    def state(idx):
        return [t for i in idx for t in (tr.opt.params[i], tr.opt.mu[i],
                                         tr.opt.nu[i])]
    for b in batches:
        losses.append(tr.step(*b))
        if tr.opt.mini_step == 0:
            updates.append(_np_tree(tr.full_params()))
            # every rank takes part in each check (collectives)
            checks = [_equal_over(state(whole), tr.mp.batch_group),
                      _equal_over(state(split), tr.mp.sp_group),
                      _equal_over(tp_whole, tr.mp.tp_group)]
            same.append(all(checks))
    shards = {n: p.detach().numpy().copy()
              for n, p in zip(tr.names, tr.opt.params)}
    moments = {n: m.numpy().copy() for n, m in zip(tr.names, tr.opt.mu)}
    return {"losses": losses, "updates": updates, "same": same,
            "shards": shards, "mu": moments,
            "mu_full": [m.numpy().copy() for m in tr._gather(tr.opt.mu)],
            "layout": {"dp": tr.dp, "sp": tr.sp, "tp": tr.tp,
                       "dp_rank": tr.mp.dp_rank, "sp_rank": tr.mp.sp_rank,
                       "tp_rank": tr.mp.tp_rank, "split": tr.split}}


def trainer_checks(rank, dec, layouts, out_dirs):
    """The decoder trainer on one of eight ranks at each of ``layouts``
    (name -> TrainConfig fields and DecoderConfig fields): two updates,
    then at "mix" a checkpoint written and one written at another layout
    resumed; the refusals."""
    from llmvox_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    tcfg, mcfg = dec["tcfg"], dec["mcfg"]
    out = {}
    for name, (tkw, mkw) in layouts.items():
        tr = Trainer(dataclasses.replace(tcfg, out_dir=out_dirs[name],
                                         **tkw),
                     dataclasses.replace(mcfg, **mkw), dec["table"],
                     dec["codebook"], compute_dtype=torch.float32,
                     device="cpu", params=dec["params"])
        out[name] = _train(tr, dec["batches"])
        out[name]["eval"] = tr.estimate_loss(iter(dec["batches"][:1]), 1)
        out[name]["path"] = tr.save_checkpoint(name)
        if name == "mix":
            tr.load_checkpoint(dec["one_path"])
            out["resumed"] = {"params": _np_tree(tr.full_params()),
                              "mu": [m.numpy().copy() for m in
                                     tr._gather(tr.opt.mu)],
                              "count": tr.opt.count,
                              "iter_num": tr.iter_num}
        del tr
    refused = {}
    for name, tkw, batch in (
            ("packed", dict(sp_size=2), dec["packed"]),
            ("t_ring", dict(sp_size=8), dec["odd"]),
            ("t_zigzag", dict(sp_size=4, sp_layout="zigzag"), dec["odd"])):
        tr = Trainer(dataclasses.replace(tcfg, **tkw), mcfg, dec["table"],
                     dec["codebook"], compute_dtype=torch.float32,
                     device="cpu", params=dec["params"])
        try:
            tr.step(*batch)
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
        del tr
    out["refused"] = refused
    return out
