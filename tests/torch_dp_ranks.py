"""The rank side of the data-parallel tests (test_torch_parallel*.py):
functions that ``llmvox_tpu_torch.parallel.launch.spawn`` runs on each
gloo rank.  A rank is a fresh interpreter, so this module imports the
port only (no JAX, nothing of the tests' JAX-side helpers); the tests
build every input in numpy and pass it in."""
import os

import numpy as np
import torch

from llmvox_tpu_torch.parallel import mesh as pmesh


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    t = (tree.detach() if hasattr(tree, "detach")
         else torch.as_tensor(np.array(tree)))
    return {prefix[:-1]: t}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return np.array(tree)


def lockstep(tensors) -> bool:
    """Every rank's tensors bitwise equal to rank 0's (a broadcast from
    rank 0 and an exact compare), agreed over the ranks."""
    same = True
    for t in tensors:
        ref = t.detach().clone()
        pmesh.broadcast_from_master(ref)
        same &= bool(torch.equal(ref, t.detach()))
    flag = torch.tensor([0.0 if same else 1.0])
    pmesh.all_reduce_([flag])
    return float(flag[0]) == 0.0


def collectives(rank):
    """average_metrics, broadcast_from_master (tensors, arrays, scalars,
    trees), gather_rows, all_reduce_ (sum and mean, bitwise equal on the
    ranks), is_master and the world."""
    torch.manual_seed(100 + rank)
    x = torch.randn(3, 5)
    out = {"world": pmesh.world(), "rank": pmesh.rank(),
           "master": pmesh.is_master(),
           "avg": pmesh.average_metrics({"b": rank + 1.0, "a": 10.0 * rank}),
           "gathered": pmesh.gather_rows(x).numpy(), "x": x.numpy()}
    tree = {"t": torch.full((2,), float(rank)),
            "n": [np.arange(3) * (rank + 1), 7 + rank]}
    got = pmesh.broadcast_from_master(tree)
    out["bcast"] = {"t": got["t"].numpy(), "n0": got["n"][0],
                    "n1": got["n"][1]}
    s, m = torch.randn(4, 3), torch.randn(7)
    out["pre"] = [s.clone().numpy(), m.clone().numpy()]
    pmesh.all_reduce_([s, m])
    mean = torch.randn(5)
    out["pre_mean"] = mean.clone().numpy()
    pmesh.all_reduce_([mean], "mean")
    out["sum"] = [s.numpy(), m.numpy()]
    out["mean"] = mean.numpy()
    out["lockstep"] = lockstep([s, m, mean])
    return out


def fail(rank):
    raise ValueError(f"rank {rank} fails on purpose")


# ---------------------------------------------------------------------------
# the decoder trainer
# ---------------------------------------------------------------------------

def _state_tensors(tr):
    return list(tr.opt.params) + tr.opt.mu + tr.opt.nu + tr.opt.acc


def decoder_trainer(rank, tcfg, mcfg, table, codebook, params, batches,
                    out_dir):
    """The port's Trainer on this rank over the global ``batches``: each
    micro-step's loss, lockstep after every update, the params after each
    update (rank 0), a checkpoint written at the end, the local valid
    counts of each batch, and a dp_size that is not the world refused."""
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.train.trainer import Trainer
    import dataclasses
    try:
        Trainer(dataclasses.replace(tcfg, dp_size=3), mcfg, table, codebook,
                device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    tr = Trainer(dataclasses.replace(tcfg, out_dir=out_dir), mcfg, table,
                 codebook, compute_dtype=torch.float32, device="cpu",
                 params=params)
    losses, updates, same, counts = [], [], [], []
    for batch in batches:
        rows = tr.rows(batch)
        segs = torch.as_tensor(rows[2]) if len(rows) == 4 else None
        counts.append(dec.loss_counts(torch.as_tensor(rows[1]), mcfg,
                                      mcfg.n_draft_heads, segs).tolist())
        losses.append(tr.step(*batch))
        if tr.opt.mini_step == 0:
            same.append(lockstep(_state_tensors(tr)))
            if rank == 0:
                updates.append({k: v.numpy().copy()
                                for k, v in _leaves(tr.params).items()})
    path = tr.save_checkpoint("dp")
    return {"losses": losses, "updates": updates, "lockstep": same,
            "counts": counts, "refused": refused, "dp": tr.dp,
            "path": path, "iter_num": tr.iter_num,
            "count": tr.opt.count}


# ---------------------------------------------------------------------------
# the codec trainer
# ---------------------------------------------------------------------------

def codec_trainer(rank, cfg, tcfg, gen, disc, vq, audios, draws, out_dir):
    """The port's CodecTrainer on this rank over the global ``audios``
    with the given draws (bandwidth id, k-means rows and dead-code rows
    as numpy): the logs, lockstep after every step, the state after each
    step (rank 0), and a checkpoint written at the end."""
    import dataclasses
    from llmvox_tpu_torch.train import codec_trainer as tct
    from llmvox_tpu_torch.utils.params import codec_train_trees
    tr = tct.CodecTrainer(cfg, dataclasses.replace(tcfg, out_dir=out_dir),
                          device="cpu", gen_params=gen, disc_params=disc,
                          vq_state=vq)
    logs, states, same = [], [], []
    for audio, (bw, init, dead) in zip(audios, draws):
        logs.append(tr.step(audio, tct.StepDraws(
            bw, torch.from_numpy(init), torch.from_numpy(dead))))
        same.append(lockstep(list(tr.gen.params) + list(tr.disc.params)
                             + list(tr.vq)[:3] + tr.opt_g.mu + tr.opt_g.nu
                             + tr.opt_d.mu + tr.opt_d.nu))
        if rank == 0:
            # copies: the arrays share the live tensors' memory
            trees = codec_train_trees(tr.state)
            states.append({k: _copy(trees[k]) for k in
                           ("gen_params", "disc_params", "vq_state")})
    path = tr.save_checkpoint("dp")
    return {"logs": logs, "states": states, "lockstep": same,
            "dp": tr.dp, "files": sorted(os.listdir(out_dir)),
            "path": path}
