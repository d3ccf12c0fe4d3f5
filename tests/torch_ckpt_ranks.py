"""The rank side of the sharded-checkpoint tests
(test_torch_checkpoint_sharded.py): one function that
``llmvox_tpu_torch.parallel.launch.spawn`` runs on each of eight gloo
ranks.  A rank is a fresh interpreter, so this module imports the port
only (no JAX); each rank returns numpy arrays."""
import dataclasses

import torch

from llmvox_tpu_torch.train import checkpoint as ckpt

from tests.torch_tp_ranks import _np_tree


def _spec_tree(names, specs):
    out = {}
    for name, spec in zip(names, specs):
        *parents, leaf = name.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = spec
    return out


def save_checks(rank, dec, path):
    """The decoder trainer at dp 2 x sp 2 x tp 2 with FSDP writes its
    shards (``save_sharded``, its layout's specs) and reads them back at
    its own layout; returns this rank's shards, what it read, the whole
    tree gathered (rank 0) and the seconds each way."""
    import time
    from llmvox_tpu_torch.train.trainer import Trainer
    tr = Trainer(dataclasses.replace(dec["tcfg"], dp_size=2, sp_size=2,
                                     tp_size=2, fsdp=True), dec["mcfg"],
                 dec["table"], dec["codebook"], compute_dtype=torch.float32,
                 device="cpu", params=dec["params"])
    specs = _spec_tree(tr.names, tr.specs)
    t0 = time.perf_counter()
    ckpt.save_sharded(path, tr.params, specs, tr.mp)
    saved_s = time.perf_counter() - t0
    back = ckpt.load_sharded(path, specs=specs, mp=tr.mp)
    full = tr.full_params()
    return {"shards": _np_tree(tr.params), "back": _np_tree(back),
            "full": _np_tree(full) if rank == 0 else None,
            "layout": (tr.dp, tr.sp, tr.tp, tr.mp.dp_rank, tr.mp.sp_rank,
                       tr.mp.tp_rank), "save_s": saved_s}
