"""Checkpoints: flat ``.npz`` parameter files and the optimizer's state.

Counterpart of ``llmvox_tpu/train/checkpoint.py``.  ``save_params_npz``
writes the files the JAX package's ``load_params_npz`` / ``load_meta``
read, and the port's loader (``utils/params.py``, re-exported here) reads
the JAX package's: keys are ``/``-joined tree paths (list indices as
``#i``) in the JAX flattening order (dict keys sorted), with an optional
JSON sidecar ``<path>.json`` for the meta.

``save_opaque`` writes a tree's leaves by position, as JAX's does (the
codec trainer's ``<tag>.disc.npz``, which JAX's ``fill_like`` reads).

The optimizer's state goes to ``<name>.adamw.npz`` beside the params:
the port's own layout (``mu/``, ``nu/``, ``acc/`` plus each parameter's
path, ``count``, ``mini_step``), which only the port's trainer resumes
from.  The JAX trainer's ``<name>.opt.npz`` holds optax's state by
position; the port does not read it and a resume without the port's file
starts the optimizer afresh, as JAX's does without its own.

``save_sharded`` / ``load_sharded`` are the counterpart of JAX's
``save_orbax`` / ``load_orbax`` (a sharding-aware checkpoint directory)
in a layout of the port's own, since orbax is not a dependency of the
port: every rank writes the shards of every leaf it is the first rank to
hold (``shards-<rank>.npz``), and rank 0 an ``index.json`` of each
leaf's global shape and dtype and each shard's file and place (per
dimension, the [start, stop) runs of global indices it holds).  Reading
assembles whole leaves, or only the shards one rank of another layout
needs.  JAX's orbax directory is not read, nor this one by JAX.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from llmvox_tpu_torch.utils.params import (_listify, load_meta,
                                           load_params_npz)

__all__ = ["flatten_pytree", "save_params_npz", "load_params_npz",
           "load_meta", "average_checkpoints", "load_partial",
           "save_opaque", "save_opt_state", "load_opt_state",
           "save_sharded", "load_sharded"]


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def flatten_pytree(tree, prefix: str = "", leaf=_numpy) -> Dict[str, Any]:
    """Nested dicts and lists of tensors or arrays -> {path: array} (each
    leaf through ``leaf``)."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(flatten_pytree(tree[k], f"{prefix}{k}/", leaf))
        return flat
    if isinstance(tree, (list, tuple)):
        flat = {}
        for i, v in enumerate(tree):
            flat.update(flatten_pytree(v, f"{prefix}#{i}/", leaf))
        return flat
    return {prefix[:-1]: leaf(tree)}


def save_params_npz(path: str, params, meta: Dict[str, Any] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_pytree(params))
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def save_opaque(path: str, tree) -> None:
    """A tree's leaves by position (``leaf_0``, ``leaf_1``, ...) in JAX's
    leaf order (dict keys sorted), as JAX's ``save_opaque`` writes them
    for its ``fill_like``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    leaves = flatten_pytree(tree).values()
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def _mean(trees: Sequence):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _mean([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_mean([t[i] for t in trees]) for i in range(len(first))]
    return np.mean(np.stack(trees), axis=0)


def average_checkpoints(paths: Sequence[str]):
    """Element-wise mean of N saved parameter sets."""
    assert paths, "need at least one checkpoint"
    return _mean([load_params_npz(p) for p in paths])


def _cast_like(template, saved):
    if isinstance(template, dict):
        return {k: _cast_like(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_cast_like(t, s) for t, s in zip(template, saved)]
    return np.asarray(saved, dtype=_numpy(template).dtype)


def load_partial(template, path: str, keep: Iterable[str] = None):
    """Refill only the top-level groups named in ``keep`` (all the saved
    ones by default) from a saved parameter set, cast to the template's
    dtypes; the rest keep the template's values."""
    saved = load_params_npz(path)
    out = dict(template)
    for key in (keep if keep is not None else saved.keys()):
        if key in saved and key in out:
            out[key] = _cast_like(out[key], saved[key])
    return out


def save_opt_state(path: str, names: Sequence[str],
                   state: Dict[str, object]) -> None:
    """The optimizer's state (``train/optim.py::AdamW.state_dict``) with
    each tensor under ``<mu|nu|acc>/<parameter path>``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"{group}/{n}": _numpy(t) for group in ("mu", "nu", "acc")
              for n, t in zip(names, state[group])}
    arrays["count"] = np.asarray(state["count"])
    arrays["mini_step"] = np.asarray(state["mini_step"])
    np.savez(path, **arrays)


def load_opt_state(path: str, names: Sequence[str]) -> Dict[str, object]:
    with np.load(path) as data:
        missing = [f"{g}/{n}" for g in ("mu", "nu", "acc") for n in names
                   if f"{g}/{n}" not in data.files]
        if missing:
            raise ValueError(f"{path}: no optimizer state for {missing}")
        return {**{g: [data[f"{g}/{n}"] for n in names]
                   for g in ("mu", "nu", "acc")},
                "count": int(data["count"]),
                "mini_step": int(data["mini_step"])}


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------

SHARDED_INDEX = "index.json"
_AXES = ("dp", "sp", "ep", "tp")


class Layout(NamedTuple):
    """The mesh a sharded tree lies on (``parallel/mesh.py::
    ModelParallel`` has these fields): each axis's size and this rank's
    index on it, ranks ordered (dp, sp, ep, tp), tp innermost."""
    dp: int = 1
    tp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    sp: int = 1
    sp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0

    @classmethod
    def of(cls, mp) -> "Layout":
        return cls(*(getattr(mp, f) for f in cls._fields))

    def coords(self, rank: int) -> Dict[str, int]:
        t, rank = rank % self.tp, rank // self.tp
        e, rank = rank % self.ep, rank // self.ep
        s, d = rank % self.sp, rank // self.sp
        return {"dp": d, "sp": s, "ep": e, "tp": t}

    def at(self, c: Dict[str, int]) -> "Layout":
        return self._replace(dp_rank=c["dp"], sp_rank=c["sp"],
                             ep_rank=c["ep"], tp_rank=c["tp"])

    @property
    def world(self) -> int:
        return self.dp * self.sp * self.ep * self.tp


def _flat_specs(specs, names: Sequence[str]) -> Dict[str, tuple]:
    """Each leaf's spec tuple from a tree of them (None: all whole)."""
    out = {}
    for n in names:
        node = specs
        for k in n.split("/") if specs is not None else ():
            node = node[k]
        out[n] = tuple(node or ())
    return out


def _split(spec: tuple, lay: Layout) -> Dict[str, int]:
    """Axis -> the dimension it splits (axes of size 1 split nothing)."""
    sizes = {"dp": lay.dp, "ep": lay.ep, "tp": lay.tp, "sp": lay.sp}
    return {a: spec.index(a) for a in _AXES if a in spec and sizes[a] > 1}


def _shard_index(name: str, shape, spec: tuple, lay: Layout):
    from llmvox_tpu_torch.parallel import sharding as psh
    return psh.leaf_index(shape, spec, lay.tp, lay.tp_rank,
                          name.split("/")[-1] in psh.FUSED_QKV, lay.dp,
                          lay.dp_rank, lay.ep, lay.ep_rank)


def _runs(ix) -> Optional[List[List[int]]]:
    """Indices as [start, stop) runs (None: the whole dimension)."""
    if ix is None:
        return None
    ix = np.asarray(ix)
    cut = np.flatnonzero(np.diff(ix) != 1) + 1
    return [[int(r[0]), int(r[-1]) + 1] for r in np.split(ix, cut)]


def _indices(runs, n: int) -> np.ndarray:
    if runs is None:
        return np.arange(n)
    return np.concatenate([np.arange(a, b) for a, b in runs])


def save_sharded(path: str, tree, specs=None, mp=None) -> None:
    """Write this rank's shards of ``tree`` (nested dicts and lists of
    tensors or arrays, each this rank's shard under ``specs``: a tree of
    spec tuples such as ``parallel/sharding.py``'s tables, None for every
    leaf whole) into the directory ``path``; ``mp``
    (``ModelParallel``, or a ``Layout``; None: one process) names the
    mesh.  Each shard is written once, by the first rank that holds it;
    rank 0 writes the index; every rank returns once all is written."""
    from llmvox_tpu_torch.parallel import mesh as pmesh
    lay = Layout() if mp is None else (mp if isinstance(mp, Layout)
                                       else Layout.of(mp))
    flat = flatten_pytree(tree)
    dtypes = {n: str(v.dtype).split(".")[-1] for n, v in
              _leaves_of(tree).items()}
    spec = _flat_specs(specs, list(flat))
    me = lay.coords(pmesh.rank())
    os.makedirs(path, exist_ok=True)
    index = {}
    for name, a in flat.items():
        split = _split(spec[name], lay)
        shape = list(a.shape)
        for ax, d in split.items():
            shape[d] *= getattr(lay, ax)
        shards = []
        for r in range(lay.world):
            c = lay.coords(r)
            if any(c[ax] for ax in _AXES if ax not in split):
                continue        # a copy of a lower rank's shard
            idx = _shard_index(name, shape, spec[name], lay.at(c))
            shards.append({"file": f"shards-{r}.npz",
                           "index": [_runs(ix) for ix in idx]})
        index[name] = {"shape": shape, "dtype": dtypes[name],
                       "shards": shards}
    mine = {n: a for n, a in flat.items()
            if not any(me[ax] for ax in _AXES if ax not in
                       _split(spec[n], lay))}
    np.savez(os.path.join(path, f"shards-{pmesh.rank()}.npz"), **mine)
    if pmesh.rank() == 0:
        with open(os.path.join(path, SHARDED_INDEX), "w") as f:
            json.dump({"format": "llmvox_tpu_torch sharded 1",
                       "layout": lay._asdict(), "leaves": index}, f)
    pmesh.barrier()


def _leaves_of(tree) -> Dict[str, Any]:
    return flatten_pytree(tree, leaf=lambda x: x)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                dtype))


def load_sharded(path: str, template=None, specs=None, mp=None):
    """A tree written by ``save_sharded`` (at any layout), as CPU
    tensors in the saved dtypes: whole, or cast to the leaves of
    ``template`` (a tree of tensors or arrays, as JAX's
    ``restore(item=)``), or, given ``specs`` and ``mp`` (the reader's
    mesh), this rank's shard of each leaf, reading only the saved shards
    that overlap it.  Raises a ValueError where the index's shards do
    not cover every element wanted."""
    with open(os.path.join(path, SHARDED_INDEX)) as f:
        index = json.load(f)["leaves"]
    lay = None if mp is None else (mp if isinstance(mp, Layout)
                                   else Layout.of(mp))
    spec = _flat_specs(specs, list(index))
    files: Dict[str, Any] = {}
    flat = {}
    try:
        for name, info in index.items():
            shape = info["shape"]
            want = ([None] * len(shape) if lay is None else
                    _shard_index(name, shape, spec[name], lay))
            want = [np.arange(n) if ix is None else np.asarray(ix)
                    for ix, n in zip(want, shape)]
            out = filled = None
            for sh in info["shards"]:
                have = [_indices(r, n) for r, n in zip(sh["index"], shape)]
                # the shard's positions of the wanted indices, per dim
                picks, ok = [], True
                for w, h in zip(want, have):
                    where = np.full(max(int(w.max(initial=-1)),
                                        int(h.max(initial=-1))) + 1, -1)
                    where[h] = np.arange(len(h))
                    pos = where[w]
                    picks.append(pos)
                    ok = ok and (pos >= 0).any()
                if not ok:
                    continue
                f = files.setdefault(sh["file"], np.load(
                    os.path.join(path, sh["file"])))
                data = f[name]
                if out is None:
                    out = np.zeros([len(w) for w in want], data.dtype)
                    filled = np.zeros(out.shape, bool)
                sel_out = np.ix_(*[np.flatnonzero(p >= 0) for p in picks])
                sel_in = np.ix_(*[p[p >= 0] for p in picks])
                out[sel_out] = data[sel_in]
                filled[sel_out] = True
            wanted = int(np.prod([len(w) for w in want]))
            got = 0 if filled is None else int(filled.sum())
            if got != wanted:
                raise ValueError(f"{path}: the saved shards of {name!r} "
                                 f"cover {got} of the {wanted} elements "
                                 "wanted")
            flat[name] = _to_torch(out, info["dtype"])
    finally:
        for f in files.values():
            f.close()
    if template is not None:
        tmpl = _leaves_of(template)
        if tmpl.keys() != flat.keys():
            raise ValueError(f"{path}: leaves {sorted(flat)} are not the "
                             f"template's {sorted(tmpl)}")
        for name, t in tmpl.items():
            v = flat[name]
            flat[name] = (v.to(t.dtype) if isinstance(t, torch.Tensor) else
                          (v.float() if v.dtype == torch.bfloat16 else v)
                          .numpy().astype(np.asarray(t).dtype))
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return _listify(tree)
