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
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Sequence

import numpy as np
import torch

from llmvox_tpu_torch.utils.params import load_meta, load_params_npz

__all__ = ["flatten_pytree", "save_params_npz", "load_params_npz",
           "load_meta", "average_checkpoints", "load_partial",
           "save_opaque", "save_opt_state", "load_opt_state"]


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists of tensors or arrays -> {path: array}."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(flatten_pytree(tree[k], f"{prefix}{k}/"))
        return flat
    if isinstance(tree, (list, tuple)):
        flat = {}
        for i, v in enumerate(tree):
            flat.update(flatten_pytree(v, f"{prefix}#{i}/"))
        return flat
    return {prefix[:-1]: _numpy(tree)}


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
