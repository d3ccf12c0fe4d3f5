"""Layouts over a mesh: which rows each device keeps, Megatron's split
of the decoder and the Llama over a tensor-parallel group, and FSDP's
split of the decoder over a data-parallel group.

Counterpart of ``llmvox_tpu/parallel/sharding.py``.  A ``Sharding``
names, per mesh axis, the leading dimensions it splits, as a JAX
``PartitionSpec`` does: ``P("dp")`` gives the device at dp index i the
i-th contiguous block of rows, in device order, and the devices along the
other axes the same block; ``P()`` gives every device all of it.
``blocks`` lists each device's index (a tuple of slices) in the mesh's
row-major device order, as ``jax.device_put(x, sharding)``'s
``addressable_shards`` hold them.

Tensor parallelism keeps JAX's spec tables as data (``DECODER_TP_SPECS``,
``LLAMA_TP_SPECS``): column-parallel weights split their output columns
over tp, row-parallel ones their input rows, the rest is replicated.
``shard_tree`` cuts a full tree in the JAX layout into one tp rank's
shard; ``place_shard`` puts a rank's shard of a leaf where it lies in a
zero-filled full leaf, so that the sum over the ranks (an all-reduce) is
the leaf gathered back.  The trainer and the Llama run on the shards
(``parallel/tensor_parallel.py``).  One layout differs from JAX's
``addressable_shards``: the decoder's fused QKV (``wqkv (L, C, 3C)``,
``bqkv (L, 3C)``).  A contiguous block of its 3C axis is not a head
block (at tp 2, rank 0's holds all of q and half of k; JAX splits it
again into q, k and v and GSPMD moves the data), so tp rank r holds head
block r of q, of k and of v, concatenated, and ``place_shard`` puts them
back in that order.

FSDP (ZeRO-3) keeps JAX's ``decoder_fsdp_shardings`` table
(``DECODER_FSDP_SPECS``): every matrix splits one dimension over dp, the
one tp does not take, and norms and biases stay whole.  ``shard_leaf`` /
``place_shard`` / ``shard_tree`` cut and place a leaf over dp and tp
together; ``FSDP`` gathers a rank's shards where the forward uses them
(``parallel/mesh.py::gather_shards``, whose backward reduce-scatters the
gradient), and the optimizer's moments take their parameter's shard
(``opt_state_specs``, JAX's ``opt_state_shardings``).

Expert parallelism: ``LLAMA_TP_SPECS`` puts the experts' axis over ep,
and ``shard_llama(..., ep=, ep_rank=)`` gives a rank its contiguous block
of E/ep experts (each with its tp block of columns).  The ep-aware FSDP
of JAX's ``llama_fsdp_shardings`` is ``LLAMA_FSDP_SPECS`` (``shard_llama``
at dp > 1): dense matrices split one dimension over dp and their
Megatron one over tp, experts over ep, dp and tp, the embedding and head
over dp, the router and norms whole; ``llama_fsdp`` gathers them where
``llama_loss`` uses them.  A quantized tree is refused, as JAX's ``llama_param_shardings``
raises an AttributeError on it (its table walk reads ``.key`` of a
quantized leaf's fields).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.parallel.mesh import (DP_AXIS, EP_AXIS, SP_AXIS,
                                            TP_AXIS, Mesh, gather_shards)


def dp_rows(n: int, index: int, parts: int) -> slice:
    """The ``index``-th of ``parts`` contiguous blocks of ``n`` rows
    (``n % parts == 0``, as GSPMD requires of an even split)."""
    if n % parts:
        raise ValueError(f"{n} rows do not split evenly over {parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


class Sharding(NamedTuple):
    """``spec[d]`` is the mesh axis that splits dimension d (None: not
    split); dimensions past the spec are not split."""
    mesh: Mesh
    spec: Tuple

    def blocks(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """Each device's index into an array of ``shape``, in the mesh's
        row-major device order."""
        names = self.mesh.axis_names
        sizes = self.mesh.devices.shape
        out = []
        for coord in itertools.product(*(range(s) for s in sizes)):
            idx = []
            for d, n in enumerate(shape):
                axis = self.spec[d] if d < len(self.spec) else None
                if axis is None:
                    idx.append(slice(0, n))
                else:
                    a = names.index(axis)
                    idx.append(dp_rows(n, coord[a], sizes[a]))
            out.append(tuple(idx))
        return out


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over dp."""
    return Sharding(mesh, (DP_AXIS,))


def batch_seq_sharding(mesh: Mesh) -> Sharding:
    """(B, T, ...) split over (dp, sp): the sequence-parallel trainer's
    input layout (its rows by ``dp_rows``, and T, permuted first under
    the zigzag layout, by ``models/decoder.py::seq_share``)."""
    return Sharding(mesh, (DP_AXIS, SP_AXIS))


# ---------------------------------------------------------------------------
# Megatron tensor parallelism
# ---------------------------------------------------------------------------

# JAX's ``decoder_param_shardings`` table (llmvox_tpu/parallel/sharding.py:
# 45-58), and the draft heads replicated: JAX's table has no entry for them
# (its Trainer replicates every leaf at tp_size > 1 without FSDP)
DECODER_TP_SPECS = {
    "wpe": (), "lnf_s": (), "lnf_b": (), "head": (), "draft_heads": (),
    "h": {
        "ln1_s": (), "ln1_b": (),
        "wqkv": (None, None, TP_AXIS), "bqkv": (None, TP_AXIS),
        "wo": (None, TP_AXIS, None), "bo": (),
        "ln2_s": (), "ln2_b": (),
        "wfc": (None, None, TP_AXIS), "bfc": (None, TP_AXIS),
        "wproj": (None, TP_AXIS, None), "bproj": (),
    },
}

# JAX's ``llama_param_shardings`` table (sharding.py:185-206)
LLAMA_TP_SPECS = {
    "tok_emb": (), "lnf_s": (), "head": (), "draft_heads": (),
    "h": {
        "ln1_s": (), "ln2_s": (),
        "wq": (None, None, TP_AXIS), "wk": (None, None, TP_AXIS),
        "wv": (None, None, TP_AXIS), "wo": (None, TP_AXIS, None),
        "wgate": (None, None, TP_AXIS), "wup": (None, None, TP_AXIS),
        "wdown": (None, TP_AXIS, None),
        "router": (),
        "moe_wgate": (None, EP_AXIS, None, TP_AXIS),
        "moe_wup": (None, EP_AXIS, None, TP_AXIS),
        "moe_wdown": (None, EP_AXIS, TP_AXIS, None),
    },
}

# JAX's ``decoder_fsdp_shardings`` table (llmvox_tpu/parallel/sharding.py:
# 86-101): dp on one matrix dimension, tp's Megatron dimension on the other
DECODER_FSDP_SPECS = {
    "wpe": (None, DP_AXIS), "lnf_s": (), "lnf_b": (), "head": (DP_AXIS, None),
    "h": {
        "ln1_s": (), "ln1_b": (),
        "wqkv": (None, DP_AXIS, TP_AXIS), "bqkv": (None, TP_AXIS),
        "wo": (None, TP_AXIS, DP_AXIS), "bo": (),
        "ln2_s": (), "ln2_b": (),
        "wfc": (None, DP_AXIS, TP_AXIS), "bfc": (None, TP_AXIS),
        "wproj": (None, TP_AXIS, DP_AXIS), "bproj": (),
    },
    "draft_heads": (None, DP_AXIS, None),
}

# JAX's ``llama_fsdp_shardings`` table (llmvox_tpu/parallel/sharding.py:
# 137-176): ZeRO-3 over dp beside tp's Megatron dimension, the experts'
# axis over ep
LLAMA_FSDP_SPECS = {
    "tok_emb": (DP_AXIS, None), "lnf_s": (), "head": (DP_AXIS, None),
    "draft_heads": (None, DP_AXIS, None),
    "h": {
        "ln1_s": (), "ln2_s": (),
        "wq": (None, DP_AXIS, TP_AXIS), "wk": (None, DP_AXIS, TP_AXIS),
        "wv": (None, DP_AXIS, TP_AXIS), "wo": (None, TP_AXIS, DP_AXIS),
        "wgate": (None, DP_AXIS, TP_AXIS), "wup": (None, DP_AXIS, TP_AXIS),
        "wdown": (None, TP_AXIS, DP_AXIS),
        "router": (),
        "moe_wgate": (None, EP_AXIS, DP_AXIS, TP_AXIS),
        "moe_wup": (None, EP_AXIS, DP_AXIS, TP_AXIS),
        "moe_wdown": (None, EP_AXIS, TP_AXIS, DP_AXIS),
    },
}

# the decoder's fused q|k|v leaves, cut by heads (the module's docstring)
FUSED_QKV = frozenset({"wqkv", "bqkv"})


def _is_quantized(leaf) -> bool:
    # ops/quant.py's containers hold their tensors as fields
    return not isinstance(leaf, (torch.Tensor, np.ndarray))


def _walk(tree: Dict, specs: Dict, fn, path: Tuple[str, ...] = ()):
    out = {}
    for k, v in tree.items():
        if k not in specs:
            raise ValueError(f"no tensor-parallel rule for parameter "
                             f"{'/'.join(path + (k,))!r}")
        out[k] = (_walk(v, specs[k], fn, path + (k,)) if isinstance(v, dict)
                  else fn(path + (k,), v, specs[k]))
    return out


def _refuse_quantized(tree: Dict) -> None:
    def check(path, leaf, spec):
        if _is_quantized(leaf):
            raise ValueError(
                f"{'/'.join(path)} is quantized ({type(leaf).__name__}): a "
                "quantized tree is not sharded (JAX's "
                "llama_param_shardings raises an AttributeError on it: its "
                "table walk reads .key of the quantized leaf's fields)")
        return spec
    _walk(tree, LLAMA_TP_SPECS, check)


def axis_dim(spec: Tuple, axis: str) -> Optional[int]:
    """The dimension a spec splits over ``axis`` (None: not split)."""
    return spec.index(axis) if axis in spec else None


def tp_dim(spec: Tuple) -> Optional[int]:
    """The dimension a spec splits over tp (None: replicated over tp)."""
    return axis_dim(spec, TP_AXIS)


def dp_dim(spec: Tuple) -> Optional[int]:
    """The dimension a spec splits over dp (FSDP; None: whole on every
    dp rank)."""
    return axis_dim(spec, DP_AXIS)


def ep_dim(spec: Tuple) -> Optional[int]:
    """The dimension a spec splits over ep (the experts' axis)."""
    return axis_dim(spec, EP_AXIS)


def tp_index(n: int, tp: int, rank: int, fused: bool = False) -> np.ndarray:
    """The indices of tp rank ``rank``'s block of an axis of ``n``: the
    rank-th contiguous block, or for a fused q|k|v axis the rank-th block
    of each third, concatenated."""
    if not fused:
        return np.arange(n)[dp_rows(n, rank, tp)]
    third = n // 3
    if n % 3:
        raise ValueError(f"a fused q|k|v axis of {n} is not three blocks")
    block = dp_rows(third, rank, tp)
    return np.concatenate([np.arange(third)[block] + i * third
                           for i in range(3)])


def _take(x, dim: int, idx: np.ndarray):
    if isinstance(x, torch.Tensor):
        return x.index_select(dim, torch.as_tensor(idx, device=x.device))
    return np.take(np.asarray(x), idx, axis=dim)


def leaf_index(shape: Sequence[int], spec: Tuple, tp: int = 1,
               rank: int = 0, fused: bool = False, dp: int = 1,
               dp_rank: int = 0, ep: int = 1, ep_rank: int = 0
               ) -> List[Optional[np.ndarray]]:
    """Per dimension of a leaf of ``shape``, the indices of the shard that
    tp rank ``rank``, dp rank ``dp_rank`` and ep rank ``ep_rank`` hold
    (None: the whole dimension)."""
    idx: List[Optional[np.ndarray]] = [None] * len(shape)
    for axis, n, r in ((TP_AXIS, tp, rank), (DP_AXIS, dp, dp_rank),
                       (EP_AXIS, ep, ep_rank)):
        d = axis_dim(spec, axis)
        if d is None or n <= 1:
            continue
        idx[d] = (tp_index(shape[d], n, r, fused) if axis == TP_AXIS
                  else np.arange(shape[d])[dp_rows(shape[d], r, n)])
    return idx


def shard_leaf(x, spec: Tuple, tp: int, rank: int, fused: bool = False,
               dp: int = 1, dp_rank: int = 0, ep: int = 1, ep_rank: int = 0):
    """The shard of one leaf that tp rank ``rank``, dp rank ``dp_rank``
    and ep rank ``ep_rank`` hold (a copy; the leaf itself when it is
    replicated)."""
    for d, ix in enumerate(leaf_index(x.shape, spec, tp, rank, fused, dp,
                                      dp_rank, ep, ep_rank)):
        if ix is not None:
            x = _take(x, d, ix)
    return x


def place_shard(shard: torch.Tensor, full_shape: Sequence[int], spec: Tuple,
                tp: int, rank: int, fused: bool = False, dp: int = 1,
                dp_rank: int = 0, ep: int = 1, ep_rank: int = 0
                ) -> torch.Tensor:
    """A zero-filled tensor of the full leaf's shape holding ``shard`` where
    its block lies: summed over the ranks (an all-reduce over tp, then over
    dp and ep, which gloo carries on CUDA tensors), the full leaf, bit for
    bit."""
    idx = leaf_index(full_shape, spec, tp, rank, fused, dp, dp_rank, ep,
                     ep_rank)
    if all(ix is None for ix in idx):
        return shard
    full = shard.new_zeros(tuple(full_shape))
    view, scattered = full, None
    for d, ix in enumerate(idx):
        if ix is None:
            continue
        if ix[-1] - ix[0] + 1 == len(ix):          # a contiguous block
            view = view.narrow(d, int(ix[0]), len(ix))
        else:                                      # the fused q|k|v heads
            scattered = (d, torch.as_tensor(ix, device=shard.device))
    if scattered is None:
        view.copy_(shard)
    else:
        view.index_copy_(*scattered, shard)
    return full


def shard_tree(tree: Dict, specs: Dict, tp: int, rank: int, dp: int = 1,
               dp_rank: int = 0, ep: int = 1, ep_rank: int = 0) -> Dict:
    """The shard of a full tree in the JAX layout that tp rank ``rank``
    (under FSDP dp rank ``dp_rank``, with experts ep rank ``ep_rank``)
    holds."""
    return _walk(tree, specs, lambda path, x, spec: shard_leaf(
        x, spec, tp, rank, path[-1] in FUSED_QKV, dp, dp_rank, ep, ep_rank))


def decoder_fsdp_shardings(mesh: Mesh, params: Dict) -> Dict:
    """JAX's ``decoder_fsdp_shardings``: each leaf's ``Sharding`` over
    ``mesh`` (dp on one matrix dimension, tp on the other)."""
    return _walk(params, DECODER_FSDP_SPECS,
                 lambda path, x, spec: Sharding(mesh, spec))


def llama_fsdp_shardings(mesh: Mesh, params: Dict) -> Dict:
    """JAX's ``llama_fsdp_shardings``: each leaf's ``Sharding`` over
    ``mesh`` (``LLAMA_FSDP_SPECS``)."""
    return _walk(params, LLAMA_FSDP_SPECS,
                 lambda path, x, spec: Sharding(mesh, spec))


def fsdp_dims(tree: Dict, specs: Dict) -> Dict[str, int]:
    """``FSDP.dims`` of a tree: each leaf split over dp by ``specs``,
    named by its ``/``-joined path, and the dimension."""
    out = {}

    def pick(path, x, spec):
        d = dp_dim(spec)
        if d is not None:
            out["/".join(path)] = d
    _walk(tree, specs, pick)
    return out


def llama_fsdp(tree: Dict, group) -> "FSDP":
    """The ``FSDP`` that gathers a Llama tree's ``LLAMA_FSDP_SPECS``
    shards over the dp ``group`` (None: every rank)."""
    return FSDP(group, fsdp_dims(tree, LLAMA_FSDP_SPECS))


def opt_state_specs(state: Dict, param_specs: Sequence[Tuple]) -> Dict:
    """The specs of an ``AdamW.state_dict()``: every entry holding one
    tensor a parameter (Adam's moments, the accumulated gradients) takes
    the parameters' specs, so each rank keeps its parameter's shard of
    them, and every other (the counts) is replicated: JAX's
    ``opt_state_shardings`` (``llmvox_tpu/parallel/sharding.py:111-134``)."""
    n = len(param_specs)
    return {k: list(param_specs) if isinstance(v, list) and len(v) == n
            else () for k, v in state.items()}


class FSDP(NamedTuple):
    """ZeRO-3 over the dp ``group``: ``dims`` maps a leaf's name
    (``"h/wqkv"``, ``"head"``) to the dimension its shard splits.  A
    leaf is gathered where the forward uses it (``gather_shards``: its
    backward reduce-scatters the gradient over the group), a layer's
    leaves inside the layer's block."""
    group: object
    dims: Dict[str, int]

    def leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        d = self.dims.get(name)
        return x if d is None else gather_shards(x, d, self.group)

    def layer(self, p: Dict) -> Dict:
        """One layer's leaves (the stacked axis indexed away)."""
        out = {}
        for k, x in p.items():
            d = self.dims.get("h/" + k)
            out[k] = x if d is None else gather_shards(x, d - 1, self.group)
        return out


def check_decoder_tp(cfg, tp: int) -> None:
    """The decoder splits over ``tp`` ranks by whole heads and MLP
    columns (JAX's divisibility, as ValueErrors)."""
    if tp < 1 or cfg.n_head % tp:
        raise ValueError(f"n_head={cfg.n_head} does not split over "
                         f"tp_size={tp}")


def check_llama_tp(cfg, tp: int, params: Optional[Dict] = None,
                   ep: int = 1, dp: int = 1) -> None:
    """A Llama splits over ``tp`` ranks by whole query and KV heads (so
    GQA's group map stays on each rank) and MLP or expert columns, over
    ``ep`` ranks by whole experts and under FSDP over ``dp`` ranks by
    even blocks of the width, the vocabulary and the MLP's columns (as
    GSPMD requires).  A quantized tree is refused (JAX raises on it)."""
    for name in ("n_head", "n_kv_head", "intermediate_size"):
        if tp < 1 or getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not split "
                             f"over tp_size={tp}")
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} does not split over "
                         f"ep_size={ep}")
    for name in ("n_embd", "vocab_size", "intermediate_size"):
        if dp < 1 or getattr(cfg, name) % dp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not split "
                             f"over dp={dp} (FSDP)")
    if params is not None:
        _refuse_quantized(params)


def shard_llama(params: Dict, cfg, tp: int, rank: int, ep: int = 1,
                ep_rank: int = 0, dp: int = 1, dp_rank: int = 0) -> Dict:
    """The shard of a full Llama tree that tp rank ``rank`` and ep rank
    ``ep_rank`` hold (``LLAMA_TP_SPECS``: a dense tree is whole over ep);
    at ``dp`` > 1, FSDP: also dp rank ``dp_rank``'s block of every matrix
    (``LLAMA_FSDP_SPECS``, which at dp 1 cuts as ``LLAMA_TP_SPECS``).
    ``check_llama_tp`` first."""
    check_llama_tp(cfg, tp, params, ep, dp)
    if dp == 1:
        return shard_tree(params, LLAMA_TP_SPECS, tp, rank, ep=ep,
                          ep_rank=ep_rank)
    return shard_tree(params, LLAMA_FSDP_SPECS, tp, rank, dp, dp_rank, ep,
                      ep_rank)


def check_decoder_fsdp(cfg, dp: int) -> None:
    """FSDP splits the width C over ``dp`` (and with it 4C and the
    positions' table's rows stay whole), evenly, as GSPMD requires."""
    if dp < 1 or cfg.n_embd % dp:
        raise ValueError(f"n_embd={cfg.n_embd} does not split over "
                         f"dp={dp} (FSDP)")


def shard_decoder(params: Dict, cfg, tp: int, rank: int, dp: int = 1,
                  dp_rank: int = 0, fsdp: bool = False) -> Dict:
    """The shard of a full decoder tree that tp rank ``rank`` holds, the
    fused QKV by heads; with ``fsdp``, also dp rank ``dp_rank``'s block of
    every matrix (``DECODER_FSDP_SPECS``)."""
    check_decoder_tp(cfg, tp)
    if not fsdp:
        return shard_tree(params, DECODER_TP_SPECS, tp, rank)
    check_decoder_fsdp(cfg, dp)
    return shard_tree(params, DECODER_FSDP_SPECS, tp, rank, dp, dp_rank)
