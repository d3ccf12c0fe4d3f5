"""Megatron tensor parallelism's two operators over a tp group.

The JAX package shards the decoder and the Llama by ``PartitionSpec``
annotations (``parallel/sharding.py``) and GSPMD inserts the collectives.
The port runs one process a card, so a model's forward names them:

- ``copy_to_tp`` before a column-parallel matmul (its weight's output
  columns split over the group): the identity forward; backward, the
  all-reduce of the input's gradient, whose rank shares each column block
  contributes;
- ``reduce_from_tp`` after a row-parallel matmul (its weight's input rows
  split over the group): forward, the all-reduce of the rank partial
  products; backward, the identity.

A replicated bias after a row-parallel matmul is added once, after
``reduce_from_tp``.  A model's ``tp=None`` means no tensor parallelism:
both operators are the identity for None and for a group of one rank
(``mesh.LOCAL``), so one-device paths (and their CUDA graphs) run as
before.
Every rank of a group ends an all-reduce with the same bits, so the
activations after it, and everything computed from them alone (norms,
heads, sampled tokens), are equal on the group's ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from llmvox_tpu_torch.parallel import mesh as pmesh


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dev = pmesh._collective_device(out.device)
    buf = out.to(dev)
    dist.all_reduce(buf, group=group)
    return buf if buf.device == out.device else buf.to(out.device)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def active(group) -> bool:
    """Whether ``group`` splits anything (a group of two or more)."""
    return group is not None and pmesh.group_size(group) > 1


def size(group) -> int:
    """The ranks of a tp group (1 for None)."""
    return pmesh.group_size(group) if active(group) else 1


def copy_to_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``."""
    return _CopyToTP.apply(x, group) if active(group) else x


def reduce_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """All-reduce over ``group`` forward, identity backward."""
    return _ReduceFromTP.apply(x, group) if active(group) else x
