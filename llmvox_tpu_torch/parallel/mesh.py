"""Device meshes and the distributed runtime.

Counterpart of ``llmvox_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` with named axes (dp, sp, ep, tp) and lets GSPMD
insert the collectives; one process drives every device.  PyTorch's
idiom differs in two places, and the port follows it:

- **Serving** stays one process.  ``Mesh`` is a grid of ``torch.device``
  with the same named axes, and the dp-sharded pool and ``BatchTTS``
  (``serve/pool.py``, ``serve/batch.py``) run one shard of their rows on
  each device of its dp axis, with no collective: streams are
  independent.  A device may appear more than once (two shards on one
  card).
- **Training** runs one process a card under ``torchrun`` (or ``spawn``
  in ``parallel/launch.py``), each holding its rows of the global batch;
  the trainers all-reduce gradients and statistics over the default
  process group.  ``initialize_distributed`` forms that group.

Data parallelism and Megatron tensor parallelism need only
``all_reduce`` and ``broadcast``: both NCCL and gloo carry them on CUDA
tensors, so two gloo ranks can share one card (NCCL refuses two ranks on
one GPU).  ``gather_rows`` is therefore an ``all_reduce`` of a
zero-filled buffer, not an ``all_gather``.

A launch of ``dp * tp`` ranks splits into tensor-parallel groups of
``tp`` consecutive ranks and data-parallel groups of the ranks with the
same tp index, tp innermost as JAX's ``create_mesh`` orders its axes:
rank r is tp index ``r % tp`` and dp index ``r // tp``
(``initialize_model_parallel``).  The collectives take a ``group``
(None: every rank; ``LOCAL``: this rank alone, a no-op).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
SP_AXIS = "sp"
EP_AXIS = "ep"
TP_AXIS = "tp"
AXES = (DP_AXIS, SP_AXIS, EP_AXIS, TP_AXIS)


class Mesh:
    """A grid of devices with named axes: ``shape`` maps each axis name to
    its size, as JAX's ``Mesh.shape`` does; ``devices`` is the grid (a
    numpy object array) and ``device_list`` its devices in row-major
    order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid needs as many axis "
                             f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"[{', '.join(str(d) for d in self.device_list)}])")


def _check_device(d) -> torch.device:
    """``d`` as a torch.device that is present: a CPU, or a card that
    exists (an unindexed ``cuda`` is the current card)."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {d!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev}: CUDA is not available; pass "
                           "CPU devices to run the plain path")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh device {dev}: only "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def visible_devices() -> List[torch.device]:
    """The visible cards, in index order."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[...] (CPU "
                           "devices run the plain path)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(dp_size: int = -1, tp_size: int = 1, sp_size: int = 1,
                ep_size: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp, ep, tp) mesh over the first dp*sp*ep*tp of ``devices``
    (the visible cards by default); ``dp_size=-1`` takes every device
    left.  The assertions of JAX's ``create_mesh`` hold, as ValueErrors."""
    devs = [_check_device(d) for d in (devices if devices is not None
                                        else visible_devices())]
    n = len(devs)
    inner = tp_size * sp_size * ep_size
    if dp_size == -1:
        if n % inner:
            raise ValueError(f"{n} devices not divisible by tp*sp*ep="
                             f"{inner}")
        dp_size = n // inner
    need = dp_size * inner
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    grid = np.empty((need,), dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(dp_size, sp_size, ep_size, tp_size), AXES)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def initialize_distributed(init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout_s: float = 600.0) -> torch.device:
    """Form the default process group and return this rank's device.

    Without arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` through
    ``env://``).  On ``device="cuda"`` the rank's card is ``cuda:LOCAL_RANK``
    (an indexed ``device`` is taken as it is) and the backend is NCCL; on
    the CPU it is gloo, unless ``backend`` names one.  A world of one
    forms no group (JAX's ``initialize_distributed`` is a no-op on one
    host), and a group already formed is kept."""
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(env.get("LOCAL_RANK", 0 if world == 1 else rank))
        dev = torch.device("cuda", local)
    dev = _check_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1 or dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def world() -> int:
    """The default group's size (1 when none was formed)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_master() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing on one)."""
    if world() > 1:
        dist.barrier()


def data_parallel_size(dp_size: int, tp_size: int = 1) -> int:
    """The data-parallel ranks a trainer's ``dp_size`` runs on:
    ``dp_size``, or the launch's world over ``tp_size`` for -1 (JAX's
    "all devices" is one process's devices).  ``dp_size * tp_size`` must
    be the world size: nothing falls back to fewer ranks."""
    w = world()
    if tp_size < 1 or w % tp_size:
        raise ValueError(f"a world of {w} ranks does not split into "
                         f"tensor-parallel groups of tp_size={tp_size}")
    dp = w // tp_size if dp_size == -1 else dp_size
    if dp * tp_size != w:
        raise ValueError(
            f"dp_size={dp_size} x tp_size={tp_size} but the launch has a "
            f"world of {w}: training runs one rank a card (torchrun "
            "--nproc_per_node N), and dp_size -1 takes the world over "
            "tp_size")
    return dp


class _Local:
    """The group of this rank alone (``LOCAL``)."""

    def __repr__(self) -> str:
        return "LOCAL"


# every collective over it is a no-op; None names every rank
LOCAL = _Local()


class ModelParallel(NamedTuple):
    """The groups of one launch split as dp x tp (tp innermost): each
    group's size, this rank's indices, and the process groups.  A group
    of this rank alone (the tp group at tp 1, the dp group at dp 1) is
    ``LOCAL``, and the dp group at tp 1 is None (every rank), so any
    group here can be handed to the collectives as it is."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[object]
    tp_group: object


def initialize_model_parallel(tp_size: int = 1) -> ModelParallel:
    """Split the launch's world into ``world / tp_size`` data-parallel
    replicas of ``tp_size`` tensor-parallel ranks, as JAX's
    ``create_mesh(dp_size=-1, tp_size=tp_size)`` orders a mesh: rank r is
    tp index ``r % tp_size`` and dp index ``r // tp_size``.  Every rank
    calls it, in the same order (``new_group`` is collective); each call
    forms its own groups."""
    w, r = world(), rank()
    dp = data_parallel_size(-1, tp_size)
    tp_group = dp_group = LOCAL
    if tp_size > 1:
        for i in range(dp):
            g = dist.new_group(list(range(i * tp_size, (i + 1) * tp_size)))
            if r // tp_size == i:
                tp_group = g
    if dp > 1 and tp_size == 1:
        dp_group = None
    elif dp > 1:
        for j in range(tp_size):
            g = dist.new_group(list(range(j, w, tp_size)))
            if r % tp_size == j:
                dp_group = g
    return ModelParallel(dp, tp_size, r // tp_size, r % tp_size, dp_group,
                         tp_group)


def group_size(group=None) -> int:
    """The ranks in ``group`` (None: every rank, 1 without a process
    group; ``LOCAL``: 1)."""
    if group is None:
        return world()
    if group is LOCAL:
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if group is LOCAL:
        return 0
    return rank() if group is None else dist.get_rank(group)


def _collective_device(t: Optional[torch.device] = None) -> torch.device:
    """Where a collective's buffer lives: NCCL takes only CUDA tensors,
    gloo takes either; ``t`` is kept where the backend carries it."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t if t is not None else torch.device("cpu")


def all_reduce_(tensors: Sequence[torch.Tensor], op: str = "sum",
                group=None) -> None:
    """All-reduce ``tensors`` in place over ``group`` (None: every rank)
    as ONE collective: their values flattened into one buffer of their
    common dtype (``op`` "sum" or "mean").  Every rank ends with the same
    bits."""
    n_ranks = group_size(group)
    if n_ranks == 1 or not tensors:
        return
    dev = _collective_device(tensors[0].device)
    flat = torch.cat([t.reshape(-1).to(dev) for t in tensors])
    dist.all_reduce(flat, group=group)
    if op == "mean":
        flat /= n_ranks
    elif op != "sum":
        raise ValueError(f"all_reduce_: op {op!r}")
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) rows of every rank of ``group`` (None: every rank),
    concatenated in the group's rank order: the global rows of JAX's
    ``lax.all_gather(x).reshape(-1, ...)``.  Every rank holds ``n`` rows.
    It is an ``all_reduce`` of a zero-filled (ranks, n, ...) buffer, which
    gloo carries on CUDA tensors too; adding zeros leaves each row's bits
    as they were."""
    w = group_size(group)
    if w == 1:
        return x
    dev = _collective_device(x.device)
    buf = torch.zeros((w, *x.shape), dtype=x.dtype, device=dev)
    buf[group_rank(group)] = x.to(dev)
    dist.all_reduce(buf, group=group)
    return buf.reshape(-1, *x.shape[1:]).to(x.device)


def average_metrics(metrics: Dict) -> Dict[str, float]:
    """The mean of scalar metrics over the ranks (JAX's
    ``average_metrics``: keys sorted, float32); one rank passes them
    through as floats."""
    if world() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float32, device=_collective_device())
    dist.all_reduce(local)
    return dict(zip(keys, (local / world()).tolist()))


def broadcast_from_master(tree, group=None):
    """Every rank of ``group`` (None: every rank) adopts the values of the
    group's first rank: tensors are overwritten in place (and returned),
    numpy arrays and Python scalars returned anew; dicts, lists and tuples
    keep their structure.  One rank returns ``tree``."""
    if group_size(group) == 1:
        return tree
    if isinstance(tree, dict):
        return {k: broadcast_from_master(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [broadcast_from_master(v, group) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else (
            type(tree)(*out) if hasattr(tree, "_fields") else tuple(out))
    src = 0 if group is None else dist.get_global_rank(group, 0)
    if isinstance(tree, torch.Tensor):
        buf = tree.to(_collective_device(tree.device))
        dist.broadcast(buf, src, group=group)
        if buf is not tree:
            tree.copy_(buf)
        return tree
    arr = np.asarray(tree)
    buf = torch.from_numpy(np.ascontiguousarray(arr)).to(
        _collective_device())
    dist.broadcast(buf, src, group=group)
    out = buf.cpu().numpy()
    return out if isinstance(tree, np.ndarray) else out.item()
