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
``all_reduce``, ``broadcast`` and an all-gather of rows (``gather_rows``);
sequence parallelism, FSDP and the pipeline a ring rotation
(``ppermute``, JAX's ``lax.ppermute``), an all-gather and a
reduce-scatter along one dimension; the all-to-all expert dispatch
(``ops/moe.py::moe_ffn_a2a``) an all-to-all (``all_to_all_dim``, JAX's
tiled ``lax.all_to_all``).  NCCL and gloo both carry ``all_reduce`` and ``broadcast`` on
CUDA tensors, so two gloo ranks can share one card (NCCL refuses two
ranks on one GPU).  The rest takes one of two routes, chosen by the
backend and the tensor's device (``route``):
the op itself (``"native"``: NCCL, or gloo on CPU tensors) or an
``all_reduce`` of a zero-filled buffer (``"all_reduce"``: gloo on CUDA
tensors, which carries nothing else), bitwise equal for the rotation, the
gather and the all-to-all because adding zeros changes no bit (but a
-0.0's sign).

A launch of ``dp * sp * ep * tp`` ranks is ordered as JAX's
``create_mesh`` orders its axes (dp, sp, ep, tp), tp innermost: rank r is
tp index ``r % tp``, ep index ``(r // tp) % ep``, sp index
``(r // (tp * ep)) % sp`` and dp index ``r // (tp * ep * sp)``
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


def data_parallel_size(dp_size: int, tp_size: int = 1,
                       sp_size: int = 1, ep_size: int = 1) -> int:
    """The data-parallel ranks a trainer's ``dp_size`` runs on:
    ``dp_size``, or the launch's world over ``tp_size * sp_size *
    ep_size`` for -1 (JAX's "all devices" is one process's devices).
    ``dp_size * sp_size * ep_size * tp_size`` must be the world size:
    nothing falls back to fewer ranks."""
    w = world()
    for name, n in (("tp_size", tp_size), ("sp_size", sp_size),
                    ("ep_size", ep_size)):
        if n < 1 or w % n:
            raise ValueError(f"a world of {w} ranks does not split into "
                             f"groups of {name}={n}")
    if w % (tp_size * sp_size * ep_size):
        raise ValueError(f"a world of {w} ranks does not split into "
                         f"groups of tp_size={tp_size} x sp_size={sp_size}"
                         + (f" x ep_size={ep_size}" if ep_size > 1 else ""))
    inner = tp_size * sp_size * ep_size
    dp = w // inner if dp_size == -1 else dp_size
    if dp * inner != w:
        raise ValueError(
            f"dp_size={dp_size} x sp_size={sp_size} x tp_size={tp_size} but "
            f"the launch has a world of {w}: training runs one rank a card "
            "(torchrun --nproc_per_node N), and dp_size -1 takes the world "
            "over sp_size x tp_size" + (" x ep_size" if ep_size > 1 else ""))
    return dp


class _Local:
    """The group of this rank alone (``LOCAL``)."""

    def __repr__(self) -> str:
        return "LOCAL"


# every collective over it is a no-op; None names every rank
LOCAL = _Local()


class ModelParallel(NamedTuple):
    """The groups of one launch split as dp x sp x ep x tp (tp innermost):
    each group's size, this rank's indices, and the process groups.  A
    group of this rank alone (the tp group at tp 1, the dp group at dp 1)
    is ``LOCAL``, and a group of every rank (the dp group at sp, ep and tp
    1, the batch group at ep and tp 1) is None, so any group here can be
    handed to the collectives as it is.  ``batch_group`` is the dp x sp
    ranks of one (ep, tp) index: the ranks whose shares of a batch make it
    whole, over which a replicated leaf's gradient is summed (the ranks of
    an ep group hold the same tokens, each with its block of experts)."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[object]
    tp_group: object
    sp: int = 1
    sp_rank: int = 0
    sp_group: object = None
    batch_group: Optional[object] = None
    ep: int = 1
    ep_rank: int = 0
    ep_group: object = None


def _form(groups: List[List[int]], model: bool = False):
    """Form every group of ``groups`` (every rank calls this in the same
    order: ``new_group`` is collective) and return this rank's: ``LOCAL``
    for a group of one rank, None for a group of every rank unless
    ``model`` (a tensor-parallel group is always a group, since None
    there means no tensor parallelism)."""
    r, w = rank(), world()
    mine = LOCAL
    for ranks in groups:
        if len(ranks) == 1:
            continue
        if len(ranks) == w and not model:
            return None
        g = dist.new_group(ranks)
        if r in ranks:
            mine = g
    return mine


def initialize_model_parallel(tp_size: int = 1, sp_size: int = 1,
                              ep_size: int = 1) -> ModelParallel:
    """Split the launch's world into ``world / (sp_size * ep_size *
    tp_size)`` data-parallel replicas of ``sp_size`` sequence-parallel
    shares of ``ep_size`` expert-parallel blocks of ``tp_size``
    tensor-parallel ranks, as JAX's ``create_mesh(dp_size=-1, tp_size=,
    sp_size=, ep_size=)`` orders a mesh (dp, sp, ep, tp): rank r is tp
    index ``r % tp``, ep index ``(r // tp) % ep``, sp index
    ``(r // (tp * ep)) % sp`` and dp index ``r // (tp * ep * sp)``.  Every
    rank calls it, in the same order (``new_group`` is collective); each
    call forms its own groups."""
    w, r = world(), rank()
    tp, sp, ep = tp_size, sp_size, ep_size
    dp = data_parallel_size(-1, tp, sp, ep)
    inner = tp * ep * sp
    cells = [(d, s, e, t) for d in range(dp) for s in range(sp)
             for e in range(ep) for t in range(tp)]

    def at(d, s, e, t):
        return ((d * sp + s) * ep + e) * tp + t

    def groups(axis: int):
        # the ranks that differ only in mesh axis ``axis`` (0 dp .. 3 tp)
        out = {}
        for c in cells:
            key = c[:axis] + c[axis + 1:]
            out.setdefault(key, []).append(at(*c))
        return list(out.values())
    tp_group = _form(groups(3), model=True)
    sp_group = _form(groups(1), model=True)
    dp_group = _form(groups(0))
    batch_group = _form([[x for x in range(w) if x % (tp * ep) == et]
                         for et in range(tp * ep)])
    ep_group = _form(groups(2), model=True)
    return ModelParallel(dp, tp, r // inner, r % tp, dp_group, tp_group,
                         sp, (r // (tp * ep)) % sp, sp_group, batch_group,
                         ep, (r // tp) % ep, ep_group)


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
    ``all_gather_dim`` along the rows, on the backend's device."""
    if group_size(group) == 1:
        return x
    return all_gather_dim(x.to(_collective_device(x.device)), 0,
                          group).to(x.device)


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


# ---------------------------------------------------------------------------
# sequence parallelism and FSDP: the ring rotation, all-gather and
# reduce-scatter along one dimension
# ---------------------------------------------------------------------------

NATIVE = "native"
ALL_REDUCE = "all_reduce"


def route(device) -> str:
    """How a rotation, all-gather or reduce-scatter of tensors on
    ``device`` travels: ``NATIVE`` (point-to-point sends,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``) where the
    backend carries them, NCCL or gloo on the CPU; ``ALL_REDUCE`` (of a
    zero-filled buffer) for gloo on CUDA tensors, which carries only
    ``all_reduce`` and ``broadcast``."""
    if dist.get_backend() == "nccl" or torch.device(device).type == "cpu":
        return NATIVE
    return ALL_REDUCE


def _global(group, i: int) -> int:
    return i if group is None else dist.get_global_rank(group, i)


def rotate(x: torch.Tensor, group, shift: int = 1,
           via: Optional[str] = None) -> torch.Tensor:
    """Rank i of ``group`` sends ``x`` to rank ``(i + shift) % n`` and
    returns what rank ``(i - shift) % n`` sent (every rank's ``x`` has one
    shape and dtype): JAX's ``lax.ppermute`` with the ring's pairs.
    ``via`` forces a route (``route`` by default)."""
    n = group_size(group)
    if n == 1:
        return x
    i = group_rank(group)
    x = x.contiguous()
    if (via or route(x.device)) == NATIVE:
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, _global(group, (i + shift) % n),
                          group=group),
               dist.P2POp(dist.irecv, out, _global(group, (i - shift) % n),
                          group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    buf = x.new_zeros((n, *x.shape))
    buf[(i + shift) % n] = x
    dist.all_reduce(buf, group=group)
    return buf[i]


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   via: Optional[str] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the group's rank
    order (every rank's ``x`` has one shape)."""
    n = group_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if (via or route(x.device)) == NATIVE:
        out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
        getattr(dist, "all_gather_single",
                dist.all_gather_into_tensor)(out, xt, group=group)
    else:
        buf = xt.new_zeros((n, *xt.shape))
        buf[group_rank(group)] = xt
        dist.all_reduce(buf, group=group)
        out = buf.reshape(n * xt.shape[0], *xt.shape[1:])
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       via: Optional[str] = None) -> torch.Tensor:
    """The sum over the ranks of ``x``, split along ``dim`` into as many
    contiguous blocks as ranks: rank i keeps block i."""
    n = group_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    size = xt.shape[0] // n
    if (via or route(x.device)) == NATIVE:
        out = xt.new_empty((size, *xt.shape[1:]))
        getattr(dist, "reduce_scatter_single",
                dist.reduce_scatter_tensor)(out, xt, group=group)
    else:
        xt = xt.clone()
        dist.all_reduce(xt, group=group)
        i = group_rank(group)
        out = xt[i * size:(i + 1) * size]
    return out.movedim(0, dim).contiguous()


def all_to_all_dim(x: torch.Tensor, group, via: Optional[str] = None,
                   dim: int = 0) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all(x, split_axis=dim, concat_axis=dim)``:
    ``x`` cut along ``dim`` into as many contiguous blocks as ranks, block
    j sent to rank j of ``group``; returns the blocks received, in the
    group's rank order (every rank's ``x`` has one shape).  Natively
    ``all_to_all_single``; by the all-reduce route a zero-filled (n, n,
    block) buffer whose row i is this rank's blocks, of which rank i keeps
    column i.  Not differentiated: ``all_to_all`` is."""
    n = group_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"all_to_all: {xt.shape[0]} rows do not split "
                         f"over {n} ranks")
    if (via or route(x.device)) == NATIVE:
        out = torch.empty_like(xt)
        dist.all_to_all_single(out, xt, group=group)
    else:
        i = group_rank(group)
        blocks = xt.reshape(n, xt.shape[0] // n, *xt.shape[1:])
        buf = xt.new_zeros((n, *blocks.shape))
        buf[i] = blocks
        dist.all_reduce(buf, group=group)
        out = buf[:, i].reshape(xt.shape)
    return out.movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_to_all_dim(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # the exchange is its own inverse: block j of rank i's gradient
        # is block i of rank j's output gradient
        return all_to_all_dim(grad, ctx.group, dim=ctx.dim), None, None


def all_to_all(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_to_all_dim`` differentiated: its backward is the inverse
    exchange (the same exchange of the gradients), as JAX's transpose of
    ``all_to_all`` is."""
    return _AllToAll.apply(x, group, dim) if group_size(group) > 1 else x


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return rotate(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return rotate(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``rotate`` differentiated: its backward is the inverse rotation,
    as JAX's transpose of ``ppermute`` is."""
    return _PPermute.apply(x, group, shift) if group_size(group) > 1 else x


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """ZeRO-3's gather of a parameter: forward, the ranks' shards
    concatenated along ``dim``; backward, the gradient summed over the
    ranks and each rank's block kept (a reduce-scatter), so the shard's
    gradient is the whole batch's."""
    return (_GatherShards.apply(x, dim, group) if group_size(group) > 1
            else x)
