"""EMA vector-quantizer training (the codec's codebook).

Counterpart of ``llmvox_tpu/train/vq_train.py``, on one device:

- k-means init on the first batch, from rows of the batch drawn by the
  caller (``init_idx``: a permutation's first ``bins`` rows, or ``bins``
  draws with replacement when the batch holds fewer vectors);
- nearest-code assignment, the straight-through estimator, the
  commitment MSE;
- EMA cluster sizes and sums with Laplace smoothing;
- dead-code expiry at ``threshold_dead``: expired codes take batch rows
  (``dead_idx``, drawn by the caller) and their averages restart there,
  the corrected semantics of JAX's module docstring.

The draws are arguments (``draw_indices`` makes them from a
``torch.Generator``) so a test can pass JAX's.  Sums are f32 matmuls, as
JAX's HIGHEST-precision dots; argmax ties go to the first index on both
sides.

Data-parallel (``sync=True`` under a process group, each rank holding
its block of the global rows): the draws index the global rows, so
k-means runs on the rows of every rank gathered in rank order (JAX's
``lax.all_gather`` over its axis, or its GSPMD program over the global
array), the EMA counts and sums are summed over the ranks (``psum``), and
a dead code's replacement is the global row its draw names, taken from
the rank that holds it.  Every rank ends with the same state.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.parallel import mesh as pmesh


class VQState(NamedTuple):
    embed: torch.Tensor         # (bins, dim)
    embed_avg: torch.Tensor     # (bins, dim)
    cluster_size: torch.Tensor  # (bins,)
    inited: torch.Tensor        # 0-d bool


def init_vq_state(seed: int, bins: int, dim: int, device="cpu",
                  kmeans_init: bool = True) -> VQState:
    """A uniform(-1, 1) codebook drawn by numpy from ``seed`` (JAX's shape
    and distribution, not its values), uninitialised."""
    embed = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (bins, dim)).astype(np.float32)
    embed = torch.from_numpy(embed).to(device)
    return VQState(embed=embed, embed_avg=embed.clone(),
                   cluster_size=torch.zeros((bins,), device=device),
                   inited=torch.tensor(not kmeans_init, device=device))


def pairwise_dist(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """-(||x||^2 - 2 x.e + ||e||^2) for (N, dim) x (bins, dim)."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    e2 = embed.square().sum(dim=-1)
    return -(x2 - 2.0 * (x @ embed.t()) + e2)


def _counts_and_sums(assign: torch.Tensor, data: torch.Tensor,
                     bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code counts and the sums of the rows assigned to each code, as
    JAX's one-hot products."""
    onehot = torch.nn.functional.one_hot(assign, bins).to(data.dtype)
    return onehot.sum(dim=0), onehot.t() @ data


def kmeans(data: torch.Tensor, bins: int, iters: int,
           init_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means (bins, dim), counts (bins,)) after ``iters`` Lloyd steps from
    ``data[init_idx]``; an empty cluster keeps its previous mean."""
    means = data[init_idx]
    for _ in range(iters):
        assign = torch.argmax(pairwise_dist(data, means), dim=-1)
        counts, sums = _counts_and_sums(assign, data, bins)
        new = sums / counts[:, None].clamp_min(1.0)
        means = torch.where(counts[:, None] > 0, new, means)
    assign = torch.argmax(pairwise_dist(data, means), dim=-1)
    counts = torch.nn.functional.one_hot(assign, bins).to(data.dtype).sum(0)
    return means, counts


def draw_indices(generator: torch.Generator, n: int,
                 bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(init_idx, dead_idx) for a batch of ``n`` vectors: k-means' initial
    rows (a permutation's first ``bins``, or ``bins`` draws with
    replacement when n < bins) and the dead codes' replacement rows."""
    if n >= bins:
        init_idx = torch.randperm(n, generator=generator)[:bins]
    else:
        init_idx = torch.randint(0, n, (bins,), generator=generator)
    dead_idx = torch.randint(0, n, (bins,), generator=generator)
    return init_idx, dead_idx


def _global_rows(xd: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows of the ranks' concatenated (world * n, dim) data that
    ``idx`` names: each rank fills the ones it holds and the ranks sum
    (every other entry is 0, so each row keeps its bits)."""
    n = xd.shape[0]
    idx = idx.to(xd.device)
    mine = (idx // n) == pmesh.rank()
    out = torch.where(mine[:, None], xd[(idx % n)], torch.zeros_like(
        xd[:1]))
    pmesh.all_reduce_([out])
    return out


def vq_train_step(state: VQState, x: torch.Tensor, init_idx: torch.Tensor,
                  dead_idx: torch.Tensor, *, decay: float = 0.99,
                  epsilon: float = 1e-5, threshold_dead: float = 2.0,
                  kmeans_iters: int = 50, sync: bool = False):
    """One training pass of the codebook over (N, dim) encoder outputs:
    (quantized (N, dim) with the straight-through gradient, codes (N,),
    commitment loss, new state).  The state's tensors carry no gradient.
    ``sync``: data-parallel over the process group (the module's
    docstring); the draws then index the global rows."""
    bins = state.embed.shape[0]
    xd = x.detach()
    if not bool(state.inited):
        data = pmesh.gather_rows(xd) if sync else xd
        means, counts = kmeans(data, bins, kmeans_iters,
                               init_idx.to(x.device))
        state = VQState(means, means, counts, state.inited)
    embed = state.embed
    codes = torch.argmax(pairwise_dist(xd, embed), dim=-1)
    quant = embed[codes]
    commit = (quant - x).square().mean()
    quant_ste = x + (quant - xd)

    batch_size, batch_sum = _counts_and_sums(codes, xd, bins)
    if sync:
        pmesh.all_reduce_([batch_size, batch_sum])
    cluster_size = state.cluster_size * decay + batch_size * (1 - decay)
    embed_avg = state.embed_avg * decay + batch_sum * (1 - decay)

    expired = cluster_size < threshold_dead
    replacements = (_global_rows(xd, dead_idx) if sync
                    else xd[dead_idx.to(x.device)])
    embed_avg = torch.where(expired[:, None], replacements * threshold_dead,
                            embed_avg)
    cluster_size = torch.where(expired, torch.full_like(
        cluster_size, threshold_dead), cluster_size)

    total = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (total + bins * epsilon) * total
    new_state = VQState(embed=embed_avg / smoothed[:, None],
                        embed_avg=embed_avg, cluster_size=cluster_size,
                        inited=torch.ones_like(state.inited))
    return quant_ste, codes.int(), commit, new_state


def vq_infer(state: VQState, x: torch.Tensor):
    """Inference assignment: (quantized (N, dim), codes (N,)); ``inited``
    is not read, as in JAX."""
    codes = torch.argmax(pairwise_dist(x, state.embed), dim=-1)
    return state.embed[codes], codes.int()
