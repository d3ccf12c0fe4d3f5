"""Optimizer and learning-rate schedules for decoder and codec training.

Counterpart of ``llmvox_tpu/train/optim.py``, whose decoder optimizer is
the optax chain ``MultiSteps(chain(clip_by_global_norm, adamw), k)``, and
of the codec trainer's two ``optax.adamw(warmup_cosine_lr, b1, b2)``
(eps 1e-8, weight decay 1e-4 on every tensor, no clipping, no
accumulation; ``llmvox_tpu/train/codec_trainer.py:122-135, 523-525``).
``AdamW`` here updates as those do, on a list of tensors, with the
hyperparameters of the config it is given (``hyper``):

- gradients are averaged over ``k`` micro-steps (``MultiSteps``' running
  mean ``acc + (g - acc) / (i + 1)``); only every k-th call updates;
- the mean is clipped by its global norm (the decoder's only): scaled by ``max_norm / norm``
  when ``norm >= max_norm`` and left as it is below (no epsilon; a
  ``grad_clip`` of 0 therefore zeroes every update, as it does in JAX).
  Under tensor parallelism and FSDP (``sharded`` and ``norm_reduce``
  set) the squares of each sharded tensor are summed over the groups of
  the axes it is split over (tp, dp, or both in turn) and those of the
  replicated ones counted once, so the norm is the whole tree's;
- Adam with bias correction ``1 - beta ** count`` in f32 and ``eps``
  added to ``sqrt(nu_hat)``; weight decay added to the Adam step for the
  tensors ``decay_mask`` selects (by name, not by ndim); then the step is
  scaled by ``-lr_schedule(u)`` where u counts updates from 0, so with a
  warmup the first update moves no parameter but does advance the
  moments.

Every operation stays on the device: nothing reads the norm or the count
back to the host.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from llmvox_tpu_torch.utils.config import CodecTrainConfig, TrainConfig

_NO_DECAY_KEYS = frozenset({
    "ln1_s", "ln1_b", "ln2_s", "ln2_b", "lnf_s", "lnf_b",
    "bqkv", "bo", "bfc", "bproj",
})


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup, cosine decay to ``min_lr``, then ``min_lr``; computed
    in float32 as the JAX schedule is."""
    f32 = np.float32

    def fn(step) -> float:
        step = f32(step)
        lr = f32(cfg.learning_rate)
        if not cfg.decay_lr:
            return float(lr)
        if step < cfg.warmup_iters:
            return float(lr * step / f32(max(cfg.warmup_iters, 1)))
        if step > cfg.lr_decay_iters:
            return float(f32(cfg.min_lr))
        ratio = (step - f32(cfg.warmup_iters)) / f32(
            max(cfg.lr_decay_iters - cfg.warmup_iters, 1))
        ratio = np.clip(ratio, f32(0.0), f32(1.0))
        coeff = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * ratio))
        return float(f32(cfg.min_lr) + coeff * (lr - f32(cfg.min_lr)))
    return fn


def warmup_cosine_lr(tcfg: CodecTrainConfig) -> Callable[[int], float]:
    """The codec trainer's schedule: linear warmup over
    ``num_warmup_steps``, then a cosine from ``initial_learning_rate`` to
    0 over ``max_steps // 2`` (transformers'
    ``get_cosine_schedule_with_warmup``), in float32 as JAX's."""
    f32 = np.float32
    total = max(tcfg.max_steps // 2, 1)
    warm = tcfg.num_warmup_steps

    def fn(step) -> float:
        step = f32(step)
        lr = f32(tcfg.initial_learning_rate)
        if step < warm:
            return float(lr * step / f32(max(warm, 1)))
        progress = np.clip((step - f32(warm)) / f32(max(total - warm, 1)),
                           f32(0.0), f32(1.0))
        return float(f32(tcfg.initial_learning_rate * 0.5) *
                     (f32(1.0) + np.cos(f32(math.pi) * progress)))
    return fn


class Hyper(NamedTuple):
    """What ``AdamW`` reads of a config: the schedule of the update
    count, the moments' decays, eps, the weight decay, the global-norm
    clip (None: none) and the micro-steps an update."""
    schedule: Callable[[int], float]
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: Optional[float]
    k: int


def hyper(cfg: Union[TrainConfig, CodecTrainConfig]) -> Hyper:
    if isinstance(cfg, CodecTrainConfig):
        # optax.adamw's defaults, as the codec trainer builds it
        return Hyper(warmup_cosine_lr(cfg), cfg.adam_b1, cfg.adam_b2, 1e-8,
                     1e-4, None, 1)
    return Hyper(lr_schedule(cfg), cfg.beta1, cfg.beta2, cfg.adam_eps,
                 cfg.weight_decay, cfg.grad_clip,
                 max(cfg.gradient_accumulation_steps, 1))


def decay_mask(params: Dict) -> Dict:
    """The params tree's structure with True for the leaves that get
    weight decay (matmul weights and embeddings)."""
    def pick(node, name):
        if isinstance(node, dict):
            return {k: pick(v, k) for k, v in node.items()}
        return name not in _NO_DECAY_KEYS
    return pick(params, None)


def named_leaves(tree: Dict, prefix: str = "") -> List:
    """[(path, leaf)] of a nested dict in insertion order, paths joined
    by ``/`` as in the checkpoint files."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(named_leaves(v, path + "/"))
        else:
            out.append((path, v))
    return out


class AdamW:
    """``make_optimizer``'s update (a ``TrainConfig``) or the codec
    trainer's (a ``CodecTrainConfig``) on ``params`` (tensors updated in
    place).  ``decay[i]`` says whether ``params[i]`` gets weight decay.
    Its state (``state_dict``) is the moments, the accumulated gradients
    and the two counts, all on the params' device."""

    def __init__(self, cfg: Union[TrainConfig, CodecTrainConfig],
                 params: Sequence[torch.Tensor], decay: Sequence[bool]):
        self.cfg = cfg
        self.hyper = hyper(cfg)
        self.params = list(params)
        self.decay = list(decay)
        self.k = self.hyper.k
        self.schedule = self.hyper.schedule
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params]
        # the counts are host integers: the device sees them only as the
        # scalars of each update
        self.count = 0        # updates applied (optax's adam count)
        self.mini_step = 0    # micro-steps accumulated since the last one
        # data parallelism: reduces the accumulated gradients over the
        # ranks in place, once an update, before clipping
        self.reduce: Optional[Callable[[List[torch.Tensor]], None]] = None
        # tensor parallelism and FSDP: the mesh axes ("tp", "dp") each
        # param is split over on this rank (() when it is whole), and per
        # axis the sum over its group (in place) of squared norms
        self.sharded: List[Tuple[str, ...]] = [()] * len(self.params)
        self.norm_reduce: Dict[str, Callable[[List[torch.Tensor]],
                                             None]] = {}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns True when this call
        applied an update."""
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        if n < self.k - 1:
            self.mini_step += 1
            return False
        if self.reduce is not None:
            self.reduce(self.acc)
        self._update(self.acc)
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        hp = self.hyper
        if hp.grad_clip is not None:
            norm = self._global_norm(grads)
            clip = ~(norm < hp.grad_clip)
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        b1, b2 = hp.b1, hp.b2
        bc1 = float(f32(1.0) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(self.count))
        for p, g, mu, nu, wd in zip(self.params, grads, self.mu, self.nu,
                                    self.decay):
            if hp.grad_clip is not None:
                g = torch.where(clip, (g / norm) * hp.grad_clip, g)
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + hp.eps)
            if wd:
                u = u + hp.weight_decay * p
            p.add_(u, alpha=-lr)

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        sq = [(g.float() ** 2).sum() for g in grads]
        if not self.norm_reduce:
            return torch.sqrt(sum(sq))
        # one partial sum per set of axes a param is split over, summed
        # over each of its axes' groups in turn; the whole ones' once
        zero = grads[0].new_zeros((), dtype=torch.float32)
        keys = sorted(set(self.sharded))
        parts = torch.stack([sum((q for q, s in zip(sq, self.sharded)
                                  if s == key), zero) for key in keys])
        for axis, reduce in self.norm_reduce.items():
            sel = torch.tensor([i for i, key in enumerate(keys)
                                if axis in key], dtype=torch.long,
                               device=parts.device)
            if len(sel):
                sub = parts[sel]
                reduce([sub])
                parts[sel] = sub
        return torch.sqrt(parts.sum())

    def state_dict(self) -> Dict[str, object]:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc,
                "count": self.count, "mini_step": self.mini_step}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        for name in ("mu", "nu", "acc"):
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(torch.as_tensor(np.asarray(src)))
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
