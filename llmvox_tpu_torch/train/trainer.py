"""Decoder training, on one device, or data- and tensor-parallel over
several.

Counterpart of ``llmvox_tpu/train/trainer.py``.  A step builds the fused
inputs from the int32 ids on the device, runs the loss forward and
backward in ``compute_dtype`` (bf16 on the card; f32 for the checks)
against f32 parameters, and hands the gradients to
``train/optim.py::AdamW``, which updates as the JAX package's optax chain
does (accumulating ``gradient_accumulation_steps`` micro-steps an update).
``iter_num`` counts micro-steps, as JAX's does.

Data parallelism runs one process a card under ``torchrun`` (the default
process group, ``parallel/mesh.py::initialize_distributed``), where JAX
runs one process over a dp mesh: ``dp_size`` -1 is the launch's world
size.  Every rank draws the same global batch from the one seeded
iterator and keeps its block of rows (JAX's ``P("dp")``); each loss term
is divided by the whole batch's count of valid targets (summed over the
ranks first), so the rank gradients sum to JAX's global one; the
accumulated gradients are summed over the ranks once an update, before
clipping and AdamW, so every rank applies the same update to the same
bits.  Rank 0 writes checkpoints.

Tensor parallelism (``tp_size`` > 1) splits the world into dp x tp ranks,
tp innermost (``parallel/mesh.py::initialize_model_parallel``): each tp
group of ``tp_size`` consecutive ranks trains one Megatron-sharded copy
(``parallel/sharding.py::shard_decoder``; the draft heads, norms,
embeddings and head replicated) on one dp block of rows, and the
gradients are summed over each dp group once an update.  AdamW keeps
each rank's moments for its shards; the clip's global norm sums the
sharded tensors over the tp group and counts the replicated ones once.
Dropout draws from a generator seeded by the dp index, so the ranks of a
tp group, which hold the same activations, draw the same masks.  The
checkpoints (params and the optimizer's file) are gathered into the full
JAX layout, which JAX reads and which resumes at any layout.  JAX's
Trainer places every leaf replicated at ``tp_size`` > 1 without FSDP; the
sharded run equals it to rounding.

Sequence parallelism (``sp_size`` > 1) splits each dp block of rows's
sequence over ``sp_size`` ranks, the world dp x sp x tp in JAX's mesh
order (tp innermost).  Each rank runs the decoder on its share of T (its
contiguous block under ``sp_layout`` "ring", its block of the zigzag
permutation under "zigzag"; ``models/decoder.py::seq_share``) with the
ring attention of ``ops/ring_attention.py``; the draft heads' shifted
targets are built over the whole sequence first, each loss term is
divided by the whole batch's valid counts, and dropout draws each
sequence's whole mask from the dp index's generator and keeps the
rank's rows, so the sp ranks of a dp block drop what one process would.
Packed batches are refused under sp, as JAX asserts.

FSDP (``fsdp``) keeps on each rank 1/dp of every matrix JAX's
``decoder_fsdp_shardings`` splits (and of its AdamW moments): dp on one
dimension, tp's Megatron dimension on the other.  Each layer's shards
are gathered in its block (``parallel/sharding.py::FSDP``, an autograd
Function whose backward reduce-scatters the gradient over dp: ZeRO-3);
with ``remat_layers`` the block, and so the gather, runs again in the
backward pass, and otherwise autograd keeps the gathered layer for it.
The gradients of the split leaves are summed over sp once an update,
those of the whole leaves over dp x sp, and the clip's norm sums each
split leaf's squares over the groups of its axes.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.ops.ring_attention import LAYOUTS
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel.sharding import dp_rows
from llmvox_tpu_torch.train import checkpoint as ckpt
from llmvox_tpu_torch.train.data import build_decoder_inputs
from llmvox_tpu_torch.train.optim import (AdamW, decay_mask, lr_schedule,
                                          named_leaves)
from llmvox_tpu_torch.utils.config import DecoderConfig, TrainConfig
from llmvox_tpu_torch.utils.device import resolve_device
from llmvox_tpu_torch.utils.params import init_decoder_params

# The dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's H100
# datasheet: 989 TFLOP/s without sparsity, at the 700 W limit); the
# environment variable overrides it for another card.
H100_PEAK_FLOPS = float(os.environ.get("LLMVOX_TPU_TORCH_PEAK_FLOPS", 989e12))


def estimate_mfu(cfg: DecoderConfig, n_params: int, tokens_per_iter: int,
                 dt: float, peak: float = H100_PEAK_FLOPS,
                 seq_len: int = 0) -> float:
    """PaLM-style model FLOPs utilisation: 6N + 12·L·H·Q·T FLOPs a token
    (N the non-embedding parameters, T the step's sequence width,
    ``cfg.block_size`` when 0), over ``dt`` seconds, against ``peak``."""
    l, h, q = cfg.n_layer, cfg.n_head, cfg.head_dim
    t = seq_len or cfg.block_size
    flops_per_token = 6 * n_params + 12 * l * h * q * t
    return flops_per_token * tokens_per_iter / dt / peak


def _check_supported(tcfg: TrainConfig,
                     mcfg: DecoderConfig) -> pmesh.ModelParallel:
    if tcfg.sp_layout not in LAYOUTS:
        raise ValueError(f"sp_layout {tcfg.sp_layout!r} is not one of "
                         f"{LAYOUTS} (JAX's Trainer runs the plain ring for "
                         "any layout but 'zigzag')")
    dp = pmesh.data_parallel_size(tcfg.dp_size, tcfg.tp_size, tcfg.sp_size)
    psh.check_decoder_tp(mcfg, tcfg.tp_size)
    if tcfg.fsdp:
        psh.check_decoder_fsdp(mcfg, dp)
    if tcfg.batch_size % dp:
        raise ValueError(f"batch_size {tcfg.batch_size} must divide over "
                         f"dp={dp}")
    return pmesh.initialize_model_parallel(tcfg.tp_size, tcfg.sp_size)


def _spec(name: str, fsdp: bool = False):
    node = psh.DECODER_FSDP_SPECS if fsdp else psh.DECODER_TP_SPECS
    for k in name.split("/"):
        node = node[k]
    return node


def _tree(names: List[str], tensors: List[torch.Tensor]) -> Dict:
    """The nested tree of ``names`` ("h/wqkv", ...) and their tensors."""
    out: Dict = {}
    for name, t in zip(names, tensors):
        *parents, leaf = name.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


class Trainer:
    """End-to-end decoder training.  ``params`` (a full tree in the JAX
    layout) replaces the seeded initialisation, as assigning
    ``state.params`` does for the JAX trainer.  Under a process group of N
    ranks it trains data-parallel, tensor-parallel at ``tp_size`` > 1,
    sequence-parallel at ``sp_size`` > 1 and with FSDP at ``fsdp`` (the
    module's docstring); the batches it is given are the global ones.
    ``params`` is this rank's shard of the tree, ``full_params()`` the
    whole of it."""

    def __init__(self, tcfg: TrainConfig, mcfg: DecoderConfig,
                 text_table: np.ndarray, codebook: np.ndarray, *,
                 compute_dtype=torch.bfloat16, device="cuda",
                 params: Optional[Dict] = None):
        self.mp = _check_supported(tcfg, mcfg)
        self.dp, self.tp, self.sp = self.mp.dp, self.mp.tp, self.mp.sp
        self.rank = pmesh.rank()
        self.device = resolve_device(device)
        self.tcfg, self.mcfg = tcfg, mcfg
        self.compute_dtype = compute_dtype
        # dropout masks, seed + dp index as JAX's seed + process_index
        # (the ranks of a tp group and of an sp group draw alike); the data
        # order is numpy's, seeded by the iterators
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tcfg.seed + self.mp.dp_rank)
        if params is None:
            params = init_decoder_params(tcfg.seed, mcfg)
        self.n_params = dec.num_params(params)
        # FSDP over a dp group of one splits nothing
        self.fsdp = tcfg.fsdp and self.dp > 1
        if self.tp > 1 or self.fsdp:
            params = psh.shard_decoder(params, mcfg, self.tp,
                                       self.mp.tp_rank, self.dp,
                                       self.mp.dp_rank, self.fsdp)
        gather = None
        if self.fsdp:
            dims = {n: psh.dp_dim(_spec(n, True))
                    for n, _ in named_leaves(params)}
            gather = psh.FSDP(self.mp.dp_group, {
                n: d for n, d in dims.items() if d is not None})
        self.model = dec.DecoderModel(params, mcfg, self.device,
                                      tp=self.mp.tp_group, fsdp=gather)
        tree = self.model.tree()
        self.names = [n for n, _ in named_leaves(tree)]
        self.specs = [_spec(n, self.fsdp) for n in self.names]
        # the axes each leaf is split over on this rank
        self.split = [tuple(a for a, n, d in (
            ("tp", self.tp, psh.tp_dim(spec)),
            ("dp", self.dp, psh.dp_dim(spec))) if n > 1 and d is not None)
            for spec in self.specs]
        self.opt = AdamW(tcfg, [p for _, p in named_leaves(tree)],
                         [d for _, d in named_leaves(decay_mask(tree))])
        self.opt.sharded = list(self.split)
        self.opt.norm_reduce = {
            a: functools.partial(pmesh.all_reduce_, group=g)
            for a, g in (("tp", self.mp.tp_group), ("dp", self.mp.dp_group))
            if any(a in sp for sp in self.split)}
        with torch.no_grad():
            for same, group in self._groups():
                pmesh.broadcast_from_master(same, group=group)
        self.opt.reduce = self._reduce
        self._n_heads = (tree["draft_heads"].shape[0]
                         if "draft_heads" in tree else 0)
        self.text_table = torch.as_tensor(
            np.asarray(text_table, np.float32)).to(self.device)
        self.codebook = torch.as_tensor(
            np.asarray(codebook, np.float32)).to(self.device)
        self.iter_num = 0

    def _groups(self) -> List[Tuple[List[torch.Tensor], object]]:
        """(tensors, the group over which they are the same tensor): the
        leaves whole over dp on the dp x sp ranks of their tp index, the
        dp-split ones on their sp group."""
        whole = [p for p, s in zip(self.opt.params, self.split)
                 if "dp" not in s]
        split = [p for p, s in zip(self.opt.params, self.split) if "dp" in s]
        return [(whole, self.mp.batch_group), (split, self.mp.sp_group)]

    def _reduce(self, acc: List[torch.Tensor]) -> None:
        """The accumulated gradients summed over the ranks that hold a copy
        of each leaf: the dp x sp ranks for a whole leaf; the sp ranks for
        a dp-split one, whose gather's backward summed it over dp."""
        whole = [a for a, s in zip(acc, self.split) if "dp" not in s]
        split = [a for a, s in zip(acc, self.split) if "dp" in s]
        pmesh.all_reduce_(whole, group=self.mp.batch_group)
        pmesh.all_reduce_(split, group=self.mp.sp_group)

    @property
    def params(self) -> Dict:
        """This rank's parameters (its shards under tp and FSDP)."""
        return self.model.tree()

    def _gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each of this rank's tensors (one per parameter, in ``names``'
        order) made whole in the JAX layout: an all-reduce over the tp
        group, then the dp group, of zero-filled full tensors, each rank's
        shard in its place (every rank of the groups takes part)."""
        out = []
        for name, t, spec, split in zip(self.names, tensors, self.specs,
                                        self.split):
            shape = list(t.shape)
            for a, n, d in (("tp", self.tp, psh.tp_dim(spec)),
                            ("dp", self.dp, psh.dp_dim(spec))):
                if a in split:
                    shape[d] *= n
            out.append(psh.place_shard(
                t.detach(), shape, spec, self.tp, self.mp.tp_rank,
                name.split("/")[-1] in psh.FUSED_QKV, self.dp,
                self.mp.dp_rank))
        for a, group in (("tp", self.mp.tp_group), ("dp", self.mp.dp_group)):
            pmesh.all_reduce_([o for o, s in zip(out, self.split) if a in s],
                              group=group)
        return out

    def _shard(self, name: str, spec, value) -> torch.Tensor:
        """This rank's shard of a whole leaf read from a file."""
        return torch.as_tensor(psh.shard_leaf(
            np.asarray(value), spec, self.tp, self.mp.tp_rank,
            name.split("/")[-1] in psh.FUSED_QKV, self.dp, self.mp.dp_rank))

    def full_params(self) -> Dict:
        """The whole parameter tree in the JAX layout (a collective over
        the tp and dp groups under tp and FSDP)."""
        return _tree(self.names, self._gather(self.opt.params))

    # -- checkpointing ---------------------------------------------------
    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """Rank 0 writes (the whole tree, gathered); every rank returns
        once the files are there."""
        name = tag or self.tcfg.checkpoint_filename
        path = os.path.join(self.tcfg.out_dir, f"{name}.npz")
        params = self.full_params()
        state = self.opt.state_dict()
        specs = psh.opt_state_specs(state, self.specs)
        state.update({k: self._gather(v) for k, v in state.items()
                      if specs[k]})
        if pmesh.is_master():
            ckpt.save_params_npz(path, params,
                                 meta={"iter_num": self.iter_num,
                                       "model_args": self.mcfg.__dict__,
                                       "config": self.tcfg.__dict__})
            ckpt.save_opt_state(os.path.join(self.tcfg.out_dir,
                                             f"{name}.adamw.npz"),
                                self.names, state)
        pmesh.barrier()
        return path

    @torch.no_grad()
    def load_checkpoint(self, path: str) -> None:
        """Params and ``iter_num`` from ``path`` (written by either
        package, at any layout); the optimizer from the port's
        ``.adamw.npz`` beside it, or afresh where there is none.  Each rank
        keeps its shard."""
        saved = ckpt.flatten_pytree(ckpt.load_params_npz(path))
        if saved.keys() != set(self.names):
            raise ValueError(f"{path}: parameters {sorted(saved)} are not "
                             f"the model's {sorted(self.names)}")
        for name, spec, p in zip(self.names, self.specs, self.opt.params):
            p.copy_(self._shard(name, spec, saved[name]))
        self.iter_num = int(ckpt.load_meta(path).get("iter_num", 0))
        opt_path = path[:-len(".npz")] + ".adamw.npz"
        old = self.opt
        self.opt = AdamW(self.tcfg, old.params, old.decay)
        self.opt.reduce, self.opt.sharded, self.opt.norm_reduce = (
            old.reduce, old.sharded, old.norm_reduce)
        if os.path.exists(opt_path):
            state = ckpt.load_opt_state(opt_path, self.names)
            specs = psh.opt_state_specs(state, self.specs)
            for k in state:
                if specs[k]:
                    state[k] = [self._shard(n, s, v) for n, s, v in
                                zip(self.names, self.specs, state[k])]
            self.opt.load_state_dict(state)

    # -- steps -----------------------------------------------------------
    def rows(self, batch) -> Tuple:
        """This rank's block of a global batch's rows: its dp index's
        (all of it on one dp rank), every position of them (the sequence
        is cut in the model, ``models/decoder.py::seq_share``)."""
        if self.dp == 1:
            return tuple(batch)
        rows = dp_rows(np.asarray(batch[0]).shape[0], self.mp.dp_rank,
                       self.dp)
        return tuple(np.asarray(a)[rows] for a in batch)

    def loss(self, batch, train: bool) -> torch.Tensor:
        """The loss of one global batch (text, targets[, segments,
        positions]): with dropout when ``train``, without it otherwise.
        Data- or sequence-parallel, this rank's share of it: its rows'
        and positions' terms over the whole batch's valid counts, so the
        ranks' shares sum to the loss."""
        dev = [torch.as_tensor(np.asarray(a)).to(self.device)
               for a in self.rows(batch)]
        text_ids, targets = dev[:2]
        segments, positions = dev[2:] if len(dev) == 4 else (None, None)
        counts = None
        if self.dp > 1 or self.sp > 1:
            # this dp block's whole sequences: the sp ranks' shares of them
            # sum to these counts
            counts = dec.loss_counts(targets, self.mcfg, self._n_heads,
                                     segments)
            pmesh.all_reduce_([counts], group=self.mp.dp_group)
        emb = build_decoder_inputs(self.text_table, self.codebook, text_ids,
                                   targets, self.mcfg, pos_ids=positions)
        return self.model(emb.to(self.compute_dtype), targets,
                          generator=self.generator if train else None,
                          train=train, positions=positions,
                          segments=segments, counts=counts,
                          sp=self.mp.sp_group if self.sp > 1 else None,
                          sp_layout=self.tcfg.sp_layout)

    def _global(self, loss: torch.Tensor) -> float:
        """The whole batch's loss from this rank's share (summed over the
        dp x sp ranks; the ranks of a tp group hold the same share)."""
        loss = loss.detach().reshape(1).clone()
        pmesh.all_reduce_([loss], group=self.mp.batch_group)
        return float(loss[0])

    def step(self, text_ids: np.ndarray, targets: np.ndarray,
             segments: Optional[np.ndarray] = None,
             positions: Optional[np.ndarray] = None) -> float:
        """One micro-step on a global batch: forward, backward, and the
        optimizer's accumulation (an update on every k-th).  Returns the
        loss."""
        batch = ((text_ids, targets) if segments is None
                 else (text_ids, targets, segments, positions))
        loss = self.loss(batch, train=True)
        loss.backward()
        self.opt.step([p.grad for p in self.opt.params])
        for p in self.opt.params:
            p.grad = None
        self.iter_num += 1
        return self._global(loss)

    @torch.no_grad()
    def estimate_loss(self, batches: Iterator[Tuple[np.ndarray, ...]],
                      eval_iters: int) -> float:
        """Mean loss over ``eval_iters`` batches, without dropout."""
        return float(np.mean([self._global(self.loss(next(batches),
                                                     train=False))
                              for _ in range(eval_iters)]))

    # -- loop ------------------------------------------------------------
    def train(self, batches: Iterator[Tuple[np.ndarray, ...]],
              max_iters: Optional[int] = None, log=print,
              logger=None) -> None:
        """Train to ``max_iters`` micro-steps: every ``eval_interval`` an
        eval loss and a checkpoint, every ``log_interval`` the loss, the
        time and the MFU against the cards' peak (``logger``: a
        ``utils/logging.py::MetricsLogger``).  Data-parallel, the losses
        logged go through ``average_metrics`` and rank 0 logs."""
        lr_fn = lr_schedule(self.tcfg)
        tcfg = self.tcfg
        max_iters = max_iters or tcfg.max_iters
        t0 = time.time()
        last_log_iter = self.iter_num
        while self.iter_num < max_iters:
            master = pmesh.is_master()
            if (self.iter_num % tcfg.eval_interval == 0 and
                    self.iter_num > 0):
                val = pmesh.average_metrics({"val/loss": self.estimate_loss(
                    batches, tcfg.eval_iters)})["val/loss"]
                if master:
                    log(f"iter {self.iter_num}: eval loss {val:.4f}")
                    if logger is not None:
                        logger.log(self.iter_num, {"val/loss": float(val)})
                self.save_checkpoint()
                if tcfg.always_save_checkpoint:
                    self.save_checkpoint(
                        f"{tcfg.checkpoint_filename}_{self.iter_num}")
            batch = next(batches)          # (text, targets[, seg, pos])
            text_ids = batch[0]
            loss = self.step(*batch)
            if self.iter_num % tcfg.log_interval == 0:
                loss = pmesh.average_metrics({"loss": loss})["loss"]
                dt = time.time() - t0
                t0 = time.time()
                # dt spans every iteration since the last log
                n_iters = max(self.iter_num - last_log_iter, 1)
                last_log_iter = self.iter_num
                tokens = text_ids.shape[0] * text_ids.shape[1] * n_iters
                mfu = estimate_mfu(self.mcfg, self.n_params, tokens,
                                   max(dt, 1e-9),
                                   peak=H100_PEAK_FLOPS * pmesh.world(),
                                   seq_len=text_ids.shape[1])
                if not master:
                    continue
                log(f"iter {self.iter_num}: loss {loss:.4f}, "
                    f"time {dt * 1000:.1f}ms, mfu {mfu * 100:.2f}%")
                if logger is not None:
                    logger.log(self.iter_num, {
                        "train/loss": float(loss),
                        "lr": float(lr_fn(self.iter_num)), "mfu": mfu})

