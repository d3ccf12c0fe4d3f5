"""Decoder-training CLI: ``python -m llmvox_tpu_torch.train --flags``.

The port's ``python -m llmvox_tpu.train``: every TrainConfig and
DecoderConfig field is a flag, and only the flags given override the
defaults.  ``--device`` (default ``cuda``; ``cpu`` runs the plain path)
picks the device; ``--dtype`` is the compute dtype (``bfloat16`` or
``float32``; parameters and moments stay f32).

Inputs (``python -m llmvox_tpu_torch.tools.convert_ckpt`` makes the first
two from reference checkpoints):
- ``--byt5_table``: the ByT5 embedding table .npz (key ``table``);
- ``--codec_params``: converted WavTokenizer params .npz (its
  ``codebooks`` give the speech features);
- ``--data_path``: a prepared dataset .npz (``train/data.py::
  save_prepared``) or a JSON manifest with precomputed codes.

    python -m llmvox_tpu_torch.train --data_path data.npz --out_dir out \\
        --max_iters 1000 [--pack --pack_len 8192] [--init_from resume]

Data-parallel over N cards, one rank a card (``--dp_size`` -1, the
default, takes the world; ``--batch_size`` is the global batch, which N
must divide):

    torchrun --nproc_per_node N -m llmvox_tpu_torch.train --data_path ...

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo
ranks on the CPU); rank 0 prints, logs and writes the checkpoints.

Tensor-parallel over groups of ``--tp_size`` cards (Megatron's split of
the decoder; the world is dp x tp, tp innermost, ``--batch_size``
divides over dp; the checkpoints are written whole, in the JAX layout):

    torchrun --nproc_per_node 4 -m llmvox_tpu_torch.train --tp_size 2 ...

Sequence-parallel over groups of ``--sp_size`` cards (each sequence
split over them, ring attention; ``--sp_layout zigzag`` balances the
causal work; T must divide by sp, or 2 x sp for zigzag; not with
``--pack``), and FSDP (``--fsdp true``: each rank keeps 1/dp of every matrix
and of its AdamW moments), composing with dp and tp (dp x sp x tp, tp
innermost):

    torchrun --nproc_per_node 8 -m llmvox_tpu_torch.train --sp_size 2 \
        --tp_size 2 --fsdp true ...
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.train.data import (BatchIterator, PackedBatchIterator,
                                         SpeechDataset)
from llmvox_tpu_torch.train.trainer import Trainer
from llmvox_tpu_torch.utils.config import (
    DecoderConfig, TrainConfig, add_dataclass_args, apply_cli_overrides)
from llmvox_tpu_torch.utils.params import load_params_npz

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="LLMVoX decoder training (PyTorch/CUDA)")
    add_dataclass_args(parser, TrainConfig)
    add_dataclass_args(parser, DecoderConfig)
    parser.add_argument("--byt5_table", type=str, default=None)
    parser.add_argument("--codec_params", type=str, default=None)
    parser.add_argument("--bucket", type=int, default=256)
    parser.add_argument("--pack", action="store_true",
                        help="pack several sentences into each row "
                             "(train/data.py::collate_packed): one "
                             "(batch_size, pack_len) shape")
    parser.add_argument("--pack_len", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    tcfg = apply_cli_overrides(TrainConfig(), args)
    mcfg = apply_cli_overrides(DecoderConfig(), args)
    if tcfg.dtype not in _DTYPES:
        parser.error(f"--dtype must be one of {sorted(_DTYPES)}")
    # torchrun's ranks form their group here; without torchrun, one rank
    device = pmesh.initialize_distributed(device=args.device)
    try:
        _train(args, tcfg, mcfg, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, tcfg: TrainConfig, mcfg: DecoderConfig, device) -> None:
    say = print if pmesh.is_master() else (lambda *a, **k: None)

    if args.byt5_table:
        table = np.load(args.byt5_table)["table"]
    else:
        say("WARNING: no --byt5_table; using random table (smoke mode)")
        table = 0.02 * np.random.default_rng(0).standard_normal(
            (mcfg.text_vocab_size, mcfg.text_embed_dim)).astype(np.float32)
    if args.codec_params:
        codebook = np.asarray(load_params_npz(args.codec_params)["codebooks"])[0]
    else:
        say("WARNING: no --codec_params; using random codebook (smoke mode)")
        codebook = np.random.default_rng(1).standard_normal(
            (max(mcfg.vocab_size, mcfg.eoa_token_id + 1),
             mcfg.speech_embed_dim)).astype(np.float32)

    kw = dict(compute_dtype=_DTYPES[tcfg.dtype], device=device)
    if tcfg.init_from.startswith("gpt2"):
        # HF gpt2* weights (downloads); forces the gpt2 architecture
        from llmvox_tpu_torch.models.gpt2_import import init_from_gpt2
        gpt2_params, mcfg = init_from_gpt2(tcfg.init_from, mcfg.vocab_size)
        trainer = Trainer(tcfg, mcfg, table, codebook, params=gpt2_params,
                          **kw)
        say(f"initialized from {tcfg.init_from}")
    else:
        trainer = Trainer(tcfg, mcfg, table, codebook, **kw)
    if tcfg.init_from == "resume":
        trainer.load_checkpoint(
            os.path.join(tcfg.out_dir, tcfg.checkpoint_filename + ".npz"))
        say(f"resumed at iter {trainer.iter_num}")

    dataset = SpeechDataset(tcfg.data_path)
    say(f"dataset: {len(dataset)} samples; model: "
        f"{trainer.n_params / 1e6:.2f}M params; device {trainer.device}"
        + (f", rank {trainer.rank} of {pmesh.world()} (dp {trainer.dp} x "
           f"tp {trainer.tp}"
           + (f", sp {trainer.sp} {tcfg.sp_layout}" if trainer.sp > 1
              else "")
           + (", fsdp" if trainer.fsdp else "") + ")"
           if pmesh.world() > 1 else ""))
    if args.pack:
        batches = iter(PackedBatchIterator(dataset, mcfg, tcfg.batch_size,
                                           args.pack_len, seed=tcfg.seed))
    else:
        batches = iter(BatchIterator(dataset, mcfg, tcfg.batch_size,
                                     bucket=args.bucket, seed=tcfg.seed))
    if tcfg.eval_only:
        say(f"eval loss: {trainer.estimate_loss(batches, tcfg.eval_iters):.4f}")
        return
    if not pmesh.is_master():
        trainer.train(batches, log=say)
        return
    from llmvox_tpu_torch.utils.logging import MetricsLogger
    logger = MetricsLogger(tcfg.out_dir, tcfg.wandb_run_name,
                           use_wandb=tcfg.wandb_log,
                           wandb_project=tcfg.wandb_project)
    try:
        trainer.train(batches, logger=logger)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
