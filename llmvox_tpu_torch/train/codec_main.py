"""Codec GAN-training CLI: ``python -m llmvox_tpu_torch.train.codec_main``.

The port's ``python -m llmvox_tpu.train.codec_main``: every
CodecTrainConfig and CodecConfig field is a flag, and only the flags given
override the defaults; ``--device`` (default ``cuda``; ``cpu`` runs the
plain path) picks the device.  Every ``val_interval`` steps it logs the
validation mel loss and a reconstruction (with ``--filelist_val``),
writes the checkpoint and the inference export
(``<out_dir>/codec_inference.npz``, which ``WavCodec.from_pretrained`` of
either package reads); at the end, the checkpoint.

    python -m llmvox_tpu_torch.train.codec_main --filelist_train files.txt \\
        --out_dir out --max_steps 1000

Data-parallel over N cards (``--dp_size`` -1, the default, takes the
world; ``--batch_size`` is the global batch, which N must divide):

    torchrun --nproc_per_node N -m llmvox_tpu_torch.train.codec_main ...

Every rank reads the same seeded batches and keeps its rows; rank 0
prints, logs, validates and writes.
"""
from __future__ import annotations

import argparse
import os
import time

import torch.distributed as dist

from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.train.checkpoint import save_params_npz
from llmvox_tpu_torch.train.codec_data import CodecDataset
from llmvox_tpu_torch.train.codec_trainer import CodecTrainer
from llmvox_tpu_torch.utils.config import (
    CodecConfig, CodecTrainConfig, add_dataclass_args, apply_cli_overrides)
from llmvox_tpu_torch.utils.logging import MetricsLogger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="LLMVoX codec GAN training (PyTorch/CUDA)")
    add_dataclass_args(parser, CodecTrainConfig)
    add_dataclass_args(parser, CodecConfig)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    tcfg = apply_cli_overrides(CodecTrainConfig(), args)
    cfg = apply_cli_overrides(CodecConfig(), args)
    # torchrun's ranks form their group here; without torchrun, one rank
    device = pmesh.initialize_distributed(device=args.device)
    try:
        _train(cfg, tcfg, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg: CodecConfig, tcfg: CodecTrainConfig, device) -> None:
    master = pmesh.is_master()
    trainer = CodecTrainer(cfg, tcfg, device=device)
    logger = (MetricsLogger(tcfg.out_dir, "codec", use_wandb=tcfg.use_wandb,
                            use_tensorboard=tcfg.use_tensorboard)
              if master else None)
    train_ds = CodecDataset(tcfg.filelist_train, tcfg, train=True,
                            seed=tcfg.seed)
    val_ds = (CodecDataset(tcfg.filelist_val, tcfg, train=False)
              if tcfg.filelist_val and master else None)
    if master:
        print(f"train files: {len(train_ds)}"
              + (f"; {trainer.dp} ranks" if trainer.dp > 1 else ""))

    t0 = time.time()
    for audio in train_ds.batches():
        logs = trainer.step(audio)
        if not master:
            if trainer.iter_num % tcfg.val_interval == 0:
                trainer.save_checkpoint()
            if trainer.iter_num >= tcfg.max_steps:
                break
            continue
        logger.log(trainer.iter_num, logs)
        if trainer.iter_num % tcfg.log_interval == 0:
            dt = time.time() - t0
            t0 = time.time()
            print(f"step {trainer.iter_num}: "
                  f"gen {logs['gen_total']:.3f} disc {logs['disc_total']:.3f} "
                  f"mel {logs['mel']:.3f} commit {logs['commit']:.4f} "
                  f"({dt:.1f}s/{tcfg.log_interval} steps)")
        if trainer.iter_num % tcfg.val_interval == 0:
            if val_ds is not None:
                val_audio = next(val_ds.batches(tcfg.val_batch_size))
                vm = trainer.validation_metrics(val_audio)
                logger.log(trainer.iter_num, vm)
                logger.log_audio(trainer.iter_num, "val/recon",
                                 trainer.reconstruct(val_audio[:1]),
                                 cfg.sample_rate)
                print(f"step {trainer.iter_num}: {vm}")
            trainer.save_checkpoint()
            save_params_npz(os.path.join(tcfg.out_dir, "codec_inference.npz"),
                            trainer.export_inference_params())
        if trainer.iter_num >= tcfg.max_steps:
            break
    trainer.save_checkpoint()
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
