"""Training metrics: an append-only JSONL file, W&B and TensorBoard when
installed.

Counterpart of ``llmvox_tpu/utils/logging.py``, with the same JSONL
records (``{"step", "time", **metrics}`` a line in
``<out_dir>/<run_name>.metrics.jsonl``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run",
                 use_wandb: bool = False, wandb_project: str = "llmvox_tpu",
                 use_tensorboard: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=wandb_project, name=run_name)
                self._wandb = wandb
            except ImportError:
                print("wandb not installed; JSONL logging only")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(out_dir, "tb", run_name))
            except ImportError:
                print("tensorboard not installed; JSONL logging only")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def log_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """Audio and its spectrogram image to W&B / TensorBoard (the JSONL
        file takes no media)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Audio(wav, sample_rate)},
                            step=step)
        if self._tb is not None:
            self._tb.add_audio(tag, wav[None], step, sample_rate)
            img = spectrogram_image(wav, sample_rate)
            self._tb.add_image(tag + "/mel", img[None], step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


def spectrogram_image(wav, sample_rate: int, n_fft: int = 1024,
                      hop: int = 256, n_mels: int = 100) -> np.ndarray:
    """Log-mel spectrogram as a normalised uint8 image, low frequencies at
    the bottom."""
    import torch
    from llmvox_tpu_torch.codec.mel import mel_spectrogram_features
    wav = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, -1))
    mel = mel_spectrogram_features(wav, n_fft=n_fft, hop_length=hop,
                                   n_mels=n_mels,
                                   sample_rate=sample_rate)[0].numpy()
    lo, hi = mel.min(), mel.max()
    norm = (mel - lo) / max(hi - lo, 1e-6)
    return (norm[::-1] * 255.0).astype(np.uint8)
