"""Codec-training data: audio files -> fixed-shape (B, num_samples) batches.

A copy of ``llmvox_tpu/train/codec_data.py`` (the port imports nothing of
the JAX package; numpy on the host, the same draws for a seed): per file
a random gain normalisation (the peak to a random dB in the train range,
``val_gain_db`` for validation), resampling to mono at the sample rate,
then repetition of short clips or a random crop of long ones.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from llmvox_tpu_torch.utils.audio import convert_audio, read_wav
from llmvox_tpu_torch.utils.config import CodecTrainConfig


def gain_normalize(wav: np.ndarray, gain_db: float) -> np.ndarray:
    """sox's ``norm``: scale so the peak sits at ``gain_db`` dBFS."""
    peak = np.max(np.abs(wav)) + 1e-9
    target = 10.0 ** (gain_db / 20.0)
    return (wav * (target / peak)).astype(np.float32)


def crop_or_repeat(wav: np.ndarray, num_samples: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Pad a short clip by repetition, crop a long one at random."""
    t = wav.shape[-1]
    if t < num_samples:
        reps = -(-num_samples // t)
        wav = np.tile(wav, reps)[:num_samples]
    elif t > num_samples:
        start = int(rng.integers(0, t - num_samples + 1))
        wav = wav[start:start + num_samples]
    return wav


class CodecDataset:
    def __init__(self, filelist_path: str, tcfg: CodecTrainConfig,
                 train: bool = True, seed: int = 0):
        with open(filelist_path) as f:
            self.files: List[str] = [l.strip() for l in f if l.strip()]
        self.tcfg = tcfg
        self.train = train
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> np.ndarray:
        wav, sr = read_wav(self.files[idx])
        if self.train:
            lo, hi = self.tcfg.train_gain_db_range
            gain = float(self.rng.uniform(lo, hi))
        else:
            gain = self.tcfg.val_gain_db
        wav = gain_normalize(wav, gain)
        wav = convert_audio(wav, sr, self.tcfg.sample_rate, 1)[0]
        return crop_or_repeat(wav, self.tcfg.num_samples, self.rng)

    def batches(self, batch_size: Optional[int] = None
                ) -> Iterator[np.ndarray]:
        """Endless batches, a new permutation of the files each pass."""
        bs = batch_size or self.tcfg.batch_size
        while True:
            order = self.rng.permutation(len(self.files))
            for i in range(0, len(order) - bs + 1, bs):
                yield np.stack([self.load(j) for j in order[i:i + bs]])
