"""Training data for the speech decoder.

Counterpart of ``llmvox_tpu/train/data.py``: a dataset of (text ids,
codec codes) pairs from a prepared ``.npz`` or a JSON manifest with a
``codes`` field per item; ``collate`` pads a batch to a bucketed length
(targets padded with ``ignore_index``); ``collate_packed`` packs several
sentences into each row with segment and position ids; the iterators
shuffle with numpy, seeded as the JAX package's, so the same seed yields
the same batches; ``build_decoder_inputs`` makes the fused input
embeddings from the integer ids on the device, as the JAX train step
does inside its program.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.utils.config import DecoderConfig


@dataclass
class Sample:
    text_ids: np.ndarray    # (n_text,) int32, per-word ByT5 + terminal 385
    codes: np.ndarray       # (n_codes,) int32, EOA-stripped codec codes


class SpeechDataset:
    """Manifest of (text, codes) pairs: a prepared ``.npz`` holding
    ``text_{i}`` / ``codes_{i}`` arrays, or the reference-style JSON with
    ``answer_text`` and a ``codes`` field per item (natural EOA codes
    stripped)."""

    def __init__(self, path: str, tokenizer: Optional[ByT5Tokenizer] = None):
        self.tokenizer = tokenizer or ByT5Tokenizer()
        self.samples: List[Sample] = []
        if path.endswith(".npz"):
            with np.load(path) as data:
                for i in range(int(data["num_samples"])):
                    self.samples.append(Sample(
                        text_ids=data[f"text_{i}"].astype(np.int32),
                        codes=data[f"codes_{i}"].astype(np.int32)))
        else:
            with open(path) as f:
                items = json.load(f)
            for item in items:
                text_ids = np.asarray(
                    self.tokenizer.encode_words(item["answer_text"]), np.int32)
                codes = np.asarray(item["codes"], np.int32)
                codes = codes[codes != 453]   # strip the natural EOA
                self.samples.append(Sample(text_ids, codes))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Sample:
        return self.samples[i]


def save_prepared(path: str, samples: Sequence[Sample]) -> None:
    arrays = {"num_samples": np.asarray(len(samples))}
    for i, s in enumerate(samples):
        arrays[f"text_{i}"] = s.text_ids
        arrays[f"codes_{i}"] = s.codes
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def collate(samples: Sequence[Sample], cfg: DecoderConfig, *,
            bucket: int = 256, max_len: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch -> (text_ids (B, T), targets (B, T)) int32.

    A sentence's length is its codes plus the terminal EOA; T is the
    longest, rounded up to a multiple of ``bucket`` and capped at
    ``max_len`` (default the block size).  Text is padded with PAD or
    cropped to T; targets are padded with ``ignore_index``."""
    max_len = max_len or cfg.block_size
    seq_lens = [min(len(s.codes) + 1, max_len) for s in samples]
    t = min(-(-max(seq_lens) // bucket) * bucket, max_len)
    b = len(samples)
    text = np.full((b, t), cfg.pad_token_id, np.int32)
    targets = np.full((b, t), cfg.ignore_index, np.int32)
    for i, s in enumerate(samples):
        n = seq_lens[i]
        targets[i, : n - 1] = s.codes[: n - 1]
        targets[i, n - 1] = cfg.eoa_token_id
        nt = min(len(s.text_ids), t)
        text[i, :nt] = s.text_ids[:nt]
    return text, targets


def collate_packed(samples: Sequence[Sample], cfg: DecoderConfig, *,
                   rows: int, seq_len: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, List[Sample]]:
    """Pack whole sentences into ``rows`` rows of ``seq_len`` (first fit,
    in arrival order).  Returns ``(text, targets, seg_ids, pos_ids,
    leftover)``: segment ids 1..n per sentence and 0 on padding, positions
    within each sentence, and the samples that did not fit.  A sentence
    longer than ``seq_len`` is cropped to it."""
    text = np.full((rows, seq_len), cfg.pad_token_id, np.int32)
    targets = np.full((rows, seq_len), cfg.ignore_index, np.int32)
    seg = np.zeros((rows, seq_len), np.int32)
    pos = np.zeros((rows, seq_len), np.int32)
    fill = [0] * rows
    nseg = [0] * rows
    leftover: List[Sample] = []
    for s in samples:
        n = min(len(s.codes) + 1, seq_len)
        row = next((r for r in range(rows) if fill[r] + n <= seq_len),
                   None)
        if row is None:
            leftover.append(s)
            continue
        o = fill[row]
        nseg[row] += 1
        targets[row, o: o + n - 1] = s.codes[: n - 1]
        targets[row, o + n - 1] = cfg.eoa_token_id
        nt = min(len(s.text_ids), n)
        text[row, o: o + nt] = s.text_ids[:nt]
        seg[row, o: o + n] = nseg[row]
        pos[row, o: o + n] = np.arange(n)
        fill[row] = o + n
    return text, targets, seg, pos, leftover


def build_decoder_inputs(text_table: torch.Tensor, codebook: torch.Tensor,
                         text_ids: torch.Tensor, targets: torch.Tensor,
                         cfg: DecoderConfig,
                         pos_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, T, C) inputs: position t's byte embedding joined to the codebook
    feature of the previous target code (zeros at t = 0, or wherever
    ``pos_ids`` is 0 in a packed batch; the EOA feature in the padding),
    L2-normalised, in f32."""
    input_codes = torch.where(targets == cfg.ignore_index, cfg.eoa_token_id,
                              targets)
    prev = torch.cat([torch.zeros_like(input_codes[:, :1]),
                      input_codes[:, :-1]], dim=1)
    feats = codebook[prev.long()]                              # (B, T, Ds)
    first = (torch.arange(targets.shape[1], device=targets.device)[None] == 0
             if pos_ids is None else pos_ids == 0)
    feats = torch.where(first[..., None], 0.0, feats)
    temb = text_table[text_ids.long()]                         # (B, T, Dt)
    return nn.l2_normalize(torch.cat([temb, feats], dim=-1).float())


class PackedBatchIterator:
    """Infinite shuffled packed batches (text, targets, seg_ids, pos_ids)
    at one (rows, seq_len) shape (see ``collate_packed``).  Samples that
    do not fit a batch carry over to the next.  The JAX iterators' shard
    options (one shard a host) wait for the multi-device trainer."""

    def __init__(self, dataset: SpeechDataset, cfg: DecoderConfig,
                 rows: int, seq_len: int, *, seed: int = 0):
        self.ds = dataset
        self.cfg = cfg
        self.rows = rows
        self.seq_len = seq_len
        # new samples offered a batch: enough to fill rows * seq_len at
        # the dataset's mean length
        mean = max(float(np.mean([len(s.codes) + 1
                                  for s in dataset.samples])), 1.0)
        self.spb = max(rows, int(rows * seq_len / mean) + rows)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]]:
        carry: List[Sample] = []
        while True:
            queue = [self.ds[j] for j in self.rng.permutation(len(self.ds))]
            while queue or carry:
                take = max(0, self.spb - len(carry))
                offer = carry + queue[:take]
                queue = queue[take:]
                if not queue and len(offer) < self.rows:
                    carry = offer       # tail too thin: next epoch tops up
                    break
                text, targets, seg, pos, carry = collate_packed(
                    offer, self.cfg, rows=self.rows, seq_len=self.seq_len)
                yield text, targets, seg, pos


class BatchIterator:
    """Infinite shuffled bucketed batches, reshuffled each epoch."""

    def __init__(self, dataset: SpeechDataset, cfg: DecoderConfig,
                 batch_size: int, *, bucket: int = 256, seed: int = 0):
        self.ds = dataset
        self.cfg = cfg
        self.bs = batch_size
        self.bucket = bucket
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            order = self.rng.permutation(len(self.ds))
            for i in range(0, len(order) - self.bs + 1, self.bs):
                batch = [self.ds[j] for j in order[i:i + self.bs]]
                yield collate(batch, self.cfg, bucket=self.bucket)
