"""Multi-stream batched TTS: N texts through one batched decode loop.

Counterpart of ``llmvox_tpu/serve/batch.py::BatchTTS``.  Every decode step
reads the decoder weights once for all streams, the KV caches are batched
(``models/decoder.py::decode_block_batch``, attention through kernel K2 on
the card), and the streams' codes are vocoded in one ragged batched codec
call (``WavCodec.decode_codes_device``).  This offline path runs
eagerly; serving goes through CUDA graphs (``utils/graphs.py``).

With a ``mesh`` (``parallel/mesh.py``) the streams shard over its dp
axis (``make_sharded_decode``): shard i decodes its contiguous block of
rows on the i-th device, from its own copy of the params and the text
table, and its block is launched on that device's dispatch thread; no
collective is needed, streams being independent (JAX's ``shard_map``
over the same layout).  The vocode runs on the codec's device.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.parallel.mesh import DP_AXIS, Mesh
from llmvox_tpu_torch.serve.engine import _to_device
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.utils.config import DecoderConfig, ServeConfig
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import launch_scope
from llmvox_tpu_torch.utils.params import to_torch


def dp_devices(mesh: Mesh) -> List[torch.device]:
    """The devices along the mesh's dp axis (the other axes' first), one
    per shard of the streams; every other axis must be 1."""
    if any(n != 1 for a, n in mesh.shape.items() if a != DP_AXIS):
        raise ValueError(f"a dp mesh only: {mesh.shape}")
    return list(mesh.devices.reshape(-1))


def shard_tag(i: int, device: torch.device) -> str:
    """The name shard i's launches are counted under
    (``graphs.launch_scope``)."""
    return f"shard {i} {device}"


class ShardFetch:
    """The shards' device tokens, fetched and stacked in shard order."""
    __slots__ = ("parts",)

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = [Fetch(t) for t in parts]

    def get(self) -> np.ndarray:
        return np.concatenate([f.get() for f in self.parts])


class ShardedDecode:
    """``decode_block_batch`` with the streams sharded over the mesh's dp
    axis (``make_sharded_decode``): weights replicated, each shard's
    caches, positions and tokens on its device.  A call takes the global
    (B, ...) host inputs, launches each shard's block on its device's
    dispatch thread without a sync, and returns the shards' device tokens
    and states."""

    def __init__(self, cfg: DecoderConfig, block: int, mesh: Mesh,
                 params: Dict, text_table, codebook: torch.Tensor,
                 param_dtype: Optional[torch.dtype] = None):
        self.cfg, self.block = cfg, block
        self.devices = dp_devices(mesh)
        self.dp = len(self.devices)
        self.params = [to_torch(params, d, param_dtype)
                       for d in self.devices]
        self.text_tables = [to_torch(text_table, d) for d in self.devices]
        self.codebooks = [codebook.to(d) for d in self.devices]

    def new_states(self, batch: int, cache_dtype) -> List[dec.DecodeState]:
        if batch % self.dp:
            raise ValueError(f"{batch} streams not divisible over "
                             f"{self.dp}-way dp mesh")
        return [dec.init_decode_state_batch(self.cfg, batch // self.dp,
                                            cache_dtype, d)
                for d in self.devices]

    def _shard(self, i, state, packed: np.ndarray, b: int):
        dev = self.devices[i]
        with launch_scope(shard_tag(i, dev)):
            t = _to_device(packed, dev)
            n = packed.size - 2 * b
            tokens, _, state = dec.decode_block_batch(
                self.params[i], self.text_tables[i], self.codebooks[i],
                state, t[:n].view(b, -1), t[n:n + b], t[n + b:], self.cfg,
                block=self.block)
        return tokens, state

    def __call__(self, states: List[dec.DecodeState], windows: np.ndarray,
                 text_lens: np.ndarray, limits: np.ndarray
                 ) -> Tuple[List[torch.Tensor], List[dec.DecodeState]]:
        b = windows.shape[0] // self.dp
        futs = []
        for i, dev in enumerate(self.devices):
            rows = slice(i * b, (i + 1) * b)
            packed = np.concatenate([windows[rows].ravel(),
                                     text_lens[rows], limits[rows]])
            futs.append(dispatch_executor(dev).submit(
                self._shard, i, states[i], packed, b))
        out = [f.result() for f in futs]
        return [t for t, _ in out], [s for _, s in out]


def make_sharded_decode(cfg: DecoderConfig, block: int, mesh: Mesh,
                        params: Dict, text_table, codebook: torch.Tensor,
                        param_dtype: Optional[torch.dtype] = None
                        ) -> ShardedDecode:
    """Multi-device batched decode: streams shard over the mesh's dp axis
    (``llmvox_tpu/serve/batch.py::make_sharded_decode``)."""
    return ShardedDecode(cfg, block, mesh, params, text_table, codebook,
                         param_dtype)


class BatchTTS:
    """Fixed-capacity batched decoder + codec for multi-stream synthesis."""

    def __init__(self, decoder_params: Dict, text_table: np.ndarray,
                 codec: WavCodec, max_streams: int = 8,
                 dcfg: Optional[DecoderConfig] = None,
                 scfg: Optional[ServeConfig] = None, *, device="cuda",
                 cache_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None,
                 block: Optional[int] = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        if codec.device != self.device:
            raise ValueError(f"codec lies on {codec.device}, batch on "
                             f"{self.device}")
        self.dcfg = dcfg or DecoderConfig()
        self.scfg = scfg or ServeConfig()
        self.codec = codec
        self.B = max_streams
        self.block = block if block is not None else self.scfg.decode_block
        self.cache_dtype = cache_dtype
        self.params = to_torch(decoder_params, self.device,
                               param_dtype or cache_dtype)
        self.text_table = to_torch(text_table, self.device)
        self.codebook = codec.params["codebooks"][0]
        self.tokenizer = ByT5Tokenizer()
        # decode steps dispatched (each block counts its full length)
        self.decode_steps = 0
        self.mesh = mesh
        self._sharded = None
        if mesh is not None:
            self._sharded = make_sharded_decode(
                self.dcfg, self.block, mesh, decoder_params, text_table,
                self.codebook, param_dtype or cache_dtype)
            if self.B % self._sharded.dp:
                raise ValueError(f"{self.B} streams not divisible over "
                                 f"{self._sharded.dp}-way dp mesh")

    def _rows(self, batch: int) -> int:
        """Rows decoded for ``batch`` streams: rounded up to a multiple of
        the mesh's dp (the extra rows decode nothing)."""
        dp = self._sharded.dp if self._sharded is not None else 1
        return -(-batch // dp) * dp

    def new_states(self, batch: int):
        """A batched state (a list of the shards' under a mesh)."""
        if self._sharded is not None:
            return self._sharded.new_states(batch, self.cache_dtype)
        return dec.init_decode_state_batch(self.dcfg, batch,
                                           self.cache_dtype, self.device)

    def decode_batch(self, states: dec.DecodeState, windows: np.ndarray,
                     text_lens: np.ndarray, limits: np.ndarray
                     ) -> Tuple[torch.Tensor, dec.DecodeState]:
        """Dispatch one ``block`` for every stream without a sync; returns
        the (B, block) device tokens and the chained states.  The inputs
        travel in one host-to-device copy (one a shard under a mesh,
        whose tokens and states are the shards' lists)."""
        windows = np.asarray(windows, np.int32)
        if self._sharded is not None:
            tokens, states = self._sharded(
                states, windows, np.asarray(text_lens, np.int32),
                np.asarray(limits, np.int32))
            self.decode_steps += self.block
            return tokens, states
        b = windows.shape[0]
        packed = np.concatenate([windows.ravel(),
                                 np.asarray(text_lens, np.int32),
                                 np.asarray(limits, np.int32)])
        t = _to_device(packed, self.device)
        n = windows.size
        tokens, _, states = dec.decode_block_batch(
            self.params, self.text_table, self.codebook, states,
            t[:n].view(b, -1), t[n:n + b], t[n + b:], self.dcfg,
            block=self.block)
        self.decode_steps += self.block
        return tokens, states

    def decode_texts(self, texts: List[str],
                     max_tokens: Optional[int] = None,
                     pipeline_depth: int = 4) -> List[List[int]]:
        """Greedy speech tokens for up to ``max_streams`` texts, each until
        EOA (kept) or the cap, as ``TTSEngine.tts`` decodes one.

        ``pipeline_depth`` blocks are kept in flight before each fetch:
        blocks chain their state on the device, so dispatch never waits on
        a result.  The cost is up to ``depth - 1`` blocks decoded after
        every stream has emitted EOA."""
        assert len(texts) <= self.B
        cap = max_tokens or self.scfg.max_audio_length
        b = len(texts)
        rows = self._rows(b)
        ids = [self.tokenizer.encode(t.strip()) + [self.dcfg.text_eos_id]
               for t in texts]
        text_lens = np.ones((rows,), np.int32)
        text_lens[:b] = [len(i) for i in ids]
        buflen = int(text_lens.max()) + cap + 2 * self.block
        buf = np.full((rows, buflen), self.dcfg.pad_token_id, np.int32)
        for i, seq in enumerate(ids):
            buf[i, : len(seq)] = seq
        live = (np.arange(rows) < b).astype(np.int32)

        states = self.new_states(rows)
        tokens_out: List[List[int]] = [[] for _ in range(b)]
        issued = 0
        pending: deque = deque()
        eoa = self.dcfg.eoa_token_id
        while True:
            while issued < cap and len(pending) < max(1, pipeline_depth):
                windows = buf[:, issued: issued + self.block]
                limits = live * min(self.block, cap - issued)
                tok_dev, states = self.decode_batch(states, windows,
                                                    text_lens, limits)
                issued += self.block
                pending.append(ShardFetch(tok_dev) if isinstance(
                    tok_dev, list) else Fetch(tok_dev))
            if not pending:
                break
            toks = pending.popleft().get()
            done_all = True
            for i in range(b):
                row = [int(t) for t in toks[i] if t >= 0]
                if row and (not tokens_out[i] or tokens_out[i][-1] != eoa):
                    tokens_out[i].extend(row)
                if not (tokens_out[i] and tokens_out[i][-1] == eoa):
                    done_all = False
            if done_all:
                break
        return tokens_out

    def tts_batch(self, texts: List[str],
                  max_tokens: Optional[int] = None,
                  pipeline_depth: int = 4) -> List[np.ndarray]:
        """Synthesize up to ``max_streams`` texts concurrently: per stream
        the semantics of ``TTSEngine.tts`` (byte tokens + 385, greedy
        decode until EOA or the cap), then one ragged batched codec decode
        for all streams."""
        cap = max_tokens or self.scfg.max_audio_length
        eoa = self.dcfg.eoa_token_id
        synth = []
        for seq in self.decode_texts(texts, max_tokens, pipeline_depth):
            if seq and seq[-1] == eoa:
                seq = seq[:-1]
            synth.append(seq[:cap])
        lengths = np.asarray([max(len(s), 1) for s in synth], np.int32)
        codes = np.zeros((len(synth), int(lengths.max())), np.int32)
        for i, seq in enumerate(synth):
            codes[i, : len(seq)] = seq
        # the offline batch path runs eagerly (it is not captured): the
        # codec's ragged decode on the device, outside its graphs
        wav = self.codec.decode_codes_device(
            _to_device(self.codec.pad_ragged(codes, lengths), self.device),
            _to_device(lengths, self.device)).cpu().numpy()
        hop = self.codec.cfg.hop_length
        return [wav[i, : int(lengths[i]) * hop] if synth[i]
                else np.zeros(0, np.float32) for i in range(len(synth))]
