"""Multi-stream batched TTS: N texts through one batched decode loop.

Counterpart of ``llmvox_tpu/serve/batch.py::BatchTTS``.  Every decode step
reads the decoder weights once for all streams, the KV caches are batched
(``models/decoder.py::decode_block_batch``, attention through kernel K2 on
the card), and the streams' codes are vocoded in one ragged batched codec
call (``WavCodec.decode_codes_ragged``).  The multi-device sharded decode
(``make_sharded_decode``) is not ported: a ``mesh`` argument raises.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.serve.engine import _to_device
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.utils.config import DecoderConfig, ServeConfig
from llmvox_tpu_torch.utils.device import Fetch, resolve_device
from llmvox_tpu_torch.utils.params import to_torch

MESH_NOT_PORTED = ("multi-device pooled and batched decode (a mesh; "
                   "make_sharded_decode) is not ported to llmvox_tpu_torch "
                   "yet: it is ROADMAP queue 1 item 10")


class BatchTTS:
    """Fixed-capacity batched decoder + codec for multi-stream synthesis."""

    def __init__(self, decoder_params: Dict, text_table: np.ndarray,
                 codec: WavCodec, max_streams: int = 8,
                 dcfg: Optional[DecoderConfig] = None,
                 scfg: Optional[ServeConfig] = None, *, device="cuda",
                 cache_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None,
                 block: Optional[int] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
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

    def new_states(self, batch: int) -> dec.DecodeState:
        return dec.init_decode_state_batch(self.dcfg, batch,
                                           self.cache_dtype, self.device)

    def decode_batch(self, states: dec.DecodeState, windows: np.ndarray,
                     text_lens: np.ndarray, limits: np.ndarray
                     ) -> Tuple[torch.Tensor, dec.DecodeState]:
        """Dispatch one ``block`` for every stream without a sync; returns
        the (B, block) device tokens and the chained states.  The inputs
        travel in one host-to-device copy."""
        windows = np.asarray(windows, np.int32)
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
        ids = [self.tokenizer.encode(t.strip()) + [self.dcfg.text_eos_id]
               for t in texts]
        text_lens = np.asarray([len(i) for i in ids], np.int32)
        buflen = int(text_lens.max()) + cap + 2 * self.block
        buf = np.full((b, buflen), self.dcfg.pad_token_id, np.int32)
        for i, seq in enumerate(ids):
            buf[i, : len(seq)] = seq

        states = self.new_states(b)
        tokens_out: List[List[int]] = [[] for _ in range(b)]
        issued = 0
        pending: deque = deque()
        eoa = self.dcfg.eoa_token_id
        while True:
            while issued < cap and len(pending) < max(1, pipeline_depth):
                windows = buf[:, issued: issued + self.block]
                limits = np.full((b,), min(self.block, cap - issued),
                                 np.int32)
                tok_dev, states = self.decode_batch(states, windows,
                                                    text_lens, limits)
                issued += self.block
                pending.append(Fetch(tok_dev))
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
        wavs = self.codec.decode_codes_ragged(codes, lengths)
        return [w if synth[i] else np.zeros(0, np.float32)
                for i, w in enumerate(wavs)]
