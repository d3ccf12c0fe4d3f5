"""TTSEngine: one TTS replica — decoder decode loop + codec — on one device.

Counterpart of ``llmvox_tpu/serve/engine.py`` with the surface the
scheduler calls.  A decode block is enqueued on the device without a host
sync (``models/decoder.py::decode_block``), and its inputs travel in one
host-to-device copy from pinned memory.  Its result comes back in one
device-to-host copy into pinned memory, started when the block is issued
and waited for only by ``Pending*.fetch()``: the scheduler issues block
i+1 on the chained state before it fetches block i.  A block is hundreds
of eager launches, so the scheduler issues it through ``dispatch``, on the
device's dispatch thread, and the event loop stays free meanwhile.

Under ``spec_decode``, with draft heads in the params, every block but a
sentence's fused first one is speculative (``decode_block_spec``,
attention through kernel K3), as in JAX; it waits on the card for its
stop flags while it is issued, one iteration behind.

Serving casts decoder params and caches to bf16 (``compute_dtype``); the
codec stays f32, and the final argmax accumulates in f32.
"""
from __future__ import annotations

import asyncio
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.codec import codec as codec_mod
from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.utils.config import (CodecConfig, DecoderConfig,
                                           ServeConfig)
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.params import to_torch


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a sync (pinned, non-blocking)."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class PendingTokens:
    """Handle to an in-flight decode block (its tokens not yet fetched)."""

    __slots__ = ("_fetch",)

    def __init__(self, tokens: torch.Tensor):
        self._fetch = Fetch(tokens)

    def fetch(self) -> List[int]:
        return [int(t) for t in self._fetch.get() if t >= 0]

    async def afetch(self) -> List[int]:
        return await asyncio.to_thread(self.fetch)


class PendingFused:
    """In-flight fused (decode block + first-chunk synthesis) call: ONE
    packed float32 vector — waveform samples, then the block's tokens — so
    the result costs a single device-to-host copy."""

    __slots__ = ("_fetch", "n_wav")

    def __init__(self, packed: torch.Tensor, n_wav: int):
        self._fetch = Fetch(packed)
        self.n_wav = n_wav

    def fetch(self) -> Tuple[List[int], bytes]:
        arr = self._fetch.get()
        wav = arr[: self.n_wav]
        toks = np.rint(arr[self.n_wav:]).astype(np.int32)
        return ([int(t) for t in toks if t >= 0],
                np.asarray(wav, dtype="<f4").tobytes())

    async def afetch(self) -> Tuple[List[int], bytes]:
        return await asyncio.to_thread(self.fetch)


def _fused_first_block(params: Dict, codec_params: Dict,
                       text_table: torch.Tensor, codebook: torch.Tensor,
                       state: dec.DecodeState, window: torch.Tensor,
                       text_len: torch.Tensor, limit: torch.Tensor,
                       dcfg: DecoderConfig, ccfg: CodecConfig,
                       block: int, dump: int, bucket: int):
    """Decode one block AND synthesize its first ``dump`` tokens, all on
    the device; the codec part is the bucket decode ``WavCodec`` runs."""
    tokens, _, state = dec.decode_block(
        params, text_table, codebook, state, window, text_len, limit,
        dcfg, block=block)
    codes = tokens[:dump].clamp(0, dcfg.vocab_size - 1)[None]
    codes = F.pad(codes, (0, bucket - dump))
    wav = codec_mod._decode_codes(codec_params, codes, 0, dump, ccfg)
    wav = wav[0, : dump * ccfg.hop_length]
    # token ids (< 4096) and the -1 inactive mark are exact in float32
    packed = torch.cat([wav.float(), tokens.float()])
    return packed, state


class TTSEngine:
    """Decoder params + text table + codec, on one device."""

    def __init__(self, decoder_params: Dict, text_table: np.ndarray,
                 codec: WavCodec, dcfg: Optional[DecoderConfig] = None,
                 scfg: Optional[ServeConfig] = None, *, device="cuda",
                 cache_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        if codec.device != self.device:
            raise ValueError(f"codec lies on {codec.device}, engine on "
                             f"{self.device}")
        self.dcfg = dcfg or DecoderConfig()
        self.scfg = scfg or ServeConfig()
        self.codec = codec
        self.cache_dtype = cache_dtype
        self.block = self.scfg.decode_block
        self.params = to_torch(decoder_params, self.device,
                               param_dtype or cache_dtype)
        self.text_table = to_torch(text_table, self.device)
        # the decoder consumes the first codebook level (n_q=1 deployed)
        self.codebook = codec.params["codebooks"][0]
        # decode steps dispatched (each block counts its full length)
        self.decode_steps = 0
        # speculative decode engages, as in JAX, only when the checkpoint
        # carries draft heads; the fused first block stays greedy
        self._spec = bool(self.scfg.spec_decode
                          and "draft_heads" in self.params)
        if self._spec:
            dec.check_draft_heads(self.params, self.dcfg,
                                  self.scfg.spec_k_draft)

    # -- decode --------------------------------------------------------
    async def dispatch(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` (``decode_block_async`` or
        ``decode_block_fused_async``) on the device's dispatch thread,
        awaited: the launches run in submission order, off the event
        loop."""
        return await asyncio.get_running_loop().run_in_executor(
            dispatch_executor(self.device),
            functools.partial(fn, *args, **kwargs))

    def new_state(self) -> dec.DecodeState:
        return dec.init_decode_state(self.dcfg, dtype=self.cache_dtype,
                                     device=self.device)

    def _inputs(self, text_window, text_len: int, limit: int):
        packed = np.empty(len(text_window) + 2, np.int32)
        packed[0], packed[1] = text_len, limit
        packed[2:] = text_window
        t = _to_device(packed, self.device)
        return t[2:], t[0], t[1]

    def decode_block_async(self, state: dec.DecodeState,
                           text_window: np.ndarray, text_len: int,
                           limit: int, block: Optional[int] = None
                           ) -> Tuple[PendingTokens, dec.DecodeState]:
        """Dispatch one block; the state chains on the device.  ``block``
        overrides the block length.  A greedy block is issued without a
        sync; a speculative one (``decode_block_spec``) waits for its
        stop flags, one iteration behind what it issues."""
        block = block or self.block
        window, tlen, lim = self._inputs(text_window, text_len, limit)
        if self._spec:
            tokens, _, state, _ = dec.decode_block_spec(
                self.params, self.text_table, self.codebook, state, window,
                tlen, lim, self.dcfg, block=block,
                k_draft=self.scfg.spec_k_draft)
        else:
            tokens, _, state = dec.decode_block(
                self.params, self.text_table, self.codebook, state, window,
                tlen, lim, self.dcfg, block=block)
        self.decode_steps += block
        return PendingTokens(tokens), state

    def decode_block_fused_async(self, state: dec.DecodeState,
                                 text_window: np.ndarray, text_len: int,
                                 limit: int, dump: int,
                                 block: Optional[int] = None
                                 ) -> Tuple[PendingFused, dec.DecodeState]:
        """Dispatch decode + synthesis of the block's first ``dump`` tokens
        (one fetch for the sentence's first audio chunk)."""
        block = block or self.block
        bucket = self.codec.bucket_for(dump)
        window, tlen, lim = self._inputs(text_window, text_len, limit)
        packed, state = _fused_first_block(
            self.params, self.codec.params, self.text_table, self.codebook,
            state, window, tlen, lim, self.dcfg, self.codec.cfg, block,
            dump, bucket)
        self.decode_steps += block
        return PendingFused(packed, dump * self.codec.cfg.hop_length), state

    def decode_block(self, state: dec.DecodeState, text_window: np.ndarray,
                     text_len: int, limit: int
                     ) -> Tuple[List[int], dec.DecodeState]:
        """Generate up to ``limit`` (<= block) tokens; returns host tokens."""
        pending, state = self.decode_block_async(state, text_window,
                                                 text_len, limit)
        return pending.fetch(), state

    # -- synthesis -----------------------------------------------------
    def synthesize(self, codes: Sequence[int]) -> bytes:
        """Speech tokens -> raw float32 little-endian PCM bytes @24 kHz."""
        arr = np.asarray(codes, np.int32)[None]
        wav = self.codec.decode_codes(arr)[0]
        return np.asarray(wav, dtype="<f4").tobytes()

    def warmup(self) -> None:
        """Run every block length, the fused first chunk and every codec
        bucket once before serving (builds the kernel, warms the
        allocator and the library handles)."""
        blocks = {self.block, self.scfg.decode_block_large,
                  self.scfg.first_decode_block} - {0}
        for blk in sorted(blocks):
            window = np.full(blk, self.dcfg.pad_token_id, np.int32)
            p, _ = self.decode_block_async(self.new_state(), window, 1, 1,
                                           block=blk)
            p.fetch()
        if self.scfg.fused_first_chunk:
            d = self.scfg.initial_dump_size_1
            window = np.full(self.block, self.dcfg.pad_token_id, np.int32)
            p, _ = self.decode_block_fused_async(self.new_state(), window, 1,
                                                 self.block, d)
            p.fetch()
        self.codec.warmup()

    # -- offline TTS ---------------------------------------------------
    def tts(self, text: str, max_tokens: Optional[int] = None
            ) -> Tuple[np.ndarray, List[int]]:
        """Non-streaming text -> (waveform float32, speech tokens): byte
        tokens, the decode loop until EOA or the cap, one synthesis.  Block
        i+1 is dispatched before block i's tokens are fetched."""
        cap = max_tokens or self.scfg.max_audio_length
        ids = ByT5Tokenizer().encode(text.strip()) + [self.dcfg.text_eos_id]
        text_len = len(ids)
        buf = np.full(text_len + cap + 2 * self.block,
                      self.dcfg.pad_token_id, np.int32)
        buf[:text_len] = ids

        state = self.new_state()
        tokens: List[int] = []
        issued = 0
        pending = None
        while True:
            if issued < cap:
                limit = min(self.block, cap - issued)
                nxt, state = self.decode_block_async(
                    state, buf[issued:issued + self.block], text_len, limit)
                issued += self.block
            else:
                nxt = None
            if pending is not None:
                got = pending.fetch()
                tokens.extend(got)
                if (got and got[-1] == self.dcfg.eoa_token_id) or not got:
                    break
                if len(tokens) >= cap:
                    break
            if nxt is None and pending is None:
                break
            pending = nxt

        if tokens and tokens[-1] == self.dcfg.eoa_token_id:
            synth = tokens[:-1]
        else:
            synth = tokens[:cap]
        if not synth:
            return np.zeros(0, np.float32), tokens
        wav = self.codec.decode_codes(np.asarray(synth, np.int32)[None])[0]
        return wav, tokens
