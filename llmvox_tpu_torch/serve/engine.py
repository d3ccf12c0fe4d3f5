"""TTSEngine: one TTS replica — decoder decode loop + codec — on one device.

Counterpart of ``llmvox_tpu/serve/engine.py`` with the surface the
scheduler calls.  A decode block is enqueued on the device without a host
sync (``models/decoder.py::decode_block``), and its inputs travel in one
host-to-device copy from pinned memory.  Its result comes back in one
device-to-host copy into pinned memory, started when the block is issued
and waited for only by ``Pending*.fetch()``: the scheduler issues block
i+1 on the chained state before it fetches block i.  The scheduler issues
a block through ``dispatch``, on the device's dispatch thread, and the
event loop stays free meanwhile.

CUDA graphs (``utils/graphs.py``).  The engine holds ONE static
``DecodeState``; a block reads its inputs from a static buffer (reset
flag, text length, limit, window: the one host-to-device copy fills it)
and writes its tokens and the next state in place.  On a card
``warmup`` captures every body serving can reach, and a block is one
replay: a graph per block length (``first_decode_block``,
``decode_block``, ``decode_block_large``), per fused first-chunk
variant (block, dump) (``fused_variants``: the set JAX's ``warmup``
compiles, and the second replica's first dumps), per speculative start
and iteration of each block length under ``spec_decode``, and per codec
bucket.  Anything else raises.  ``new_state`` enqueues nothing: it
returns the marker ``FRESH``, and the block it is passed to resets the
state on the device, from its input copy.  An engine decodes one
sentence at a time (the scheduler gives each replica one request).
``graphs=False`` keeps the same buffers and runs each body eagerly (the
CPU always does).  Offline ``tts`` synthesizes its whole utterance
eagerly (``WavCodec.decode_codes_eager``): it may be longer than the
largest bucket.

Under ``spec_decode``, with draft heads in the params, every block but a
sentence's fused first one is speculative (``spec_start`` and
``spec_iteration`` of ``models/decoder.py``, attention through kernel
K3), as in JAX; it waits on the card for its stop flags while it is
issued, one iteration behind (``run_spec_loop``).

Serving casts decoder params and caches to bf16 (``compute_dtype``); the
codec stays f32, and the final argmax accumulates in f32.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.codec import codec as codec_mod
from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.models import spec
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.utils.config import (CodecConfig, DecoderConfig,
                                           ServeConfig)
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import GraphSet, fill, settle, use_graphs
from llmvox_tpu_torch.utils.params import to_torch


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a sync (pinned, non-blocking)."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class FreshState:
    """What ``TTSEngine.new_state`` returns: the block it is passed to
    resets the engine's state before it decodes."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "FRESH"


FRESH = FreshState()


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
    """Decoder params + text table + codec, on one device; ``graphs``
    (None: on for a card) serves through CUDA graphs captured by
    ``warmup``, ``graphs=False`` eagerly."""

    def __init__(self, decoder_params: Dict, text_table: np.ndarray,
                 codec: WavCodec, dcfg: Optional[DecoderConfig] = None,
                 scfg: Optional[ServeConfig] = None, *, device="cuda",
                 cache_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None,
                 graphs: Optional[bool] = None):
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
            spec.check_draft_heads(self.params, self.dcfg,
                                  self.scfg.spec_k_draft)
            self._heads = self.params["draft_heads"][
                :self.scfg.spec_k_draft].float()
        # the static state, and its (L, 1, S, C) batched view for the
        # speculative blocks
        self.state = dec.init_decode_state(self.dcfg, dtype=cache_dtype,
                                           device=self.device)
        st = self.state
        self._bstate = dec.DecodeState(
            st.k_cache.unsqueeze(1), st.v_cache.unsqueeze(1),
            st.pos.view(1), st.prev_token.view(1), st.done.view(1))
        self._inputs: Dict[int, torch.Tensor] = {}
        self._spec_bufs: Dict[int, dec.SpecBuffers] = {}
        use = use_graphs(self.device, graphs)
        self._blocks = GraphSet("decode block", self.device, use,
                                self._make_block)
        self._fused = GraphSet("fused first block", self.device, use,
                               self._make_fused)
        self._specs = GraphSet("speculative block", self.device, use,
                               self._make_spec)

    # -- static buffers and bodies --------------------------------------
    def _input(self, block: int) -> torch.Tensor:
        """The static inputs of a block length: reset flag, text length,
        limit, then the window."""
        if block not in self._inputs:
            self._inputs[block] = torch.zeros((3 + block,),
                                              dtype=torch.int32,
                                              device=self.device)
        return self._inputs[block]

    def _fill(self, inp: torch.Tensor, state, text_window, text_len: int,
              limit: int) -> None:
        """The block's inputs, with the reset flag set when ``state`` is
        ``FRESH``; otherwise it must be the state a block returned."""
        if state is not FRESH and state is not self.state:
            raise ValueError(
                "a block starts from new_state() (FRESH) or continues the "
                "state this engine's previous block returned")
        host = np.empty(len(text_window) + 3, np.int32)
        host[0], host[1], host[2] = state is FRESH, text_len, limit
        host[3:] = text_window
        fill(inp, host)

    def _apply_reset(self, inp: torch.Tensor) -> None:
        dec.assign_state(self.state,
                         dec.masked_reset(self.state, inp[0].bool()))

    def _make_block(self, block: int):
        inp = self._input(block)
        tokens = torch.full((block,), -1, dtype=torch.int32,
                            device=self.device)

        def body():
            self._apply_reset(inp)
            toks, _, new = dec.decode_block(
                self.params, self.text_table, self.codebook, self.state,
                inp[3:], inp[1], inp[2], self.dcfg, block=block)
            dec.assign_state(self.state, new)
            tokens.copy_(toks)
        return body, (inp, tokens)

    def _make_fused(self, key: Tuple[int, int]):
        block, dump = key
        inp = self._input(block)
        bucket = self.codec.bucket_for(dump)
        packed = torch.zeros((dump * self.codec.cfg.hop_length + block,),
                             dtype=torch.float32, device=self.device)

        def body():
            self._apply_reset(inp)
            out, new = _fused_first_block(
                self.params, self.codec.params, self.text_table,
                self.codebook, self.state, inp[3:], inp[1], inp[2],
                self.dcfg, self.codec.cfg, block, dump, bucket)
            dec.assign_state(self.state, new)
            packed.copy_(out)
        return body, (inp, packed)

    def _make_spec(self, key: Tuple[str, int]):
        """("start", block): the reset and ``spec_start``; ("iter",
        block): one ``spec_iteration``, over the block's buffers."""
        kind, block = key
        inp = self._input(block)
        if block not in self._spec_bufs:
            self._spec_bufs[block] = dec.spec_buffers(
                1, block, self.scfg.spec_k_draft, self.device)
        bufs = self._spec_bufs[block]
        if kind == "start":
            def body():
                self._apply_reset(inp)
                dec.spec_start(self._bstate, bufs, inp[3:].view(1, block),
                               inp[2:3], self.dcfg)
        else:
            def body():
                dec.spec_iteration(self.params, self.text_table,
                                   self.codebook, self._bstate, bufs,
                                   inp[1:2], self.dcfg, self._heads)
        return body, (inp, bufs)

    # -- decode --------------------------------------------------------
    async def dispatch(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` (``decode_block_async`` or
        ``decode_block_fused_async``) on the device's dispatch thread,
        awaited: the launches run in submission order, off the event
        loop (a job of owner ``replica.block``)."""
        return await asyncio.wrap_future(
            dispatch_executor(self.device).submit_as(
                "replica.block", None, fn, *args, **kwargs))

    def new_state(self) -> FreshState:
        """A fresh state for a new sentence: ``FRESH``, so the block it is
        passed to zeroes pos, prev_token and done on the device first
        (cache rows past pos are never read).  Nothing is enqueued here,
        on the caller's thread.  The reset rides with that block, not with
        the engine, so a block still queued on the dispatch thread from a
        cancelled request cannot take it."""
        return FRESH

    def decode_block_async(self, state, text_window: np.ndarray,
                           text_len: int, limit: int,
                           block: Optional[int] = None
                           ) -> Tuple[PendingTokens, dec.DecodeState]:
        """Dispatch one block on the engine's state (``state`` is
        ``new_state()``'s ``FRESH``, which resets the state first, or the
        value the previous block returned).  ``block``
        overrides the block length.  A greedy block is issued without a
        sync; a speculative one (``run_spec_loop``) waits for its stop
        flags, one iteration behind what it issues."""
        block = block or self.block
        if self._spec:
            start, it = (self._specs.get((k, block))
                         for k in ("start", "iter"))
            inp, bufs = start.out
            self._fill(inp, state, text_window, text_len, limit)
            spec.run_spec_loop(start, it, bufs.flag, block)
            tokens = bufs.out[0, :block]
        else:
            g = self._blocks.get(block)
            inp, tokens = g.out
            self._fill(inp, state, text_window, text_len, limit)
            g()
        self.decode_steps += block
        return PendingTokens(tokens), self.state

    def decode_block_fused_async(self, state, text_window: np.ndarray,
                                 text_len: int, limit: int, dump: int,
                                 block: Optional[int] = None
                                 ) -> Tuple[PendingFused, dec.DecodeState]:
        """Dispatch decode + synthesis of the block's first ``dump`` tokens
        (one fetch for the sentence's first audio chunk)."""
        block = block or self.block
        g = self._fused.get((block, dump))
        inp, packed = g.out
        self._fill(inp, state, text_window, text_len, limit)
        g()
        self.decode_steps += block
        return PendingFused(packed, dump * self.codec.cfg.hop_length), \
            self.state

    def decode_block(self, state, text_window: np.ndarray,
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

    def block_lengths(self) -> List[int]:
        """Every block length the scheduler can issue: ``decode_block``,
        ``decode_block_large`` when larger, ``first_decode_block`` when
        smaller."""
        s = self.scfg
        out = {self.block}
        if s.decode_block_large > self.block:
            out.add(s.decode_block_large)
        if 0 < s.first_decode_block < self.block:
            out.add(s.first_decode_block)
        return sorted(out)

    def fused_variants(self) -> List[Tuple[int, int]]:
        """Every fused (block, dump) the scheduler can pick: the dumps of
        a replica's ladder that fit one block, at both first-block
        lengths, except those the short first block takes.  For the
        ``initial_dump_size_1`` ladder these are the variants JAX's
        ``TTSEngine.warmup`` compiles, in its order; the
        ``initial_dump_size_2`` ladder (the second replica's) follows,
        which JAX leaves to compile on first use and a graph cannot
        (with the deployed sizes, 160 > 32, it adds none)."""
        s = self.scfg
        if not s.fused_first_chunk:
            return []
        first = s.first_decode_block if s.first_decode_block < self.block \
            else 0
        out = []
        for d0 in (s.initial_dump_size_1, s.initial_dump_size_2):
            for blk in sorted({self.block} | ({first} if first else set())):
                d = d0
                while d <= blk:
                    if (not (first and blk != first and d <= first)
                            and (blk, d) not in out):
                        out.append((blk, d))
                    d *= s.dump_growth_factor
        return out

    def warmup(self) -> None:
        """Capture every body serving can reach before the first request
        (on a card a CUDA graph each, after an eager pass that builds the
        kernels and the libraries' plans; without graphs one eager pass
        each): the block lengths (greedy, or under ``spec_decode`` the
        speculative start and iteration), the fused variants and the
        codec's buckets; then ``settle``."""
        for blk in self.block_lengths():
            if self._spec:
                self._specs.capture(("start", blk))
                self._specs.capture(("iter", blk))
            else:
                self._blocks.capture(blk)
        for key in self.fused_variants():
            self._fused.capture(key)
        self.codec.warmup()
        settle()

    # -- offline TTS ---------------------------------------------------
    def tts(self, text: str, max_tokens: Optional[int] = None
            ) -> Tuple[np.ndarray, List[int]]:
        """Non-streaming text -> (waveform float32, speech tokens): byte
        tokens, the decode loop until EOA or the cap, one synthesis.  Block
        i+1 is dispatched before block i's tokens are fetched.  The
        synthesis runs eagerly, at any length: the captured buckets serve
        the streamed chunks."""
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
        wav = self.codec.decode_codes_eager(
            np.asarray(synth, np.int32)[None])[0]
        return wav, tokens
