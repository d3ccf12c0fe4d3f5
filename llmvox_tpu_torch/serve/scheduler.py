"""The multi-queue dual-replica streaming scheduler.

The port's own copy of ``llmvox_tpu/serve/scheduler.py`` (that one
imports the JAX engine), driving ``llmvox_tpu_torch`` engines: the
dedicated dual replicas (``serve/engine.py``) or two slots of the
continuous-batching pool (``serve/pool.py::PooledEngine``), which set the
hooks ``fixed_block``, ``issue_ahead`` and ``synthesize_async``.
Behavior-compatible rebuild of the reference's producer / 2-consumer /
async-mux state machine (streaming_server.py:184-469), re-cut as asyncio
tasks instead of daemon threads:

- the **producer** routes cleaned LLM text deltas into two text queues,
  flipping the active queue whenever a delta ends with '.' (sentence
  boundary) and flagging generation end on the LLM eos token;
- each **consumer** drives one TTS replica: it consumes deltas, appends
  the text-EOS (385) at sentence end, then feeds PAD embeddings; speech
  tokens accumulate until ``dump_size`` (x3 growth, capped) and each chunk
  is codec-synthesized to float32 bytes; EOA (453) or the
  ``max_audio_length`` cap terminates the sentence, emits a control signal
  (``"end"`` if the LLM finished, else the index of the other replica) and
  resets all per-sentence state including the KV cache — the
  "infinite-length dialogue" mechanism;
- the **mux** interleaves the two audio queues into one byte stream,
  switching on 0/1 control signals and finishing on "end".

Fixes over the reference (SURVEY §2.7 known defects): consumers terminate
and queues are garbage-collected per request (the reference leaks both,
streaming_server.py:287,425), and a producer or consumer that raises
fails the request instead of leaving the mux waiting (``_next``); the
unreachable ``active_model`` flag is
gone; eos stripping removes the token substring instead of ``rstrip``'s
character-set behavior (which eats trailing letters, e.g.
"Hide<|eot_id|>".rstrip(eos) -> "H"); a text stream that ends without an
eos token still terminates the request; the EOA control token is
stripped before vocoding (the reference decodes 453 as an audio code in
each sentence's final chunk, streaming_server.py:378-391 — caught by
tests/test_e2e_quality.py's trained-weights loop).
"""
from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Deque, List, Optional

import numpy as np

from llmvox_tpu_torch.serve.engine import TTSEngine
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.text.cleaning import clean_text
from llmvox_tpu_torch.utils.config import ServeConfig
from llmvox_tpu_torch.utils.trace import Trace

# Control-signal protocol on the audio queues (streaming_server.py:397-404):
# bytes = audio chunk; int 0/1 = switch mux to that replica; "end" = finish.
END = "end"
_STREAM_CLOSED = object()  # producer sentinel: LLM stream exhausted


@dataclass
class _SentenceState:
    """Per-sentence consumer state, reset at every boundary
    (streaming_server.py:406-417)."""
    text_ids: List[int] = field(default_factory=list)
    sentence_done: bool = False
    end_generation: bool = False
    buffer: List[int] = field(default_factory=list)
    n_generated: int = 0
    fused_audio: object = None   # pre-synthesized first chunk (bytes)
    fused_dump: int = 0          # dump size the fused chunk was built for
    first_dump_done: bool = False


class StreamingScheduler:
    """One instance per server; ``run()`` serves one request."""

    def __init__(self, engines: List[TTSEngine],
                 cfg: Optional[ServeConfig] = None):
        assert len(engines) == 2, "dual-replica scheduler needs 2 engines"
        self.engines = engines
        self.cfg = cfg or ServeConfig()
        self.tokenizer = ByT5Tokenizer()

    # ------------------------------------------------------------------
    async def run(self, text_stream: AsyncIterator[str],
                  trace: Optional[Trace] = None) -> AsyncIterator[bytes]:
        """text deltas in -> 24 kHz float32 PCM chunks out."""
        trace = trace or Trace("request")
        text_qs = [asyncio.Queue(), asyncio.Queue()]
        audio_qs = [asyncio.Queue(), asyncio.Queue()]

        tasks = [
            asyncio.create_task(self._producer(text_stream, text_qs)),
            asyncio.create_task(self._consumer(
                0, self.engines[0], text_qs[0], audio_qs[0],
                self.cfg.initial_dump_size_1, trace)),
            asyncio.create_task(self._consumer(
                1, self.engines[1], text_qs[1], audio_qs[1],
                self.cfg.initial_dump_size_2, trace)),
        ]
        try:
            current = 0
            while True:
                item = await self._next(audio_qs[current], tasks)
                if isinstance(item, bytes):
                    if trace.first("first_audio") is None:
                        trace.mark("first_audio")
                    yield item
                elif item == END:
                    trace.mark("end")
                    return
                elif item in (0, 1):
                    current = item
                elif item is None:
                    return
        finally:
            for t in tasks:
                t.cancel()
            for t in tasks:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass

    @staticmethod
    async def _next(queue: asyncio.Queue, tasks):
        """The queue's next item; raises what a producer or consumer task
        raised meanwhile (a decode that fails, e.g. on a shape no CUDA
        graph was captured for, ends the request instead of leaving the
        mux waiting)."""
        getter = asyncio.ensure_future(queue.get())
        try:
            while True:
                live = [t for t in tasks if not t.done()]
                done, _ = await asyncio.wait(
                    [getter, *live], return_when=asyncio.FIRST_COMPLETED)
                if getter in done:
                    return getter.result()
                for t in done:
                    if not t.cancelled() and t.exception() is not None:
                        raise t.exception()
        finally:
            getter.cancel()

    # ------------------------------------------------------------------
    async def _producer(self, text_stream: AsyncIterator[str],
                        text_qs: List[asyncio.Queue]) -> None:
        """Route deltas, ping-ponging at sentence ends
        (streaming_server.py:184-248)."""
        eos = self.cfg.eos_token
        active = 0
        async for output in text_stream:
            if output in ("", "-"):
                continue
            output = output.strip()
            if output != eos:
                output = clean_text(output, eos)
            if not output:
                continue
            await text_qs[active].put(output)
            if output.endswith("."):
                active = 1 - active
        # Robustness fix over the reference: close BOTH queues when the LLM
        # stream ends.  This covers (a) streams that end without an eos
        # token (the reference hangs) and (b) a mid-sentence length-cap
        # termination that switches the mux to a replica which never
        # receives text (the reference deadlocks) — the starved replica
        # sees the close marker and emits its own "end".
        for q in text_qs:
            await q.put(_STREAM_CLOSED)

    # ------------------------------------------------------------------
    async def _consumer(self, index: int, engine: TTSEngine,
                        text_q: asyncio.Queue, audio_q: asyncio.Queue,
                        dump_size: int, trace: Trace) -> None:
        """Drive one replica (streaming_server.py:250-426).

        Two latency mechanisms on top of the reference semantics:
        - decode blocks are double-buffered: block i+1 is dispatched on the
          chained device state before block i's tokens are fetched, hiding
          the host<->device round trip;
        - synthesis runs on an ordered worker task fed through a queue, so
          decode never stalls on a chunk being vocoded; control signals
          flow through the same queue to preserve stream order.
        """
        cfg = self.cfg
        eos = cfg.eos_token
        dcfg = engine.dcfg
        block = engine.block
        # pooled engines decode at the pool's fixed block: no block growth
        # and no small first block
        fixed = getattr(engine, "fixed_block", False)
        big_block = 0 if fixed else (cfg.decode_block_large or 0)
        first_block = 0 if fixed else (cfg.first_decode_block or 0)
        if first_block >= block:
            first_block = 0  # only ever SHRINK the first device call
        can_fuse = (cfg.fused_first_chunk
                    and hasattr(engine, "decode_block_fused_async"))
        # dedicated engines launch their blocks on their own dispatch
        # thread (the loop awaits it); a pooled engine's calls only queue
        # work for the pool, on the loop
        dispatch = getattr(engine, "dispatch", None)

        st = _SentenceState()
        dec_state = engine.new_state()

        # ---- ordered synthesis worker --------------------------------
        synth_q: asyncio.Queue = asyncio.Queue()
        synth_async = getattr(engine, "synthesize_async", None)

        async def synth_worker():
            while True:
                item = await synth_q.get()
                if isinstance(item, list):
                    with trace.span(f"synth_r{index}"):
                        if synth_async is not None:
                            # pooled engines batch concurrent requests'
                            # chunks into one codec call
                            chunk = await synth_async(item)
                        else:
                            chunk = await asyncio.to_thread(
                                engine.synthesize, item)
                    await audio_q.put(chunk)
                else:
                    await audio_q.put(item)
                    if item == END:
                        return

        worker = asyncio.create_task(synth_worker())

        def grow_dump():
            nonlocal dump_size
            if dump_size < cfg.max_dump_size:
                dump_size = min(dump_size * cfg.dump_growth_factor,
                                cfg.max_dump_size)

        async def synthesize(codes: List[int]) -> None:
            # EOA is a control token, not an audio code: the reference
            # vocodes it in each sentence's final chunk
            # (streaming_server.py:378-391 token_batch = speech_outputs
            # with 453 still inside) — ~13 ms of wrong audio per
            # sentence with a trained model.  Defect #7; strip it.
            codes = [c for c in codes if c != dcfg.eoa_token_id]
            if codes:
                await synth_q.put(codes)

        issued = 0          # absolute decode position dispatched so far
        # In-flight Pending* handles, oldest first.  Dedicated engines
        # pipeline one block ahead (2 outstanding); pooled engines ask for
        # enough outstanding blocks that every in-flight pool step can
        # take a merged pair from their slot
        # (PooledEngine.issue_ahead = pipeline depth * merge factor).
        ahead = max(1, int(getattr(engine, "issue_ahead", 1)))
        pending: Deque = deque()

        async def end_sentence(flush_buffer: bool) -> bool:
            """Terminate the current sentence; True => whole request ended."""
            nonlocal st, dec_state, issued
            if flush_buffer and st.buffer:
                await synthesize(st.buffer)
            ended = st.end_generation
            if ended:
                await synth_q.put(END)
                await worker
            else:
                await synth_q.put(1 - index)
                st = _SentenceState()
                dec_state = engine.new_state()
                issued = 0
                pending.clear()
                grow_dump()
            return ended

        try:
            while True:
                terminated = False

                # -- text intake until the sentence is complete -----------
                if not st.sentence_done:
                    delta = await text_q.get()
                    if delta is _STREAM_CLOSED:
                        if st.n_generated == 0 and not st.text_ids:
                            await synth_q.put(END)
                            await worker
                            return
                        st.end_generation = True
                        st.sentence_done = True
                        st.text_ids.append(dcfg.text_eos_id)
                    else:
                        if eos in delta:
                            st.end_generation = True
                            delta = delta.replace(eos, "")
                            st.sentence_done = True
                        elif delta.endswith("."):
                            st.sentence_done = True
                        # Every delta is byte-tokenized with its ByT5 </s>
                        # (streaming_server.py:305-306); an empty eos
                        # remainder still contributes the bare </s>.
                        st.text_ids.extend(self.tokenizer.encode(delta.strip()))
                        if st.sentence_done:
                            st.text_ids.append(dcfg.text_eos_id)

                # -- generate as far as pacing allows ---------------------
                # Issue-ahead pipeline: keep up to 1+ahead blocks
                # dispatched on the chained device state before fetching
                # the oldest one's tokens.  ``issued`` tracks the
                # optimistic decode position of dispatched blocks; it
                # only diverges from the fetched position when EOA
                # fires, at which point the speculative blocks generate
                # nothing (device-side ``done``) and are discarded.
                while True:
                    # -- fill the dispatch pipeline ----------------------
                    capped = False
                    while len(pending) < 1 + ahead:
                        # Adaptive block growth: after the sentence has
                        # generated past the small first dumps, decode in
                        # larger blocks — same device throughput, ~4x fewer
                        # host round-trips (the dominant cost over a remote
                        # chip); EOA detection coarsens by <= big_block
                        # tokens, well under max_dump_size of buffered
                        # audio.
                        cur = block
                        if (big_block > block
                                and st.n_generated >= cfg.decode_block_switch):
                            cur = big_block
                        elif (first_block and issued == 0
                              and st.n_generated == 0
                              and dump_size <= first_block):
                            # sentence's first device call: a short block —
                            # the first chunk needs only dump_size tokens,
                            # so the extra decode_block-dump steps would
                            # just delay it
                            cur = first_block
                        if issued + cur > dcfg.block_size:
                            # KV-cache capacity guard (the reference would
                            # assert at 8192, src/model.py:205); close out
                            # like the length cap once the pipeline drains.
                            capped = True
                            break
                        if st.sentence_done:
                            limit = cur
                        else:
                            limit = min(cur, len(st.text_ids) - issued)
                        if limit <= 0:
                            break  # starved for text
                        if (issued == 0 and st.n_generated == 0
                                and not st.sentence_done
                                and limit < min(cur, dump_size)):
                            # Eager-start guard (VERDICT r4 #1): the
                            # sentence's FIRST dispatch cannot emit audio
                            # until dump_size speech tokens exist, and
                            # speech decode is text-paced (limit) — so a
                            # tiny first delta (an LLM's first block is
                            # 1 token) would burn a full block-scan
                            # device step to decode 1-2 unplayable
                            # tokens AND forfeit the fused
                            # decode+vocode first chunk (which needs
                            # dump_size <= limit).  Wait for enough text
                            # to cover the first chunk: the next delta
                            # either brings it or ends the sentence
                            # (sentence_done lifts the pacing), so this
                            # can never deadlock.  Measured: 2 fewer
                            # pool steps + 1 fewer synth round trip to
                            # first audio on the LLM-driven path.
                            break
                        if limit < cur and len(pending) >= 2:
                            # Text is trickling in: a partial-limit block
                            # still costs a full ``cur``-step device call,
                            # so beyond the 1-ahead pair wait for the
                            # text to fill a whole block instead of
                            # flooding the pipeline with tiny requests.
                            break
                        window = np.full(cur, dcfg.pad_token_id, np.int32)
                        avail = st.text_ids[issued:issued + cur]
                        window[:len(avail)] = avail
                        if (can_fuse and issued == 0
                                and st.n_generated == 0
                                and dump_size <= limit
                                and cur in (block, first_block)):
                            # sentence's first block: synthesize its
                            # first dump-size chunk in the same device
                            # call — one round trip to first audio
                            call = (engine.decode_block_fused_async,
                                    dec_state, window, len(st.text_ids),
                                    limit, dump_size)
                        else:
                            call = (engine.decode_block_async, dec_state,
                                    window, len(st.text_ids), limit)
                        if dispatch is not None:
                            nxt, dec_state = await dispatch(*call,
                                                            block=cur)
                        else:
                            nxt, dec_state = call[0](*call[1:], block=cur)
                        pending.append(nxt)
                        issued += limit

                    if not pending:
                        if capped:
                            if await end_sentence(flush_buffer=True):
                                return
                            terminated = True
                        break  # starved for text (or at capacity)

                    with trace.span(f"decode_r{index}"):
                        got = await pending.popleft().afetch()
                    if isinstance(got, tuple):   # fused: (tokens, audio)
                        tokens, st.fused_audio = got
                        st.fused_dump = dump_size
                    else:
                        tokens = got
                    st.n_generated += len(tokens)

                    # Per-token bookkeeping, exactly the reference's
                    # inner-loop order (streaming_server.py:347-422).
                    for tok in tokens:
                        st.buffer.append(tok)
                        if len(st.buffer) >= dump_size:
                            chunk, st.buffer = (st.buffer[:dump_size],
                                                st.buffer[dump_size:])
                            if (st.fused_audio is not None
                                    and not st.first_dump_done
                                    and len(chunk) == st.fused_dump
                                    and dcfg.eoa_token_id not in chunk):
                                # (EOA inside the fused dump falls back
                                # to host synthesis of the stripped
                                # chunk — defect #7 fix)
                                # chunk == the sentence's first
                                # fused_dump tokens, already vocoded
                                # on-device with the decode block
                                await synth_q.put(st.fused_audio)
                            else:
                                await synthesize(chunk)
                            st.first_dump_done = True
                            st.fused_audio = None
                            grow_dump()
                        elif dcfg.eoa_token_id in st.buffer:
                            chunk, st.buffer = st.buffer, []
                            await synthesize(chunk)
                            grow_dump()
                        if (tok == dcfg.eoa_token_id
                                or len(st.buffer) > cfg.max_audio_length):
                            # reference discards the residual buffer at
                            # sentence reset (streaming_server.py:414)
                            if await end_sentence(flush_buffer=False):
                                return
                            terminated = True
                            break
                    if terminated:
                        break

                if terminated:
                    continue

                if st.sentence_done and not pending:
                    # Defensive: generation stalled without EOA termination
                    # (unreachable in normal operation).  Close out so the
                    # request can never deadlock.
                    if await end_sentence(flush_buffer=True):
                        return
        finally:
            if not worker.done():
                worker.cancel()
