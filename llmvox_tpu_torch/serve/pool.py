"""Continuous-batching decode pool: N concurrent streams, one decode step.

Counterpart of ``llmvox_tpu/serve/pool.py``.  The dual-replica scheduler
stays per request, but the replicas of every in-flight request decode
through one shared, fixed-capacity batched step
(``models/decoder.py::decode_block_batch``, attention through kernel K2
on the card).  Every pool step reads the decoder weights once for all
active streams; idle slots ride along with ``limit=0`` masked steps.

Concurrency: each slot holds a FIFO of submitted blocks; each pool step
takes the head of every non-empty queue (two heads, merged into one
double-width step, when block merging is on).  Sentence resets are
applied lazily on the pool loop, before the next gather.  Up to
``pool_pipeline_depth`` steps are in flight: a step's tokens (and its
fused first-chunk audio) come back in one device-to-host copy into pinned
memory, started at dispatch and waited for on its own task.

In-place state.  The JAX pool's state is immutable, so a step in flight
owns its own version.  Here the KV caches are written in place, and
``pos``/``prev_token``/``done`` are replaced by each step's outputs.  That
is correct only because every pool step and every reset is enqueued on
the same CUDA stream, in dispatch order: a later step or reset cannot run
on the device before an earlier step has read the state it needs.  So
nothing here moves decode to a side stream.  The step is issued eagerly
from the event loop (``_dispatch_step``), which holds the loop for the
step's host launch cost; ``dispatch_s`` adds that time up.

Not ported here: speculative rungs (the K3 slice; a checkpoint with draft
heads under ``spec_decode`` raises) and the multi-device mesh pool
(ROADMAP item 15; a ``mesh`` argument raises).
"""
from __future__ import annotations

import asyncio
import time
import traceback
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.serve.batch import MESH_NOT_PORTED
from llmvox_tpu_torch.serve.engine import _Fetch, _to_device
from llmvox_tpu_torch.utils.config import DecoderConfig, ServeConfig
from llmvox_tpu_torch.utils.device import resolve_device
from llmvox_tpu_torch.utils.params import to_torch

SPEC_NOT_PORTED = ("speculative decode in the pool (draft heads, "
                   "decode_block_spec_batch, kernel K3) is not ported to "
                   "llmvox_tpu_torch yet: it is the next slice, ROADMAP "
                   "item 8")


def _gather_rows(tokens: torch.Tensor, idx: torch.Tensor,
                 bucket: int) -> torch.Tensor:
    """Select fused slots' token rows and shape them for the ragged
    vocoder: (S, bucket) int32, inactive (-1) entries clamped to code 0."""
    rows = tokens.index_select(0, idx).clamp_min(0)
    b = rows.shape[1]
    if bucket <= b:
        return rows[:, :bucket]
    return F.pad(rows, (0, bucket - b))


def _masked_reset(states: dec.DecodeState,
                  mask: torch.Tensor) -> dec.DecodeState:
    """Zero ``pos``/``prev_token``/``done`` of the rows in the (B,) bool
    device ``mask``: a fixed-shape select, no host sync."""
    return states._replace(
        pos=torch.where(mask, 0, states.pos),
        prev_token=torch.where(mask, 0, states.prev_token),
        done=torch.where(mask, False, states.done))


class _Request:
    __slots__ = ("window", "text_len", "limit", "future", "fused_dump")

    def __init__(self, window, text_len, limit, future, fused_dump=0):
        self.window = window
        self.text_len = text_len
        self.limit = limit
        self.future = future
        self.fused_dump = fused_dump  # >0: vocode the block's first N
                                      # tokens on the device with the decode


class _Slot:
    __slots__ = ("active", "queue", "pending_reset")

    def __init__(self):
        self.active = False
        self.queue: Deque[_Request] = deque()
        self.pending_reset = False

    def clear(self):
        while self.queue:
            req = self.queue.popleft()
            if not req.future.done():
                req.future.cancel()


class DecodePool:
    """Fixed-capacity batched decoder shared by all live streams."""

    # Concurrent requests' chunks are grouped per bucket and vocoded in ONE
    # ragged batched codec call, the batch padded to this fixed size (and
    # fused first chunks go in groups of it).
    SYNTH_BATCH = 8

    def __init__(self, decoder_params: Dict, text_table: np.ndarray,
                 codec: WavCodec, capacity: int = 16,
                 dcfg: Optional[DecoderConfig] = None,
                 scfg: Optional[ServeConfig] = None, *, device="cuda",
                 cache_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        self.dcfg = dcfg or DecoderConfig()
        self.scfg = scfg or ServeConfig()
        # the JAX pool speculates when spec_decode is on and the
        # checkpoint carries draft heads; greedy tokens are no stand-in
        if self.scfg.spec_decode and "draft_heads" in decoder_params:
            raise NotImplementedError(SPEC_NOT_PORTED)
        self.device = resolve_device(device)
        if codec.device != self.device:
            raise ValueError(f"codec lies on {codec.device}, pool on "
                             f"{self.device}")
        self.codec = codec
        self.B = capacity
        self.block = self.scfg.pool_decode_block or self.scfg.decode_block
        self.cache_dtype = cache_dtype
        self.params = to_torch(decoder_params, self.device,
                               param_dtype or cache_dtype)
        self.text_table = to_torch(text_table, self.device)
        self.codebook = codec.params["codebooks"][0]

        # Block merging: consumers submit ``block``-token requests (a
        # sentence's first chunk waits for one small step) and the pool
        # runs a slot's two queued requests as ONE ``2*block`` step when
        # demand allows, sharing the step's fixed cost.
        self.merge = bool(self.scfg.pool_merge_blocks)
        self.big_block = 2 * self.block if self.merge else self.block
        self.depth = max(1, int(self.scfg.pool_pipeline_depth))
        # outstanding requests each consumer should keep in flight so
        # every in-flight step can take a merged pair from its slot
        self.issue_ahead = self.depth * (2 if self.merge else 1)
        self.states = dec.init_decode_state_batch(self.dcfg, self.B,
                                                  cache_dtype, self.device)
        self._widths = ((self.block, self.big_block) if self.merge
                        else (self.block,))
        # fused first chunks vocode at the bucket of the step's largest
        # fused dump, capped here (dumps never exceed the block)
        self._fuse_bucket = codec.bucket_for(min(self.block,
                                                 max(codec.buckets)))
        self.slots = [_Slot() for _ in range(self.B)]
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._inflight = None
        self.steps = 0
        self.merged_steps = 0
        # decode steps dispatched (each step counts its width) and the
        # host seconds the event loop spent issuing them
        self.decode_steps = 0
        self.dispatch_s = 0.0
        self._synth_q: Deque = deque()
        self._synth_task: Optional[asyncio.Task] = None
        self._synth_wake: Optional[asyncio.Event] = None
        self.synth_calls = 0

    # -- slot lifecycle -------------------------------------------------
    def try_acquire(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                s.active = True
                s.pending_reset = True
                return i
        return None

    def acquire(self) -> int:
        idx = self.try_acquire()
        if idx is None:
            raise RuntimeError("decode pool exhausted")
        return idx

    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def release(self, idx: int) -> None:
        slot = self.slots[idx]
        slot.active = False
        slot.clear()

    def reset_slot(self, idx: int) -> None:
        """Per-sentence reset: drop queued work, re-zero state lazily."""
        slot = self.slots[idx]
        slot.clear()
        slot.pending_reset = True

    # -- stepping -------------------------------------------------------
    def submit(self, idx: int, window: np.ndarray, text_len: int,
               limit: int, fused_dump: int = 0) -> asyncio.Future:
        """Enqueue a block request; resolves with the block's tokens (or,
        with ``fused_dump > 0``, with ``(tokens, first_chunk_bytes|None)``)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.slots[idx].queue.append(
            _Request(np.array(window, np.int32), text_len, limit, fut,
                     fused_dump))
        # wake the parked step loop only when the arrival can change what
        # it dispatches now: a fused head may dispatch past ``depth``, and
        # an idle loop (no steps in flight) must start
        if self._wake is not None and (fused_dump > 0 or not self._inflight):
            self._wake.set()
        return fut

    def _apply_resets(self) -> None:
        idxs = [i for i, s in enumerate(self.slots) if s.pending_reset]
        if not idxs:
            return
        # Resetting pos/prev/done suffices: cache rows beyond pos are
        # never attended and are overwritten before they are read.
        mask = np.zeros((self.B,), bool)
        mask[idxs] = True
        self.states = _masked_reset(self.states,
                                    _to_device(mask, self.device))
        for i in idxs:
            self.slots[i].pending_reset = False

    def _pick(self) -> List[Tuple[int, List[_Request]]]:
        """Pop every non-empty slot queue's head, plus its second request
        when the pair can merge: a pair (r1, r2) runs as one ``2*block``
        step with window r1 ++ r2, limit r1.limit + r2.limit and text_len
        r2.text_len, which equals two sequential steps iff r1.limit ==
        block (active steps are a prefix, and EOA inside r1 freezes the
        row).  Fused (sentence-first) requests never merge."""
        picks = []
        for i, s in enumerate(self.slots):
            if s.active and s.queue:
                rs = [s.queue.popleft()]
                if (self.merge and s.queue
                        and rs[0].limit == self.block
                        and rs[0].fused_dump == 0
                        and s.queue[0].fused_dump == 0):
                    rs.append(s.queue.popleft())
                picks.append((i, rs))
        return picks

    def _dispatch_step(self) -> Optional[Tuple]:
        """Gather the queued requests and dispatch ONE batched decode step,
        plus the fused first chunks' vocodes chained on its tokens, with
        no host fetch.  Returns the in-flight record, or None when no work
        is queued.  Requests are popped here, at dispatch, so the next
        dispatch sees each slot's issue-ahead requests."""
        t0 = time.perf_counter()
        self._apply_resets()
        picks = self._pick()
        if not picks:
            return None
        merged = any(len(rs) == 2 for _, rs in picks)
        width = self.big_block if merged else self.block
        self.merged_steps += int(merged)
        # heads: (slot, request, token-row offset of this request)
        heads: List[Tuple[int, _Request, int]] = []
        try:
            windows = np.full((self.B, width), self.dcfg.pad_token_id,
                              np.int32)
            text_lens = np.zeros((self.B,), np.int32)
            limits = np.zeros((self.B,), np.int32)
            for i, rs in picks:
                off = 0
                for req in rs:
                    windows[i, off: off + self.block] = req.window
                    text_lens[i] = req.text_len
                    limits[i] += req.limit
                    heads.append((i, req, off))
                    off += self.block
            # fused first chunks in groups of SYNTH_BATCH (more fused
            # slots than that split into extra vocode calls); fused
            # requests never merge, so their tokens sit at row offset 0
            fused = [(i, req) for i, req, _ in heads if req.fused_dump > 0]
            groups = []
            for c0 in range(0, len(fused), self.SYNTH_BATCH):
                part = fused[c0: c0 + self.SYNTH_BATCH]
                fidx = np.zeros((self.SYNTH_BATCH,), np.int32)
                flens = np.ones((self.SYNTH_BATCH,), np.int32)
                for j, (i, req) in enumerate(part):
                    fidx[j] = i
                    flens[j] = req.fused_dump
                bucket = self.codec.bucket_for(
                    min(max(req.fused_dump for _, req in part),
                        self._fuse_bucket))
                groups.append((fidx, flens, bucket))
            # every input of the step in one host-to-device copy from a
            # fresh pinned buffer
            t = _to_device(np.concatenate(
                [windows.ravel(), text_lens, limits]
                + [a for fidx, flens, _ in groups for a in (fidx, flens)]),
                self.device)
            n = windows.size
            tokens, _, self.states = dec.decode_block_batch(
                self.params, self.text_table, self.codebook, self.states,
                t[:n].view(self.B, width), t[n:n + self.B],
                t[n + self.B:n + 2 * self.B], self.dcfg, block=width)
            wavs = []
            off = n + 2 * self.B
            for _, _, bucket in groups:
                fidx = t[off:off + self.SYNTH_BATCH]
                flens = t[off + self.SYNTH_BATCH:off + 2 * self.SYNTH_BATCH]
                off += 2 * self.SYNTH_BATCH
                rows = _gather_rows(tokens, fidx, bucket)
                wavs.append(self.codec.decode_codes_device(rows, flens))
                self.synth_calls += 1
            # tokens (exact in f32) and audio come back in one copy
            fetch = _Fetch(torch.cat([tokens.reshape(-1).float()]
                                     + [w.reshape(-1).float() for w in wavs]))
        except BaseException as exc:
            # requests were popped at dispatch: fail them now or their
            # waiters hang (the crash handler only sees the queues)
            for _, req, _ in heads:
                if not req.future.done():
                    req.future.set_exception(exc)
            raise
        self.steps += 1
        self.decode_steps += width
        self.dispatch_s += time.perf_counter() - t0
        shapes = (width, [w.shape for w in wavs])
        return heads, fused, fetch, shapes

    def _unpack(self, arr: np.ndarray, shapes) -> Tuple[np.ndarray, List]:
        width, wav_shapes = shapes
        n = self.B * width
        toks = np.rint(arr[:n]).astype(np.int32).reshape(self.B, width)
        wavs, off = [], n
        for shape in wav_shapes:
            size = int(np.prod(shape))
            wavs.append(arr[off:off + size].reshape(shape))
            off += size
        return toks, wavs

    async def _resolve_step(self, inflight: Tuple) -> None:
        """Fetch one in-flight step's results and resolve its futures."""
        heads, fused, fetch, shapes = inflight
        toks, wavs_h = self._unpack(await asyncio.to_thread(fetch.get),
                                    shapes)
        # slot -> (flat synth row, dump): rows follow the FUSED list
        # order, not the heads order
        fused_slots = {i: (j, req.fused_dump)
                       for j, (i, req) in enumerate(fused)}
        hop = self.codec.cfg.hop_length
        for i, req, off in heads:
            if req.future.done():
                continue
            out = [int(t) for t in toks[i][off: off + self.block] if t >= 0]
            if req.fused_dump > 0:
                audio = None
                if i in fused_slots and len(out) >= req.fused_dump:
                    j, dump = fused_slots[i]
                    row = wavs_h[j // self.SYNTH_BATCH][j % self.SYNTH_BATCH]
                    audio = np.asarray(row[: dump * hop],
                                       dtype="<f4").tobytes()
                req.future.set_result((out, audio))
            else:
                req.future.set_result(out)

    async def _resolve_task(self, inflight: Tuple) -> None:
        """Per-step fetch task: a failed fetch fails its own step's
        futures (they were popped at dispatch, so the crash handler can
        no longer see them)."""
        try:
            await self._resolve_step(inflight)
        except BaseException as exc:
            cancelled = isinstance(exc, asyncio.CancelledError)
            for _, req, _ in inflight[0]:
                if not req.future.done():
                    if cancelled:
                        req.future.cancel()
                    else:
                        req.future.set_exception(exc)
            raise

    async def _step_loop(self) -> None:
        """Keep ``pool_pipeline_depth`` steps in flight: each dispatched
        step (chained on the device state) starts its own fetch task at
        once, and the loop waits only for the OLDEST one.  A fused
        (sentence-first) request that arrives while the loop waits wakes
        it and may dispatch one step beyond ``depth``, so a sentence's
        first audio does not queue behind the previous sentence's
        issued-ahead steps."""
        self._inflight = deque()   # (record, fetch task), oldest first

        def fused_waiting() -> bool:
            return any(s.active and s.queue and s.queue[0].fused_dump > 0
                       for s in self.slots)

        while True:
            while len(self._inflight) < self.depth + int(fused_waiting()):
                nxt = self._dispatch_step()
                if nxt is None:
                    break
                self._inflight.append(
                    (nxt, asyncio.create_task(self._resolve_task(nxt))))
            if self._inflight:
                _, task = self._inflight[0]
                if not task.done():
                    # wait for the oldest fetch OR a new arrival
                    self._wake.clear()
                    waker = asyncio.create_task(self._wake.wait())
                    try:
                        await asyncio.wait(
                            {task, waker},
                            return_when=asyncio.FIRST_COMPLETED)
                    finally:
                        # also when stop() cancels the loop mid-wait
                        waker.cancel()
                if task.done():
                    self._inflight.popleft()
                    await task
                    # let consumers see results and enqueue follow-ups
                    # before the next gather
                    await asyncio.sleep(0)
            elif not any(s.active and s.queue for s in self.slots):
                await self._wake.wait()
                self._wake.clear()

    # -- batched synthesis ------------------------------------------------
    def submit_synth(self, codes: Sequence[int]) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._synth_q.append((list(codes), fut))
        if self._synth_wake is not None:
            self._synth_wake.set()
        return fut

    def _synth_batch(self, reqs) -> List[bytes]:
        hop = self.codec.cfg.hop_length
        bucket = self.codec.bucket_for(max(max(len(c) for c, _ in reqs), 1))
        codes = np.zeros((self.SYNTH_BATCH, bucket), np.int32)
        lengths = np.ones((self.SYNTH_BATCH,), np.int32)
        for i, (c, _) in enumerate(reqs):
            codes[i, : len(c)] = c
            lengths[i] = max(len(c), 1)
        wavs = self.codec.decode_codes_ragged(codes, lengths)
        self.synth_calls += 1
        return [np.asarray(wavs[i][: len(c) * hop], dtype="<f4").tobytes()
                for i, (c, _) in enumerate(reqs)]

    async def _synth_loop(self) -> None:
        while True:
            await self._synth_wake.wait()
            self._synth_wake.clear()
            while self._synth_q:
                batch = []
                while self._synth_q:
                    batch.append(self._synth_q.popleft())
                groups: Dict[int, list] = {}
                for codes, fut in batch:
                    b = self.codec.bucket_for(max(len(codes), 1))
                    groups.setdefault(b, []).append((codes, fut))
                for reqs in groups.values():
                    for i in range(0, len(reqs), self.SYNTH_BATCH):
                        part = reqs[i: i + self.SYNTH_BATCH]
                        try:
                            chunks = await asyncio.to_thread(
                                self._synth_batch, part)
                        except Exception as e:
                            for _, fut in part:
                                if not fut.done():
                                    fut.set_exception(e)
                            continue
                        for (_, fut), chunk in zip(part, chunks):
                            if not fut.done():
                                fut.set_result(chunk)
                await asyncio.sleep(0)

    def warmup(self) -> None:
        """Run each step width, each fused-chunk bucket and each synth
        bucket once before traffic.  Eager PyTorch compiles nothing per
        shape, so one pass builds the kernel and warms the allocator and
        the library handles (the JAX pool runs each width twice and the
        reset->step cycle for XLA's executables and TPU layouts)."""
        ones = np.ones((self.B,), np.int32)
        for w in self._widths:
            windows = np.full((self.B, w), self.dcfg.pad_token_id, np.int32)
            t = _to_device(np.concatenate([windows.ravel(), ones, ones]),
                           self.device)
            n = windows.size
            tokens, _, self.states = dec.decode_block_batch(
                self.params, self.text_table, self.codebook, self.states,
                t[:n].view(self.B, w), t[n:n + self.B], t[n + self.B:],
                self.dcfg, block=w)
        idx = torch.zeros((self.SYNTH_BATCH,), dtype=torch.int32,
                          device=self.device)
        lens = torch.ones((self.SYNTH_BATCH,), dtype=torch.int32,
                          device=self.device)
        for fb in [b for b in self.codec.buckets if b <= self._fuse_bucket]:
            self.codec.decode_codes_device(_gather_rows(tokens, idx, fb),
                                           lens)
        for s in self.slots:
            s.pending_reset = True
        self._apply_resets()
        for bucket in self.codec.buckets:
            # lengths reach the bucket: decode_codes_ragged pads to the
            # bucket of the longest row
            self.codec.decode_codes_ragged(
                np.zeros((self.SYNTH_BATCH, bucket), np.int32),
                np.full((self.SYNTH_BATCH,), bucket, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats(self) -> Dict:
        """Operational counters for GET /stats (serve/server.py)."""
        return {
            "capacity": self.B,
            "active": self.active_count,
            "steps": self.steps,
            "merged_steps": self.merged_steps,
            "synth_calls": self.synth_calls,
            "block": self.block,
        }

    def start(self) -> None:
        if self._synth_task is None:
            self._synth_wake = asyncio.Event()
            self._synth_task = asyncio.create_task(self._synth_loop())
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._step_loop())

            def _report(task):
                if task.cancelled():
                    return
                exc = task.exception()
                if exc is not None:
                    print("DecodePool step loop crashed:",
                          "".join(traceback.format_exception(exc)),
                          flush=True)
                    # fail all queued waiters so streams error instead of
                    # hanging; in-flight steps fail their own futures
                    self._inflight = None
                    for s in self.slots:
                        while s.queue:
                            req = s.queue.popleft()
                            if not req.future.done():
                                req.future.set_exception(exc)
                    self._task = None

            self._task.add_done_callback(_report)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._synth_task is not None:
            self._synth_task.cancel()
            self._synth_task = None
        # a restart (new event loop) must not resolve stale in-flight
        # records from the cancelled loop
        if self._inflight:
            for rec, task in self._inflight:
                task.cancel()
                for _, req, _ in rec[0]:
                    if not req.future.done():
                        req.future.cancel()
        self._inflight = None


class PoolLadder:
    """Occupancy-adaptive set of DecodePools (small -> large capacity).

    A batched pool's step cost scales with its CAPACITY, not its
    occupancy: inactive slots ride along in every step.  The ladder keeps
    several pools and routes engines to the smallest pool covering current
    demand; engines migrate at sentence boundaries
    (``PooledEngine.new_state``), where the slot state is reset anyway, so
    migration copies nothing.

    Demand is a decaying high-water mark of active slots: it holds its
    peak for ``decay_s``, so the later waves of a burst route straight to
    the big rung, then drifts back down.  Duck-types the DecodePool
    surface the server uses (``B``, ``warmup``, ``stop``, ``stats``).
    """

    def __init__(self, pools: Sequence[DecodePool], decay_s: float = 10.0):
        assert pools, "ladder needs at least one pool"
        caps = [p.B for p in pools]
        assert caps == sorted(caps), "order pools small -> large"
        blocks = {(p.block, p.big_block, p.issue_ahead) for p in pools}
        assert len(blocks) == 1, \
            "ladder pools must share block config (scheduler sees one)"
        self.pools = list(pools)
        self.decay_s = float(decay_s)
        self._peak = 0
        self._peak_t = time.monotonic()

    def _demand(self, extra: int = 0) -> int:
        now = time.monotonic()
        a = self.active_total + extra
        if a >= self._peak or now - self._peak_t >= self.decay_s:
            self._peak = a
            self._peak_t = now
        return self._peak

    @property
    def B(self) -> int:
        return self.pools[-1].B        # admission gates on the largest

    def warmup(self) -> None:
        for p in self.pools:
            p.warmup()

    def stop(self) -> None:
        for p in self.pools:
            p.stop()

    def stats(self) -> Dict:
        return {"ladder": [p.stats() for p in self.pools],
                "demand": self._peak}

    @property
    def active_total(self) -> int:
        return sum(p.active_count for p in self.pools)

    def target(self, extra: int = 0) -> DecodePool:
        """Smallest pool whose capacity covers current demand (+extra
        slots about to be acquired)."""
        need = self._demand(extra)
        for p in self.pools:
            if need <= p.B:
                return p
        return self.pools[-1]

    def acquire(self) -> Tuple[DecodePool, int]:
        for p in self.pools[self.pools.index(self.target(extra=1)):]:
            idx = p.try_acquire()
            if idx is not None:
                p.start()
                return p, idx
        raise RuntimeError("decode pool ladder exhausted")


class PooledEngine:
    """TTSEngine-compatible facade over one DecodePool slot.

    The StreamingScheduler drives engines through ``new_state`` /
    ``decode_block_async`` / ``synthesize_async`` (which it prefers to
    ``synthesize``, so a pooled engine needs no other); here decode goes
    through the shared pool (the state lives in the pool, so
    ``new_state`` resets the slot) and synthesis through the pool's
    batching synth queue.  Over a :class:`PoolLadder`, the engine moves to
    the ladder's target pool at each sentence boundary.
    """

    class _Pending:
        __slots__ = ("_fut",)

        def __init__(self, fut: asyncio.Future):
            self._fut = fut

        async def afetch(self) -> List[int]:
            # awaits the loop-owned future directly, with no executor
            # thread (blocking fetches could exhaust the executor and
            # starve the pool's own fetch threads)
            try:
                return await self._fut
            except asyncio.CancelledError:
                return []

    # the pool decodes every slot at its fixed block: no per-request block
    # growth and no small first block
    fixed_block = True

    def __init__(self, pool, scfg: Optional[ServeConfig] = None):
        self.ladder = pool if isinstance(pool, PoolLadder) else None
        if self.ladder is not None:
            self.pool, self.slot = self.ladder.acquire()
        else:
            self.pool = pool
            self.slot = pool.acquire()
            pool.start()
        self.dcfg = self.pool.dcfg
        self.scfg = scfg or self.pool.scfg
        self.codec = self.pool.codec
        self.block = self.pool.block
        # read by the scheduler to size its issue-ahead pipeline
        self.issue_ahead = self.pool.issue_ahead

    def new_state(self):
        if self.ladder is not None:
            tgt = self.ladder.target()
            if tgt is not self.pool:
                idx = tgt.try_acquire()
                if idx is not None:
                    self.pool.release(self.slot)
                    self.pool, self.slot = tgt, idx
                    self.codec = tgt.codec
                    tgt.start()
        self.pool.reset_slot(self.slot)
        return None  # the state lives in the pool

    def decode_block_async(self, state, window: np.ndarray, text_len: int,
                           limit: int, block: Optional[int] = None):
        assert block is None or block == self.block, \
            "pool slots decode at the pool's fixed block size"
        fut = self.pool.submit(self.slot, window, text_len, limit)
        return PooledEngine._Pending(fut), None

    def decode_block_fused_async(self, state, window: np.ndarray,
                                 text_len: int, limit: int, dump: int,
                                 block: Optional[int] = None):
        """Decode + on-device vocode of the block's first ``dump`` tokens,
        chained on the batched step: the sentence's first chunk costs one
        fetch."""
        assert block is None or block == self.block
        assert dump <= self.block
        fut = self.pool.submit(self.slot, window, text_len, limit,
                               fused_dump=dump)
        return PooledEngine._Pending(fut), None

    async def synthesize_async(self, codes: Sequence[int]) -> bytes:
        """Through the pool's batching synth queue: chunks of concurrent
        requests vocode in one ragged batched codec call."""
        return await self.pool.submit_synth(codes)

    def close(self) -> None:
        self.pool.release(self.slot)
