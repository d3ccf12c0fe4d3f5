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

In-place state and CUDA graphs.  The JAX pool's state is immutable, so
a step in flight owns its own version.  Here the pool holds ONE static
batched ``DecodeState``: a step reads its inputs from a static buffer
(the reset mask, text lengths, limits, windows and the fused groups'
rows, which the step's one host-to-device copy fills), applies the reset
mask on the device, and writes its tokens and the next state in place
(``utils/graphs.py``).  On a card ``warmup`` captures each (width, rung)
of ``_decode_fns`` (a greedy step, or a speculative start and iteration)
and the fused groups' gather and vocode per (width, bucket), and a step
is replays of those graphs; anything else raises.  That is correct only
because every step is issued on one thread, on one CUDA stream, in
dispatch order: a later step cannot run on the device before an earlier
step's results have been copied out.  So nothing here moves decode to a
side stream.

Dispatch.  A step is split in two (``_dispatch_step``).  The gather runs
on the event loop: it takes the pending resets, pops the slot queues
(which ``submit`` also touches) and builds the numpy windows.  The launch
(the one pinned copy, the step's replays, the fused vocodes and the
fetch) runs on the device's dispatch thread
(``utils/device.py::dispatch_executor``), so the loop stays free
for arrivals and chunk writes while a step's hundreds of kernels are
issued.  The loop does not wait for a launch to gather the next step:
every read and write of ``self.states`` happens on that one thread, in
submission order, as JAX's async dispatch keeps its programs in order.
``gather_s`` and ``launch_s`` add up the host seconds of the gathers and
the launches (``dispatch_s`` is their sum); ``active_rows`` the rows of
the slots a step decodes for, each counting the step's width.  With spans
on (``utils/trace.py``) a step's ``pool.gather``, ``dispatch.wait``,
``pool.launch`` and ``pool.fetch_wait`` share its step id, and a
synthesis batch is a ``pool.synth_batch`` span.

Speculation: with ``spec_decode`` and draft heads in the params, a step
is ``decode_block_spec_batch`` (attention through kernel K3) at
``spec_k_draft`` drafts, or, with ``spec_k_ladder``, at the rung that
``serve/spec_control.py::SpecController`` picks at dispatch, from the
commits and iterations that earlier steps fetched with their tokens.
Every rung gives the greedy step's tokens.  A speculative step waits on
the card for its stop flags while it is issued (one iteration behind),
so its launch holds the dispatch thread for that time too.

A mesh (``parallel/mesh.py``) shards the slots over its dp axis, as
JAX's mesh pool does (``llmvox_tpu/serve/pool.py:196-234``): shard i is a
one-device pool of ``capacity / dp`` slots on the i-th device, with its
own static state, replicated params, codec copy and graphs, captured on
that device at warmup.  The slots, queues, gather and resolve stay here;
a step's gather splits its inputs by shard, each shard's launch runs on
its device's dispatch thread (its kernels counted under the shard's
``graphs.launch_scope``), and the tokens come back in slot order.  A
shard's fused first chunks vocode on its own device.  Speculation is off
under a mesh, as in JAX (``_spec`` requires ``mesh is None``); no
collective is needed.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import statistics
import threading
import time
import traceback
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import decoder as dec
from llmvox_tpu_torch.models import spec
from llmvox_tpu_torch.parallel.mesh import Mesh
from llmvox_tpu_torch.serve.batch import dp_devices, shard_tag
from llmvox_tpu_torch.serve.spec_control import SpecController
from llmvox_tpu_torch.utils import trace as tracing
from llmvox_tpu_torch.utils.config import DecoderConfig, ServeConfig
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import (GraphSet, fill, launch_scope,
                                           settle, use_graphs)
from llmvox_tpu_torch.utils.params import to_torch


def _gather_rows(tokens: torch.Tensor, idx: torch.Tensor,
                 bucket: int) -> torch.Tensor:
    """Select fused slots' token rows and shape them for the ragged
    vocoder: (S, bucket) int32, inactive (-1) entries clamped to code 0."""
    rows = tokens.index_select(0, idx).clamp_min(0)
    b = rows.shape[1]
    if bucket <= b:
        return rows[:, :bucket]
    return F.pad(rows, (0, bucket - b))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_masked_reset = dec.masked_reset


def _fail(heads, exc: BaseException) -> None:
    """Fail the popped requests of a step that will not resolve them:
    cancel them when the step was cancelled, else pass ``exc`` on."""
    cancelled = isinstance(exc, asyncio.CancelledError)
    for _, req, _ in heads:
        if not req.future.done():
            if cancelled:
                req.future.cancel()
            else:
                req.future.set_exception(exc)


class _Request:
    __slots__ = ("window", "text_len", "limit", "future", "fused_dump")

    def __init__(self, window, text_len, limit, future, fused_dump=0):
        self.window = window
        self.text_len = text_len
        self.limit = limit
        self.future = future
        self.fused_dump = fused_dump  # >0: vocode the block's first N
                                      # tokens on the device with the decode


class _Plan:
    """A gathered step: what the dispatch thread launches (under a mesh,
    ``shards`` holds each shard's plan over its own slots)."""
    __slots__ = ("gather_s", "width", "rung", "heads", "fused", "groups",
                 "host", "shards", "rows")

    def __init__(self, gather_s, width, rung, heads, fused, groups, host,
                 shards=None):
        self.gather_s = gather_s  # host seconds the gather took
        self.width = width
        self.rung = rung
        self.heads = heads        # (slot, request, token-row offset)
        self.rows = len({i for i, _, _ in heads})   # slots decoded for
        self.fused = fused        # (slot, request) of the fused heads
        self.groups = groups      # (fused slot idx, fused dumps, bucket)
        self.host = host          # every input of the step, one int32 array
        self.shards = shards


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
                 param_dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None,
                 graphs: Optional[bool] = None):
        self.dcfg = dcfg or DecoderConfig()
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        if codec.device != self.device:
            raise ValueError(f"codec lies on {codec.device}, pool on "
                             f"{self.device}")
        self.codec = codec
        self.B = capacity
        self.block = self.scfg.pool_decode_block or self.scfg.decode_block
        self.cache_dtype = cache_dtype
        self.shards: Optional[List[DecodePool]] = None
        if mesh is not None:
            devices = dp_devices(mesh)
            dp = len(devices)
            if capacity % dp:
                raise ValueError(f"pool capacity {capacity} must divide "
                                 f"over dp={dp}")
            # JAX's mesh pool never speculates (its _spec needs no mesh)
            self.scfg = dataclasses.replace(self.scfg, spec_decode=False)
            self.shards = [DecodePool(
                decoder_params, text_table,
                codec if d == codec.device else codec.copy_to(d),
                capacity // dp, self.dcfg, self.scfg, device=d,
                cache_dtype=cache_dtype, param_dtype=param_dtype,
                graphs=graphs) for d in devices]
            self._tags = [shard_tag(i, d) for i, d in enumerate(devices)]
            self._lock = threading.Lock()
        else:
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
        self._widths = ((self.block, self.big_block) if self.merge
                        else (self.block,))
        # fused first chunks vocode at the bucket of the step's largest
        # fused dump, capped here (dumps never exceed the block)
        self._fuse_bucket = codec.bucket_for(min(self.block,
                                                 max(codec.buckets)))
        self._spec, self._spec_ctl, self._fixed_k = False, None, 0
        if self.shards is None:
            self._init_device(graphs)
        self.slots = [_Slot() for _ in range(self.B)]
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._inflight = None
        self._last_launch = None   # the newest launch(es) handed over
        self.steps = 0
        self.merged_steps = 0
        # decode steps launched (each step counts its width), the rows of
        # the slots they decode for (each counting the width), and the
        # host seconds spent issuing them, gather and launch (counted by
        # the dispatch thread)
        self.decode_steps = 0
        self.active_rows = 0
        self.gather_s = 0.0
        self.launch_s = 0.0
        self._synth_q: Deque = deque()
        self._synth_task: Optional[asyncio.Task] = None
        self._synth_wake: Optional[asyncio.Event] = None
        self.synth_calls = 0

    @property
    def dispatch_s(self) -> float:
        """Host seconds spent issuing steps: gathers and launches."""
        return self.gather_s + self.launch_s

    def _init_device(self, graphs: Optional[bool]) -> None:
        """The one-device pool's state, static buffers, graphs and rungs."""
        self.states = dec.init_decode_state_batch(
            self.dcfg, self.B, self.cache_dtype, self.device)
        # speculation engages, as in JAX, only when the checkpoint carries
        # draft heads.  A ladder holds rung 0 (the greedy step) and the
        # controller moves between rungs; every rung gives greedy's tokens.
        self._spec = bool(self.scfg.spec_decode
                          and "draft_heads" in self.params)
        ladder = tuple(int(k) for k in self.scfg.spec_k_ladder)
        self._spec_ctl = None
        self._fixed_k = self.scfg.spec_k_draft if self._spec else 0
        rungs = [self._fixed_k]
        if self._spec and any(k > 0 for k in ladder):
            rungs = sorted({k for k in ladder if k >= 0} | {0})
            self._spec_ctl = SpecController(
                rungs, k0=(self.scfg.spec_k_draft
                           if self.scfg.spec_k_draft in rungs else None))
        if self._spec:
            spec.check_draft_heads(self.params, self.dcfg, max(rungs))
            self._heads = self.params["draft_heads"][:max(rungs)].float()
        # static buffers: the step's inputs (reset mask, text lengths,
        # limits, windows, then each fused group's slots and dumps), one
        # fused group's rows for its vocode, each width's tokens
        nb = 2 * self.SYNTH_BATCH
        self._in = torch.zeros(
            (3 * self.B + self.B * self.big_block
             + -(-self.B // self.SYNTH_BATCH) * nb,),
            dtype=torch.int32, device=self.device)
        self._fused_in = torch.ones((nb,), dtype=torch.int32,
                                    device=self.device)
        self._tok = {w: torch.full((self.B, w), -1, dtype=torch.int32,
                                   device=self.device)
                     for w in self._widths}
        self._spec_bufs: Dict[Tuple[int, int], dec.SpecBuffers] = {}
        use = use_graphs(self.device, graphs)
        self._steps = GraphSet("pool step", self.device, use,
                               self._make_step)
        self._vocode = GraphSet("pool fused vocode", self.device, use,
                                self._make_vocode)
        self._decode_fns = {(w, k): self._decode_fn(w, k)
                            for w in self._widths for k in rungs}

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

    def _make_step(self, key: Tuple[int, int, str]):
        """(width, 0, "step"): the greedy block (attention through K2);
        (width, k, "start") and (width, k, "iter"): the speculative
        block's start and iteration at k drafts (K3).  Each applies the
        reset mask first where it begins a block."""
        w, k, part = key
        b = self.B
        reset = self._in[:b]
        tl, lim = self._in[b:2 * b], self._in[2 * b:3 * b]
        windows = self._in[3 * b:3 * b + b * w].view(b, w)
        tokens = self._tok[w]

        def apply_reset():
            dec.assign_state(self.states,
                             _masked_reset(self.states, reset.bool()))

        if k == 0:
            n = torch.zeros((b,), dtype=torch.int32, device=self.device)

            def body():
                apply_reset()
                toks, nprod, new = dec.decode_block_batch(
                    self.params, self.text_table, self.codebook,
                    self.states, windows, tl, lim, self.dcfg, block=w)
                dec.assign_state(self.states, new)
                tokens.copy_(toks)
                n.copy_(nprod)
            return body, (tokens, n, None)
        if (w, k) not in self._spec_bufs:
            self._spec_bufs[(w, k)] = dec.spec_buffers(b, w, k, self.device)
        bufs = self._spec_bufs[(w, k)]
        if part == "start":
            def body():
                apply_reset()
                dec.spec_start(self.states, bufs, windows, lim, self.dcfg)
        else:
            def body():
                dec.spec_iteration(self.params, self.text_table,
                                   self.codebook, self.states, bufs, tl,
                                   self.dcfg, self._heads[:k])
        return body, bufs

    def _make_vocode(self, key: Tuple[int, int]):
        """One fused group of a width-``w`` step at ``bucket``: its slots'
        token rows gathered and vocoded (batch ``SYNTH_BATCH``)."""
        w, bucket = key
        sb = self.SYNTH_BATCH
        fidx, flens = self._fused_in[:sb], self._fused_in[sb:]
        out = torch.zeros((sb, bucket * self.codec.cfg.hop_length),
                          dtype=torch.float32, device=self.device)

        def body():
            out.copy_(self.codec.decode_codes_device(
                _gather_rows(self._tok[w], fidx, bucket), flens))
        return body, out

    def _decode_fn(self, width: int, k: int):
        """The pool step at one (width, rung), over the static buffers:
        rung 0 is the greedy block, rung k > 0 the speculative block at k
        drafts.  Each returns (tokens, n, iters), iters None for the
        greedy block; the tokens are the width's static buffer."""
        def step():
            if k == 0:
                return self._steps.get((width, 0, "step"))()
            start, it = (self._steps.get((width, k, p))
                         for p in ("start", "iter"))
            bufs = start.out
            spec.run_spec_loop(start, it, bufs.flag, width)
            self._tok[width].copy_(bufs.out[:, :width])
            return self._tok[width], bufs.count, bufs.iters
        return step

    def _take_resets(self) -> np.ndarray:
        """The (B,) reset mask of the slots with a pending reset, which are
        marked done.  Resetting pos/prev/done suffices: cache rows beyond
        pos are never attended and are overwritten before they are read."""
        mask = np.zeros((self.B,), np.int32)
        for i, s in enumerate(self.slots):
            if s.pending_reset:
                mask[i] = 1
                s.pending_reset = False
        return mask

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

    def _gather(self) -> Optional[_Plan]:
        """On the event loop: take the pending resets, pop every slot
        queue's head (and merge partner) and build the step's host inputs;
        None when no work is queued (the resets then wait for the next
        step).  Requests are popped here, at dispatch, so the next gather
        sees each slot's issue-ahead requests."""
        t0 = time.perf_counter()
        picks = self._pick()
        if not picks:
            return None
        reset = self._take_resets()
        merged = any(len(rs) == 2 for _, rs in picks)
        width = self.big_block if merged else self.block
        heads: List[Tuple[int, _Request, int]] = [
            (i, req, k * self.block)
            for i, rs in picks for k, req in enumerate(rs)]
        if self.shards is not None:
            # each shard's plan over its own slots (numbered from 0)
            n = self.B // len(self.shards)
            try:
                shards = [sh._plan(
                    [(i - s * n, req, off) for i, req, off in heads
                     if s * n <= i < (s + 1) * n],
                    reset[s * n:(s + 1) * n], width, 0.0)
                    for s, sh in enumerate(self.shards)]
            except BaseException as exc:
                _fail(heads, exc)
                raise
            self.synth_calls += sum(len(p.groups) for p in shards)
            return _Plan(time.perf_counter() - t0, width, 0, heads,
                         [p.fused for p in shards], None, None, shards)
        plan = self._plan(heads, reset, width, t0)
        self.synth_calls += len(plan.groups)
        return plan

    def _plan(self, heads, reset: np.ndarray, width: int,
              t0: float) -> _Plan:
        """The step's host inputs for ``heads`` (slot, request, offset) and
        the (B,) reset mask: windows, text lengths, limits, the fused
        groups, the rung."""
        try:
            windows = np.full((self.B, width), self.dcfg.pad_token_id,
                              np.int32)
            text_lens = np.zeros((self.B,), np.int32)
            limits = np.zeros((self.B,), np.int32)
            for i, req, off in heads:
                windows[i, off: off + self.block] = req.window
                text_lens[i] = req.text_len
                limits[i] += req.limit
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
            host = np.concatenate(
                [reset, text_lens, limits, windows.ravel()]
                + [a for fidx, flens, _ in groups for a in (fidx, flens)])
            # the rung is picked here, on the loop, where the controller
            # also observes the fetched steps
            rung = (self._spec_ctl.next_k() if self._spec_ctl is not None
                    else self._fixed_k)
        except BaseException as exc:
            _fail(heads, exc)
            raise
        return _Plan(time.perf_counter() - t0 if t0 else 0.0, width, rung,
                     heads, fused, groups, host)

    def _launch(self, plan: _Plan) -> Tuple:
        """On the dispatch thread: ONE batched decode step (its resets
        applied on the device first), and the fused first chunks' vocodes
        chained on its tokens, with no host fetch.  Returns (the fetch
        started for the tokens and audio, their shapes, the controller's
        feedback or None)."""
        t0 = time.perf_counter()
        with tracing.span("pool.launch"):
            # every input of the step in one host-to-device copy from a
            # fresh pinned buffer
            fill(self._in, plan.host)
            tokens, nprod, iters = self._decode_fns[(plan.width,
                                                     plan.rung)]()
            wavs = []
            off = 3 * self.B + self.B * plan.width
            nb = 2 * self.SYNTH_BATCH
            for _, _, bucket in plan.groups:
                g = self._vocode.get((plan.width, bucket))
                self._fused_in.copy_(self._in[off:off + nb])
                off += nb
                # a second group may replay the same graph: keep this one's
                wavs.append(g().clone())
            # accept statistics for the adaptive controller come back with
            # the step: each slot's commits and iterations (active slots
            # only are read; a merged pick appears once)
            feedback = None
            if self._spec_ctl is not None and iters is not None:
                feedback = (plan.rung, sorted({i for i, _, _ in plan.heads}))
                wavs = [nprod, iters] + wavs
            # tokens (exact in f32) and audio come back in one copy
            fetch = Fetch(torch.cat([tokens.reshape(-1).float()]
                                    + [w.reshape(-1).float() for w in wavs]))
            shapes = (plan.width, [w.shape for w in wavs])
        # counted here, where the step is launched
        self.steps += 1
        self.merged_steps += int(plan.width == 2 * self.block)
        self.decode_steps += plan.width
        self.active_rows += plan.rows * plan.width
        self.gather_s += plan.gather_s
        self.launch_s += time.perf_counter() - t0
        return fetch, shapes, feedback

    def _launch_shard(self, s: int, plan: _Plan) -> Tuple:
        """On shard ``s``'s dispatch thread: its launch, its kernels
        counted under its tag."""
        t0 = time.perf_counter()
        with launch_scope(self._tags[s]):
            out = self.shards[s]._launch(plan)
        with self._lock:
            self.launch_s += time.perf_counter() - t0
        return out

    def _dispatch_step(self) -> Optional[Tuple]:
        """Gather on the loop and hand the launch to the dispatch thread
        (each shard's to its device's), without waiting for it.  Returns
        the in-flight record (the step's popped requests, its fused heads,
        and its fetch task), or None when no work is queued."""
        step = tracing.new_step()
        with tracing.span("pool.gather", step=step):
            plan = self._gather()
        if plan is None:
            return None
        rec = (plan.heads, plan.fused, step)
        if self.shards is None:
            self._last_launch = dispatch_executor(self.device).submit_as(
                "pool.step", step, self._launch, plan)
            launch = asyncio.wrap_future(self._last_launch)
        else:
            self._last_launch = [
                dispatch_executor(sh.device).submit_as(
                    "pool.step", step, self._launch_shard, s, sp)
                for s, (sh, sp) in enumerate(zip(self.shards, plan.shards))]
            launch = [asyncio.wrap_future(f) for f in self._last_launch]
            self.steps += 1
            self.merged_steps += int(plan.width == 2 * self.block)
            self.decode_steps += plan.width
            self.active_rows += plan.rows * plan.width
            with self._lock:
                self.gather_s += plan.gather_s
        return rec, asyncio.create_task(self._resolve_task(rec, launch))

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

    def _fused_rows(self, fused, wavs_h) -> Dict[int, Tuple]:
        """slot -> (its fused first chunk's audio row, dump): rows follow
        the FUSED list order, not the heads order."""
        sb = self.SYNTH_BATCH
        return {i: (wavs_h[j // sb][j % sb], req.fused_dump)
                for j, (i, req) in enumerate(fused)}

    async def _resolve_step(self, rec: Tuple, launch) -> None:
        """Wait for one step's launch and fetch, then resolve its
        futures (under a mesh, each shard's tokens and fused audio, put
        back in slot order)."""
        heads, fused, step = rec
        if self.shards is None:
            fetch, shapes, feedback = await launch
            with tracing.span("pool.fetch_wait", step=step):
                arr = await asyncio.to_thread(fetch.get)
            toks, wavs_h = self._unpack(arr, shapes)
            if feedback is not None:
                (rung, act), (nprod, iters) = feedback, wavs_h[:2]
                wavs_h = wavs_h[2:]
                self._spec_ctl.observe(rung,
                                       float(sum(nprod[i] for i in act)),
                                       float(sum(iters[i] for i in act)))
            audio = self._fused_rows(fused, wavs_h)
        else:
            launches = [await f for f in launch]
            with tracing.span("pool.fetch_wait", step=step):
                arrs = await asyncio.to_thread(
                    lambda: [f.get() for f, _, _ in launches])
            parts, audio = [], {}
            for s, (sh, arr, (_, shapes, _)) in enumerate(
                    zip(self.shards, arrs, launches)):
                t, wavs_h = sh._unpack(arr, shapes)
                parts.append(t)
                audio.update({i + s * sh.B: row for i, row in
                              sh._fused_rows(fused[s], wavs_h).items()})
            toks = np.concatenate(parts)
        hop = self.codec.cfg.hop_length
        for i, req, off in heads:
            if req.future.done():
                continue
            out = [int(t) for t in toks[i][off: off + self.block] if t >= 0]
            if req.fused_dump > 0:
                chunk = None
                if i in audio and len(out) >= req.fused_dump:
                    row, dump = audio[i]
                    chunk = np.asarray(row[: dump * hop],
                                       dtype="<f4").tobytes()
                req.future.set_result((out, chunk))
            else:
                req.future.set_result(out)

    async def _resolve_task(self, rec: Tuple, launch) -> None:
        """Per-step task: a failed launch or fetch fails its own step's
        futures (they were popped at dispatch, so the crash handler can no
        longer see them)."""
        try:
            await self._resolve_step(rec, launch)
        except BaseException as exc:
            _fail(rec[0], exc)
            raise

    async def _step_loop(self) -> None:
        """Keep ``pool_pipeline_depth`` steps in flight: each dispatched
        step (chained on the device state) starts its own fetch task at
        once, and the loop waits only for the OLDEST one.  A fused
        (sentence-first) request that arrives while the loop waits wakes
        it and may dispatch one step beyond ``depth``, so a sentence's
        first audio does not queue behind the previous sentence's
        issued-ahead steps."""
        tracing.detach()
        self._inflight = deque()   # (record, fetch task), oldest first

        def fused_waiting() -> bool:
            return any(s.active and s.queue and s.queue[0].fused_dump > 0
                       for s in self.slots)

        while True:
            while len(self._inflight) < self.depth + int(fused_waiting()):
                nxt = self._dispatch_step()
                if nxt is None:
                    break
                self._inflight.append(nxt)
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
        with tracing.span("pool.synth_batch"):
            hop = self.codec.cfg.hop_length
            bucket = self.codec.bucket_for(
                max(max(len(c) for c, _ in reqs), 1))
            codes = np.zeros((self.SYNTH_BATCH, bucket), np.int32)
            lengths = np.ones((self.SYNTH_BATCH,), np.int32)
            for i, (c, _) in enumerate(reqs):
                codes[i, : len(c)] = c
                lengths[i] = max(len(c), 1)
            wavs = self.codec.decode_codes_ragged(codes, lengths)
            self.synth_calls += 1
            return [np.asarray(wavs[i][: len(c) * hop],
                               dtype="<f4").tobytes()
                    for i, (c, _) in enumerate(reqs)]

    async def _synth_loop(self) -> None:
        tracing.detach()
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

    def _fill_idle(self, width: int, limit: int, text_len: int) -> None:
        """Static inputs for a step outside traffic: every slot reset,
        PAD windows, the given limit and text length, fused groups at
        slot 0 with dump 1."""
        b, sb = self.B, self.SYNTH_BATCH
        groups = -(-b // sb)
        fill(self._in, np.concatenate(
            [np.ones(b, np.int32), np.full(b, text_len, np.int32),
             np.full(b, limit, np.int32),
             np.full(b * width, self.dcfg.pad_token_id, np.int32)]
            + [np.zeros(sb, np.int32), np.ones(sb, np.int32)] * groups))

    def warmup(self) -> None:
        """Capture every body traffic can reach before it arrives (on a
        card a CUDA graph each, after an eager pass that builds the
        kernels and the libraries' plans; without graphs one eager pass
        each): each (width, rung) of ``_decode_fns``, the fused groups'
        gather and vocode at each width and bucket up to ``_fuse_bucket``,
        and the codec's ragged buckets; then calibrate the ladder's rungs
        on the captured steps, leave every slot reset, and ``settle``.
        The reset
        mask is an input of every step, so the JAX pool's reset->step
        cycle needs no program of its own here.  Under a mesh each shard
        warms on its device, under its tag."""
        if self.shards is not None:
            for tag, sh in zip(self._tags, self.shards):
                with launch_scope(tag):
                    sh.warmup()
            self.codec.warmup(self.SYNTH_BATCH)
            settle()
            return
        self._fill_idle(self.big_block, 1, 1)
        for w, k in sorted(self._decode_fns):
            for part in (("step",) if k == 0 else ("start", "iter")):
                self._steps.capture((w, k, part))
        for w in self._widths:
            for fb in [b for b in self.codec.buckets
                       if b <= self._fuse_bucket]:
                self._vocode.capture((w, fb))
        self.codec.warmup(self.SYNTH_BATCH)
        if self._spec_ctl is not None and not self._spec_ctl.cost_ms:
            self._spec_ctl.cost_ms = self._calibrate_spec_costs()
        for t in (self.states.pos, self.states.prev_token, self.states.done):
            t.zero_()
        _sync(self.device)
        settle()

    def _calibrate_spec_costs(self, repeats: int = 7) -> Dict[int, float]:
        """Each rung's cost on the pool's own state (warmup calls it after
        capture, so a rung costs what its replays cost): ms per ITERATION
        issued for a speculative rung, ms per TOKEN for rung 0 (a greedy
        "iteration" commits one token).  Every step resets all slots
        first.  Each rung runs one untimed step; then ``repeats`` rounds
        time every rung once, in an order that rotates from round to
        round, each step alone between two device syncs.  A rung's cost
        is the median of its rounds, so a slow stretch of a shared host
        falls on every rung alike and one outlier moves nothing."""
        self._fill_idle(self.block, self.block, 0)
        rungs = sorted({k for (_w, k) in self._decode_fns})
        for k in rungs:
            self._decode_fns[(self.block, k)]()
        samples: Dict[int, List[float]] = {k: [] for k in rungs}
        for r in range(repeats):
            for k in rungs[r % len(rungs):] + rungs[:r % len(rungs)]:
                _sync(self.device)
                it0 = dec.SPEC_ITERATIONS
                t0 = time.perf_counter()
                self._decode_fns[(self.block, k)]()
                _sync(self.device)
                dt_ms = (time.perf_counter() - t0) * 1000.0
                units = self.block if k == 0 else dec.SPEC_ITERATIONS - it0
                samples[k].append(dt_ms / max(units, 1))
        return {k: statistics.median(v) for k, v in samples.items()}

    def spec_stats(self) -> Optional[Dict]:
        """Speculation state for /stats: None when spec is off."""
        if self._spec_ctl is not None:
            return self._spec_ctl.stats()
        if self._spec:
            return {"k": self._fixed_k, "ladder": [self._fixed_k]}
        return None

    def stats(self) -> Dict:
        """Operational counters for GET /stats (serve/server.py)."""
        out = {
            "capacity": self.B,
            "active": self.active_count,
            "steps": self.steps,
            "merged_steps": self.merged_steps,
            "synth_calls": self.synth_calls,
            "block": self.block,
            "decode_steps": self.decode_steps,
            "active_rows": self.active_rows,
            "gather_s": self.gather_s,
            "launch_s": self.launch_s,
        }
        if self.shards is not None:
            out["dp"] = len(self.shards)
        spec = self.spec_stats()
        if spec is not None:
            out["spec"] = spec
        return out

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
        # the launches handed over run in order: once the newest is done,
        # no step of the stopped loop touches the state after stop()
        if self._last_launch is not None:
            concurrent.futures.wait(self._last_launch
                                    if isinstance(self._last_launch, list)
                                    else [self._last_launch])
            self._last_launch = None


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
