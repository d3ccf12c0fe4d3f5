"""Continuous-batching pool for the in-framework text LLM, on the card.

Counterpart of ``llmvox_tpu/serve/llm_pool.py``: N in-flight requests
share one batched decode program (``models/llama.py::
decode_block_pooled``) with per-row positions, and mixed-length prompts
prefill into their slots in one program (``prefill_slots``).  Each row's
last sampled token is carried on the device (``LlamaPoolState.tok``), so a
request's first decode block is submitted before the host has seen its
prefill's token: prefill and first block run back to back in one pool
iteration, one fetch for the first ``1 + block`` tokens.  The same knobs
as JAX's: the small first block, the prefill buckets and their merge,
chunked prefill of long prompts, the shared-prefix KV cache, streaming
prompts, per-request sampling, the attention-window ladder, the
``pipeline_depth`` step loop, and speculation: with draft heads in the
params, ``spec_k`` serves every block as ``decode_block_spec_pooled`` at
that depth, and ``spec_ladder`` adds rung 0 and lets
``serve/spec_control.py::SpecController`` pick a rung at each dispatch
from the iterations earlier blocks fetched, costed by
``_calibrate_spec_costs`` after warmup.  Every rung gives the plain
block's tokens (greedy) or its law (sampled).

On the device:
- One static ``LlamaPoolState`` serves every program.  Each program reads
  its inputs (tokens, valid lengths, slots, the active mask, the
  continuation's start, the sampling rows) from two static buffers that
  one pinned copy fills per launch, and writes its tokens into static
  outputs (``utils/graphs.py``).  On a card ``warmup`` captures, as one
  CUDA graph each, the set JAX's ``LLMPool.warmup`` compiles: a prefill
  per (bucket, arrival size 1 or ``PREFILL_BATCH``, prefix or not), a
  continuation per (attention rung above the top bucket, final or not)
  and a decode block per (attention rung, width ``first_block`` or
  ``block``) at rung 0, or at a speculative rung an iteration per
  (attention rung, width, rung) and a start per (width, rung).  Any other
  shape raises, and nothing is captured while serving.  The prefix rows
  are static too, so ``set_prefix`` is refused once warmup has captured.
- A dispatch is split in two.  The event loop plans it (pops the pending
  prefills and the slots' block requests, updates the host's position
  bounds, builds the numpy inputs); the launch (the copies, the replays,
  the fetch) runs on the card's dispatch thread
  (``utils/device.py::dispatch_executor``), so the loop stays free while
  a block's launches are issued.  Launches run in dispatch order on one
  thread and one stream, which is what lets every program share the one
  state.  A pool iteration's results come back in one device-to-host
  copy, started at launch; with ``pipeline_depth`` 2 the next iteration
  is issued before this one is fetched, and the fetch waits only for its
  own iteration.
- ``plan_s`` and ``launch_s`` add up the host seconds of the plans and the
  launches (``dispatch_s`` is their sum), ``prefill_s`` the launches'
  seconds in prefill and continuation programs, and ``prefill_tokens``
  the prompt tokens prefilled past the cached prefix.  With spans on
  (``utils/trace.py``) an iteration's ``llm.plan``, ``dispatch.wait``,
  ``llm.launch`` (its programs each an ``llm.prefill`` or ``llm.block``
  span) and ``llm.fetch_wait`` share its step id, and the wait for a free
  slot is an ``admission`` span.
- Sampled programs draw Gumbel noise from one device ``torch.Generator``,
  registered with every capture.
- A speculative block is its start graph, then iteration graphs issued by
  ``models/spec.py::run_spec_loop``, which waits on the card's "any
  row active" flag one iteration behind, on the dispatch thread.  So the
  launch of a speculative block holds the dispatch thread until its last
  iteration but one has run; with ``pipeline_depth`` 2 the next
  iteration is planned on the loop meanwhile and launched behind it, and
  the block's results still come back in the iteration's one fetch (its
  tokens, and its rows' iterations for the controller).

As in JAX, ``spec_k`` or ``spec_ladder`` without draft heads in the params
serve the plain block.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import statistics
import time
import traceback
from collections import deque
from typing import (AsyncIterator, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from llmvox_tpu_torch.models import llama
from llmvox_tpu_torch.models.spec import check_draft_heads, run_spec_loop
from llmvox_tpu_torch.serve.spec_control import SpecController
from llmvox_tpu_torch.utils import trace as tracing
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import GraphSet, fill, settle, use_graphs
from llmvox_tpu_torch.utils.params import to_torch

class PromptRestart(Exception):
    """Raised by a streaming-prompt producer when already-submitted ids
    turned out wrong (a tokenizer revised its own earlier output).
    Carries the final prompt ids; the pool recovers with one plain fresh
    prefill of them, so the output is always ``generate(final_ids)``."""

    def __init__(self, ids: List[int]):
        super().__init__("streaming prompt restarted")
        self.ids = list(ids)


class _PrefillReq:
    __slots__ = ("slot", "ids", "future", "prefix", "final", "extend")

    def __init__(self, slot: int, ids: List[int], future: asyncio.Future,
                 prefix: bool = False, final: bool = True,
                 extend: bool = False):
        self.slot = slot
        self.ids = ids              # suffix ids when prefix=True
        self.future = future
        self.prefix = prefix        # reuse the pool's shared-prefix KV
        self.final = final          # False: a streaming-prompt part,
        self.extend = extend        # more ids follow before sampling


class _LSlot:
    __slots__ = ("active", "queue", "blocks_done")

    def __init__(self):
        self.active = False
        self.queue: Deque[asyncio.Future] = deque()
        self.blocks_done = 0        # decode blocks dispatched this request

    def clear(self):
        while self.queue:
            fut = self.queue.popleft()
            if not fut.done():
                fut.cancel()


class _Plan:
    """One pool iteration as the loop planned it: the programs to launch
    in order, each ``(graph key, int32 inputs, sampling rows or None,
    requests its token resolves or None)``; the prefill groups and the
    block requests it resolves; the decode block's width and rung, and
    whether its rows' iterations come back for the controller."""
    __slots__ = ("items", "parts", "blocks", "width", "rung", "observe",
                 "gather_s", "launch", "step")

    def __init__(self):
        self.items: List[Tuple] = []
        self.parts: List[List[_PrefillReq]] = []
        self.blocks: List[Tuple[int, asyncio.Future]] = []
        self.width = 0
        self.rung = 0
        self.observe = False
        self.gather_s = 0.0
        self.launch: Optional[concurrent.futures.Future] = None
        self.step: Optional[int] = None


def _fail_plan(plan: _Plan, exc: BaseException, cancel: bool = False) -> None:
    """Fail (or cancel) every future of an iteration that will not
    resolve them."""
    futs = [r.future for part in plan.parts for r in part]
    futs += [f for _, f in plan.blocks]
    for fut in futs:
        if not fut.done():
            if cancel:
                fut.cancel()
            else:
                fut.set_exception(exc)


class LLMPool:
    """Fixed-capacity batched Llama decoder shared by all live requests,
    on ``device`` (``"cuda"`` by default; the CPU runs the same bodies
    eagerly).  ``dtype`` casts the floating params and sets the caches'
    dtype (f32 without it); ``graphs`` (None: on for a card) serves every
    program through the CUDA graphs ``warmup`` captures."""

    # Arrival batches pad to 1 (the steady-state single arrival) or this
    # (bursts): two captured prefill programs per bucket, not one per
    # arrival count.
    PREFILL_BATCH = 4

    def __init__(self, params, cfg: llama.LlamaConfig, *,
                 capacity: int = 8, block: int = 16, first_block: int = 0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, dtype: Optional[torch.dtype] = None,
                 device="cuda",
                 prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 seed: int = 0, pipeline_depth: int = 2,
                 spec_k: int = 0, spec_ladder: Sequence[int] = (),
                 prefill_merge: bool = True, chunked_prefill: bool = True,
                 per_request_sampling: bool = False,
                 graphs: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.B = capacity
        self.block = block
        # a step runs at first_block only when every row in it is on its
        # first block (a fresh request alone); width never changes results
        self.first_block = (int(first_block)
                            if 0 < int(first_block) < block else 0)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        # per-request sampling: every program takes per-row (t, k, p), so
        # one captured program serves any mix of request configs
        self.per_request = bool(per_request_sampling)
        self._samp = np.tile(np.asarray(
            [temperature, float(top_k), top_p], np.float32), (capacity, 1))
        # speculation (decode_block_spec_pooled) needs draft heads in the
        # params; without them spec_k and spec_ladder serve the plain
        # block, as JAX's pool does.  A ladder holds rung 0 and the
        # controller moves between rungs at dispatch.
        self.spec_k = int(spec_k)
        ladder = tuple(int(k) for k in (spec_ladder or ()))
        has_heads = "draft_heads" in params
        self._adaptive = has_heads and any(k > 0 for k in ladder)
        self.use_spec = (self.spec_k > 0 or self._adaptive) and has_heads
        self._spec_ctl = None
        if self._adaptive:
            rungs = sorted({k for k in ladder if k >= 0} | {0})
            self._spec_rungs = tuple(rungs)
            self._spec_ctl = SpecController(
                rungs, k0=self.spec_k if self.spec_k in rungs else None)
        elif self.use_spec:
            self._spec_rungs = (self.spec_k,)
        else:
            self._spec_rungs = (0,)
        # the verifier writes up to k + 1 cache rows past the last
        # committed token: the deepest rung's headroom is reserved in
        # every capacity check, so a rung switch never changes what fits
        self._spec_margin = (max(self._spec_rungs) + 1 if self.use_spec
                             else 0)
        self.prefill_merge = bool(prefill_merge)
        self.chunked_prefill = bool(chunked_prefill)
        self.cache_dtype = dtype or torch.float32
        self.params = to_torch(params, self.device, dtype)
        if self.use_spec:
            check_draft_heads(self.params, cfg, max(self._spec_rungs))
        # prompts longer than the largest bucket chunk (or keep their
        # tail); buckets leave room for at least one decode block
        cap = cfg.max_seq_len - block - 1 - self._spec_margin
        self.buckets = tuple(sorted(b for b in prefill_buckets if b <= cap))
        if not self.buckets:
            self.buckets = (min(16, cap),)
        self.state = llama.init_llama_pool_state(
            cfg, capacity, self.cache_dtype, self.device)
        # attention-window ladder: attend only over a rung covering every
        # active row's position upper bound (tracked here, at dispatch)
        self._ub = [0] * self.B
        self.attn_buckets = tuple(
            b for b in llama.attn_window_ladder(cfg.max_seq_len)
            if b >= self.block + 1 or b == cfg.max_seq_len)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        # shared-prefix KV cache (set_prefix)
        self._prefix_ids: Optional[List[int]] = None
        self._prefix_k = self._prefix_v = None
        self._prefix_buckets: Tuple[int, ...] = ()
        # static inputs: the largest program's int32 inputs (a burst
        # prefill at the top bucket, or a decode block's active mask) and
        # the sampling rows (t, k, p per row)
        nb = self.PREFILL_BATCH
        self._in = torch.zeros(
            (max(nb * self.buckets[-1] + 3 * nb, self.buckets[-1] + 4,
                 self.B),), dtype=torch.int32, device=self.device)
        self._rows_in = torch.zeros((3 * max(self.B, nb),),
                                    dtype=torch.float32, device=self.device)
        sampled = temperature > 0 or self.per_request
        self._spec_bufs: Dict[Tuple[int, int], llama.SpecBuffers] = {}
        self._graphs = GraphSet(
            "LLM pool", self.device, use_graphs(self.device, graphs),
            self._make, generators=(self.generator,) if sampled else ())
        self.slots = [_LSlot() for _ in range(self.B)]
        self._prefills: Deque[_PrefillReq] = deque()
        self._free: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._inflight = None
        self._last_launch = None   # the newest launch handed over
        self.steps = 0
        self.prefill_calls = 0
        # token steps of the decode blocks dispatched (each block counts
        # its width), the prompt tokens prefilled past the cached prefix,
        # and the host seconds spent planning and launching iterations and
        # launching their prefills (the seconds counted by the dispatch
        # thread)
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.plan_s = 0.0
        self.launch_s = 0.0
        self.prefill_s = 0.0

    @property
    def dispatch_s(self) -> float:
        """Host seconds spent issuing iterations: plans and launches."""
        return self.plan_s + self.launch_s

    # -- slot lifecycle -------------------------------------------------
    def _ensure_free_queue(self) -> asyncio.Queue:
        if self._free is None:
            self._free = asyncio.Queue()
            for i in range(self.B):
                self._free.put_nowait(i)
        return self._free

    async def acquire(self) -> int:
        """Wait for a free slot (requests beyond capacity queue here)."""
        idx = await self._ensure_free_queue().get()
        self.slots[idx].active = True
        self.slots[idx].blocks_done = 0
        return idx

    def _drop_slot_prefills(self, idx: int) -> None:
        """Cancel the queued prefills of a slot: two fresh prefills for one
        slot must never share an iteration (the restart path drops the
        stale ones before resubmitting)."""
        keep: Deque[_PrefillReq] = deque()
        while self._prefills:
            r = self._prefills.popleft()
            if r.slot == idx:
                if not r.future.done():
                    r.future.cancel()
            else:
                keep.append(r)
        self._prefills = keep

    def release(self, idx: int) -> None:
        slot = self.slots[idx]
        slot.active = False
        slot.clear()
        self._drop_slot_prefills(idx)
        self._ensure_free_queue().put_nowait(idx)

    # -- request API ----------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def set_prefix(self, ids: Sequence[int], min_len: int = 8) -> None:
        """Pin the KV rows of a shared prompt prefix (one
        ``llama.prefix_kv`` forward, here, once); later prompts that start
        with these ids prefill only their suffix.  A too-short or too-long
        prefix disables the cache.  Call before ``warmup``: on a card the
        captured prefills read the prefix rows, so a later call raises."""
        if self._graphs.enabled and self._graphs.graphs:
            raise RuntimeError(
                "LLMPool.set_prefix after warmup: the captured prefill "
                "graphs read the prefix rows; set the prefix before warmup")
        ids = list(int(t) for t in ids)
        cap = self._ctx_cap()
        pbuckets = tuple(b for b in self.buckets if len(ids) + b <= cap)
        if len(ids) < min_len or not pbuckets:
            self._prefix_ids = None
            self._prefix_k = self._prefix_v = None
            self._prefix_buckets = ()
            return
        k, v = llama.prefix_kv(
            self.params, torch.tensor([ids], dtype=torch.int32,
                                      device=self.device), self.cfg)
        self._prefix_ids = ids
        self._prefix_k = k.to(self.cache_dtype)
        self._prefix_v = v.to(self.cache_dtype)
        self._prefix_buckets = pbuckets

    def _ctx_cap(self) -> int:
        """Longest cacheable prompt: room is left for one decode block (and
        the verifier's rows past it)."""
        return self.cfg.max_seq_len - self.block - 1 - self._spec_margin

    def _chunk0_len(self, n: int, buckets: Tuple[int, ...]) -> Optional[int]:
        """First-chunk length of an n-token chunked prefill: the ragged
        remainder goes first (through the bucketed ``prefill_slots``),
        every later chunk is exactly ``self.buckets[-1]`` wide.  None when
        that remainder fits no bucket of the class."""
        cw = self.buckets[-1]
        r = n % cw or cw
        return r if r <= buckets[-1] else None

    def _plan(self, ids: List[int]) -> Tuple[bool, List[int], int]:
        """(use_prefix, prefill_ids, cached_len) for a prompt: the prefix
        path takes strictly longer prompts that start with the prefix;
        with chunked prefill prompts run up to the context cap, otherwise
        they keep the tail that fits the largest bucket."""
        cap = self._ctx_cap()
        pids = self._prefix_ids
        if pids is not None and len(ids) > len(pids) \
                and list(ids[: len(pids)]) == pids:
            sfx = list(ids[len(pids):])
            if len(sfx) <= self._prefix_buckets[-1]:
                return True, sfx, len(pids) + len(sfx)
            if (self.chunked_prefill
                    and len(pids) + len(sfx) <= cap
                    and self._chunk0_len(len(sfx),
                                         self._prefix_buckets) is not None):
                return True, sfx, len(pids) + len(sfx)
        limit = cap if self.chunked_prefill else self.buckets[-1]
        ids2 = list(ids)[-limit:] or [0]
        return False, ids2, len(ids2)

    def _submit(self, req: _PrefillReq) -> asyncio.Future:
        self._prefills.append(req)
        if self._wake is not None:
            self._wake.set()
        return req.future

    def submit_prefill(self, idx: int, ids: List[int],
                       final: bool = True) -> asyncio.Future:
        """Enqueue a prompt prefill into slot ``idx``; resolves with the
        first sampled token.  ``final=False``: a streaming-prompt head,
        whose token the caller ignores (more ids follow through
        ``submit_prefill_extend``)."""
        use_pfx, ids, _ = self._plan(list(ids))
        return self._submit(_PrefillReq(
            idx, ids, asyncio.get_running_loop().create_future(), use_pfx,
            final=final))

    def submit_prefill_extend(self, idx: int, ids: List[int],
                              final: bool = True) -> asyncio.Future:
        """Enqueue more prompt ids for a slot whose head already
        prefilled: they land at the slot's cached upper bound through the
        continuation programs.  ``final=True`` samples the real first
        token (``ids`` is then non-empty).  FIFO with ``submit_prefill``."""
        return self._submit(_PrefillReq(
            idx, list(ids), asyncio.get_running_loop().create_future(),
            final=final, extend=True))

    def submit_block(self, idx: int) -> asyncio.Future:
        """Enqueue one decode block for slot ``idx``; resolves with its
        tokens.  Chains on the slot's device state, so it may be submitted
        before the prefill's token is known."""
        fut = asyncio.get_running_loop().create_future()
        self.slots[idx].queue.append(fut)
        if self._wake is not None:
            self._wake.set()
        return fut

    def set_sampling(self, idx: int, temperature: Optional[float] = None,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None) -> None:
        """Per-request sampling knobs for slot ``idx`` (None keeps the
        pool's default); used when the pool was built with
        ``per_request_sampling``."""
        self._samp[idx] = [
            self.temperature if temperature is None else float(temperature),
            float(self.top_k if top_k is None else int(top_k)),
            self.top_p if top_p is None else float(top_p)]

    def _rows_for(self, slot_ids) -> Optional[np.ndarray]:
        """The (t, k, p) rows of prefill rows that land in ``slot_ids``
        (padding rows read slot 0's: they write nothing), flat."""
        if not self.per_request:
            return None
        return np.ascontiguousarray(
            self._samp[np.asarray(slot_ids, np.int64) % self.B].T).ravel()

    def _rows_all(self) -> Optional[np.ndarray]:
        if not self.per_request:
            return None
        return np.ascontiguousarray(self._samp.T).ravel()

    # -- the programs, over the static buffers -----------------------------
    def _rows(self, n: int) -> Optional[Tuple]:
        if not self.per_request:
            return None
        r = self._rows_in
        return r[:n], r[n:2 * n].to(torch.int32), r[2 * n:3 * n]

    def _make(self, key: Tuple):
        """The body of one program: ("prefill", bucket, rows, prefix),
        ("continue", attn_len, final), ("block", attn_len, width), or a
        speculative block's ("spec_start", width, k) and ("spec_iter",
        attn_len, width, k)."""
        kind = key[0]
        sample = dict(temperature=self.temperature, top_k=self.top_k,
                      top_p=self.top_p, generator=self.generator)
        st = self.state
        if kind == "prefill":
            _, bucket, n, pfx = key
            tokens = self._in[:n * bucket].view(n, bucket)
            valid, slots, active = self._in[n * bucket:n * bucket + 3 * n
                                            ].view(3, n)
            out = torch.zeros((n,), dtype=torch.int32, device=self.device)

            def body():
                first, new = llama.prefill_slots(
                    self.params, tokens, valid, st, slots, active.bool(),
                    self.cfg, prefix_k=self._prefix_k if pfx else None,
                    prefix_v=self._prefix_v if pfx else None,
                    rows=self._rows(n), **sample)
                st.pos.copy_(new.pos)
                st.tok.copy_(new.tok)
                out.copy_(first)
            return body, out
        if kind == "continue":
            _, attn, final = key
            cw = self.buckets[-1]
            tokens = self._in[:cw].view(1, cw)
            valid, slots, active, pos0 = self._in[cw:cw + 4].view(4, 1)
            out = torch.zeros((1,), dtype=torch.int32, device=self.device)

            def body():
                first, new = llama.prefill_slots_continue(
                    self.params, tokens, valid, st, slots, active.bool(),
                    pos0, self.cfg, final=final, attn_len=attn,
                    rows=self._rows(1), **sample)
                st.pos.copy_(new.pos)
                st.tok.copy_(new.tok)
                out.copy_(first)
            return body, out
        if kind in ("spec_start", "spec_iter"):
            return self._make_spec(key, sample)
        _, attn, width = key
        active = self._in[:self.B]
        out = torch.zeros((self.B, width), dtype=torch.int32,
                          device=self.device)

        def body():
            toks, new = llama.decode_block_pooled(
                self.params, st, active.bool(), self.cfg, block=width,
                attn_len=attn, rows=self._rows(self.B), **sample)
            st.pos.copy_(new.pos)
            st.tok.copy_(new.tok)
            out.copy_(toks)
        return body, out

    def _make_spec(self, key: Tuple, sample: Dict):
        """A speculative block's start (the block's buffers reset from the
        active mask) or one iteration, over the buffers of its (width,
        k), which hold its outputs."""
        width, k = key[-2:]
        if (width, k) not in self._spec_bufs:
            self._spec_bufs[(width, k)] = llama.spec_buffers(
                self.B, width, k, self.device)
        bufs = self._spec_bufs[(width, k)]
        if key[0] == "spec_start":
            active = self._in[:self.B]

            def body():
                llama.spec_start(bufs, active.bool(), width)
            return body, bufs
        attn = key[1]

        def body():
            llama.spec_iteration(self.params, self.state, bufs, self.cfg, k,
                                 attn, rows=self._rows(self.B), **sample)
        return body, bufs

    def _spec_block(self, attn: int, width: int, k: int
                    ) -> Tuple[llama.SpecBuffers, int]:
        """Issue one speculative block at rung ``k`` (its start, then its
        iterations one ahead of the card's flag); returns its buffers and
        the iterations issued."""
        start = self._graphs.get(("spec_start", width, k))
        it = self._graphs.get(("spec_iter", attn, width, k))
        return start.out, run_spec_loop(start, it, start.out.flag, width)

    # -- planning (on the event loop) ----------------------------------
    def _add_prefill(self, plan: _Plan, tokens: np.ndarray,
                     valid: np.ndarray, slot_ids: np.ndarray,
                     active: np.ndarray, pfx: bool,
                     part: Optional[List[_PrefillReq]]) -> None:
        n, bucket = tokens.shape
        plan.items.append((
            ("prefill", bucket, n, pfx),
            np.concatenate([tokens.ravel(), valid, slot_ids,
                            active.astype(np.int32)]).astype(np.int32),
            self._rows_for(slot_ids), part))
        self.prefill_calls += 1

    def _add_continue(self, plan: _Plan, chunk: List[int], slot: int,
                      pos: int, final: bool,
                      part: Optional[List[_PrefillReq]]) -> None:
        cw = self.buckets[-1]
        tokens = np.zeros((cw,), np.int32)
        tokens[: len(chunk)] = chunk
        plan.items.append((
            ("continue", self._attn_bucket(pos + cw), final),
            np.concatenate([tokens, [len(chunk), slot, 1, pos]]).astype(
                np.int32),
            self._rows_for([slot]), part))
        self.prefill_calls += 1

    def _run_prefills(self, plan: _Plan, reqs: List[_PrefillReq]) -> None:
        """Plan the pending prefills in as few programs as possible.  With
        ``prefill_merge`` (default), within a prefix class, sort by prompt
        length (descending) and cut full ``PREFILL_BATCH`` chunks across
        buckets, each at the bucket of its longest member; off, one group
        per (bucket, prefix).  Long prompts chunk (``_run_chunked``);
        streaming-prompt extensions follow the fresh heads
        (``_run_extend``).  Arrival counts pad to 1 or
        ``PREFILL_BATCH``."""
        exts = [r for r in reqs if r.extend]
        reqs = [r for r in reqs if not r.extend]
        for pfx in (False, True):
            rs = [r for r in reqs if r.prefix == pfx]
            if not rs:
                continue
            buckets = self._prefix_buckets if pfx else self.buckets
            plen = len(self._prefix_ids) if pfx else 0
            if self.chunked_prefill:
                for r in [r for r in rs if len(r.ids) > buckets[-1]]:
                    self._run_chunked(plan, r, pfx, buckets, plen)
                rs = [r for r in rs if len(r.ids) <= buckets[-1]]
                if not rs:
                    continue
            if self.prefill_merge:
                rs.sort(key=lambda r: len(r.ids), reverse=True)
                chunks = [rs[c0: c0 + self.PREFILL_BATCH]
                          for c0 in range(0, len(rs), self.PREFILL_BATCH)]
            else:
                grouped: Dict[int, List[_PrefillReq]] = {}
                for r in rs:
                    b = next(b for b in buckets if len(r.ids) <= b)
                    grouped.setdefault(b, []).append(r)
                chunks = [g[c0: c0 + self.PREFILL_BATCH]
                          for g in grouped.values()
                          for c0 in range(0, len(g), self.PREFILL_BATCH)]
            for part in chunks:
                need = max(len(r.ids) for r in part)
                bucket = next(b for b in buckets if need <= b)
                npad = 1 if len(part) == 1 else self.PREFILL_BATCH
                tokens = np.zeros((npad, bucket), np.int32)
                valid = np.ones((npad,), np.int32)
                slot_ids = np.zeros((npad,), np.int32)
                active = np.zeros((npad,), bool)
                for j, r in enumerate(part):
                    tokens[j, : len(r.ids)] = r.ids
                    valid[j] = len(r.ids)
                    slot_ids[j] = r.slot
                    active[j] = True
                self._add_prefill(plan, tokens, valid, slot_ids, active,
                                  pfx, part)
                plan.parts.append(part)
                for r in part:
                    self._ub[r.slot] = plen + len(r.ids)
        for r in exts:
            self._run_extend(plan, r)

    def _run_extend(self, plan: _Plan, r: _PrefillReq) -> None:
        """A streaming prompt's next ids: top-bucket-wide continuation
        chunks landing at the slot's cached upper bound, the last one
        sampling the real first token when ``r.final``."""
        cw = self.buckets[-1]
        pos = self._ub[r.slot]
        rest = list(r.ids) or [0]   # callers guarantee non-empty finals
        while rest:
            chunk, rest = rest[:cw], rest[cw:]
            self._add_continue(plan, chunk, r.slot, pos,
                               r.final and not rest, None if rest else [r])
            pos += len(chunk)
        self._ub[r.slot] = pos
        plan.parts.append([r])

    def _run_chunked(self, plan: _Plan, r: _PrefillReq, pfx: bool,
                     buckets: Tuple[int, ...], plen: int) -> None:
        """One long prompt (over the class's largest bucket) as a chain of
        programs: the ragged remainder first through the bucketed prefill
        (its token is overwritten below), then exact ``buckets[-1]``-wide
        continuation chunks, the last with ``final=True``."""
        cw = self.buckets[-1]
        ids = r.ids
        r0 = self._chunk0_len(len(ids), buckets)
        bucket = next(b for b in buckets if r0 <= b)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :r0] = ids[:r0]
        self._add_prefill(plan, tokens, np.asarray([r0], np.int32),
                          np.asarray([r.slot], np.int32),
                          np.ones((1,), bool), pfx, None)
        pos = plen + r0
        rest = ids[r0:]
        while rest:
            chunk, rest = rest[:cw], rest[cw:]
            self._add_continue(plan, chunk, r.slot, pos, not rest,
                               None if rest else [r])
            pos += cw
        self._ub[r.slot] = pos
        plan.parts.append([r])

    def _attn_bucket(self, needed: int) -> int:
        for b in self.attn_buckets:
            if needed <= b:
                return b
        return self.attn_buckets[-1]

    # -- step loop ------------------------------------------------------
    def _dispatch(self) -> Optional[_Plan]:
        """Plan the pending prefills and one batched decode block on the
        loop and hand the launch to the dispatch thread, without waiting
        for it.  Block futures are popped here, so the next dispatch sees
        each slot's issue-ahead request.  Returns the iteration's plan
        (its ``launch`` the dispatch thread's future), or None when
        nothing is queued."""
        t0 = time.perf_counter()
        plan = _Plan()
        plan.step = tracing.new_step()
        with tracing.span("llm.plan", step=plan.step):
            self._plan_iteration(plan)
        if not plan.items:
            return None
        plan.gather_s = time.perf_counter() - t0
        self._last_launch = plan.launch = dispatch_executor(
            self.device).submit_as("llm.iteration", plan.step, self._launch,
                                   plan)
        return plan

    def _plan_iteration(self, plan: _Plan) -> None:
        """Plan into ``plan`` the pending prefills and one batched decode
        block of every slot with a block queued."""
        reqs: List[_PrefillReq] = []
        try:
            if self._prefills:
                reqs = [r for r in self._prefills if not r.future.done()]
                self._prefills.clear()
                self.prefill_tokens += sum(len(r.ids) for r in reqs)
                self._run_prefills(plan, reqs)
            heads = [i for i, s in enumerate(self.slots)
                     if s.active and s.queue]
            if heads:
                active = np.zeros((self.B,), np.int32)
                active[heads] = 1
                for i in heads:
                    plan.blocks.append((i, self.slots[i].queue.popleft()))
                width = self.block
                if (self.first_block
                        and all(self.slots[i].blocks_done == 0
                                for i in heads)):
                    width = self.first_block
                attn = self._attn_bucket(
                    max(self._ub[i] for i in heads) + width
                    + self._spec_margin)
                for i in heads:
                    self._ub[i] += width
                    self.slots[i].blocks_done += 1
                # the rung is picked here, on the loop, where the
                # controller also observes the fetched blocks
                rung = (self._spec_ctl.next_k()
                        if self._spec_ctl is not None
                        else (self.spec_k if self.use_spec else 0))
                plan.width, plan.rung = width, rung
                plan.observe = rung > 0 and self._spec_ctl is not None
                key = (("spec", attn, width, rung) if rung > 0
                       else ("block", attn, width))
                plan.items.append((key, active, self._rows_all(),
                                   plan.blocks))
                self.steps += 1
                self.decode_steps += width
        except BaseException as exc:
            # requests already popped here would otherwise hang their
            # waiters: fail them before the crash handler runs
            plan.parts.append(reqs)
            _fail_plan(plan, exc)
            raise

    def _launch(self, plan: _Plan) -> Tuple[Optional[Fetch], List[int]]:
        """On the dispatch thread: each program of the iteration (its
        inputs copied in, one replay), then one fetch of every result the
        iteration resolves.  Returns the fetch and the results' sizes."""
        t0 = time.perf_counter()
        outs = []
        with tracing.span("llm.launch"):
            for key, host, rows, part in plan.items:
                prefill = key[0] in ("prefill", "continue")
                t = time.perf_counter()
                with tracing.span("llm.prefill" if prefill else "llm.block"):
                    fill(self._in, host)
                    if rows is not None:
                        fill(self._rows_in, rows)
                    if key[0] == "spec":
                        bufs, _ = self._spec_block(*key[1:])
                        out = bufs.out[:, :plan.width]
                    else:
                        out = self._graphs.get(key)()
                if prefill:
                    self.prefill_s += time.perf_counter() - t
                if part is not None:
                    # the key's output buffer is rewritten by its next
                    # replay
                    outs.append(out.reshape(-1).clone())
            if plan.observe:
                outs.append(bufs.iters.clone())
            fetch = Fetch(torch.cat(outs)) if outs else None
        self.plan_s += plan.gather_s
        self.launch_s += time.perf_counter() - t0
        return fetch, [o.numel() for o in outs]

    async def _resolve(self, plan: _Plan) -> None:
        """Wait for the iteration's launch and its one fetch, then resolve
        its futures."""
        fetch, sizes = await asyncio.wrap_future(plan.launch)
        with tracing.span("llm.fetch_wait", step=plan.step):
            vals = (await asyncio.to_thread(fetch.get) if fetch is not None
                    else np.zeros((0,), np.int32))
        off = 0
        results = []
        for n in sizes:
            results.append(vals[off:off + n])
            off += n
        if plan.observe and plan.blocks:
            # the controller's accept statistics (active rows only): each
            # row committed ``width`` tokens over its iterations
            iters = results.pop()
            act = [i for i, _ in plan.blocks]
            self._spec_ctl.observe(plan.rung, float(plan.width * len(act)),
                                   float(sum(iters[i] for i in act)))
        for part, firsts in zip(plan.parts, results):
            for j, r in enumerate(part):
                if not r.future.done():
                    r.future.set_result(int(firsts[j]))
        if plan.blocks:
            toks = results[-1].reshape(self.B, plan.width)
            for i, fut in plan.blocks:
                if not fut.done():
                    fut.set_result([int(t) for t in toks[i]])

    async def _resolve_task(self, plan: _Plan) -> None:
        """Per-iteration fetch task: a failed launch or fetch fails its own
        iteration's futures (popped at dispatch, so the crash handler can
        no longer see them); a cancelled one cancels them."""
        try:
            await self._resolve(plan)
        except BaseException as exc:
            _fail_plan(plan, exc,
                       cancel=isinstance(exc, asyncio.CancelledError))
            raise

    async def _step_loop(self) -> None:
        """Pipelined to ``pipeline_depth`` iterations in flight: each
        dispatch (chained on the device state) starts its own fetch task,
        and the loop waits only for the oldest.  ``generate`` issues one
        block ahead per slot, which depth 2 needs."""
        tracing.detach()
        self._inflight = deque()   # (plan, fetch task), oldest first
        while True:
            while len(self._inflight) < self.pipeline_depth:
                nxt = self._dispatch()
                if nxt is None:
                    break
                self._inflight.append(
                    (nxt, asyncio.create_task(self._resolve_task(nxt))))
            if self._inflight:
                _, task = self._inflight.popleft()
                await task
                # let consumers enqueue follow-ups and new arrivals join
                await asyncio.sleep(0)
            elif (not self._prefills
                    and not any(s.active and s.queue for s in self.slots)):
                await self._wake.wait()
                self._wake.clear()

    def start(self) -> None:
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._step_loop())

            def _report(task):
                if task.cancelled():
                    return
                exc = task.exception()
                if exc is not None:
                    print("LLMPool step loop crashed:",
                          "".join(traceback.format_exception(exc)),
                          flush=True)
                    # in-flight iterations fail their own futures
                    self._inflight = None
                    for s in self.slots:
                        while s.queue:
                            fut = s.queue.popleft()
                            if not fut.done():
                                fut.set_exception(exc)
                    while self._prefills:
                        r = self._prefills.popleft()
                        if not r.future.done():
                            r.future.set_exception(exc)
                    self._task = None

            self._task.add_done_callback(_report)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        # a restart (new event loop) must not resolve stale in-flight
        # iterations of the cancelled loop
        if self._inflight:
            for plan, task in self._inflight:
                task.cancel()
                _fail_plan(plan, None, cancel=True)
        self._inflight = None
        # launches run in order: once the newest is done, no iteration of
        # the stopped loop touches the state after stop()
        if self._last_launch is not None:
            concurrent.futures.wait([self._last_launch])
            self._last_launch = None

    def stats(self) -> Dict:
        """Operational counters for GET /stats (serve/server.py)."""
        out = {
            "capacity": self.B,
            "active": sum(1 for s in self.slots if s.active),
            "steps": self.steps,
            "prefill_calls": self.prefill_calls,
            "block": self.block,
            "first_block": self.first_block,
            "spec_k": self.spec_k if self.use_spec else 0,
            "prefix_cached": self._prefix_ids is not None,
            "chunked_prefill": self.chunked_prefill,
            "per_request_sampling": self.per_request,
        }
        spec = self.spec_stats()
        if spec is not None:
            out["spec"] = spec
        return out

    def host_stats(self) -> Dict:
        """The port's own counters, for GET /stats beside ``stats()``,
        which keeps JAX's keys."""
        return {"decode_steps": self.decode_steps,
                "prefill_tokens": self.prefill_tokens,
                "plan_s": self.plan_s, "launch_s": self.launch_s,
                "prefill_s": self.prefill_s}

    def spec_stats(self) -> Optional[Dict]:
        """Speculation state for /stats: None when spec is off."""
        if self._spec_ctl is not None:
            return self._spec_ctl.stats()
        if self.use_spec:
            return {"k": self.spec_k, "ladder": [self.spec_k]}
        return None

    # -- warmup ---------------------------------------------------------
    def warmup_keys(self) -> List[Tuple]:
        """The programs JAX's ``LLMPool.warmup`` compiles, as graph keys:
        both arrival sizes of each prefill bucket (and of each prefix
        bucket), the continuation chunks at every attention rung above
        the top bucket when long prompts chunk, and a decode block at
        every attention rung, speculative rung and width: the plain block
        at rung 0, else a speculative iteration (and the start of its
        width and rung, once)."""
        variants = [(b, False) for b in self.buckets]
        if self._prefix_ids is not None:
            variants += [(b, True) for b in self._prefix_buckets]
        keys = [("prefill", b, n, pfx) for b, pfx in variants
                for n in (1, self.PREFILL_BATCH)]
        cw = self.buckets[-1]
        if self.chunked_prefill and self._ctx_cap() > cw:
            keys += [("continue", a, fin) for a in self.attn_buckets
                     if a > cw for fin in (False, True)]
        widths = ((self.first_block, self.block) if self.first_block
                  else (self.block,))
        for a in self.attn_buckets:
            for rung in self._spec_rungs:
                for w in widths:
                    if rung == 0:
                        keys.append(("block", a, w))
                        continue
                    if ("spec_start", w, rung) not in keys:
                        keys.append(("spec_start", w, rung))
                    keys.append(("spec_iter", a, w, rung))
        return keys

    def warmup(self) -> None:
        """Capture every program traffic can reach (``warmup_keys``)
        before requests arrive: on a card a CUDA graph each, without
        graphs one eager pass each.  Every input is zero, so every row is
        inactive and nothing live is disturbed.  Then, on a ladder, each
        rung's cost (``_calibrate_spec_costs``), and ``settle``."""
        self._in.zero_()
        self._rows_in.zero_()
        for key in self.warmup_keys():
            self._graphs.capture(key)
        if self._spec_ctl is not None and not self._spec_ctl.cost_ms:
            self._spec_ctl.cost_ms = self._calibrate_spec_costs()
        self._sync()
        settle()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _calibrate_spec_costs(self, repeats: int = 3) -> Dict[int, float]:
        """Each rung's cost on the pool's own state and programs (warmup
        calls it after capture): ms per ITERATION issued for a speculative
        rung, ms per TOKEN for rung 0, every row active from position 0,
        each block from fresh slots (positions and tokens zeroed).  Each
        rung runs one untimed block; then ``repeats`` rounds time every
        rung once, in an order that rotates from round to round, each
        block alone between two device syncs; a rung's cost is the median
        of its rounds.  The slots are left zeroed (the cache rows written
        lie above every later request's positions until it overwrites
        them)."""
        attn = self._attn_bucket(self.block + self._spec_margin)
        rungs = list(self._spec_rungs)

        def run(rung: int) -> int:
            self.state.pos.zero_()
            self.state.tok.zero_()
            fill(self._in, np.ones((self.B,), np.int32))
            if self.per_request:
                fill(self._rows_in, self._rows_all())
            if rung == 0:
                self._graphs.get(("block", attn, self.block))()
                return self.block
            return self._spec_block(attn, self.block, rung)[1]

        samples: Dict[int, List[float]] = {k: [] for k in rungs}
        for rung in rungs:
            run(rung)
        for r in range(repeats):
            for rung in rungs[r % len(rungs):] + rungs[:r % len(rungs)]:
                self._sync()
                t0 = time.perf_counter()
                units = run(rung)
                self._sync()
                samples[rung].append(
                    (time.perf_counter() - t0) * 1000.0 / max(units, 1))
        self.state.pos.zero_()
        self.state.tok.zero_()
        self._sync()
        return {k: statistics.median(v) for k, v in samples.items()}

    # -- streaming generation -------------------------------------------
    async def generate(self, ids: List[int], max_tokens: int = 512,
                       sampling: Optional[Dict] = None
                       ) -> AsyncIterator[List[int]]:
        """Async generator: acquire a slot, prefill, then yield token lists
        per block ([first], block, block, ...) until the consumer stops or
        the budget or the context runs out.  EOS is the consumer's.
        ``sampling``: per-request {"temperature", "top_k", "top_p"}
        (honoured with ``per_request_sampling``)."""
        self.start()
        with tracing.span("admission"):
            idx = await self.acquire()
        if self.per_request:
            self.set_sampling(idx, **(sampling or {}))
        try:
            _, _, cached = self._plan(list(ids))
            first_fut = self.submit_prefill(idx, ids)
            async for toks in self._stream_blocks(idx, cached, first_fut,
                                                  max_tokens):
                yield toks
        finally:
            self.release(idx)

    async def _stream_blocks(self, idx: int, cached: int,
                             first_fut: asyncio.Future, max_tokens: int
                             ) -> AsyncIterator[List[int]]:
        """Yield [first], then the blocks' token lists, keeping one block
        in flight ahead of the consumer."""
        n_sub = 0

        # block n+1 writes cache rows up to cached + (n+1)*block - 1 (and
        # the verifier's rows past them under speculation)
        def room() -> bool:
            return (cached + (n_sub + 1) * self.block + self._spec_margin
                    <= self.cfg.max_seq_len)

        # the first block chains on the device-carried token: submitted
        # before the prefill's result is known
        if room():
            blk_fut = self.submit_block(idx)
            n_sub += 1
        else:
            blk_fut = None
        first = await first_fut
        yield [first]
        produced = 1
        while blk_fut is not None and produced < max_tokens:
            nxt_fut = None
            if room() and produced + self.block < max_tokens:
                nxt_fut = self.submit_block(idx)   # issue-ahead
                n_sub += 1
            try:
                toks = await blk_fut
            except asyncio.CancelledError:
                break
            produced += len(toks)
            yield toks
            blk_fut = nxt_fut

    async def generate_streaming_prompt(self, parts, max_tokens: int = 512,
                                        sampling: Optional[Dict] = None
                                        ) -> AsyncIterator[List[int]]:
        """``generate`` for a prompt that is still being produced (the
        overlapped voice chat): ``parts`` is an async iterator of token-id
        lists, each prefilled into the slot as it arrives; generation
        starts when it ends, after only the last part's prefill.  The last
        part must be non-empty.  A producer that finds its earlier ids
        wrong raises ``PromptRestart`` with the final ids, and one plain
        fresh prefill recovers, so the output is always
        ``generate(final_ids)``'s.  Streaming prompts past the context cap
        drop their tail.  Without continuation programs (a card's pool
        whose warmup, like JAX's, captured none: ``chunked_prefill`` off)
        the parts are gathered and prefill once at the end, with the same
        output."""
        self.start()
        with tracing.span("admission"):
            idx = await self.acquire()
        if self.per_request:
            self.set_sampling(idx, **(sampling or {}))
        streams = (not self._graphs.enabled
                   or any(k[0] == "continue" for k in self._graphs.graphs))
        try:
            cap = self._ctx_cap()
            flush_at = max(16, self.buckets[0])
            buf: List[int] = []
            cached = 0
            started = False
            restart: Optional[List[int]] = None
            try:
                async for part in parts:
                    buf.extend(int(t) for t in part)
                    if not streams or (started and cached + 1 >= cap):
                        continue        # keep draining the producer
                    if not started and len(buf) >= 2:
                        head, buf = buf[: cap - 1][:-1], buf[-1:]
                        _, _, cached = self._plan(list(head))
                        self.submit_prefill(idx, head, final=False)
                        started = True
                    elif started and len(buf) > flush_at:
                        head, buf = buf[:-1], buf[-1:]
                        head = head[: cap - 1 - cached]
                        if head:
                            self.submit_prefill_extend(idx, head,
                                                       final=False)
                            cached += len(head)
            except PromptRestart as e:
                restart = list(e.ids)
            if restart is not None:
                self._drop_slot_prefills(idx)   # never two fresh prefills
                _, _, cached = self._plan(restart)   # for one slot at once
                first_fut = self.submit_prefill(idx, restart)
            elif not started:
                _, _, cached = self._plan(list(buf))
                first_fut = self.submit_prefill(idx, buf)
            else:
                tail = buf[: max(1, cap - cached)]
                first_fut = self.submit_prefill_extend(idx, tail,
                                                       final=True)
                cached += len(tail)
            async for toks in self._stream_blocks(idx, cached, first_fut,
                                                  max_tokens):
                yield toks
        finally:
            self.release(idx)
