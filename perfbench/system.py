"""The system under test, built in process from a cell's files, and the
taps that read what it served.

The port's ``TTSServer`` (``serve/server.build_server``) runs on its own
thread and event loop.  Its text comes from the cell's text source:
``instant`` speaks the request's own text word by word, as an LLM that
answered instantly would, through the same delta protocol as the LLM
streams.  The taps wrap a few methods of the port's classes for the life
of a run: they note which request and which replica each decoded block
and each sentence reset belongs to (two context variables, set where the
server starts a request and where the scheduler starts a replica's
consumer, which the tasks of both inherit), and, in a traced run, the
host's spans around a pool step's launch and a synthesis batch.  They
change no argument and no result.
"""
from __future__ import annotations

import asyncio
import contextlib
import contextvars
import dataclasses
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

from perfbench import weights as W

REQUEST = contextvars.ContextVar("perfbench_request", default=None)
REPLICA = contextvars.ContextVar("perfbench_replica", default=None)


class InstantText:
    """A text stream that speaks the request's own text, one word a delta,
    then the eos token."""

    def __init__(self, eos: str):
        self.eos = eos

    def load(self) -> None:
        pass

    def predict(self, request: Dict):
        words = request["prompt"].split(" ")

        async def gen():
            for w in words:
                yield w
            yield self.eos
        return gen()


class _Logged:
    """A decoded block's pending result that notes its tokens on fetch."""

    def __init__(self, pending, taps):
        self.pending, self.taps = pending, taps

    def _keep(self, got):
        toks = got[0] if isinstance(got, tuple) else got
        self.taps.block(list(toks))
        return got

    def fetch(self):
        return self._keep(self.pending.fetch())

    async def afetch(self):
        return self._keep(await self.pending.afetch())


class Taps:
    """Per request (keyed by its text): per replica the sentences' served
    tokens, with each block's fetch time and first position."""

    def __init__(self, spans: bool):
        self.lock = threading.Lock()
        self.served: Dict[str, Dict[int, List[List[int]]]] = {}
        # per request: the text stream's deltas, the LLM's token blocks
        self.deltas: Dict[str, List[str]] = {}
        self.llm: Dict[str, List[tuple]] = {}
        self.blocks: List[tuple] = []      # (fetch time, first pos, n)
        self.spans: List[tuple] = [] if spans else None
        self._saved: List[tuple] = []

    # -- records ---------------------------------------------------------
    def _sentences(self) -> Optional[List[List[int]]]:
        req, rep = REQUEST.get(), REPLICA.get()
        if req is None or rep is None:
            return None
        return self.served.setdefault(req, {}).setdefault(rep, [])

    def new_sentence(self) -> None:
        with self.lock:
            s = self._sentences()
            if s is not None:
                s.append([])

    def block(self, toks: List[int]) -> None:
        now = time.monotonic()
        with self.lock:
            s = self._sentences()
            if s is None:
                return
            if not s:
                s.append([])
            self.blocks.append((now, len(s[-1]), len(toks)))
            s[-1].extend(toks)

    def delta(self, req, d: str) -> None:
        with self.lock:
            self.deltas.setdefault(req, []).append(d)

    def llm_block(self, req, toks) -> None:
        now = time.monotonic()
        with self.lock:
            self.llm.setdefault(req, []).append((now, [int(t) for t in toks]))

    def span(self, name: str, t0: float, t1: float) -> None:
        if self.spans is not None:
            with self.lock:
                self.spans.append((t0, t1, name))

    # -- wrapping --------------------------------------------------------
    def _patch(self, cls, name, make):
        orig = cls.__dict__[name]
        self._saved.append((cls, name, orig))
        setattr(cls, name, make(orig))

    def install(self) -> None:
        from llmvox_tpu_torch.serve.engine import TTSEngine
        from llmvox_tpu_torch.serve.pool import DecodePool, PooledEngine
        from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
        from llmvox_tpu_torch.serve.server import TTSServer
        taps = self

        def stream_response(orig):
            async def call(srv, writer, path, body):
                REQUEST.set(body.get("text"))
                return await orig(srv, writer, path, body)
            return call

        def consumer(orig):
            async def call(sched, index, *a, **k):
                REPLICA.set(index)
                return await orig(sched, index, *a, **k)
            return call

        def new_state(orig):
            def call(eng, *a, **k):
                taps.new_sentence()
                return orig(eng, *a, **k)
            return call

        def decode(orig):
            def call(eng, *a, **k):
                pending, state = orig(eng, *a, **k)
                return _Logged(pending, taps), state
            return call

        def timed(name):
            def make(orig):
                def call(obj, *a, **k):
                    t0 = time.monotonic()
                    try:
                        return orig(obj, *a, **k)
                    finally:
                        taps.span(name, t0, time.monotonic())
                return call
            return make

        def predict(orig):
            def call(model, request, *a, **k):
                req = REQUEST.get()
                gen = orig(model, request, *a, **k)

                async def rec():
                    async for d in gen:
                        taps.delta(req, d)
                        yield d
                return rec()
            return call

        def generate(orig):
            def call(pool, *a, **k):
                req = REQUEST.get()
                gen = orig(pool, *a, **k)

                async def rec():
                    try:
                        async for toks in gen:
                            taps.llm_block(req, toks)
                            yield toks
                    finally:
                        await gen.aclose()
                return rec()
            return call

        from llmvox_tpu_torch.serve.llm_pool import LLMPool
        from llmvox_tpu_torch.streams.llm import PooledLlamaStreamModel
        self._patch(PooledLlamaStreamModel, "predict", predict)
        self._patch(LLMPool, "generate", generate)
        if self.spans is not None:
            self._patch(LLMPool, "_launch", timed("LLM pool launch"))
        self._patch(TTSServer, "_stream_response", stream_response)
        self._patch(StreamingScheduler, "_consumer", consumer)
        for cls in (TTSEngine, PooledEngine):
            self._patch(cls, "new_state", new_state)
            for name in ("decode_block_async", "decode_block_fused_async"):
                self._patch(cls, name, decode)
        if self.spans is not None:
            self._patch(DecodePool, "_launch", timed("pool step launch"))
            self._patch(DecodePool, "_synth_batch",
                        timed("pool synthesis batch"))
            self._patch(TTSEngine, "synthesize", timed("replica synthesis"))

    def uninstall(self) -> None:
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)
        self._saved.clear()

    def tokens_between(self, t0: float, t1: float):
        """(n, first pos) of the blocks fetched in [t0, t1)."""
        with self.lock:
            return [(n, p) for t, p, n in self.blocks if t0 <= t < t1]


class LoopLag:
    """A coroutine on the server's event loop that sleeps 1 ms in a loop
    and notes how late each wake-up is (a copy of ``chip_smoke._LoopLag``)."""

    def __init__(self, loop):
        self.lags: List[float] = []
        self._stop = False

        async def tick():
            while not self._stop:
                t0 = time.perf_counter()
                await asyncio.sleep(0.001)
                self.lags.append(time.perf_counter() - t0 - 0.001)

        self._done = asyncio.run_coroutine_threadsafe(tick(), loop)

    def stop(self) -> List[float]:
        self._stop = True
        self._done.result(timeout=30)
        return self.lags


class ServerThread:
    """A server's ``serve()`` on its own thread and event loop (a copy of
    ``chip_smoke._Server``)."""

    def __init__(self, srv, port: int):
        self.srv, self.port = srv, port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_until_complete,
                                       args=(srv.serve(),), daemon=True)

    def start(self) -> None:
        self.thread.start()
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=0.2):
                    return
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("server did not start")

    def stop(self) -> None:
        self.srv.shutdown()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("server did not stop")
        self.loop.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class System:
    """One cell's server, built and warmed: ``laps`` holds the set-up's
    steps in seconds."""

    def __init__(self, config: Dict, cell: Dict, seed: int, device: str,
                 laps: Dict[str, float]):
        from llmvox_tpu_torch.codec.codec import WavCodec
        from llmvox_tpu_torch.serve.pool import DecodePool
        from llmvox_tpu_torch.serve.server import build_server
        from llmvox_tpu_torch.utils import graphs
        from llmvox_tpu_torch.utils.config import (CodecConfig,
                                                   DecoderConfig,
                                                   ServeConfig)
        self.device = torch.device(device)
        self.port = free_port()
        dcfg = DecoderConfig(**config["decoder"])
        if config.get("assumed", {}).get("eoa_disabled"):
            dcfg = dataclasses.replace(dcfg, eoa_token_id=-1)
        ccfg = CodecConfig(**config["codec"])
        scfg = ServeConfig(**cell.get("serve", {}), api_host="127.0.0.1",
                           api_port=self.port)
        dtype = getattr(torch, config["dtype"]["decoder"])
        self.dcfg, self.ccfg, self.scfg = dcfg, ccfg, scfg

        t = time.perf_counter()
        self.tts = {"decoder": W.decoder_tree(seed, dcfg, self.device, dtype),
                    "text_table": W.text_table(seed, dcfg, self.device),
                    "codec": W.codec_tree(seed, ccfg, self.device),
                    "dcfg": dcfg, "ccfg": ccfg, "scfg": scfg,
                    "eos": scfg.eos_token, "eoa": dcfg.eoa_token_id}
        self._sync()
        laps["weights"] = time.perf_counter() - t

        t = time.perf_counter()
        cap0, cap_s0 = graphs.CAPTURES, graphs.CAPTURE_S
        self.codec = WavCodec(self.tts["codec"], ccfg,
                              buckets=scfg.chunk_buckets, device=self.device)
        self.pool = None
        engines = []
        if scfg.pool_capacity > 0:
            self.pool = DecodePool(self.tts["decoder"],
                                   self.tts["text_table"], self.codec,
                                   capacity=scfg.pool_capacity, dcfg=dcfg,
                                   scfg=scfg, device=self.device,
                                   cache_dtype=dtype)
        else:
            from llmvox_tpu_torch.serve.engine import TTSEngine
            codecs = [self.codec, WavCodec(self.tts["codec"], ccfg,
                                           buckets=scfg.chunk_buckets,
                                           device=self.device)]
            engines = [TTSEngine(self.tts["decoder"], self.tts["text_table"],
                                 c, dcfg, scfg, device=self.device,
                                 cache_dtype=dtype) for c in codecs]
            for e in engines:
                e.warmup()
        self.engines = engines
        self.codecs = [self.codec] + [e.codec for e in engines
                                      if e.codec is not self.codec]
        self.text = cell["text"]
        self.llm_pool = self.llm_tree = self.lcfg = None
        if self.text == "instant":
            stream = InstantText(scfg.eos_token)
        else:
            stream = self._llm(config, scfg, seed, laps)
        self.server = build_server(scfg, engines, stream_model=stream,
                                   pool=self.pool)
        self._sync()
        laps["graph captures and first replays"] = time.perf_counter() - t
        laps["of which captures"] = graphs.CAPTURE_S - cap_s0
        self.captured = graphs.CAPTURES - cap0

    def _llm(self, config: Dict, scfg, seed: int, laps: Dict[str, float]):
        """The in-framework LLM behind a continuous-batching pool, as
        ``streams/llm.py::build_llama_stream`` builds it for
        ``--llm_pool_capacity``, over weights made here: the byte
        tokenizer, the system prompt's prefix cached."""
        from llmvox_tpu_torch.models.llama import LlamaConfig
        from llmvox_tpu_torch.serve.llm_pool import LLMPool
        from llmvox_tpu_torch.streams.llm import (ByteTokenizer,
                                                  PooledLlamaStreamModel)
        lcfg = LlamaConfig(**config["llm"])
        dtype = getattr(torch, config["dtype"]["llm"])
        t = time.perf_counter()
        self.llm_tree = W.llm_tree(seed, lcfg, self.device, dtype)
        W.speakable_head(self.llm_tree)
        self.lcfg = lcfg
        self._sync()
        laps["LLM weights"] = time.perf_counter() - t
        self.llm_pool = LLMPool(
            self.llm_tree, lcfg, capacity=scfg.llm_pool_capacity,
            block=scfg.llm_block, first_block=scfg.llm_first_block,
            temperature=scfg.llm_temperature, top_k=scfg.llm_top_k,
            top_p=scfg.llm_top_p, dtype=dtype, device=self.device,
            prefill_buckets=tuple(scfg.llm_prefill_buckets),
            pipeline_depth=scfg.pool_pipeline_depth,
            prefill_merge=scfg.llm_prefill_merge,
            chunked_prefill=scfg.llm_chunked_prefill)
        model = PooledLlamaStreamModel(self.llm_pool, ByteTokenizer(),
                                       max_tokens=scfg.llm_max_tokens,
                                       eos_text=scfg.eos_token)
        if scfg.llm_prefix_cache and scfg.system_prompt:
            model.enable_prefix_cache(scfg.system_prompt)
        return model

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def quiet(self):
        """No launch on the card while held: a task that waits occupies the
        card's one dispatch thread (every decode step, LLM iteration and
        fused vocode), and the codecs' locks hold the synthesis threads.
        The profiler starts and stops under it."""
        from llmvox_tpu_torch.utils.device import dispatch_executor
        entered, release = threading.Event(), threading.Event()

        def hold():
            entered.set()
            release.wait(600)

        fut = dispatch_executor(self.device).submit(hold)
        held = []
        try:
            if not entered.wait(60):
                raise RuntimeError("the dispatch thread did not come free")
            for c in self.codecs:
                c._lock.acquire()
                held.append(c._lock)
            yield
        finally:
            for lock in held:
                lock.release()
            release.set()
            fut.result(timeout=60)

    def counters(self) -> Dict[str, float]:
        """The program's own counters, read now."""
        from llmvox_tpu_torch.utils import graphs
        out = {"captures": graphs.CAPTURES}
        if self.pool is not None:
            p = self.pool
            out.update(pool_steps=p.steps, pool_decode_steps=p.decode_steps,
                       pool_dispatch_s=p.dispatch_s,
                       pool_merged_steps=p.merged_steps,
                       pool_synth_calls=p.synth_calls)
        if self.engines:
            out["engine_decode_steps"] = sum(e.decode_steps
                                             for e in self.engines)
        if self.llm_pool is not None:
            q = self.llm_pool
            out.update(llm_steps=q.steps, llm_decode_steps=q.decode_steps,
                       llm_dispatch_s=q.dispatch_s,
                       llm_prefill_calls=q.prefill_calls)
        return out

    def close(self) -> None:
        """Drop every reference to the program's state."""
        self.server = self.pool = self.codec = self.llm_pool = None
        self.engines, self.codecs = [], []
