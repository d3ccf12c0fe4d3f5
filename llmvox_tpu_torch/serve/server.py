"""Streaming TTS HTTP server (stdlib asyncio HTTP/1.1).

The port's counterpart of ``llmvox_tpu/serve/server.py``, with the same
endpoints:

- ``POST /tts``            {"text": ...}
- ``POST /voicechat``      {"source_language", "target_language",
                            "audio_base64"}
- ``POST /multimodalchat`` {"audio_base64", "image_list"}
- ``POST /vlmschat``       {"source_language", "target_language",
                            "audio_base64", "image_base64"}
- ``GET  /``               service info
- ``GET  /demo``           the browser demo page
- ``GET  /stats``          the last 1024 requests' summaries (id,
                           admission wait, first text, first audio,
                           end), the TTS pool's counters, the pooled
                           LLM's (``llm_pool``, JAX's keys, and
                           ``llm_pool_host``, the port's host seconds
                           and prefill tokens) and the span recorder's
                           (``trace``)

A POST answers a chunked ``application/octet-stream`` body of raw float32
little-endian 24 kHz PCM.  Its text comes from the text stream: a
scripted reply, the in-framework Llama on the card (``--llm_backend
jax``, ``streams/llm.py``), a HuggingFace model on the host
(``--llm_backend hf``), or for the multimodal chat types the HF
multimodal and vision-language streams.  ``/voicechat`` and ``/vlmschat``
transcribe the request's audio first (``streams/asr.py``: the host HF
pipeline, or ``--asr_backend jax``, the in-framework Whisper on the
replicas' card).  JAX's serial path calls ``run_asr`` on the event loop;
here it runs on a worker thread and is awaited, so the loop is never
held for a transcription (ROADMAP §3).  The overlapped ``/voicechat``
(``s2s_overlap``, the default: partial transcripts of
``transcribe_stream_async`` streamed into the LLM's prefill) is taken, as
in JAX, when the ASR streams and the text stream has
``predict_streaming``: the pooled LLM (``--llm_pool_capacity > 0``,
``streams/llm.py::PooledLlamaStreamModel``).

Two serving modes, as in the JAX server:
- **dedicated** (default): one dual-replica scheduler; requests are
  serialized on it;
- **pooled**: with ``pool`` (``serve/pool.py::DecodePool`` or
  ``PoolLadder``), each request gets two ``PooledEngine`` slots and runs
  concurrently with up to ``pool.B // 2`` others; all in-flight requests
  decode through the pool's batched step.

Each request is a ``utils/trace.py::Trace`` under its id (``REQUEST``,
which the request's tasks inherit), from a parsed body to its last chunk:
a ``request`` span carrying its marks, its wait for a seat an
``admission`` span, ``admitted`` marked when it has one.
"""
from __future__ import annotations

import asyncio
import collections
import json
from typing import Dict, Optional

from llmvox_tpu_torch.serve.demo_page import DEMO_HTML
from llmvox_tpu_torch.serve.pool import PooledEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
from llmvox_tpu_torch.streams.protocol import aiter_stream
from llmvox_tpu_torch.utils import trace as tracing
from llmvox_tpu_torch.utils.config import ServeConfig

_MAX_BODY = 64 * 1024 * 1024
_POST = ("/tts", "/voicechat", "/multimodalchat", "/vlmschat")


class TTSServer:
    def __init__(self, scheduler: Optional[StreamingScheduler],
                 cfg: Optional[ServeConfig] = None, stream_model=None,
                 asr_model=None, pool=None):
        self.scheduler = scheduler
        self.cfg = cfg or ServeConfig()
        self.stream_model = stream_model
        self.asr_model = asr_model
        self.pool = pool
        if pool is not None:
            self._busy = asyncio.Semaphore(max(pool.B // 2, 1))
        else:
            self._busy = asyncio.Lock()
        self.traces = collections.deque(maxlen=1024)
        self._requests = 0

    # -- request -> text stream ---------------------------------------
    async def _transcribe(self, path: str, body: Dict) -> str:
        """``run_asr`` on a worker thread, awaited: the loop runs on while
        the ASR decodes (its launches are the card's dispatch thread's)."""
        if self.asr_model is None:
            raise RuntimeError(f"{path} needs an ASR model: serve with "
                               "chat_type 'voice' or 'visual_speech'")
        return await asyncio.get_running_loop().run_in_executor(
            None, self.asr_model.run_asr, body)

    async def _make_text_stream(self, path: str, body: Dict):
        """The request's text stream, as JAX's ``_make_text_stream`` makes
        it: the system prompt and the per-request sampling knobs (honoured
        by JAX's pooled LLM; the B=1 streams ignore them, as JAX's do)."""
        cfg = self.cfg
        system = cfg.system_prompt
        knobs = {k: body[k]
                 for k in ("temperature", "top_p", "top_k", "max_tokens")
                 if k in body}
        if path == "/tts":
            return self.stream_model.predict(
                {"system": system, "prompt": body["text"], **knobs})
        if path == "/voicechat":
            # the overlapped speech-to-speech path: stable partial
            # transcripts stream into the LLM's prefill while the ASR
            # finishes; single-window audio only
            if (cfg.s2s_overlap
                    and hasattr(self.asr_model, "transcribe_stream_async")
                    and hasattr(self.stream_model, "predict_streaming")):
                audio = self.asr_model.decode_base64_audio(
                    body["audio_base64"])
                if self.asr_model.stream_supported(audio):
                    source = body.get("source_language",
                                      cfg.asr_default_language)
                    target = body.get("target_language", source)
                    task = ("translate" if source != target
                            else "transcribe")
                    texts = self.asr_model.transcribe_stream_async(
                        audio, task=task, language=source)

                    async def stripped(src):
                        # run_asr strips the final transcript; partial
                        # prompts must match its final text exactly
                        async for txt, done in src:
                            yield txt.strip(), done

                    return self.stream_model.predict_streaming(
                        {"system": system, **knobs}, stripped(texts))
            prompt = await self._transcribe(path, body)
            return self.stream_model.predict(
                {"system": system, "prompt": prompt, **knobs})
        if path == "/multimodalchat":
            return self.stream_model.predict(
                {"system": system, "audio_data": body["audio_base64"],
                 "images_data": body.get("image_list", [])})
        if path == "/vlmschat":
            prompt = await self._transcribe(path, body)
            return self.stream_model.predict(
                {"system": system, "prompt": prompt,
                 "image_base64": body["image_base64"]})
        raise KeyError(path)

    # -- HTTP plumbing --------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            if not request_line:
                return
            method, path, _ = request_line.decode().split(" ", 2)
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", 0))
            body = b""
            if length:
                if length > _MAX_BODY:
                    await self._plain(writer, 413, {"error": "body too large"})
                    return
                body = await reader.readexactly(length)

            if method == "GET" and path == "/":
                await self._plain(writer, 200, {
                    "message": "Streaming TTS API (LLMVoX, PyTorch/CUDA)",
                    "usage": 'POST /tts with {"text": "..."}',
                    "demo": "GET /demo",
                    "version": "1.0.0",
                })
            elif method == "GET" and path == "/demo":
                await self._html(writer, DEMO_HTML)
            elif method == "GET" and path == "/stats":
                obj = {"requests": list(self.traces)}
                if self.pool is not None:
                    obj["pool"] = self.pool.stats()
                llm_pool = getattr(self.stream_model, "pool", None)
                if llm_pool is not None and hasattr(llm_pool, "stats"):
                    obj["llm_pool"] = llm_pool.stats()
                    obj["llm_pool_host"] = llm_pool.host_stats()
                obj["trace"] = tracing.counters()
                await self._plain(writer, 200, obj)
            elif method == "POST" and path in _POST:
                await self._stream_response(writer, path,
                                            json.loads(body or b"{}"))
            else:
                await self._plain(writer, 404, {"error": "not found"})
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — report, don't crash the server
            try:
                await self._plain(writer, 500, {"error": str(e)})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _html(self, writer, html: str) -> None:
        payload = html.encode()
        writer.write(
            "HTTP/1.1 200 OK\r\nContent-Type: text/html; charset=utf-8\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n".encode() + payload)
        await writer.drain()

    async def _plain(self, writer, status: int, obj: Dict) -> None:
        payload = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {status} X\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Access-Control-Allow-Origin: *\r\nConnection: close\r\n\r\n"
            .encode() + payload)
        await writer.drain()

    async def _stream_response(self, writer, path: str, body: Dict) -> None:
        self._requests += 1
        trace = tracing.Trace(path, self._requests)
        tracing.REQUEST.set(trace.id)
        with tracing.span("request", trace.marks):
            await self._respond(writer, path, body, trace)

    async def _respond(self, writer, path: str, body: Dict,
                       trace: tracing.Trace) -> None:
        # Build the text stream (and transcribe) BEFORE the 200 header: a
        # bad request (missing "text", an ASR failure) surfaces as a clean
        # JSON error response, not a status line spliced into an open
        # chunked body.
        text_stream = aiter_stream(await self._make_text_stream(path, body))
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/octet-stream\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Access-Control-Allow-Origin: *\r\nConnection: close\r\n\r\n")
        await writer.drain()
        try:
            with tracing.span("admission"):
                await self._busy.acquire()
            try:
                trace.mark("admitted")
                if self.pool is not None:
                    engines = [PooledEngine(self.pool, self.cfg),
                               PooledEngine(self.pool, self.cfg)]
                    scheduler = StreamingScheduler(engines, self.cfg)
                else:
                    engines = []
                    scheduler = self.scheduler
                try:
                    async for chunk in scheduler.run(text_stream,
                                                     trace=trace):
                        writer.write(f"{len(chunk):x}\r\n".encode() + chunk
                                     + b"\r\n")
                        await writer.drain()
                finally:
                    for e in engines:
                        e.close()
                self.traces.append(trace.summary())
            finally:
                self._busy.release()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            raise
        except Exception as e:  # noqa: BLE001 — streaming already began
            # The 200 header is on the wire; a second status line would be
            # malformed HTTP.  End the chunked body instead, so the client
            # sees a short (truncated-audio) but valid response.
            print(f"[server] error mid-stream on {path}: {e!r}")
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    # -- lifecycle -------------------------------------------------------
    async def serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown = asyncio.Event()
        server = await asyncio.start_server(
            self._handle, self.cfg.api_host, self.cfg.api_port)
        addrs = ", ".join(str(s.getsockname()) for s in server.sockets)
        print(f"LLMVoX (PyTorch/CUDA) serving on {addrs}", flush=True)
        async with server:
            forever = asyncio.create_task(server.serve_forever())
            stop = asyncio.create_task(self._shutdown.wait())
            await asyncio.wait([forever, stop],
                               return_when=asyncio.FIRST_COMPLETED)
            forever.cancel()
            try:
                await forever
            except asyncio.CancelledError:
                pass
            if self.pool is not None:
                self.pool.stop()
            llm_pool = getattr(self.stream_model, "pool", None)
            if hasattr(llm_pool, "stop"):
                llm_pool.stop()

    def shutdown(self) -> None:
        """Thread-safe graceful stop: ``serve()`` returns and the listening
        socket closes.  Callable from any thread once ``serve()`` is up."""
        if getattr(self, "_loop", None) is not None:
            self._loop.call_soon_threadsafe(self._shutdown.set)

    def run(self) -> None:
        asyncio.run(self.serve())


def _replicas_device(engines, pool):
    """The card of the first TTS replica, or of the pool (a ladder's
    smallest): where the in-framework LLM and ASR lie beside the TTS."""
    if engines:
        return engines[0].device
    return getattr(pool, "pools", [pool])[0].device


def build_server(cfg: ServeConfig, engines, stream_model=None,
                 asr_model=None, pool=None) -> TTSServer:
    """Wire the dual-replica scheduler (or, with ``pool``, the
    continuous-batching pool, which is warmed here) to a text-stream
    source per ``chat_type``, as the JAX ``build_server`` does: the given
    ``stream_model``; a ScriptedStream of ``cfg.scripted_reply``; for
    "text" or "voice" the LLM of ``llm_backend`` ("jax": the in-framework
    Llama on the replicas' card, B=1 or, with ``llm_pool_capacity > 0``,
    pooled, its programs captured here; "hf": a HuggingFace model on
    ``llm_device``); for "multimodal" the HF
    multimodal stream; for "visual_speech" the HF vision-language stream.
    "voice" and "visual_speech" also build the ASR of ``asr_backend``
    ("jax": the in-framework Whisper on the replicas' card, its buckets
    captured here; "hf": the host pipeline)."""
    scheduler = StreamingScheduler(engines, cfg) if engines else None
    if stream_model is None and cfg.scripted_reply:
        from llmvox_tpu_torch.streams.scripted import ScriptedStream
        stream_model = ScriptedStream([cfg.scripted_reply],
                                      eos_token=cfg.eos_token)
    if stream_model is None:
        if cfg.chat_type in ("voice", "text"):
            if cfg.llm_backend == "jax":
                from llmvox_tpu_torch.streams.llm import build_llama_stream
                stream_model = build_llama_stream(
                    cfg, device=_replicas_device(engines, pool))
            else:
                from llmvox_tpu_torch.streams.hf_llm import HFStreamModel
                stream_model = HFStreamModel(cfg)
        elif cfg.chat_type == "multimodal":
            from llmvox_tpu_torch.streams.hf_multimodal import (
                HFStreamMultimodal)
            stream_model = HFStreamMultimodal(cfg)
        elif cfg.chat_type == "visual_speech":
            from llmvox_tpu_torch.streams.hf_vlm import HFStreamVLM
            stream_model = HFStreamVLM(cfg)
        stream_model.load()
    if asr_model is None and cfg.chat_type in ("voice", "visual_speech"):
        from llmvox_tpu_torch.streams.asr import build_asr
        asr_model = build_asr(cfg, device=_replicas_device(engines, pool))
        asr_model.load()
    if pool is not None:
        pool.warmup()
    if hasattr(stream_model, "warmup"):
        # the in-framework LLM: a CUDA graph per decode block rung (the
        # pooled LLM: per prefill, continuation and decode block)
        stream_model.warmup()
    if hasattr(asr_model, "warmup"):
        # the in-framework Whisper: the graphs of every context bucket
        asr_model.warmup()
    return TTSServer(scheduler, cfg, stream_model, asr_model, pool=pool)
