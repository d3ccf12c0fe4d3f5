"""Streaming TTS HTTP server (stdlib asyncio HTTP/1.1).

The port's counterpart of ``llmvox_tpu/serve/server.py``:

- ``POST /tts``   {"text": ...} -> chunked ``application/octet-stream``
  body of raw float32 little-endian 24 kHz PCM;
- ``GET  /``      service info;
- ``GET  /stats`` per-request latency traces, and the pool's counters.

``POST /tts`` feeds the request's text to the text stream: a scripted
reply, the in-framework Llama on the card (``--llm_backend jax``,
``streams/llm.py``) or a HuggingFace model on the host
(``--llm_backend hf``, ``streams/hf_llm.py``).  ``/voicechat``,
``/multimodalchat`` and ``/vlmschat`` (they need ASR and the multimodal
LLM streams) answer 501 with a JSON error until they are ported.

Two serving modes, as in the JAX server:
- **dedicated** (default): one dual-replica scheduler; requests are
  serialized on it;
- **pooled**: with ``pool`` (``serve/pool.py::DecodePool`` or
  ``PoolLadder``), each request gets two ``PooledEngine`` slots and runs
  concurrently with up to ``pool.B // 2`` others; all in-flight requests
  decode through the pool's batched step.
"""
from __future__ import annotations

import asyncio
import collections
import json
from typing import Dict, Optional

from llmvox_tpu_torch.serve.pool import PooledEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
from llmvox_tpu_torch.streams.protocol import aiter_stream
from llmvox_tpu_torch.utils.config import ServeConfig
from llmvox_tpu_torch.utils.trace import Trace

_MAX_BODY = 64 * 1024 * 1024
_NOT_PORTED = ("/voicechat", "/multimodalchat", "/vlmschat")


class TTSServer:
    def __init__(self, scheduler: Optional[StreamingScheduler],
                 cfg: Optional[ServeConfig] = None, stream_model=None,
                 pool=None):
        self.scheduler = scheduler
        self.cfg = cfg or ServeConfig()
        self.stream_model = stream_model
        self.pool = pool
        if pool is not None:
            self._busy = asyncio.Semaphore(max(pool.B // 2, 1))
        else:
            self._busy = asyncio.Lock()
        self.traces = collections.deque(maxlen=50)

    # -- request -> text stream ---------------------------------------
    def _make_text_stream(self, path: str, body: Dict):
        """``/tts``: the request's text to the LLM stream, with the system
        prompt and the per-request sampling knobs (honoured by JAX's
        pooled LLM; the B=1 streams ignore them, as JAX's do)."""
        if path != "/tts":
            raise KeyError(path)
        knobs = {k: body[k]
                 for k in ("temperature", "top_p", "top_k", "max_tokens")
                 if k in body}
        return self.stream_model.predict(
            {"system": self.cfg.system_prompt, "prompt": body["text"],
             **knobs})

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
                    "version": "1.0.0",
                })
            elif method == "GET" and path == "/stats":
                obj = {"requests": list(self.traces)}
                if self.pool is not None:
                    obj["pool"] = self.pool.stats()
                await self._plain(writer, 200, obj)
            elif method == "POST" and path == "/tts":
                await self._stream_response(writer, path,
                                            json.loads(body or b"{}"))
            elif method == "POST" and path in _NOT_PORTED:
                await self._plain(writer, 501, {
                    "error": f"{path} is not available in llmvox_tpu_torch "
                             "yet; POST /tts is"})
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

    async def _plain(self, writer, status: int, obj: Dict) -> None:
        payload = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {status} X\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Access-Control-Allow-Origin: *\r\nConnection: close\r\n\r\n"
            .encode() + payload)
        await writer.drain()

    async def _stream_response(self, writer, path: str, body: Dict) -> None:
        # Build the text stream BEFORE the 200 header: a bad request
        # (missing "text") surfaces as a clean JSON error response, not a
        # status line spliced into an open chunked body.
        text_stream = aiter_stream(self._make_text_stream(path, body))
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/octet-stream\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Access-Control-Allow-Origin: *\r\nConnection: close\r\n\r\n")
        await writer.drain()
        try:
            async with self._busy:
                trace = Trace(path)
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

    def shutdown(self) -> None:
        """Thread-safe graceful stop: ``serve()`` returns and the listening
        socket closes.  Callable from any thread once ``serve()`` is up."""
        if getattr(self, "_loop", None) is not None:
            self._loop.call_soon_threadsafe(self._shutdown.set)

    def run(self) -> None:
        asyncio.run(self.serve())


def _replicas_device(engines, pool):
    """The card of the first TTS replica, or of the pool (a ladder's
    smallest): where the in-framework LLM lies beside the TTS."""
    if engines:
        return engines[0].device
    return getattr(pool, "pools", [pool])[0].device


def build_server(cfg: ServeConfig, engines, stream_model=None,
                 pool=None) -> TTSServer:
    """Wire the dual-replica scheduler (or, with ``pool``, the
    continuous-batching pool, which is warmed here) to a text-stream
    source per ``chat_type``, as the JAX ``build_server`` does: the given
    ``stream_model``; a ScriptedStream of ``cfg.scripted_reply``; or for
    ``chat_type`` "text" or "voice" the LLM of ``llm_backend``: "jax" the
    in-framework Llama on the replicas' card (its decode blocks captured
    here), "hf" a HuggingFace model on ``llm_device``.  The multimodal
    chat types are not ported."""
    scheduler = StreamingScheduler(engines, cfg) if engines else None
    if stream_model is None and cfg.scripted_reply:
        from llmvox_tpu_torch.streams.scripted import ScriptedStream
        stream_model = ScriptedStream([cfg.scripted_reply],
                                      eos_token=cfg.eos_token)
    if stream_model is None:
        if cfg.chat_type not in ("voice", "text"):
            raise NotImplementedError(
                f"chat_type={cfg.chat_type!r}: the multimodal and visual "
                "speech streams are not ported to llmvox_tpu_torch yet "
                "(ROADMAP queue 1 item 2)")
        if cfg.llm_backend == "jax":
            from llmvox_tpu_torch.streams.llm import build_llama_stream
            stream_model = build_llama_stream(
                cfg, device=_replicas_device(engines, pool))
        else:
            from llmvox_tpu_torch.streams.hf_llm import HFStreamModel
            stream_model = HFStreamModel(cfg)
        stream_model.load()
    if pool is not None:
        pool.warmup()
    if hasattr(stream_model, "warmup"):
        # the in-framework LLM: a CUDA graph per decode block rung
        stream_model.warmup()
    return TTSServer(scheduler, cfg, stream_model, pool=pool)
