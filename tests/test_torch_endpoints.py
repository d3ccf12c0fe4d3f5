"""Every endpoint of the port's server against the JAX server's, on the
tiny stack in f32 on the CPU: ``/voicechat`` with each ASR backend (the
host HF pipeline, the in-framework Whisper), ``/vlmschat`` with a local
tiny Qwen2.5-VL, ``/multimodalchat`` with the multimodal adapter on a tiny
GPT-2 (``tests/test_streams.py``'s substitution), each with the same
injected text stream on both sides and the chunk schedules equal; ``GET
/demo``; the port's ``RemoteStream`` against a fake SSE endpoint; the
CLI's ``--chat_type`` and ``--asr_backend`` flags; the event loop
during a serial ``/voicechat``, which the port awaits and JAX's server
blocks on; and the overlapped ``/voicechat`` through the pooled LLM
(the same audio as the serial path, the loop free)."""
import asyncio
import base64
import dataclasses
import http.client
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict

import numpy as np
import pytest
import torch

from llmvox_tpu.serve import server as jserver
from llmvox_tpu.serve.demo_page import DEMO_HTML as JAX_DEMO_HTML
from llmvox_tpu.streams import asr as jasr
from llmvox_tpu.streams.hf_multimodal import (
    HFStreamMultimodal as JMultimodal)
from llmvox_tpu.streams.hf_vlm import HFStreamVLM as JVLM
from llmvox_tpu.streams.remote import RemoteStream as JRemoteStream
from llmvox_tpu.tools.convert_ckpt import main as convert_main
from llmvox_tpu.utils.config import ServeConfig as JServeConfig
from llmvox_tpu_torch.serve import server as tserver
from llmvox_tpu_torch.serve.client import post_chunks, to_wave
from llmvox_tpu_torch.streams import asr as tasr
from llmvox_tpu_torch.streams.hf_multimodal import HFStreamMultimodal
from llmvox_tpu_torch.streams.hf_vlm import HFStreamVLM
from llmvox_tpu_torch.streams.remote import RemoteStream
from llmvox_tpu_torch.utils import config as tconfig

from tests.test_streams import _FakeTokenizer, _b64_png
from tests.test_torch_engine import (CODEC_TOL, _free_port, _jax_engines,
                                     _port_cfg, _port_engines, _Running,
                                     weights)  # noqa: F401 (a fixture)
from tests.test_whisper import _speechish
from tests.tiny_stack import SERVE_CFG

SLOW_S = 0.3
MAX_LAG_S = 0.05


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from tests.tiny_hf import build_tiny_whisper
    return build_tiny_whisper(str(tmp_path_factory.mktemp("tiny_whisper")))


def _b64(audio: np.ndarray) -> str:
    return base64.b64encode((audio * 32767).astype(np.int16).tobytes()
                            ).decode()


class _EchoStream:
    """An injected text stream that speaks back its prompt, so that the
    chunk schedule depends on the transcript; it notes each request."""

    def __init__(self, eos: str):
        self.eos, self.requests = eos, []

    def load(self):
        pass

    def predict(self, request):
        self.requests.append(request)
        return iter([f"You said {request.get('prompt', '')}.", " Thanks.",
                     self.eos])


def _asr(side: str, backend: str, model: str):
    if side == "jax":
        cfg = JServeConfig(asr_model=model, asr_device="cpu")
        asr = (jasr.JAXWhisperASR(cfg) if backend == "jax"
               else jasr.WhisperASR(cfg))
    else:
        cfg = tconfig.ServeConfig(asr_model=model, asr_device="cpu")
        asr = (tasr.WhisperModelASR(cfg, device="cpu") if backend == "jax"
               else tasr.WhisperASR(cfg))
    asr.load()
    return asr


def _serve_both(weights, path, body, make_stream, make_asr=None,  # noqa
                seed=None):
    """POST ``body`` to ``path`` on the JAX server and on the port's, each
    built by its ``build_server`` with ``make_stream(side)`` (and
    ``make_asr(side)``) on two replicas; returns each side's chunks and
    its stream."""
    out, streams = {}, {}
    for side in ("jax", "port"):
        port = _free_port()
        scfg = dataclasses.replace(SERVE_CFG, api_host="127.0.0.1",
                                   api_port=port)
        stream = streams[side] = make_stream(side)
        asr = make_asr(side) if make_asr else None
        if side == "jax":
            srv = jserver.build_server(scfg, _jax_engines(weights, scfg, 2),
                                       stream_model=stream, asr_model=asr)
        else:
            srv = tserver.build_server(_port_cfg(tconfig.ServeConfig, scfg),
                                       _port_engines(weights, scfg, 2),
                                       stream_model=stream, asr_model=asr)
        with _Running(srv, port):
            if seed is not None:
                torch.manual_seed(seed)
            out[side] = post_chunks("127.0.0.1", port, path, body,
                                    timeout=300)
    return out, streams


def _same_schedule(chunks, at_least: int = 2):
    lens = {side: [len(c) for _, c in ch] for side, ch in chunks.items()}
    assert lens["port"] == lens["jax"] and len(lens["port"]) >= at_least
    np.testing.assert_allclose(to_wave(chunks["port"]),
                               to_wave(chunks["jax"]), **CODEC_TOL)


# ---------------------------------------------------------------------------
# the endpoints, against the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["hf", "jax"])
def test_voicechat_equals_the_jax_server(weights, tiny_dir, backend):
    """``/voicechat``: the request's audio transcribed (task "transcribe",
    the source language forced), the transcript spoken back."""
    body = {"audio_base64": _b64(_speechish(2)),
            "source_language": "en", "target_language": "en"}
    chunks, streams = _serve_both(
        weights, "/voicechat", body,
        lambda side: _EchoStream(SERVE_CFG.eos_token),
        lambda side: _asr(side, backend, tiny_dir))
    prompts = [s.requests[-1]["prompt"] for s in streams.values()]
    assert prompts[0] == prompts[1] and prompts[0]
    assert streams["port"].requests[-1]["system"] == SERVE_CFG.system_prompt
    _same_schedule(chunks)


def test_vlmschat_equals_the_jax_server(weights, tiny_dir, tmp_path):
    """``/vlmschat``: the transcript and the image to a tiny Qwen2.5-VL
    (sampled from torch's global generator, seeded before each request,
    as ``tests/test_streams.py`` runs it)."""
    from tests.tiny_hf import build_tiny_qwen_vl
    model, proc = build_tiny_qwen_vl(str(tmp_path / "qwen"))
    knobs = dict(llm_max_tokens=8, llm_temperature=1.0, llm_top_p=0.9,
                 llm_top_k=40)

    def stream(side):
        cls, cfg_cls = ((JVLM, JServeConfig) if side == "jax"
                        else (HFStreamVLM, tconfig.ServeConfig))
        vlm = cls(dataclasses.replace(cfg_cls(), **knobs))
        vlm.model, vlm.processor = model, proc
        return vlm

    body = {"audio_base64": _b64(_speechish(3)), "image_base64": _b64_png(),
            "source_language": "en", "target_language": "en"}
    chunks, _ = _serve_both(weights, "/vlmschat", body, stream,
                            lambda side: _asr(side, "jax", tiny_dir),
                            seed=0)
    _same_schedule(chunks, at_least=1)


def test_multimodalchat_equals_the_jax_server(weights):
    """``/multimodalchat``: the audio and the images go to the multimodal
    model itself (no ASR); its prompt build, on a tiny GPT-2 behind a
    recording processor (``tests/test_streams.py``'s substitution)."""
    from transformers import GPT2Config, GPT2LMHeadModel
    from transformers.feature_extraction_utils import BatchFeature
    prompts = []

    class _Letters(_FakeTokenizer):
        def decode(self, ids, **kw):
            return "".join(chr(97 + int(i) % 24)
                           for i in np.atleast_1d(np.asarray(ids))) + ". "

    class _Proc:
        tokenizer = _Letters()

        def __call__(self, text, audios, images, return_tensors):
            prompts.append((text, len(audios), len(images or [])))
            ids = [1 + (ord(c) % 40) for c in text[:16]]
            return BatchFeature(
                {"input_ids": torch.tensor([ids], dtype=torch.long)})

    torch.manual_seed(0)
    model = GPT2LMHeadModel(GPT2Config(
        n_layer=1, n_head=2, n_embd=16, vocab_size=48, n_positions=64,
        bos_token_id=1, eos_token_id=47, pad_token_id=47)).eval()
    model.generation_config.eos_token_id = None

    def stream(side):
        cls, cfg_cls = ((JMultimodal, JServeConfig) if side == "jax"
                        else (HFStreamMultimodal, tconfig.ServeConfig))
        mm = cls(dataclasses.replace(cfg_cls(), llm_device="cpu",
                                     llm_max_tokens=6))
        mm.model, mm.processor = model, _Proc()
        return mm

    body = {"audio_base64": _b64(_speechish(4, 0.5)),
            "image_list": [_b64_png(28, 28)]}
    chunks, _ = _serve_both(weights, "/multimodalchat", body, stream)
    assert prompts[0] == prompts[1]
    assert prompts[1][0].startswith(f"<|system|>{SERVE_CFG.system_prompt}")
    assert prompts[1][1:] == (1, 1)
    _same_schedule(chunks, at_least=1)


def test_demo_page_and_info(weights):
    port = _free_port()
    scfg = _port_cfg(tconfig.ServeConfig, dataclasses.replace(
        SERVE_CFG, api_host="127.0.0.1", api_port=port,
        scripted_reply="Hi."))
    srv = tserver.build_server(scfg, _port_engines(weights, SERVE_CFG, 2))
    with _Running(srv, port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/demo")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/html")
        assert resp.read().decode() == JAX_DEMO_HTML
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/")
        assert json.loads(conn.getresponse().read())["demo"] == "GET /demo"


# ---------------------------------------------------------------------------
# the remote stream
# ---------------------------------------------------------------------------

class _FakeLLM(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        assert body["stream"] is True
        assert body["messages"][0]["role"] == "system"
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        self.wfile.write(b": a comment line\n\n")
        for delta in ["Hello", " there", "."]:
            chunk = {"choices": [{"delta": {"content": delta}}]}
            self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
        self.wfile.write(b"data: not json\n\n")
        self.wfile.write(b"data: [DONE]\n\n")

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def fake_llm():
    srv = HTTPServer(("127.0.0.1", 0), _FakeLLM)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    t.join(timeout=10)


def test_remote_stream_yields_the_jax_deltas(fake_llm):
    out = {}
    for side, cls, cfg_cls in (("jax", JRemoteStream, JServeConfig),
                               ("port", RemoteStream, tconfig.ServeConfig)):
        stream = cls(cfg_cls(eos_token="<|eot_id|>"), base_host="127.0.0.1",
                     base_port=fake_llm)
        stream.load()
        out[side] = list(stream.predict({"system": "sys", "prompt": "hi"}))
    assert out["port"] == out["jax"] == ["Hello", " there", ".",
                                         "<|eot_id|>"]


def test_remote_stream_raises_on_a_bad_endpoint():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]     # closed again: nothing listens
    stream = RemoteStream(tconfig.ServeConfig(), base_host="127.0.0.1",
                          base_port=dead)
    with pytest.raises(OSError):
        list(stream.predict({"system": "s", "prompt": "p"}))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(argv, monkeypatch):
    from tests.test_torch_llm_stream import SERVE_FLAGS, _flags, _serve_cli
    flags = {**SERVE_FLAGS, "scripted_reply": "Hi there."}
    return _serve_cli(_flags(flags) + argv, monkeypatch)


def test_cli_serves_voicechat_with_the_in_framework_asr(tiny_dir, tmp_path,
                                                        monkeypatch):
    """``--chat_type voice --asr_backend jax --asr_model <npz>`` builds the
    in-framework Whisper on the replicas' device, warms it, and answers
    ``/voicechat``."""
    from tests.test_torch_llm_stream import _Running as _CliRunning
    npz = str(tmp_path / "w.npz")
    convert_main(["whisper", tiny_dir, npz])
    srv, port, engines = _cli(["--chat_type", "voice", "--asr_backend",
                               "jax", "--asr_model", npz], monkeypatch)
    asr = srv.asr_model
    assert type(asr) is tasr.WhisperModelASR
    assert asr.device == engines[0].device
    assert sorted(asr._blocks.graphs) == [600, 1200, 3000]
    with _CliRunning(srv, port):
        chunks = post_chunks("127.0.0.1", port, "/voicechat",
                             {"audio_base64": _b64(_speechish(1))},
                             timeout=300)
    wav = to_wave(chunks)
    assert chunks and wav.size > 0 and np.isfinite(wav).all()


@pytest.mark.parametrize("chat_type,backend,stream,asr", [
    ("visual_speech", "hf", HFStreamVLM, tasr.WhisperASR),
    ("multimodal", "jax", HFStreamMultimodal, type(None)),
    ("voice", "hf", None, tasr.WhisperASR),
])
def test_cli_chat_type_and_asr_backend(chat_type, backend, stream, asr,
                                       monkeypatch):
    """Each chat type wires JAX's streams: the HF vision-language or
    multimodal model, and an ASR for "voice" and "visual_speech"."""
    for cls in (HFStreamVLM, HFStreamMultimodal, tasr.WhisperASR):
        monkeypatch.setattr(cls, "load", lambda self: None)
    argv = ["--chat_type", chat_type, "--asr_backend", backend]
    if stream is not None:
        # the multimodal chat types take their stream from the model
        argv += ["--scripted_reply", ""]
    srv, _, _ = _cli(argv, monkeypatch)
    if stream is not None:
        assert type(srv.stream_model) is stream
    assert type(srv.asr_model) is asr


def test_cli_refuses_a_quantized_in_framework_asr(monkeypatch):
    with pytest.raises(ValueError, match="346-349.*ROADMAP"):
        _cli(["--chat_type", "voice", "--asr_backend", "jax",
              "--quantize", "w4"], monkeypatch)


# ---------------------------------------------------------------------------
# the event loop during a serial /voicechat
# ---------------------------------------------------------------------------

async def _with_ticker(coro):
    """Run ``coro`` beside a coroutine that sleeps 1 ms in a loop; returns
    (coro's result, the ticker's lateness in seconds per wake-up)."""
    lags, stop = [], asyncio.Event()

    async def tick():
        while not stop.is_set():
            t0 = time.perf_counter()
            await asyncio.sleep(0.001)
            lags.append(time.perf_counter() - t0 - 0.001)

    ticker = asyncio.create_task(tick())
    try:
        return await coro, lags
    finally:
        stop.set()
        await ticker


def test_serial_voicechat_leaves_the_loop_free(tiny_dir):
    """The port's serial ``/voicechat`` awaits the ASR: with its prep
    launch slowed by 0.3 s on the dispatch thread, a 1 ms ticker on the
    loop is never 50 ms late, and the transcript reaches the stream.
    JAX's server calls ``run_asr`` on the loop: slowed as much, the
    ticker waits the whole 0.3 s (the divergence ROADMAP §3 records)."""
    body = {"audio_base64": _b64(_speechish(2)),
            "source_language": "en", "target_language": "en"}
    asr = _asr("port", "jax", tiny_dir)
    prep, threads = asr._prep, set()

    def slow_prep(*a):
        threads.add(threading.current_thread().name)
        time.sleep(SLOW_S)
        return prep(*a)

    asr._prep = slow_prep
    echo = _EchoStream(SERVE_CFG.eos_token)
    srv = tserver.TTSServer(None, tconfig.ServeConfig(), stream_model=echo,
                            asr_model=asr)
    _, lags = asyncio.run(_with_ticker(srv._make_text_stream("/voicechat",
                                                             body)))
    assert threads and all(t.startswith("dispatch-cpu") for t in threads)
    assert max(lags) < MAX_LAG_S, max(lags)
    assert echo.requests[-1]["prompt"] == asr.run_asr(body)

    jasr_model = _asr("jax", "jax", tiny_dir)
    run = jasr_model.run_asr
    jasr_model.run_asr = lambda b: time.sleep(SLOW_S) or run(b)
    jsrv = jserver.TTSServer(None, JServeConfig(),
                             stream_model=_EchoStream("<|eot_id|>"),
                             asr_model=jasr_model)

    async def jax_side():
        await asyncio.sleep(0.01)
        return jsrv._make_text_stream("/voicechat", body)

    _, jlags = asyncio.run(_with_ticker(jax_side()))
    assert max(jlags) >= SLOW_S * 0.9


# ---------------------------------------------------------------------------
# the overlapped /voicechat, through the pooled LLM
# ---------------------------------------------------------------------------

def _pooled_voice_server(weights, tiny_dir, overlap: bool, port: int = 0):
    """The port's server on two replicas with the tiny in-framework
    Whisper and a 2-layer pooled Llama (max_seq_len 384: the system prompt
    and the transcript fit the context, so the overlap path runs, as
    tests/test_whisper.py's JAX counterpart has it)."""
    from llmvox_tpu.models import llama as jl
    from llmvox_tpu_torch.models import llama as tl
    from llmvox_tpu_torch.serve.llm_pool import LLMPool
    from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
    from llmvox_tpu_torch.streams.llm import PooledLlamaStreamModel
    from tests.test_llama import _ToyTokenizer

    import jax
    lcfg = jl.LlamaConfig(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
                          n_embd=32, intermediate_size=64, max_seq_len=384)
    lparams = jax.device_get(jl.init_llama_params(jax.random.PRNGKey(0),
                                                  lcfg))
    scfg = dataclasses.replace(SERVE_CFG, api_host="127.0.0.1",
                               api_port=port, asr_model=tiny_dir,
                               asr_backend="jax", s2s_overlap=overlap)
    tcfg = _port_cfg(tconfig.ServeConfig, scfg)
    pool = LLMPool(lparams, tl.LlamaConfig(**dataclasses.asdict(lcfg)),
                   capacity=2, block=4, prefill_buckets=(8, 16, 32),
                   device="cpu")
    model = PooledLlamaStreamModel(pool, _ToyTokenizer(), max_tokens=10,
                                   eos_text=scfg.eos_token)
    asr = tasr.WhisperModelASR(tcfg, device="cpu")
    asr.load()
    engines = _port_engines(weights, scfg, 2)
    return tserver.TTSServer(StreamingScheduler(engines, tcfg), tcfg,
                             stream_model=model, asr_model=asr)


def _voice_body(seconds: float = 7) -> Dict:
    pcm = (_speechish(seconds) * 32768.0).astype(np.int16)
    return {"audio_base64": base64.b64encode(pcm.tobytes()).decode(),
            "source_language": "english", "target_language": "english"}


def test_voicechat_overlapped_matches_serial(weights, tiny_dir):
    """``/voicechat`` through the overlapped path (the in-framework
    Whisper's partial transcripts streaming into the pooled LLM's
    prefill) returns exactly the serial path's audio: overlap changes
    timing, never results."""
    body = _voice_body()
    out, streamed = {}, []
    for overlap in (True, False):
        port = _free_port()
        srv = _pooled_voice_server(weights, tiny_dir, overlap, port)
        real = srv.stream_model.predict_streaming

        def spy(request, texts, _real=real):
            streamed.append(request)
            return _real(request, texts)
        srv.stream_model.predict_streaming = spy
        with _Running(srv, port):
            out[overlap] = post_chunks("127.0.0.1", port, "/voicechat",
                                       body, timeout=300)
    assert len(streamed) == 1            # the overlapped run, only
    assert [len(c) for _, c in out[True]] == [len(c) for _, c in out[False]]
    wav = to_wave(out[True])
    assert wav.size > 0 and np.isfinite(wav).all()
    np.testing.assert_array_equal(wav, to_wave(out[False]))


def test_overlapped_voicechat_leaves_the_loop_free(weights, tiny_dir):
    """The overlapped ``/voicechat`` with the ASR's prep launch slowed by
    0.3 s on the dispatch thread: a 1 ms ticker on the loop is never
    50 ms late while the text stream is built and drained, and the text
    equals the serial path's."""
    body = _voice_body(3)
    srv = _pooled_voice_server(weights, tiny_dir, True)
    asr = srv.asr_model
    prep, threads = asr._prep, set()

    def slow_prep(*a):
        threads.add(threading.current_thread().name)
        time.sleep(SLOW_S)
        return prep(*a)

    asr._prep = slow_prep

    async def overlapped():
        stream = await srv._make_text_stream("/voicechat", body)
        text = "".join([d async for d in stream])
        srv.stream_model.pool.stop()
        return text

    text, lags = asyncio.run(_with_ticker(overlapped()))
    assert threads and all(t.startswith("dispatch-cpu") for t in threads)
    assert max(lags) < MAX_LAG_S, max(lags)
    serial = _pooled_voice_server(weights, tiny_dir, False)

    async def plain():
        stream = await serial._make_text_stream("/voicechat", body)
        out = "".join([d async for d in stream])
        serial.stream_model.pool.stop()
        return out

    assert text == asyncio.run(plain()) and text.endswith(
        SERVE_CFG.eos_token)
