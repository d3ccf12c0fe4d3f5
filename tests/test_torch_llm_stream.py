"""The port's LLM text streams against the JAX package's, on the CPU: the
in-framework Llama stream (``llmvox_tpu_torch/streams/llm.py``, the
counterpart of ``llmvox_tpu/streams/jax_llm.py``) from a tiny npz that the
JAX package writes, its helpers, its CUDA-graph and dispatch-thread
discipline (with the graph path stubbed to run on the CPU), the HF host
backend, and ``python -m llmvox_tpu_torch.serve`` answering ``/tts`` from
each LLM."""
import asyncio
import dataclasses
import http.client
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.models import llama as jl
from llmvox_tpu.serve import server as jserver
from llmvox_tpu.serve.engine import TTSEngine as JTTSEngine
from llmvox_tpu.streams import jax_llm
from llmvox_tpu.streams.hf_llm import HFStreamModel as JHFStreamModel
from llmvox_tpu.train.checkpoint import save_params_npz
from llmvox_tpu.utils.config import ServeConfig as JServeConfig
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.ops import cuda_int4_mm
from llmvox_tpu_torch.serve import server as tserver
from llmvox_tpu_torch.serve.client import post_chunks, to_wave
from llmvox_tpu_torch.streams import hf_llm, llm
from llmvox_tpu_torch.streams.protocol import aiter_stream
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import graphs
from llmvox_tpu_torch.utils import params as tparams

from tests.test_streams import _FakeTokenizer
from tests.tiny_stack import CODEC_CFG, DEC_CFG

CFG = jl.LlamaConfig(vocab_size=384, n_layer=2, n_head=4, n_kv_head=2,
                     n_embd=64, intermediate_size=128, max_seq_len=256)
MARGS = ("vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd",
         "intermediate_size", "max_seq_len")
REQUEST = {"system": "sys", "prompt": "hello there"}
CODEC_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A tiny Llama as the JAX package saves a converted one."""
    path = str(tmp_path_factory.mktemp("llm") / "llama.npz")
    params = jax.device_get(jl.init_llama_params(jax.random.PRNGKey(0), CFG))
    save_params_npz(path, params,
                    meta={"model_args": {k: getattr(CFG, k) for k in MARGS}})
    return path


@pytest.fixture(scope="module")
def speakable_npz(tmp_path_factory):
    """The same Llama with the head's columns zeroed except the printable
    ASCII byte ids (as chip_smoke.py's full-width LLM has it), so that the
    greedy reply is printable text with sentence ends."""
    path = str(tmp_path_factory.mktemp("llm") / "llama.npz")
    params = jax.device_get(jl.init_llama_params(jax.random.PRNGKey(0), CFG))
    ids = np.arange(CFG.vocab_size)
    keep = (ids >= 0x20 + 1) & (ids <= 0x7e + 1)
    params["head"] = np.where(keep[None], params["head"], 0).astype(
        np.float32)
    save_params_npz(path, params,
                    meta={"model_args": {k: getattr(CFG, k) for k in MARGS}})
    return path


def _llm_cfg(cls, npz, **kw):
    return dataclasses.replace(cls(), **{
        "llm_backend": "jax", "llm_jax_params": npz, "llm_checkpoint": "byte",
        "llm_block": 4, "llm_temperature": 0.0, "llm_max_tokens": 40,
        "compute_dtype": "float32", **kw})


def _port(npz, **kw):
    return llm.build_llama_stream(_llm_cfg(tconfig.ServeConfig, npz, **kw),
                                  device="cpu")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_byte_tokenizer_and_prompt_ids_equal_jax():
    jt, tt = jax_llm.ByteTokenizer(), llm.ByteTokenizer()
    text = "héllo, wörld ✓"
    assert tt.encode(text) == jt.encode(text)
    ids = tt.encode(text) + [0, 300]
    assert tt.decode(ids) == jt.decode(ids) == text
    assert (tt.eos_token_id, tt.eos_token) == (jt.eos_token_id, jt.eos_token)
    for req in (REQUEST, {"prompt": "no system"}, {"text": "as text"}):
        assert (llm.build_prompt_ids(tt, req)
                == jax_llm.build_prompt_ids(tt, req))

    class Templated:
        def apply_chat_template(self, messages, tokenize=True,
                                add_generation_prompt=True):
            return [len(m["content"]) for m in messages] + [7]

    assert (llm.build_prompt_ids(Templated(), REQUEST)
            == jax_llm.build_prompt_ids(Templated(), REQUEST) == [3, 11, 7])


class _Rewrite(llm.ByteTokenizer):
    """Decodes "ab" as "X": a later token rewrites earlier text."""

    def decode(self, ids):
        return super().decode(ids).replace("ab", "X")


@pytest.mark.parametrize("tok_cls", ["byte", "rewrite"])
def test_stable_delta_equals_jax(tok_cls):
    """A multibyte character split across tokens is held back until it
    completes; a rewrite of emitted text resyncs from the common
    prefix."""
    tok = llm.ByteTokenizer() if tok_cls == "byte" else _Rewrite()
    ids = tok.encode("aé€b") if tok_cls == "byte" else tok.encode("zaab!")
    te = je = ""
    for n in range(1, len(ids) + 1):
        for final in (False, True):
            got = llm.stable_delta(tok, 0, ids[:n], te, final)
            want = jax_llm.stable_delta(tok, 0, ids[:n], je, final)
            assert got == want, (n, final)
        te = je = got[1]
    if tok_cls == "byte":
        assert llm.stable_delta(tok, 0, ids[:2], "a") == ("", "a")
        assert llm.stable_delta(tok, 0, ids[:3], "a") == ("é", "aé")


# ---------------------------------------------------------------------------
# the B=1 stream against JAX's
# ---------------------------------------------------------------------------

def test_stream_yields_jax_deltas(npz):
    """The factory on the JAX package's npz, greedy: exactly the deltas of
    JAX's ``build_jax_stream(...).predict``.  The 103-byte prompt
    prefills in the bucket of 128 and its 40 tokens cross the attention
    rung at 128."""
    req = {"system": "s" * 60, "prompt": "p" * 40}
    want = list(jax_llm.build_jax_stream(
        _llm_cfg(JServeConfig, npz)).predict(req))
    model = _port(npz)
    assert model.attn_buckets == (128, 256)
    got = list(model.predict(req))
    assert got == want and got[-1] == "<|eot_id|>" and len(got) > 2
    assert model.tokens == 40 and int(model.state.pos) > 128


def test_stream_in_bf16(npz):
    """``compute_dtype`` bfloat16: params and caches in bf16; the deltas
    follow JAX's bf16 stream until XLA and torch round a bf16 tie apart
    (held step by step in tests/test_torch_llama.py)."""
    want = "".join(jax_llm.build_jax_stream(
        _llm_cfg(JServeConfig, npz, compute_dtype="bfloat16")).predict(
            REQUEST))
    model = _port(npz, compute_dtype="bfloat16")
    assert model.params["h"]["wq"].dtype == torch.bfloat16
    assert model.state.k.dtype == torch.bfloat16
    got = "".join(model.predict(REQUEST))
    assert got.endswith("<|eot_id|>") and got[:8] == want[:8]


def test_quantized_stream_routes_every_layer_linear_through_k4(npz,
                                                               monkeypatch):
    """``--quantize w4``: the head stays weight-only int8 and every other
    linear of a step is K4's (7 a layer); each prefill launches them once
    at M = the bucket."""
    model = _port(npz, quantize="w4")
    assert type(model.params["head"]).__name__ == "QuantizedTensor"
    assert type(model.params["h"]["wdown"]).__name__ == "Int4Tensor"
    calls = []
    real = cuda_int4_mm.int4_matmul
    monkeypatch.setattr(cuda_int4_mm, "int4_matmul",
                        lambda x, q, s: calls.append(x.shape) or real(x, q,
                                                                      s))
    deltas = list(model.predict(REQUEST))
    assert deltas[-1] == "<|eot_id|>"
    per_step = 7 * CFG.n_layer
    assert len(calls) == per_step * (1 + model.tokens)
    assert {c[-2] for c in calls} == {32, 1}


# ---------------------------------------------------------------------------
# CUDA graphs (stubbed on the CPU) and the dispatch thread
# ---------------------------------------------------------------------------

class _StubGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        before = graphs.counts()
        self.body()
        graphs._add({k: before[k] - v for k, v in graphs.counts().items()})


@pytest.fixture
def stub_graphs(monkeypatch):
    """Capture and replay on the CPU: the warm pass and the recording run
    the body; a replay runs it with the counters held still.  Returns the
    generators each capture registered."""
    registered = []
    monkeypatch.setattr(graphs, "_warm", lambda body, device: body())

    def record(body, device, generators=()):
        registered.append(tuple(generators))
        body()
        return _StubGraph(body)

    monkeypatch.setattr(graphs, "_record", record)
    return registered


def _counted_k4(monkeypatch):
    """K4's wrapper counting its calls as launches (the CPU path does not
    count)."""
    real = cuda_int4_mm.int4_matmul

    def counted(x, q, s):
        with cuda_int4_mm._count_lock:
            cuda_int4_mm.LAUNCHES += 1
        return real(x, q, s)

    monkeypatch.setattr(cuda_int4_mm, "int4_matmul", counted)


def test_warmup_captures_the_ladder_and_replays_count_launches(
        npz, stub_graphs, monkeypatch):
    _counted_k4(monkeypatch)
    want = list(_port(npz, quantize="w4").predict(REQUEST))
    model = llm.build_llama_stream(
        _llm_cfg(tconfig.ServeConfig, npz, quantize="w4"), device="cpu",
        graphs=True)
    n0 = graphs.CAPTURES
    model.warmup()
    assert sorted(model._blocks.graphs) == [(4, 128), (4, 256)]
    assert graphs.CAPTURES == n0 + 2 and stub_graphs[-2:] == [(), ()]
    cuda_int4_mm.LAUNCHES = 0
    got = list(model.predict(REQUEST))
    assert got == want and graphs.CAPTURES == n0 + 2
    assert cuda_int4_mm.LAUNCHES == 7 * CFG.n_layer * (1 + model.tokens)


def test_a_bucket_warmup_did_not_capture_raises(npz, stub_graphs):
    model = llm.build_llama_stream(_llm_cfg(tconfig.ServeConfig, npz),
                                   device="cpu", graphs=True)
    model.warmup()
    del model._blocks.graphs[(4, 128)]
    with pytest.raises(RuntimeError, match=r"no CUDA graph for \(4, 128\)"):
        list(model.predict(REQUEST))


def test_sampled_stream_registers_its_generator(npz, stub_graphs):
    """Sampling: the device generator is registered with every capture,
    and two requests from one model draw different text (the generator
    advances)."""
    model = llm.build_llama_stream(
        _llm_cfg(tconfig.ServeConfig, npz, llm_temperature=1.5,
                 llm_top_k=0, llm_top_p=1.0),
        device="cpu", graphs=True)
    model.warmup()
    assert stub_graphs == [(model.generator,)] * 2
    a = "".join(model.predict(REQUEST))
    b = "".join(model.predict(REQUEST))
    assert a != b and a.endswith("<|eot_id|>")


def test_every_llm_launch_is_on_the_dispatch_thread(npz, monkeypatch):
    """Iterated as the server iterates it (``aiter_stream``'s pump thread),
    the stream issues its prefill and every block on the device's
    dispatch thread, never on the pump thread or the loop's."""
    threads = []
    for name in ("prefill_padded", "decode_block"):
        real = getattr(tl, name)

        def rec(*a, _real=real, **k):
            threads.append(threading.current_thread().name)
            return _real(*a, **k)
        monkeypatch.setattr(tl, name, rec)
    model = _port(npz)

    async def go():
        return [d async for d in aiter_stream(model.predict(REQUEST))]

    deltas = asyncio.run(go())
    assert deltas[-1] == "<|eot_id|>"
    assert len(threads) == 1 + model.tokens // 4
    assert all(t.startswith("dispatch-cpu") for t in threads), threads


def test_what_is_not_ported_raises(npz, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(npz, llm_pool_capacity=4)
    params = tparams.load_params_npz(npz)
    for kw in ({"n_experts": 2}, {"n_draft_heads": 2}):
        cfg = dataclasses.replace(tl.LlamaConfig(**{k: getattr(CFG, k)
                                                    for k in MARGS}), **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            llm.LlamaStreamModel(params, cfg, llm.ByteTokenizer(),
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            llm.LlamaStreamModel(params, tl.LlamaConfig(
                **{k: getattr(CFG, k) for k in MARGS}), llm.ByteTokenizer())


# ---------------------------------------------------------------------------
# the HF host backend
# ---------------------------------------------------------------------------

def _tiny_gpt2():
    from transformers import GPT2Config, GPT2LMHeadModel
    torch.manual_seed(0)
    return GPT2LMHeadModel(GPT2Config(
        n_layer=1, n_head=2, n_embd=16, vocab_size=48, n_positions=64,
        bos_token_id=1, eos_token_id=0)).eval()


def test_hf_backend_gives_jax_deltas():
    """The same random GPT-2 (built from seed 0, sampling from the global
    generator right after, as tests/test_streams.py does) through each
    side's adapter."""
    out = {}
    for side, cls, cfg_cls in (("jax", JHFStreamModel, JServeConfig),
                               ("port", hf_llm.HFStreamModel,
                                tconfig.ServeConfig)):
        sm = cls(dataclasses.replace(cfg_cls(), llm_device="cpu",
                                     llm_max_tokens=12))
        sm.tokenizer, sm.model = _FakeTokenizer(), _tiny_gpt2()
        out[side] = list(sm.predict({"system": "be brief",
                                     "prompt": "hello"}))
    assert out["port"] == out["jax"] and out["port"]


# ---------------------------------------------------------------------------
# the CLI serves /tts from each LLM
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SERVE_FLAGS = {"decode_block": 8, "max_audio_length": 40,
               "initial_dump_size_1": 4, "initial_dump_size_2": 8,
               "max_dump_size": 16, "chunk_buckets": (4, 8, 16, 32),
               "compute_dtype": "float32", "llm_block": 4,
               "llm_max_tokens": 24, "llm_temperature": 0.0}
CODEC_FLAGS = ("vq_bins", "vq_dim", "backbone_input_channels",
               "backbone_dim", "backbone_intermediate_dim",
               "backbone_num_layers", "n_fft", "hop_length")


def _flags(d):
    return [a for k, v in d.items() for a in
            (f"--{k}", json.dumps(list(v)) if isinstance(v, tuple)
             else str(v))]


def _serve_cli(argv, monkeypatch):
    """Run the CLI up to ``server.run()`` on an ephemeral port; returns the
    built server, its port and its engines."""
    from llmvox_tpu_torch.serve import __main__ as cli
    t_dec = tconfig.DecoderConfig(**{f.name: getattr(DEC_CFG, f.name) for f
                                     in dataclasses.fields(
                                         tconfig.DecoderConfig)})
    port = _free_port()
    real_build = tserver.build_server
    got = {}

    class _NoRun:
        def run(self):
            pass

    def fake_build_server(cfg, engines, pool=None):
        got["srv"] = real_build(dataclasses.replace(
            cfg, api_host="127.0.0.1", api_port=port), engines, pool=pool)
        got["engines"] = engines
        return _NoRun()

    monkeypatch.setattr(cli, "DecoderConfig", lambda: t_dec)
    monkeypatch.setattr(tserver, "build_server", fake_build_server)
    cli.main(["--device", "cpu", "--random_seed", "0"] + argv
             + _flags({f: getattr(CODEC_CFG, f) for f in CODEC_FLAGS}))
    return got["srv"], port, got["engines"]


class _Running:
    def __init__(self, srv, port):
        self.srv, self.port = srv, port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_until_complete,
                                       args=(srv.serve(),), daemon=True)

    def __enter__(self):
        self.thread.start()
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=0.2):
                    return self
            except OSError:
                time.sleep(0.1)
        raise RuntimeError("server did not start")

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        self.loop.close()


def test_cli_serves_tts_from_the_llm_like_the_jax_server(speakable_npz,
                                                         monkeypatch):
    """``--llm_backend jax --llm_jax_params <npz> --llm_checkpoint byte``
    (no scripted reply) answers ``POST /tts`` with the Llama's reply
    spoken; the chunk schedule equals the JAX server's with the same LLM
    and TTS weights, and the audio agrees to the codec's bound."""
    flags = {**SERVE_FLAGS, "llm_backend": "jax",
             "llm_jax_params": speakable_npz, "llm_checkpoint": "byte"}
    srv, port, engines = _serve_cli(_flags(flags), monkeypatch)
    assert isinstance(srv.stream_model, llm.LlamaStreamModel)
    with _Running(srv, port):
        got = post_chunks("127.0.0.1", port, "/tts", {"text": "Hi."},
                          timeout=300)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/voicechat", body="{}")
        assert conn.getresponse().status == 501

    t_dec = engines[0].dcfg
    dec_p = tparams.init_decoder_params(0, t_dec)
    codec_p = tparams.init_codec_params(1, tconfig.CodecConfig(
        **{f: getattr(CODEC_CFG, f) for f in CODEC_FLAGS}))
    table = tparams.random_text_table(2, t_dec)
    jport = _free_port()
    jcfg = dataclasses.replace(JServeConfig(), api_host="127.0.0.1",
                               api_port=jport, **flags)
    jengines = [JTTSEngine(dec_p, table,
                           JWavCodec(codec_p, CODEC_CFG,
                                     buckets=jcfg.chunk_buckets),
                           DEC_CFG, jcfg, cache_dtype=jnp.float32)
                for _ in range(2)]
    jsrv = jserver.build_server(jcfg, jengines)
    with _Running(jsrv, jport):
        want = post_chunks("127.0.0.1", jport, "/tts", {"text": "Hi."},
                           timeout=300)
    assert [len(c) for _, c in got] == [len(c) for _, c in want]
    assert len(got) >= 2
    np.testing.assert_allclose(to_wave(got), to_wave(want), **CODEC_TOL)


def test_cli_serves_tts_from_the_hf_backend(monkeypatch):
    def load(self):
        self.tokenizer, self.model = _FakeTokenizer(), _tiny_gpt2()

    monkeypatch.setattr(hf_llm.HFStreamModel, "load", load)
    # HF samples (do_sample=True), at the default temperature 0.7
    flags = {**SERVE_FLAGS, "llm_backend": "hf", "llm_device": "cpu",
             "llm_temperature": 0.7}
    srv, port, _ = _serve_cli(_flags(flags), monkeypatch)
    assert isinstance(srv.stream_model, hf_llm.HFStreamModel)
    with _Running(srv, port):
        # the reply samples from torch's global generator (a random model
        # may emit its eos first): seeded, as tests/test_streams.py is
        torch.manual_seed(0)
        chunks = post_chunks("127.0.0.1", port, "/tts", {"text": "Hi."},
                             timeout=300)
    wav = to_wave(chunks)
    assert chunks and wav.size > 0 and np.isfinite(wav).all()
