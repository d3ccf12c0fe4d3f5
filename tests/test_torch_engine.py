"""The port's engine, scheduler and server against the JAX package's, on
the tiny stack, both sides in f32 on the CPU with the same parameters."""
import asyncio
import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.codec.codec import init_codec_params
from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.serve import server as jserver
from llmvox_tpu.serve.engine import TTSEngine as JTTSEngine
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.serve import server as tserver
from llmvox_tpu_torch.serve.client import post_chunks, to_wave
from llmvox_tpu_torch.serve.engine import TTSEngine as TTTSEngine
from llmvox_tpu_torch.utils import config as tconfig

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

CODEC_TOL = dict(atol=2e-3, rtol=1e-3)


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC, T_CODEC = (_port_cfg(tconfig.DecoderConfig, DEC_CFG),
                  _port_cfg(tconfig.CodecConfig, CODEC_CFG))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(31)
    params = jax.device_get(
        jdec.init_decoder_params(jax.random.PRNGKey(31), DEC_CFG))
    params = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    table = rng.standard_normal(
        (DEC_CFG.text_vocab_size, DEC_CFG.text_embed_dim)).astype(np.float32)
    codec = jax.device_get(init_codec_params(jax.random.PRNGKey(32),
                                             CODEC_CFG))
    return params, table, codec


def _jax_engines(weights, scfg, n=1):
    params, table, codec = weights
    return [JTTSEngine(params, table,
                       JWavCodec(codec, CODEC_CFG, buckets=scfg.chunk_buckets),
                       DEC_CFG, scfg, cache_dtype=jnp.float32)
            for _ in range(n)]


def _port_engines(weights, scfg, n=1):
    params, table, codec = weights
    tscfg = _port_cfg(tconfig.ServeConfig, scfg)
    return [TTTSEngine(params, table,
                       TWavCodec(codec, T_CODEC, buckets=scfg.chunk_buckets,
                                 device="cpu"),
                       T_DEC, tscfg, device="cpu", cache_dtype=torch.float32)
            for _ in range(n)]


def test_tts_matches_jax(weights):
    jeng, = _jax_engines(weights, SERVE_CFG)
    teng, = _port_engines(weights, SERVE_CFG)
    jwav, jtoks = jeng.tts("Hello world.", max_tokens=24)
    twav, ttoks = teng.tts("Hello world.", max_tokens=24)
    assert ttoks == jtoks and len(ttoks) == 24
    assert twav.shape == jwav.shape == (24 * CODEC_CFG.hop_length,)
    np.testing.assert_allclose(twav, jwav, **CODEC_TOL)
    # every dispatched step is counted: 3 blocks of 8 reach the cap
    assert teng.decode_steps == 3 * SERVE_CFG.decode_block


def test_fused_first_block_matches_jax(weights):
    jeng, = _jax_engines(weights, SERVE_CFG)
    teng, = _port_engines(weights, SERVE_CFG)
    ids = np.arange(60, 66, dtype=np.int32)
    window = np.full(8, DEC_CFG.pad_token_id, np.int32)
    window[:len(ids)] = ids
    jp, jstate = jeng.decode_block_fused_async(jeng.new_state(), window, 6,
                                               8, 4)
    tp, tstate = teng.decode_block_fused_async(teng.new_state(), window, 6,
                                               8, 4)
    jtoks, jwav = jp.fetch()
    ttoks, twav = tp.fetch()
    assert ttoks == jtoks and len(ttoks) == 8
    assert len(twav) == len(jwav) == 4 * CODEC_CFG.hop_length * 4
    np.testing.assert_allclose(np.frombuffer(twav, "<f4"),
                               np.frombuffer(jwav, "<f4"), **CODEC_TOL)
    assert int(tstate.pos) == int(jstate.pos) == 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Running:
    """A server's serve() on its own thread and event loop."""

    def __init__(self, srv, port):
        self.srv, self.port = srv, port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=self.loop.run_until_complete, args=(srv.serve(),),
            daemon=True)

    def __enter__(self):
        self.thread.start()
        for _ in range(100):
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=0.2):
                    return self
            except OSError:
                time.sleep(0.1)
        raise RuntimeError("server did not start")

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.loop.close()


def test_server_chunks_match_jax(weights):
    reply = "Answer sentence one. And two."
    chunks = {}
    for side in ("jax", "port"):
        port = _free_port()
        scfg = dataclasses.replace(SERVE_CFG, api_host="127.0.0.1",
                                   api_port=port, scripted_reply=reply)
        if side == "jax":
            srv = jserver.build_server(scfg, _jax_engines(weights, scfg, 2))
        else:
            srv = tserver.build_server(
                _port_cfg(tconfig.ServeConfig, scfg),
                _port_engines(weights, scfg, 2))
        with _Running(srv, port):
            chunks[side] = post_chunks("127.0.0.1", port, "/tts",
                                       {"text": "hi"}, timeout=300)
    jl = [len(c) for _, c in chunks["jax"]]
    tl = [len(c) for _, c in chunks["port"]]
    assert tl == jl and len(tl) >= 2
    np.testing.assert_allclose(to_wave(chunks["port"]),
                               to_wave(chunks["jax"]), **CODEC_TOL)


def test_server_refuses_unported_endpoints(weights):
    import http.client
    import json
    port = _free_port()
    scfg = _port_cfg(tconfig.ServeConfig, dataclasses.replace(
        SERVE_CFG, api_host="127.0.0.1", api_port=port,
        scripted_reply="Hi."))
    srv = tserver.build_server(scfg, _port_engines(weights, SERVE_CFG, 2))
    with _Running(srv, port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/voicechat", body="{}")
        resp = conn.getresponse()
        assert resp.status == 501
        assert "/voicechat" in json.loads(resp.read())["error"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read()) == {"requests": []}


def test_engine_without_device_raises_when_no_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    params, table, codec = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TWavCodec(codec, T_CODEC)
    cpu_codec = TWavCodec(codec, T_CODEC, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTTSEngine(params, table, cpu_codec, T_DEC)
