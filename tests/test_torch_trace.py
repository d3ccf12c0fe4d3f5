"""The port's span recorder and counters (``utils/trace.py``) at the
serving path's boundaries, on the CPU at the tiny stack:

- with spans off nothing is recorded and a site allocates nothing;
- a pooled request's spans carry its id, and each TTS pool step's
  ``pool.gather``, ``dispatch.wait``, ``pool.launch`` and
  ``pool.fetch_wait`` (each LLM iteration's ``llm.plan`` ...
  ``llm.fetch_wait``) share a step id, under the right parents;
- ``dispatch_s`` is ``gather_s + launch_s`` (``plan_s + launch_s``);
- a job queued behind another owner's job on one dispatch thread waits at
  least that job's run;
- a server with one seat makes its second request wait for admission,
  and every request's first text comes before its first audio;
- a full buffer counts what it drops;
- ``prefill_tokens`` counts the prompt tokens past the cached prefix;
- ``/stats`` shows the pools' split host time, rows and prefill tokens."""
import asyncio
import dataclasses
import http.client
import json
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.models import llama as tl
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.client import post_chunks
from llmvox_tpu_torch.serve.llm_pool import LLMPool
from llmvox_tpu_torch.serve.server import TTSServer
from llmvox_tpu_torch.streams.scripted import ScriptedStream
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as P
from llmvox_tpu_torch.utils import trace as tracing
from llmvox_tpu_torch.utils.device import DispatchExecutor

from tests.test_torch_pool import _free_port, _serve_pooled
from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC = _tcfg(tconfig.DecoderConfig, DEC_CFG)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)
T_SERVE = _tcfg(tconfig.ServeConfig, SERVE_CFG)
LCFG = tl.LlamaConfig(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
                      n_embd=32, intermediate_size=64, max_seq_len=96)
PREFIX = [9, 4, 7, 1, 8, 3, 6, 2, 11, 5, 13, 10]
DELTAS = ["Hello there.", "How are you", "today?"]


@pytest.fixture(scope="module")
def weights():
    return (P.init_decoder_params(0, T_DEC), P.init_codec_params(1, T_CODEC),
            P.random_text_table(2, T_DEC))


@pytest.fixture
def recording():
    """Spans on for the test; what it recorded is drained after."""
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _pool(weights, capacity):
    return tpool.DecodePool(
        weights[0], weights[2],
        WavCodec(weights[1], T_CODEC, buckets=T_SERVE.chunk_buckets,
                 device="cpu"),
        capacity=capacity, dcfg=T_DEC, scfg=T_SERVE, device="cpu",
        cache_dtype=torch.float32)


def _serve(weights, capacity, n_requests):
    """``n_requests`` concurrent ``/tts`` requests through a pooled server
    of ``capacity`` slots (``capacity // 2`` seats); returns the server's
    ``/stats`` and its TTS pool."""
    port = _free_port()
    cfg = dataclasses.replace(T_SERVE, api_host="127.0.0.1", api_port=port,
                              pool_capacity=capacity)
    pool = _pool(weights, capacity)
    stop = _serve_pooled(lambda: TTSServer(None, cfg, stream_model=(
        ScriptedStream(DELTAS, eos_token=cfg.eos_token)), pool=pool), port)
    try:
        with ThreadPoolExecutor(max_workers=n_requests) as ex:
            got = list(ex.map(lambda i: post_chunks(
                "127.0.0.1", port, "/tts", {"text": f"request {i}"},
                timeout=300), range(n_requests)))
        assert all(got)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
    finally:
        stop()
    return stats, pool


def _llm_pool(prefix=None):
    pool = LLMPool(P.init_llama_params(3, LCFG), LCFG, capacity=2, block=4,
                   device="cpu", prefill_buckets=(16, 32))
    if prefix:
        pool.set_prefix(prefix)
    return pool


def _generate(pool, prompts, n=9):
    async def one(ids):
        return [t async for toks in pool.generate(ids, max_tokens=n)
                for t in toks]

    async def go():
        try:
            return await asyncio.gather(*[one(p) for p in prompts])
        finally:
            pool.stop()
    return asyncio.run(asyncio.wait_for(go(), timeout=300))


def _by_step(spans):
    out = defaultdict(lambda: defaultdict(list))
    for s in spans:
        if s.step is not None:
            out[s.step][s.name].append(s)
    return out


def test_spans_off_record_nothing(weights):
    tracing.drain()
    before = tracing.counters()
    assert not tracing.ACTIVE and tracing.new_step() is None
    # a site allocates nothing: every span off is one shared object
    assert tracing.span("a") is tracing.span("b", "info", 3)
    stats, pool = _serve(weights, 4, 2)
    _generate(_llm_pool(), [[5, 9, 2], [7, 11]])
    assert tracing.drain() == []
    after = tracing.counters()
    assert after["spans_recorded"] == before["spans_recorded"]
    # counters stay on
    assert pool.steps > 0 and after["sched_rounds"] > before["sched_rounds"]
    assert stats["trace"]["sched_rounds"] == after["sched_rounds"]


def test_pooled_request_and_step_spans(weights, recording):
    _serve(weights, 4, 2)
    spans = tracing.drain()
    by_id = {s.sid: s for s in spans}
    requests = [s for s in spans if s.name == "request"]
    assert len(requests) == 2 and len({s.request for s in requests}) == 2
    for r in requests:
        assert {"admitted", "first_text", "first_audio", "end"} <= set(
            r.info)
        mine = [s for s in spans if s.request == r.request]
        names = {s.name for s in mine}
        assert {"admission", "scheduler.text_wait",
                "scheduler.fetch_wait"} <= names
        for s in mine:
            # every span of the request lies under its request span
            while s.parent is not None:
                s = by_id[s.parent]
                assert s.request == r.request
            assert s is r
    steps = _by_step(spans)
    launched = [k for k, v in steps.items() if "pool.launch" in v]
    fetched = [k for k in launched if "pool.fetch_wait" in steps[k]]
    assert len(fetched) >= 3 and len(launched) - len(fetched) <= 2
    for k in fetched:
        v = steps[k]
        (gather,), (wait,), (run,), (launch,) = (
            v["pool.gather"], v["dispatch.wait"], v["dispatch.run"],
            v["pool.launch"])
        assert wait.info == run.info == "pool.step"
        assert launch.parent == run.sid
        assert all(g.parent == launch.sid for g in v["graph.replay"])
        assert v["graph.replay"] and len(v["pool.fetch_wait"]) == 1
        # the pool's loops serve no request
        assert {s.request for s in (gather, wait, launch)} == {None}
        assert gather.t1 <= wait.t1 <= launch.t0 and wait.t0 >= gather.t0


def test_llm_iteration_spans_share_a_step(recording):
    pool = _llm_pool()
    _generate(pool, [[5, 9, 2], [7, 11, 13, 17]])
    spans = tracing.drain()
    assert sum(s.name == "admission" for s in spans) == 2
    steps = _by_step(spans)
    launched = [v for v in steps.values() if "llm.launch" in v]
    assert len(launched) >= pool.steps > 0
    assert any("llm.prefill" in v for v in launched)
    for v in launched:
        (plan,), (wait,), (run,), (launch,) = (
            v["llm.plan"], v["dispatch.wait"], v["dispatch.run"],
            v["llm.launch"])
        assert wait.info == "llm.iteration" and launch.parent == run.sid
        progs = v["llm.prefill"] + v["llm.block"]
        assert progs and all(p.parent == launch.sid for p in progs)
        assert len(v["llm.fetch_wait"]) <= 1
        assert plan.t1 <= wait.t1 <= launch.t0
    assert sum(len(v["llm.fetch_wait"]) for v in launched) >= \
        len(launched) - 1


def test_dispatch_s_is_the_sum_of_its_parts(weights):
    stats, pool = _serve(weights, 4, 2)
    assert pool.steps > 0 and pool.gather_s > 0 and pool.launch_s > 0
    assert pool.gather_s + pool.launch_s == pool.dispatch_s
    # /stats shows the parts, as they stood when it was read
    for k in ("gather_s", "launch_s", "active_rows", "decode_steps"):
        assert 0 < stats["pool"][k] <= getattr(pool, k)
    # every step decodes for at least one slot's rows, at most all
    assert pool.decode_steps <= pool.active_rows <= pool.B * pool.decode_steps
    llm = _llm_pool()
    _generate(llm, [[5, 9, 2], [7, 11]])
    assert llm.steps > 0 and llm.plan_s > 0 and llm.launch_s > 0
    assert llm.plan_s + llm.launch_s == llm.dispatch_s
    assert 0 < llm.prefill_s < llm.launch_s


def test_a_job_behind_another_owners_waits_its_run(recording):
    ex = DispatchExecutor(1)
    gate = threading.Event()
    try:
        ex.submit(gate.wait, 30)
        first = ex.submit_as("pool.step", None, time.sleep, 0.2)
        second = ex.submit_as("llm.iteration", None, lambda: None)
        gate.set()
        first.result(timeout=30)
        second.result(timeout=30)
    finally:
        ex.shutdown(wait=True)
    spans = tracing.drain()
    run = {s.info: s for s in spans if s.name == "dispatch.run"}
    wait = {s.info: s for s in spans if s.name == "dispatch.wait"}
    assert set(run) == set(wait) == {"other", "pool.step", "llm.iteration"}
    first_run = run["pool.step"].t1 - run["pool.step"].t0
    assert first_run >= 0.2e9
    assert wait["llm.iteration"].t1 - wait["llm.iteration"].t0 >= first_run


def test_one_seat_makes_the_second_request_wait(weights, recording):
    stats, _ = _serve(weights, 2, 2)
    reqs = stats["requests"]
    assert {r["id"] for r in reqs} == {1, 2}
    waits = sorted(r["admission_s"] for r in reqs)
    assert waits[1] > 0.05 and waits[1] > waits[0]
    spans = [s for s in tracing.drain() if s.name == "admission"]
    assert max(s.t1 - s.t0 for s in spans) > 0.05e9
    for r in reqs:
        assert r["admitted"] <= r["first_text"] <= r["first_audio"] <= \
            r["end"]
    assert stats["trace"]["spans_dropped"] == 0


def test_a_full_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_buf", deque(maxlen=4))
    dropped = tracing.counters()["spans_dropped"]
    tracing.enable()
    try:
        for i in range(10):
            with tracing.span("s", i):
                pass
        got = tracing.drain()
    finally:
        tracing.disable()
    assert [s.info for s in got] == [6, 7, 8, 9]
    assert tracing.counters()["spans_dropped"] - dropped == 6


def test_prefill_tokens_count_past_the_cached_prefix():
    pool = _llm_pool(PREFIX)
    prompts = [PREFIX + [5, 9, 2], PREFIX + [7] * 10, [3] * 12]
    out = _generate(pool, prompts, n=5)
    assert all(len(o) == 5 for o in out)
    assert pool.prefill_tokens == 3 + 10 + 12
    assert pool.host_stats()["prefill_tokens"] == pool.prefill_tokens
