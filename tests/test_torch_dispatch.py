"""The port's dispatch threads, the CLI's device clamp and
``chip_smoke.check_chain``, on the CPU and the tiny stack.

* A pool step and a dedicated engine's block launch on the device's
  dispatch thread, one for every engine and pool of the device: with the
  launch slowed by 0.3 s, a 1 ms ticker on the event loop never waits more
  than 50 ms, and the tokens and audio do not change.
* ``--tts_device_1`` / ``--tts_device_2`` are clamped to the last card
  present, as the JAX CLI does.
* ``check_chain`` holds a parted card chain to its end: every divergence
  must be a near tie in the CPU's logits after the card's own prefix.
"""
import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.__main__ import main as serve_main
from llmvox_tpu_torch.serve.__main__ import replica_devices
from llmvox_tpu_torch.serve.engine import TTSEngine
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler
from llmvox_tpu_torch.streams.scripted import ScriptedStream
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import params as P
from llmvox_tpu_torch.utils.device import dispatch_executor

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC = _tcfg(tconfig.DecoderConfig, DEC_CFG)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)
T_SERVE = _tcfg(tconfig.ServeConfig, SERVE_CFG)
SLOW_S = 0.3
MAX_LAG_S = 0.05


@pytest.fixture(scope="module")
def weights():
    return (P.init_decoder_params(0, T_DEC), P.init_codec_params(1, T_CODEC),
            P.random_text_table(2, T_DEC))


def _codec(weights):
    return WavCodec(weights[1], T_CODEC, buckets=T_SERVE.chunk_buckets,
                    device="cpu")


def _engine(weights):
    return TTSEngine(weights[0], weights[2], _codec(weights), T_DEC, T_SERVE,
                     device="cpu", cache_dtype=torch.float32)


def _slowed(fn, threads):
    """``fn`` after a 0.3 s sleep, noting the thread it runs on."""
    def slow(*args, **kwargs):
        threads.add(threading.get_ident())
        time.sleep(SLOW_S)
        return fn(*args, **kwargs)
    return slow


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


def _pool_blocks(weights, slow: bool):
    """Three blocks of one pool slot, each fetched before the next is
    submitted; with ``slow`` every step's launch sleeps 0.3 s first."""
    pool = tpool.DecodePool(weights[0], weights[2], _codec(weights),
                            capacity=2, dcfg=T_DEC, scfg=T_SERVE,
                            device="cpu", cache_dtype=torch.float32)
    threads = set()
    if slow:
        pool._decode_fns = {key: _slowed(fn, threads)
                            for key, fn in pool._decode_fns.items()}
    ids = np.frombuffer(b"Hello there.", np.uint8).astype(np.int32) + 3

    async def go():
        eng = tpool.PooledEngine(pool)
        eng.new_state()
        out = []
        for i in range(3):
            window = np.full(pool.block, T_DEC.pad_token_id, np.int32)
            part = ids[i * pool.block:(i + 1) * pool.block]
            window[:len(part)] = part
            pending, _ = eng.decode_block_async(None, window, len(ids),
                                                pool.block)
            out.append(await pending.afetch())
        eng.close()
        pool.stop()
        return out, threading.get_ident()

    (out, loop_thread), lags = asyncio.run(_with_ticker(go()))
    return out, lags, threads, loop_thread, pool


def test_pool_step_launches_on_the_devices_dispatch_thread(weights):
    want, _, _, _, _ = _pool_blocks(weights, slow=False)
    got, lags, threads, loop_thread, pool = _pool_blocks(weights, slow=True)
    assert got == want and all(len(b) == pool.block for b in got)
    assert threads and loop_thread not in threads
    assert threads == {_thread_of(dispatch_executor(torch.device("cpu")))}
    assert pool.steps == 3 and pool.dispatch_s >= 3 * SLOW_S
    assert len(lags) > 100 and max(lags) < MAX_LAG_S, max(lags)
    assert pool._last_launch is None          # stop() waited for it


def _serve_request(weights, slow: bool):
    """One scripted request through the dedicated dual-replica scheduler;
    with ``slow`` every block launch sleeps 0.3 s first."""
    engines = [_engine(weights), _engine(weights)]
    threads = set()
    if slow:
        for e in engines:
            e.decode_block_async = _slowed(e.decode_block_async, threads)
            e.decode_block_fused_async = _slowed(e.decode_block_fused_async,
                                                 threads)
    stream = ScriptedStream(["Hello there.", "How are you?"],
                            eos_token=T_SERVE.eos_token)

    async def go():
        chunks = [c async for c in
                  StreamingScheduler(engines, T_SERVE).run(stream.predict({}))]
        return chunks, threading.get_ident()

    (chunks, loop_thread), lags = asyncio.run(_with_ticker(go()))
    return chunks, lags, threads, loop_thread


def test_scheduler_launches_both_replicas_on_the_devices_thread(weights):
    want, _, _, _ = _serve_request(weights, slow=False)
    got, lags, threads, loop_thread = _serve_request(weights, slow=True)
    assert len(got) == len(want) >= 2
    assert b"".join(got) == b"".join(want)
    # both replicas on the device's one dispatch thread, never the loop's
    assert threads == {_thread_of(dispatch_executor(torch.device("cpu")))}
    assert loop_thread not in threads
    assert len(lags) > 100 and max(lags) < MAX_LAG_S, max(lags)


def test_engine_dispatch_runs_on_the_devices_thread_in_order(weights):
    eng = _engine(weights)
    window = np.full(eng.block, T_DEC.pad_token_id, np.int32)

    async def blocks():
        state = eng.new_state()
        out = []
        for _ in range(3):
            pending, state = await eng.dispatch(eng.decode_block_async,
                                                state, window, 1, 4)
            out.append(pending.fetch())
        return out

    got = asyncio.run(blocks())
    state = eng.new_state()
    want = []
    for _ in range(3):
        pending, state = eng.decode_block_async(state, window, 1, 4)
        want.append(pending.fetch())
    assert got == want and all(len(b) == 4 for b in got)


def _thread_of(executor):
    return executor.submit(threading.get_ident).result()


@pytest.mark.parametrize("device, want", [("cuda", 2), ("cuda:1", 1)])
def test_dispatch_thread_is_one_per_card(device, want, monkeypatch):
    """One dispatch thread for each card, whose current device it is; a
    bare ``cuda`` is the calling thread's current card (``set_device``
    needs an index)."""
    from llmvox_tpu_torch.utils import device as tdevice
    got = []
    monkeypatch.setattr(tdevice, "_dispatchers", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: got.append((i, threading.get_ident())))
    ex = tdevice.dispatch_executor(torch.device(device))
    assert tdevice.dispatch_executor(torch.device("cuda", want)) is ex
    assert tdevice.dispatch_executor(torch.device("cuda", 3)) is not ex
    worker = _thread_of(ex)
    for e in tdevice._dispatchers.values():
        e.shutdown(wait=True)
    assert (want, worker) in got and worker != threading.get_ident()


@pytest.mark.parametrize("count, d1, d2, want", [
    (1, 0, 1, ["cuda:0", "cuda:0"]), (2, 0, 1, ["cuda:0", "cuda:1"]),
    (2, 5, 3, ["cuda:1", "cuda:1"]), (4, 3, 7, ["cuda:3", "cuda:3"])])
def test_replica_devices_clamp_to_the_last_card(count, d1, d2, want,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cfg = dataclasses.replace(T_SERVE, tts_device_1=d1, tts_device_2=d2)
    assert replica_devices("cuda", cfg) == want
    assert replica_devices("cpu", cfg) == ["cpu", "cpu"]


def test_cli_builds_both_replicas_on_card_0_of_a_one_card_host(monkeypatch):
    """``--tts_device_2 1`` on a host with one card: both replicas and their
    codecs on ``cuda:0``, where the JAX CLI serves them too."""
    from llmvox_tpu_torch.codec import codec as tcodec
    from llmvox_tpu_torch.serve import __main__ as cli
    from llmvox_tpu_torch.serve import engine as tengine
    from llmvox_tpu_torch.serve import server as tserver
    built = []

    class FakeCodec:
        def __init__(self, params, cfg, buckets=None, device="cuda"):
            built.append(("codec", device))

    class FakeEngine:
        def __init__(self, *args, device="cuda", **kwargs):
            built.append(("engine", device))

        def warmup(self):
            pass

    class NoRun:
        def run(self):
            pass

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tcodec, "WavCodec", FakeCodec)
    monkeypatch.setattr(tengine, "TTSEngine", FakeEngine)
    monkeypatch.setattr(tserver, "build_server",
                        lambda cfg, engines, pool=None: NoRun())
    monkeypatch.setattr(cli, "DecoderConfig", lambda: T_DEC)
    codec_flags = [a for f in ("vq_bins", "vq_dim", "backbone_input_channels",
                               "backbone_dim", "backbone_intermediate_dim",
                               "backbone_num_layers", "n_fft", "hop_length")
                   for a in (f"--{f}", str(getattr(CODEC_CFG, f)))]
    serve_main(["--random_seed", "0", "--tts_device_1", "0",
                "--tts_device_2", "1"] + codec_flags)
    assert built == [("codec", "cuda:0"), ("engine", "cuda:0")] * 2


# ---------------------------------------------------------------------------
# chip_smoke.check_chain
# ---------------------------------------------------------------------------

def _crafted(chain, ties):
    """Logits for each step of ``chain``: the chain's token on top by a
    wide margin, except at the steps of ``ties`` {d: (other, gap in % of
    std)}, where ``other`` is on top and the chain's token trails it."""
    out = []
    for d, tok in enumerate(chain):
        logits = torch.linspace(-3.0, 0.0, 64)
        std = logits.std().item()
        if d in ties:
            other, pct = ties[d]
            logits[other] = 2.0
            logits[tok] = 2.0 - pct / 100 * std
        else:
            logits[tok] = 2.0
        out.append(logits)
    return out


@pytest.mark.parametrize("second_gap, ok", [(0.4, True), (5.0, False)])
def test_check_chain_holds_every_divergence(second_gap, ok, monkeypatch):
    card = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    cpu = card[:3] + [40, 41, 42, 43, 44, 45, 46]
    logits = _crafted(card, {3: (40, 0.2), 7: (50, second_gap)})
    monkeypatch.setattr(chip_smoke, "_cpu_forced_logits",
                        lambda eng, chain: logits)
    if ok:
        got = chip_smoke.check_chain(card, cpu, None, "w4")
        assert "2 near tie(s)" in got and "(3, " in got and "(7, " in got
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_chain(card, cpu, None, "w4")


def test_cpu_forced_logits_replay_the_engines_own_chain(weights):
    """Fed the CPU engine's own greedy chain, every step's argmax is that
    chain's token; a chain doctored at a step that is no tie is refused."""
    eng = _engine(weights)
    _, chain = eng.tts(chip_smoke.TEXT, max_tokens=20)
    assert len(chain) == 20
    logits = chip_smoke._cpu_forced_logits(eng, chain)
    assert [int(x.argmax()) for x in logits] == chain
    assert chip_smoke.check_chain(chain, chain, eng, "f32") == (
        "20 tokens identical")
    d = 9
    gaps = [(logits[d][chain[d]] - logits[d][t]).item()
            for t in range(T_DEC.vocab_size)]
    far = int(np.argmax(gaps))                # the least likely token
    card = chain[:d] + [far] + chain[d + 1:]
    with pytest.raises(AssertionError):
        chip_smoke.check_chain(card, chain, eng, "f32")
