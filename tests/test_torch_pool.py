"""The port's continuous-batching pool, pooled scheduler hooks and pooled
server against the JAX package's, on the tiny stack, both sides in f32 on
the CPU from the same parameters."""
import asyncio
import dataclasses
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.serve import pool as jpool
from llmvox_tpu.serve.scheduler import StreamingScheduler as JScheduler
from llmvox_tpu.serve.server import TTSServer as JTTSServer
from llmvox_tpu.streams.scripted import ScriptedStream as JScripted
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.__main__ import main as serve_main
from llmvox_tpu_torch.serve.client import post_chunks, to_wave
from llmvox_tpu_torch.serve.scheduler import StreamingScheduler as TScheduler
from llmvox_tpu_torch.serve.server import TTSServer as TTTSServer
from llmvox_tpu_torch.streams.scripted import ScriptedStream as TScripted
from llmvox_tpu_torch.utils import config as tconfig

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG, make_engines

CODEC_TOL = dict(atol=2e-3, rtol=1e-3)


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC = _tcfg(tconfig.DecoderConfig, DEC_CFG)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)
T_SERVE = _tcfg(tconfig.ServeConfig, SERVE_CFG)


@pytest.fixture(scope="module")
def jeng():
    """The tiny stack's JAX engine; its numpy weights feed both sides."""
    return make_engines(0, SERVE_CFG, n=1)[0]


def _weights(jeng):
    return (jax.device_get(jeng.params), np.asarray(jeng.text_table),
            jax.device_get(jeng.codec.params))


def _jax_pool(jeng, capacity, scfg=SERVE_CFG):
    return jpool.DecodePool(jeng.params, np.asarray(jeng.text_table),
                            jeng.codec, capacity=capacity, dcfg=DEC_CFG,
                            scfg=scfg, cache_dtype=jnp.float32,
                            param_dtype=jnp.float32)


def _port_pool(jeng, capacity, scfg=SERVE_CFG, **kw):
    params, table, codec = _weights(jeng)
    tscfg = _tcfg(tconfig.ServeConfig, scfg)
    return tpool.DecodePool(
        params, table,
        TWavCodec(codec, T_CODEC, buckets=scfg.chunk_buckets, device="cpu"),
        capacity=capacity, dcfg=kw.pop("dcfg", T_DEC), scfg=tscfg,
        device="cpu", cache_dtype=torch.float32, **kw)


def _run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [4, 8, 16])
def test_gather_rows_matches_jax(bucket):
    rng = np.random.default_rng(61)
    tokens = rng.integers(-1, 16, (5, 8)).astype(np.int32)
    idx = np.asarray([3, 0, 4, 0], np.int32)
    want = jpool._gather_rows(jnp.asarray(tokens), jnp.asarray(idx), bucket)
    got = tpool._gather_rows(torch.from_numpy(tokens), torch.from_numpy(idx),
                             bucket)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_reset_matches_jax():
    mask = np.asarray([True, False, True, False])
    pos, prev = np.asarray([5, 6, 7, 8], np.int32), np.arange(4, dtype=np.int32)
    done = np.asarray([True, True, False, False])
    js = jpool._masked_reset(jax.tree.map(jnp.asarray, jpool.dec.DecodeState(
        np.zeros(1), np.zeros(1), pos, prev, done)), jnp.asarray(mask))
    ts = tpool._masked_reset(tdec.DecodeState(
        torch.zeros(1), torch.zeros(1), torch.from_numpy(pos),
        torch.from_numpy(prev), torch.from_numpy(done)),
        torch.from_numpy(mask))
    for f in ("pos", "prev_token", "done"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.pos.dtype == torch.int32 and ts.done.dtype == torch.bool


# ---------------------------------------------------------------------------
# the pool under the scheduler
# ---------------------------------------------------------------------------

REQUESTS = [["Hello", "there."], ["Second request arriving now."],
            ["Third one", "with two", "deltas."]]


async def _pooled_requests(pool, requests, side, scfg=SERVE_CFG):
    """Concurrent requests, two pooled engines each; returns each request's
    chunk list."""
    mod, sched_cls, stream_cls = (
        (jpool, JScheduler, JScripted) if side == "jax"
        else (tpool, TScheduler, TScripted))
    cfg = scfg if side == "jax" else _tcfg(tconfig.ServeConfig, scfg)

    async def one(deltas):
        engines = [mod.PooledEngine(pool, cfg), mod.PooledEngine(pool, cfg)]
        sched = sched_cls(engines, cfg)
        stream = stream_cls(deltas, eos_token=cfg.eos_token)
        out = []
        async for c in sched.run(stream.predict({}), trace=None):
            out.append(c)
        for e in engines:
            e.close()
        return out

    res = await asyncio.gather(*[one(d) for d in requests])
    pool.stop()
    return res


def test_concurrent_pooled_requests_match_jax_pool(jeng):
    want = _run(_pooled_requests(_jax_pool(jeng, 8), REQUESTS, "jax"))
    tp = _port_pool(jeng, 8)
    got = _run(_pooled_requests(tp, REQUESTS, "port"))
    for g, w in zip(got, want):
        assert [len(c) for c in g] == [len(c) for c in w] and len(g) >= 2
        np.testing.assert_allclose(np.frombuffer(b"".join(g), "<f4"),
                                   np.frombuffer(b"".join(w), "<f4"),
                                   **CODEC_TOL)
    st = tp.stats()
    assert st["steps"] > 0 and st["synth_calls"] > 0 and st["active"] == 0
    # merged steps run at twice the block width
    assert tp.decode_steps == tp.block * (st["steps"] + st["merged_steps"])


def _merged_pair_tokens(make_pool, side):
    """Slot 0 queues a full-limit pair (mergeable); slot 1 queues one full
    request (it rides the double-width step)."""
    pool = make_pool()
    mod = jpool if side == "jax" else tpool
    blk = pool.block
    text = list(range(5, 5 + 2 * blk))
    w1, w2 = (np.asarray(text[:blk], np.int32),
              np.asarray(text[blk:], np.int32))

    async def go():
        engines = [mod.PooledEngine(pool) for _ in range(2)]
        for e in engines:
            e.new_state()
        pendings = []
        for k, e in enumerate(engines):
            pendings.append(e.decode_block_async(None, w1, 2 * blk, blk)[0])
            if k == 0:
                pendings.append(
                    e.decode_block_async(None, w2, 2 * blk, blk // 2)[0])
        res = [await p.afetch() for p in pendings]
        for e in engines:
            e.close()
        pool.stop()
        return res, pool.merged_steps

    return _run(go())


def test_merged_pair_steps_match_sequential_steps_and_jax(jeng):
    merge_on = dataclasses.replace(SERVE_CFG, pool_merge_blocks=True)
    merge_off = dataclasses.replace(SERVE_CFG, pool_merge_blocks=False)
    want, j_merged = _merged_pair_tokens(
        lambda: _jax_pool(jeng, 4, merge_on), "jax")
    seq, off_merged = _merged_pair_tokens(
        lambda: _port_pool(jeng, 4, merge_off), "port")
    got, on_merged = _merged_pair_tokens(
        lambda: _port_pool(jeng, 4, merge_on), "port")
    assert off_merged == 0 and on_merged >= 1 and j_merged == on_merged
    assert got == seq == want
    assert [len(t) for t in got] == [32, 16, 32]


def test_fused_first_chunks_beyond_synth_batch_match_jax(jeng):
    """12 simultaneous fused sentence starts land in ONE step and split
    into two vocode calls; every one gets its audio (submissions are
    synchronous, so the step loop cannot run before the first await)."""
    n = 12
    dump = SERVE_CFG.initial_dump_size_1
    hop = CODEC_CFG.hop_length

    def run(pool, mod):
        async def go():
            assert n > pool.SYNTH_BATCH
            engines = [mod.PooledEngine(pool) for _ in range(n)]
            pendings = []
            for k, e in enumerate(engines):
                e.new_state()
                window = np.full(pool.block, DEC_CFG.pad_token_id, np.int32)
                window[0] = 7 + k
                pendings.append(e.decode_block_fused_async(
                    None, window, 1, pool.block, dump)[0])
            res = await asyncio.gather(*[p.afetch() for p in pendings])
            for e in engines:
                e.close()
            pool.stop()
            return res, pool.steps, pool.synth_calls

        return _run(go())

    want, jsteps, _ = run(_jax_pool(jeng, n), jpool)
    got, steps, synth_calls = run(_port_pool(jeng, n), tpool)
    assert steps == jsteps == 1 and synth_calls == 2
    for (tt, ta), (jt, ja) in zip(got, want):
        assert tt == jt and len(tt) >= dump
        assert ta is not None and len(ta) == dump * hop * 4
        np.testing.assert_allclose(np.frombuffer(ta, "<f4"),
                                   np.frombuffer(ja, "<f4"), **CODEC_TOL)


def test_pool_restart_after_stop_serves_new_loop(jeng):
    """stop() clears the in-flight record, so a restart on a NEW event
    loop does not resolve futures bound to the dead loop."""
    pool = _port_pool(jeng, 2)
    window = np.full(pool.block, DEC_CFG.pad_token_id, np.int32)
    window[0] = 7

    async def first():
        e = tpool.PooledEngine(pool)
        e.new_state()
        e.decode_block_async(None, window, 1, pool.block)
        for _ in range(500):
            if pool._inflight:
                break
            await asyncio.sleep(0)
        assert pool._inflight
        pool.stop()
        e.close()

    _run(first())
    assert pool._inflight is None

    async def second():
        e = tpool.PooledEngine(pool)     # start() on the new loop
        e.new_state()
        p, _ = e.decode_block_async(None, window, 1, pool.block)
        out = await p.afetch()
        pool.stop()
        e.close()
        return out

    assert len(_run(second())) == pool.block


def _ladder(jeng, caps=(4, 8), decay_s=0.0):
    return tpool.PoolLadder([_port_pool(jeng, c) for c in caps],
                            decay_s=decay_s)


def test_pool_ladder_routes_and_migrates(jeng):
    """Engines land in the smallest pool that covers demand, overflow to
    the next rung, migrate UP at sentence boundaries when demand grows,
    and drift back DOWN when it shrinks."""
    async def go():
        ladder = _ladder(jeng)
        p4, p8 = ladder.pools
        reqs = [[tpool.PooledEngine(ladder) for _ in range(2)]
                for _ in range(2)]
        assert all(e.pool is p4 for r in reqs for e in r)
        extra = [tpool.PooledEngine(ladder) for _ in range(2)]
        assert all(e.pool is p8 for e in extra)
        assert ladder.active_total == 6
        for r in reqs:
            for e in r:
                e.new_state()
        assert all(e.pool is p8 for r in reqs for e in r)
        assert p4.active_count == 0 and p8.active_count == 6
        for r in reqs:
            for e in r:
                e.close()
        for e in extra:
            e.new_state()
        assert all(e.pool is p4 for e in extra)
        for e in extra:
            e.close()
        assert ladder.B == 8 and len(ladder.stats()["ladder"]) == 2
        ladder.stop()

    _run(go())


def test_pool_ladder_demand_high_water_decay(jeng):
    async def go():
        ladder = _ladder(jeng, decay_s=0.5)
        p4, p8 = ladder.pools
        burst = [tpool.PooledEngine(ladder) for _ in range(6)]
        assert ladder._demand() == 6
        for e in burst:
            e.close()
        assert ladder.target(extra=1) is p8
        time.sleep(0.6)
        assert ladder.target(extra=1) is p4
        ladder.stop()

    _run(go())


def test_pool_ladder_output_matches_jax_dedicated_scheduler(jeng):
    """A request whose engines migrate rungs mid-dialogue streams the same
    chunks as the JAX dedicated dual-replica scheduler."""
    deltas_a = ["Hello", "there.", "Another sentence", "now."]
    deltas_b = ["Second request arriving now."]

    def reference(deltas):
        engines = make_engines(0, SERVE_CFG)
        stream = JScripted(deltas, eos_token=SERVE_CFG.eos_token)

        async def go():
            return [c async for c in
                    JScheduler(engines, SERVE_CFG).run(stream.predict({}))]
        return _run(go())

    want_a, want_b = reference(deltas_a), reference(deltas_b)

    async def go():
        ladder = _ladder(jeng, caps=(2, 8))

        async def one(deltas, delay):
            await asyncio.sleep(delay)
            engines = [tpool.PooledEngine(ladder, T_SERVE),
                       tpool.PooledEngine(ladder, T_SERVE)]
            stream = TScripted(deltas, eos_token=T_SERVE.eos_token)
            out = [c async for c in
                   TScheduler(engines, T_SERVE).run(stream.predict({}))]
            for e in engines:
                e.close()
            return out

        res = await asyncio.gather(one(deltas_a, 0), one(deltas_b, 0.2))
        moved = ladder.pools[1].steps > 0
        ladder.stop()
        return res, moved

    (got_a, got_b), moved = _run(go(), timeout=600)
    assert moved
    for got, want in ((got_a, want_a), (got_b, want_b)):
        assert [len(c) for c in got] == [len(c) for c in want]
        np.testing.assert_allclose(np.frombuffer(b"".join(got), "<f4"),
                                   np.frombuffer(b"".join(want), "<f4"),
                                   **CODEC_TOL)


# ---------------------------------------------------------------------------
# what the pool refuses
# ---------------------------------------------------------------------------

def test_spec_decode_with_draft_heads_raises(jeng):
    """Under ``spec_decode`` the pool speculates when the params carry
    draft heads, and raises when the heads cannot serve its deepest rung
    (speculation at k drafts reads heads 0..k-1), as the JAX step fails
    to trace then.  Without draft heads it decodes greedily, as in JAX."""
    params, table, codec = _weights(jeng)
    spec = dataclasses.replace(T_SERVE, spec_decode=True, spec_k_draft=3)
    codec = TWavCodec(codec, T_CODEC, device="cpu")
    c, v = T_DEC.n_embd, T_DEC.vocab_size
    for bad in (np.zeros((2, c, v), np.float32),      # too few for k = 3
                np.zeros((3, c + 1, v), np.float32),  # wrong width
                {"w": np.zeros((3, c, v), np.float32)}):
        with pytest.raises(ValueError, match="draft_heads"):
            tpool.DecodePool(dict(params, draft_heads=bad), table, codec,
                             capacity=2, dcfg=T_DEC, scfg=spec, device="cpu")
    pool = tpool.DecodePool(
        dict(params, draft_heads=np.zeros((3, c, v), np.float32)), table,
        codec, capacity=2, dcfg=T_DEC, scfg=spec, device="cpu")
    assert pool._spec and pool.stats()["spec"] == {"k": 3, "ladder": [3]}
    greedy = tpool.DecodePool(params, table, codec, capacity=2, dcfg=T_DEC,
                              scfg=spec, device="cpu")
    assert not greedy._spec and "spec" not in greedy.stats()


def test_pool_refuses_a_mesh_and_a_foreign_codec(jeng):
    """A mesh the capacity does not divide over is refused (JAX's
    assertion), as is a codec on another device than the pool's."""
    from llmvox_tpu_torch.parallel import create_mesh
    with pytest.raises(ValueError, match="pool capacity 2 must divide "
                                         "over dp=3"):
        _port_pool(jeng, 2, mesh=create_mesh(3, devices=["cpu"] * 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params, table, codec = _weights(jeng)
            tpool.DecodePool(params, table,
                             TWavCodec(codec, T_CODEC, device="cpu"),
                             dcfg=T_DEC)


@pytest.mark.parametrize("flags, caps", [
    (["--pool_capacity", "4"], [4]),
    (["--pool_ladder", "[4,2]"], [2, 4])])
def test_cli_builds_the_pool_on_the_first_replica(flags, caps, monkeypatch):
    """``--pool_capacity`` / ``--pool_ladder`` wire a DecodePool (or a
    ladder, smallest first) on the first replica's device and codec into
    ``build_server``; the tiny stack's configs stand in for the deployed
    ones (the codec's through its flags)."""
    from llmvox_tpu_torch.serve import __main__ as cli
    from llmvox_tpu_torch.serve import server as tserver
    got = {}

    class _NoRun:
        def run(self):
            pass

    def fake_build_server(cfg, engines, pool=None):
        got.update(cfg=cfg, engines=engines, pool=pool)
        return _NoRun()

    monkeypatch.setattr(cli, "DecoderConfig", lambda: T_DEC)
    monkeypatch.setattr(tserver, "build_server", fake_build_server)
    codec_flags = [a for f in ("vq_bins", "vq_dim", "backbone_input_channels",
                               "backbone_dim", "backbone_intermediate_dim",
                               "backbone_num_layers", "n_fft", "hop_length")
                   for a in (f"--{f}", str(getattr(CODEC_CFG, f)))]
    serve_main(["--device", "cpu", "--random_seed", "0", "--decode_block",
                "8", "--chunk_buckets", "[4,8,16,32]"] + codec_flags + flags)
    pool, engines = got["pool"], got["engines"]
    pools = pool.pools if isinstance(pool, tpool.PoolLadder) else [pool]
    assert [p.B for p in pools] == caps
    for p in pools:
        assert p.codec is engines[0].codec and p.device.type == "cpu"
        assert p.cache_dtype == torch.bfloat16     # compute_dtype


@pytest.mark.parametrize("flags, slice_", [
    (["--quantize", "w4", "--pool_capacity", "4"], None),
    (["--quantize", "w3"], "unknown quantization mode 'w3'"),
    (["--spec_decode", "true", "--pool_capacity", "4", "--spec_k_ladder",
      "[0,2]"], None),
    (["--pool_mesh_dp", "3", "--pool_capacity", "8"],
     "--pool_capacity 8 must divide over --pool_mesh_dp 3")])
def test_cli_refuses_unported_flags(flags, slice_, capsys, monkeypatch):
    """A ``--pool_mesh_dp`` that does not divide ``--pool_capacity`` is
    refused (``--pool_mesh_dp 2`` is served: test_torch_parallel.py), and
    an unknown ``--quantize`` mode with the quantizer's message.
    ``--quantize w4`` is served: the random decoder's matmul weights are
    int4 in the engines and the pool, scales in the compute dtype, the
    head int8.  ``--spec_decode`` is served: with ``--random_seed`` the
    random decoder carries draft heads for the deepest rung, and the
    engines and the pool speculate."""
    if slice_ is not None:
        with pytest.raises(SystemExit):
            serve_main(["--device", "cpu", "--random_seed", "0"] + flags)
        assert slice_ in capsys.readouterr().err
        return
    from llmvox_tpu_torch.serve import __main__ as cli
    from llmvox_tpu_torch.serve import server as tserver
    got = {}

    class _NoRun:
        def run(self):
            pass

    def fake_build_server(cfg, engines, pool=None):
        got.update(cfg=cfg, engines=engines, pool=pool)
        return _NoRun()

    monkeypatch.setattr(cli, "DecoderConfig", lambda: T_DEC)
    monkeypatch.setattr(tserver, "build_server", fake_build_server)
    codec_flags = [a for f in ("vq_bins", "vq_dim", "backbone_input_channels",
                               "backbone_dim", "backbone_intermediate_dim",
                               "backbone_num_layers", "n_fft", "hop_length")
                   for a in (f"--{f}", str(getattr(CODEC_CFG, f)))]
    serve_main(["--device", "cpu", "--random_seed", "0", "--decode_block",
                "8", "--chunk_buckets", "[4,8,16,32]", "--spec_k_draft", "3"]
               + codec_flags + flags)
    pool, engines = got["pool"], got["engines"]
    if got["cfg"].quantize:
        from llmvox_tpu_torch.ops import quant as tq
        for holder in engines + [pool]:
            h = holder.params["h"]
            assert all(type(h[k]) is tq.Int4Tensor
                       for k in ("wqkv", "wo", "wfc", "wproj"))
            assert h["wfc"].q.dtype == torch.int8
            assert h["wfc"].s.dtype == torch.bfloat16
            assert type(holder.params["head"]) is tq.QuantizedTensor
        assert not pool._spec
        return
    assert got["cfg"].spec_decode and all(e._spec for e in engines)
    assert tuple(pool.params["draft_heads"].shape) == (
        3, T_DEC.n_embd, T_DEC.vocab_size)
    assert pool.stats()["spec"]["ladder"] == [0, 2]
    assert sorted(pool._decode_fns) == [
        (w, k) for w in (pool.block, pool.big_block) for k in (0, 2)]


# ---------------------------------------------------------------------------
# the pooled server
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_pooled(make_server, port):
    """Start a pooled server on its own thread and loop; returns a stop
    function."""
    loop = asyncio.new_event_loop()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        holder["srv"] = make_server()
        loop.run_until_complete(holder["srv"].serve())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for _ in range(200):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.2):
                break
        except OSError:
            time.sleep(0.1)

    def stop():
        holder["srv"].shutdown()
        thread.join(timeout=30)
        assert not thread.is_alive()
        loop.close()
    return stop


def test_pooled_server_matches_jax_pooled_server(jeng):
    deltas = ["Pooled answer one.", "And two."]
    results = {}
    for side in ("jax", "port"):
        port = _free_port()
        cfg = dataclasses.replace(SERVE_CFG, api_host="127.0.0.1",
                                  api_port=port, pool_capacity=8)
        if side == "jax":
            def make(cfg=cfg):
                return JTTSServer(None, cfg, stream_model=JScripted(
                    deltas, eos_token=cfg.eos_token),
                    pool=_jax_pool(jeng, 8, cfg))
        else:
            tcfg = _tcfg(tconfig.ServeConfig, cfg)

            def make(tcfg=tcfg):
                return TTTSServer(None, tcfg, stream_model=TScripted(
                    deltas, eos_token=tcfg.eos_token),
                    pool=_port_pool(jeng, 8, cfg))
        stop = _serve_pooled(make, port)
        try:
            with ThreadPoolExecutor(max_workers=3) as ex:
                results[side] = list(ex.map(
                    lambda i: post_chunks("127.0.0.1", port, "/tts",
                                          {"text": f"request {i}"},
                                          timeout=300), range(3)))
            if side == "port":
                import http.client
                import json
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                conn.request("GET", "/stats")
                stats = json.loads(conn.getresponse().read())
        finally:
            stop()
    want = results["jax"][0]
    for got in results["port"] + results["jax"]:
        assert [len(c) for _, c in got] == [len(c) for _, c in want]
        np.testing.assert_allclose(to_wave(got), to_wave(want), **CODEC_TOL)
    assert len(stats["requests"]) == 3
    assert stats["pool"]["capacity"] == 8 and stats["pool"]["steps"] > 0
    assert stats["pool"]["active"] == 0
