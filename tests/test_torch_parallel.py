"""The port's parallel layer (llmvox_tpu_torch/parallel/) and its
dp-sharded serving paths against the JAX package's, on the CPU: meshes
and row layouts against JAX's ``create_mesh`` and shardings, the
collectives on two gloo ranks (spawned once), the dp-sharded
``DecodePool`` and ``BatchTTS`` over CPU shards against the one-device
port and JAX's mesh versions (tokens identical; f32), per-shard launch
counts through a graph's replays, and ``--pool_mesh_dp`` serving
``/tts``."""
import asyncio
import dataclasses
import socket
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.parallel import mesh as jmesh
from llmvox_tpu.parallel import sharding as jsharding
from llmvox_tpu.serve import pool as jpool
from llmvox_tpu.serve.batch import BatchTTS as JBatchTTS
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.parallel import (batch_seq_sharding, batch_sharding,
                                       create_mesh, replicated)
from llmvox_tpu_torch.parallel import mesh as tmesh
from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.serve import pool as tpool
from llmvox_tpu_torch.serve.batch import BatchTTS as TBatchTTS
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import graphs
from llmvox_tpu_torch.utils.device import dispatch_executor

from tests import torch_dp_ranks as ranks
from tests.test_torch_pool import (CODEC_TOL, REQUESTS, T_CODEC, T_DEC,
                                   _pooled_requests, _run, _tcfg)
from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

CPU = torch.device("cpu")


def _cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def weights():
    """The tiny stack's decoder, text table and codec, numpy trees in the
    JAX layout from the port's seeded initialisers: both sides take them
    as they are."""
    from llmvox_tpu_torch.utils import params as P
    return (P.init_decoder_params(0, T_DEC), P.random_text_table(2, T_DEC),
            P.init_codec_params(1, T_CODEC))


def _port_pool(weights, capacity, **kw):
    params, table, codec = weights
    return tpool.DecodePool(
        params, table,
        TWavCodec(codec, T_CODEC, buckets=SERVE_CFG.chunk_buckets,
                  device="cpu"),
        capacity=capacity, dcfg=T_DEC, scfg=_tcfg(tconfig.ServeConfig,
                                                  SERVE_CFG),
        device="cpu", cache_dtype=torch.float32, **kw)


# ---------------------------------------------------------------------------
# meshes and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(dp_size=-1), dict(dp_size=2),
                                dict(dp_size=-1, tp_size=2),
                                dict(dp_size=2, sp_size=2, tp_size=2),
                                dict(dp_size=-1, ep_size=4)])
def test_create_mesh_matches_jax(kw):
    want = jmesh.create_mesh(**kw, devices=jax.devices()[:8])
    got = create_mesh(**kw, devices=_cpus(8))
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert all(d == CPU for d in got.device_list)


@pytest.mark.parametrize("kw, msg", [
    (dict(dp_size=16), "need 16 devices, have 8"),
    (dict(dp_size=-1, tp_size=3), "8 devices not divisible by tp*sp*ep=3")])
def test_create_mesh_refusals_match_jax(kw, msg):
    with pytest.raises(AssertionError, match=msg.replace("*", r"\*")):
        jmesh.create_mesh(**kw, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match=msg.replace("*", r"\*")):
        create_mesh(**kw, devices=_cpus(8))


def test_create_mesh_needs_present_devices():
    """No card on this host: an explicit CUDA device, or the default
    device list, raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"only {n} CUDA devices"):
            create_mesh(1, devices=[f"cuda:{n}"])
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_mesh(1, devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_mesh(1)
    with pytest.raises(ValueError, match="unsupported mesh device"):
        create_mesh(1, devices=["meta"])


def _norm(idx, shape):
    return tuple((s.indices(n)[:2]) for s, n in zip(idx, shape))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("layout", ["batch", "batch_seq", "replicated"])
def test_rows_each_shard_keeps_match_jax(n, layout):
    """The block each device keeps, in the mesh's device order, equals
    the index and data of JAX's ``device_put(x, sharding)`` shard on the
    device at the same mesh position (with sp = 2 for batch_seq)."""
    sp = 2 if layout == "batch_seq" else 1
    dp = n // sp
    jm = jmesh.create_mesh(dp_size=dp, sp_size=sp, devices=jax.devices()[:n])
    tm = create_mesh(dp_size=dp, sp_size=sp, devices=_cpus(n))
    jfn, tfn = {"batch": (jsharding.batch_sharding, batch_sharding),
                "batch_seq": (jsharding.batch_seq_sharding,
                              batch_seq_sharding),
                "replicated": (jsharding.replicated, replicated)}[layout]
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    arr = jax.device_put(x, jfn(jm))
    pos = {d.id: i for i, d in enumerate(jm.devices.flat)}
    want = {pos[s.device.id]: s for s in arr.addressable_shards}
    got = tfn(tm).blocks(x.shape)
    assert len(got) == len(want) == n
    for i, idx in enumerate(got):
        assert _norm(idx, x.shape) == _norm(want[i].index, x.shape)
        np.testing.assert_array_equal(x[idx], np.asarray(want[i].data))


# ---------------------------------------------------------------------------
# the collectives on two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collectives():
    return spawn(ranks.collectives, 2, threads=1, timeout_s=120)


def test_average_metrics_and_broadcast_from_master(collectives):
    r0, r1 = collectives
    assert (r0["world"], r0["rank"], r0["master"]) == (2, 0, True)
    assert (r1["world"], r1["rank"], r1["master"]) == (2, 1, False)
    for r in collectives:
        assert r["avg"] == {"a": 5.0, "b": 1.5}
        assert list(r["avg"]) == ["a", "b"]          # keys sorted, as JAX
        np.testing.assert_array_equal(r["bcast"]["t"], np.zeros(2))
        np.testing.assert_array_equal(r["bcast"]["n0"], np.arange(3))
        assert r["bcast"]["n1"] == 7


def test_gather_and_all_reduce_on_two_ranks(collectives):
    """gather_rows gives every rank's rows in rank order (JAX's
    all_gather), all_reduce_ sums (or averages) several tensors in one
    collective, and the ranks hold the same bits after it."""
    r0, r1 = collectives
    want = np.concatenate([r0["x"], r1["x"]])
    for r in collectives:
        np.testing.assert_array_equal(r["gathered"], want)
        for i in range(2):
            np.testing.assert_array_equal(
                r["sum"][i], r0["pre"][i] + r1["pre"][i])
        np.testing.assert_array_equal(
            r["mean"], (r0["pre_mean"] + r1["pre_mean"]) / np.float32(2))
        assert r["lockstep"]


def test_one_process_passes_through_and_a_failed_rank_fails_the_launch():
    """Without a group the collectives are identities, as JAX's on one
    process; a rank that raises fails ``spawn`` with its traceback."""
    assert tmesh.world() == 1 and tmesh.is_master()
    assert tmesh.average_metrics({"x": np.float32(2.5)}) == {"x": 2.5}
    tree = {"a": torch.ones(2)}
    assert tmesh.broadcast_from_master(tree) is tree
    x = torch.arange(6.0).view(3, 2)
    assert tmesh.gather_rows(x) is x
    tmesh.barrier()
    assert tmesh.data_parallel_size(-1) == 1
    with pytest.raises(RuntimeError, match="(?s)rank 0 failed.*fails on "
                                           "purpose"):
        spawn(ranks.fail, 1, timeout_s=120)


# ---------------------------------------------------------------------------
# per-shard launch counts
# ---------------------------------------------------------------------------

class _StubGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        before = graphs.counts()
        self.body()
        graphs._add({k: before[k] - v for k, v in graphs.counts().items()})


def test_shard_counts_follow_each_graphs_replays(monkeypatch):
    """A dict counter takes each launch under the ``launch_scope`` of the
    shard that issued it; a capture records the entry it moved and every
    replay adds to that entry (the stub capture runs the body on the CPU,
    as tests/test_torch_graphs.py's does)."""
    monkeypatch.setattr(graphs, "_warm", lambda body, device: body())
    monkeypatch.setattr(graphs, "_record",
                        lambda body, device, generators=(): (
                            body(), _StubGraph(body))[1])
    mod, lock = types.ModuleType("sharded_kernel"), threading.Lock()
    mod.SHARD_LAUNCHES = {}
    monkeypatch.setitem(sys.modules, "sharded_kernel", mod)
    monkeypatch.setattr(graphs, "_COUNTERS", dict(graphs._COUNTERS))
    graphs.register_counter("sharded_kernel", "SHARD_LAUNCHES", lock)

    def launch():
        with lock:
            graphs.count_in_scope(mod.SHARD_LAUNCHES)

    steps = []
    for tag in ("shard 0 cpu", "shard 1 cpu"):
        with graphs.launch_scope(tag):
            g = graphs.StepGraph(launch, None, CPU, True)
            g.capture()                # the warm pass and the first replay
        steps.append(g)
    assert graphs.scope() is None
    launch()                           # outside any shard: not counted
    assert mod.SHARD_LAUNCHES == {"shard 0 cpu": 2, "shard 1 cpu": 2}
    for _ in range(3):
        steps[1]()                     # replays need no scope
    steps[0]()
    assert mod.SHARD_LAUNCHES == {"shard 0 cpu": 3, "shard 1 cpu": 5}
    assert graphs.counts()[("sharded_kernel.SHARD_LAUNCHES",
                            "shard 1 cpu")] == 5


# ---------------------------------------------------------------------------
# the dp-sharded pool and BatchTTS
# ---------------------------------------------------------------------------

def _fused_starts(pool, mod, n):
    """n simultaneous fused sentence starts, one a slot: each slot's
    tokens and first-chunk audio, the steps and the vocode calls."""
    dump = SERVE_CFG.initial_dump_size_1

    async def go():
        engines = [mod.PooledEngine(pool) for _ in range(n)]
        pendings = []
        for k, e in enumerate(engines):
            e.new_state()
            window = np.full(pool.block, DEC_CFG.pad_token_id, np.int32)
            window[0] = 7 + k
            window[1] = 3 + (k % 5)
            pendings.append(e.decode_block_fused_async(
                None, window, 2, pool.block, dump)[0])
        res = await asyncio.gather(*[p.afetch() for p in pendings])
        for e in engines:
            e.close()
        pool.stop()
        return res, pool.steps, pool.synth_calls

    return _run(go())


def test_mesh_pool_matches_single_pool_and_jax_mesh_pool(weights):
    """12 fused starts over a dp=2 pool (6 slots a shard, each shard one
    vocode group on its own device): tokens identical to the one-device
    port pool and to JAX's ``DecodePool(mesh=create_mesh(dp_size=2))``,
    audio byte-identical to the one-device pool and within the pool
    tests' tolerance of JAX's."""
    n = 12
    params, table, codec = weights
    jm = jmesh.create_mesh(dp_size=2, tp_size=1)
    jp = jpool.DecodePool(params, table,
                          JWavCodec(codec, CODEC_CFG,
                                    buckets=SERVE_CFG.chunk_buckets),
                          capacity=n, dcfg=DEC_CFG, scfg=SERVE_CFG,
                          cache_dtype=jnp.float32, param_dtype=jnp.float32,
                          mesh=jm)
    want, jsteps, _ = _fused_starts(jp, jpool, n)
    single, s_steps, s_calls = _fused_starts(_port_pool(weights, n), tpool,
                                             n)
    mesh = create_mesh(dp_size=2, devices=_cpus(2))
    mp = _port_pool(weights, n, mesh=mesh)
    assert [sh.B for sh in mp.shards] == [6, 6] and not mp._spec
    got, steps, calls = _fused_starts(mp, tpool, n)
    assert steps == s_steps == jsteps == 1
    assert calls == 2 and s_calls == 2        # a group a shard; 8 + 4
    assert mp.stats()["dp"] == 2 and mp.stats()["steps"] == 1
    assert [sh.steps for sh in mp.shards] == [1, 1]
    for (gt, ga), (st, sa), (jt, ja) in zip(got, single, want):
        assert gt == st == jt and len(gt) >= SERVE_CFG.initial_dump_size_1
        assert ga == sa
        np.testing.assert_allclose(np.frombuffer(ga, "<f4"),
                                   np.frombuffer(ja, "<f4"), **CODEC_TOL)


def test_mesh_pool_serves_the_scheduler_as_one_device(weights):
    """Concurrent requests through the scheduler (merged steps, resets
    between sentences, slots on both shards): the same chunks as the
    one-device pool, byte for byte."""
    want = _run(_pooled_requests(_port_pool(weights, 8), REQUESTS, "port"))
    mp = _port_pool(weights, 8,
                    mesh=create_mesh(dp_size=4, devices=_cpus(4)))
    got = _run(_pooled_requests(mp, REQUESTS, "port"))
    for g, w in zip(got, want):
        assert len(g) >= 2 and g == w
    st = mp.stats()
    assert st["steps"] > 0 and st["merged_steps"] > 0 and st["active"] == 0
    assert mp.decode_steps == mp.block * (st["steps"] + st["merged_steps"])
    assert sum(sh.steps for sh in mp.shards) == 4 * st["steps"]


def test_batch_tts_over_dp4_matches_unsharded_and_jax(weights):
    """BatchTTS over four CPU shards against the unsharded port and JAX's
    ``BatchTTS(mesh=create_mesh(dp_size=4))`` (tests/test_batch.py's
    check): eight streams, and three (padded to four rows)."""
    params, table, codec = weights
    texts = [f"stream number {i} says something." for i in range(8)]
    tscfg = _tcfg(tconfig.ServeConfig, SERVE_CFG)

    def make(mesh=None):
        tcodec = TWavCodec(codec, T_CODEC, buckets=SERVE_CFG.chunk_buckets,
                           device="cpu")
        return TBatchTTS(params, table, tcodec, max_streams=8, dcfg=T_DEC,
                         scfg=tscfg, device="cpu",
                         cache_dtype=torch.float32, mesh=mesh)

    sharded = make(create_mesh(dp_size=4, devices=_cpus(4)))
    ref = make()
    jb = JBatchTTS(params, table,
                   JWavCodec(codec, CODEC_CFG,
                             buckets=SERVE_CFG.chunk_buckets),
                   max_streams=8, dcfg=DEC_CFG, scfg=SERVE_CFG,
                   cache_dtype=jnp.float32,
                   mesh=jmesh.create_mesh(dp_size=4, tp_size=1))
    toks = sharded.decode_texts(texts, max_tokens=12)
    assert toks == ref.decode_texts(texts, max_tokens=12)
    got = sharded.tts_batch(texts, max_tokens=12)
    want = jb.tts_batch(texts, max_tokens=12)
    for a, b, c in zip(got, ref.tts_batch(texts, max_tokens=12), want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, **CODEC_TOL)
    assert sharded.decode_texts(texts[:3], max_tokens=12) == toks[:3]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flags, err", [
    (["--pool_mesh_dp", "3", "--pool_capacity", "8"],
     "--pool_capacity 8 must divide over --pool_mesh_dp 3"),
    (["--pool_mesh_dp", "2", "--pool_ladder", "[4,8]"],
     "a --pool_ladder stays on one device"),
    (["--pool_mesh_dp", "2"], "shards the one pool of --pool_capacity")])
def test_cli_refuses_a_mesh_it_cannot_shard(flags, err, capsys):
    from llmvox_tpu_torch.serve.__main__ import main as serve_main
    with pytest.raises(SystemExit):
        serve_main(["--device", "cpu", "--random_seed", "0"] + flags)
    assert err in capsys.readouterr().err


def test_cli_refuses_more_shards_than_cards(capsys):
    from llmvox_tpu_torch.serve.__main__ import main as serve_main
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit):
        serve_main(["--random_seed", "0", "--pool_mesh_dp", str(n + 2),
                    "--pool_capacity", str(4 * (n + 2))])
    err = capsys.readouterr().err
    assert (f"need {n + 2} devices, have {n}" in err if n
            else "CUDA is not available" in err)


def test_cli_pool_mesh_dp_serves_tts(monkeypatch):
    """``--pool_mesh_dp 2 --pool_capacity 8 --device cpu`` (the tiny
    configs standing in for the deployed ones) builds a pool of two CPU
    shards of 4 slots and answers ``POST /tts`` with finite audio, every
    step on both shards."""
    from llmvox_tpu_torch.serve import __main__ as cli
    from llmvox_tpu_torch.serve import server as tserver
    from llmvox_tpu_torch.serve.client import post_chunks
    port = _free_port()
    real_build = tserver.build_server
    got = {}

    class _NoRun:
        def run(self):
            pass

    def fake_build_server(cfg, engines, pool=None):
        got.update(cfg=cfg, pool=pool, srv=real_build(
            dataclasses.replace(cfg, api_host="127.0.0.1", api_port=port),
            engines, pool=pool))
        return _NoRun()

    monkeypatch.setattr(cli, "DecoderConfig", lambda: T_DEC)
    monkeypatch.setattr(tserver, "build_server", fake_build_server)
    codec_flags = [a for f in ("vq_bins", "vq_dim", "backbone_input_channels",
                               "backbone_dim", "backbone_intermediate_dim",
                               "backbone_num_layers", "n_fft", "hop_length")
                   for a in (f"--{f}", str(getattr(CODEC_CFG, f)))]
    cli.main(["--device", "cpu", "--random_seed", "0", "--pool_mesh_dp", "2",
              "--pool_capacity", "8", "--decode_block", "8",
              "--max_audio_length", "10", "--initial_dump_size_1", "4",
              "--initial_dump_size_2", "8", "--max_dump_size", "16",
              "--chunk_buckets", "[4,8,16,32]", "--scripted_reply",
              "Hello there. How are you?"] + codec_flags)
    pool = got["pool"]
    assert got["cfg"].pool_mesh_dp == 2 and pool.stats()["dp"] == 2
    assert [(sh.B, sh.device.type) for sh in pool.shards] == [(4, "cpu")] * 2
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_until_complete,
                              args=(got["srv"].serve(),), daemon=True)
    thread.start()
    try:
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=0.2):
                    break
            except OSError:
                time.sleep(0.1)
        chunks = post_chunks("127.0.0.1", port, "/tts", {"text": "Hi."},
                             timeout=300)
    finally:
        got["srv"].shutdown()
        thread.join(timeout=60)
        loop.close()
    dispatch_executor(CPU).submit(lambda: None).result()
    wav = np.frombuffer(b"".join(c for _, c in chunks), "<f4")
    assert chunks and wav.size > 0 and np.isfinite(wav).all()
    steps = [sh.steps for sh in pool.shards]
    assert steps[0] == steps[1] == pool.steps > 0


def test_warmup_cache_warms_each_shard(capsys):
    """``tools/warmup_cache --pool_capacity 4 --pool_mesh_dp 2 --device
    cpu`` builds the pool as the server shards it and warms each shard
    (the tiny flags of test_torch_graphs.py's warmup test)."""
    from llmvox_tpu_torch.tools import warmup_cache
    warmup_cache.main([
        "--device", "cpu", "--n_layer", "1", "--n_head", "2", "--n_embd",
        "32", "--block_size", "128", "--vocab_size", "16",
        "--text_embed_dim", "12", "--speech_embed_dim", "20", "--vq_bins",
        "16", "--vq_dim", "20", "--backbone_input_channels", "20",
        "--backbone_dim", "32", "--backbone_intermediate_dim", "64",
        "--backbone_num_layers", "1", "--n_fft", "128", "--hop_length", "32",
        "--chunk_buckets", "[4, 8]", "--decode_block", "8",
        "--decode_block_large", "16", "--first_decode_block", "4",
        "--initial_dump_size_1", "4", "--pool_capacity", "4",
        "--pool_mesh_dp", "2", "--pool_decode_block", "8",
        "--compute_dtype", "float32"])
    out = capsys.readouterr().out
    assert ("pool of 4 (steps [(8, 0), (16, 0)], 2 shards of 2 on "
            "['cpu', 'cpu'])") in out
    with pytest.raises(SystemExit):
        warmup_cache.main(["--device", "cpu", "--pool_capacity", "4",
                           "--pool_mesh_dp", "3"])
