"""The port's data-parallel codec trainer (train/codec_trainer.py and
vq_train.py under a process group) against JAX's CodecTrainer on a dp=2
mesh, in f32 on the CPU.

Two gloo ranks are spawned once for the module: each takes its block of
the same global batches, and both run the step through the k-means init
(on the ranks' rows gathered in rank order) and one step after it (EMA
statistics summed over the ranks, dead codes replaced by the global rows
their draws name).  JAX's draws (bandwidth, k-means rows, dead-code rows)
are fed to every rank, as tests/test_torch_codec_train.py feeds them to
one process; they index the global rows.

Bounds.  The logs of the k-means step and the VQ state after each step
are held to JAX's own bound between its step implementations
(tests/test_codec_train.py: ``rtol=2e-4, atol=1e-5``).  A log of the
next step may miss it only where JAX's f32 value is itself that far
from the port's f64 one-process run on the same batches and draws, and
then the ranks' value is held to that f64 run: an f32 leaky ReLU whose
input is within rounding of 0 takes a different slope in two runs (with a
DAC discriminator in this config, JAX's grad_norm_gen sat 0.37% from the
f64 run's, the ranks' 0.009%).  The params after Adam's first steps are held as the
one-process trainer's are (tests/test_torch_codec_train.py: rtol 2e-3,
atol 5e-5, at most 1 element in 1000 outside)."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llmvox_tpu.parallel import mesh as jmesh
from llmvox_tpu.parallel.sharding import batch_sharding, replicated
from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import codec_trainer as jct
from llmvox_tpu.train import vq_train as jvt
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu.utils.config import CodecTrainConfig as JCodecTrainConfig
import torch

from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.train import codec_trainer as tct
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import codec_train_trees

from tests import torch_dp_ranks as ranks

CODEC = JCodecConfig(
    downsamples=(2, 2), n_filters=4, seanet_dimension=16, vq_dim=16,
    vq_bins=32, backbone_input_channels=16, backbone_dim=64,
    backbone_intermediate_dim=96, backbone_num_layers=2, n_fft=16,
    hop_length=4)
# one MPD and one MRD sub-discriminator and no DAC: the data-parallel
# path (rows, gradient means, the VQ's gathers and sums) is the same for
# every discriminator family, and JAX compiles this pair in ~20 s (~33 s
# with a DAC; each family is held one-process in
# tests/test_torch_codec_train.py)
TRAIN = JCodecTrainConfig(batch_size=4, num_samples=1024, vq_kmeans_iters=5,
                          max_steps=100, mpd_periods=(2,),
                          mrd_resolutions=((512, 128, 512),),
                          dac_periods=(), dac_fft_sizes=(), dp_size=2)
TOL = dict(rtol=2e-4, atol=1e-5)


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


TCODEC = _port(CODEC, tconfig.CodecConfig)
TTRAIN = _port(TRAIN, tconfig.CodecTrainConfig, dp_size=-1)


def _audio(seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (TRAIN.batch_size, TRAIN.num_samples))).astype(np.float32)


def _jax_draws(key, n, bins, cfg):
    """The bandwidth id and VQ rows JAX's step pair draws from ``key``
    (tests/test_torch_codec_train.py's)."""
    k_bw, k_vq, _ = jax.random.split(key, 3)
    bw = int(jax.random.randint(k_bw, (), 0, cfg.adanorm_num_embeddings))
    init = (jax.random.permutation(k_vq, n)[:bins] if n >= bins
            else jax.random.randint(k_vq, (bins,), 0, n))
    dead = jax.random.randint(jax.random.fold_in(k_vq, 1), (bins,), 0, n)
    return tct.StepDraws(bw, torch.from_numpy(np.array(init)).long(),
                         torch.from_numpy(np.array(dead)).long())


def _flat(tree):
    """Path -> a copy of the leaf (a JAX buffer is donated at the next
    step)."""
    return {k: np.array(v) for k, v in jckpt.flatten_pytree(tree).items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Two steps of JAX's CodecTrainer over a dp=2 mesh (its step, on a
    trainer whose state is the port's seeded one), the draws it made, and
    the two ranks' results on the same batches and draws."""
    init = tct.CodecTrainer(TCODEC, dataclasses.replace(TTRAIN, dp_size=1),
                            device="cpu")
    trees = codec_train_trees(init.state)
    sched = jct.warmup_cosine_lr(TRAIN)
    jt = jct.CodecTrainer.__new__(jct.CodecTrainer)
    jt.cfg, jt.tcfg = CODEC, TRAIN
    jt.mesh = jmesh.create_mesh(dp_size=2, tp_size=1)
    jt.rng = jax.random.PRNGKey(3)
    jt.tx_g = optax.adamw(sched, b1=TRAIN.adam_b1, b2=TRAIN.adam_b2)
    jt.tx_d = optax.adamw(sched, b1=TRAIN.adam_b1, b2=TRAIN.adam_b2)
    jt.bsh = batch_sharding(jt.mesh)
    rep = replicated(jt.mesh)
    # copies: the steps donate their state, and XLA may write the
    # outputs into a buffer that a zero-copy asarray shares with numpy
    gen = jax.tree.map(jnp.array, trees["gen_params"])
    dis = jax.tree.map(jnp.array, trees["disc_params"])
    vq = jvt.VQState(**{k: jnp.array(v)
                        for k, v in trees["vq_state"].items()})
    # every leaf replicated, as the step's outputs are (a scalar left on
    # one device would compile the disc step a second time)
    jt.state = jax.device_put(jct.CodecTrainState(
        gen, dis, vq, jt.tx_g.init(gen), jt.tx_d.init(dis), jnp.int32(0)),
        rep)
    ds, gs = jct.make_codec_gan_steps(CODEC, TRAIN, jt.tx_g, jt.tx_d)
    jt._disc_step = jax.jit(ds, donate_argnums=(0,))
    jt._gen_step = jax.jit(gs, donate_argnums=(0,))
    jt.iter_num = 0
    n = TRAIN.batch_size * tct.encoded_length(TRAIN.num_samples, TCODEC)
    audios = [_audio(1), _audio(2)]
    # the keys JAX's step splits off its rng, and their draws
    draws, rng = [], jt.rng
    for _ in audios:
        key, rng = jax.random.split(rng)
        d = _jax_draws(key, n, CODEC.vq_bins, CODEC)
        draws.append((d.bandwidth_id, d.init_idx.numpy(),
                      d.dead_idx.numpy()))
    # the ranks run while JAX compiles
    res = {}
    ranks_thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.codec_trainer, 2, TCODEC, TTRAIN, trees["gen_params"],
        trees["disc_params"], trees["vq_state"], audios, draws,
        str(tmp_path_factory.mktemp("codec_dp")), threads=2,
        timeout_s=240)))
    ranks_thread.start()
    jlogs, jstates = [], []
    for audio in audios:
        jlogs.append(jt.step(audio))
        st = jax.device_get(jt.state)
        jstates.append({"gen_params": _flat(st.gen_params),
                        "disc_params": _flat(st.disc_params),
                        "vq_state": {k: np.array(v) for k, v in
                                     st.vq_state._asdict().items()}})
    f64 = tct.CodecTrainer(TCODEC, dataclasses.replace(TTRAIN, dp_size=1),
                           device="cpu", gen_params=trees["gen_params"],
                           disc_params=trees["disc_params"],
                           vq_state=trees["vq_state"], dtype=torch.float64)
    logs64 = [f64.step(a, tct.StepDraws(bw, torch.from_numpy(i),
                                        torch.from_numpy(d)))
              for a, (bw, i, d) in zip(audios, draws)]
    ranks_thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(jlogs=jlogs, jstates=jstates, ranks=res["r"], n=n,
                draws=draws, logs64=logs64)


def _close(a, b):
    return abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)


@pytest.mark.parametrize("step", [0, 1])
def test_dp_logs_match_jax_dp2(dp, step):
    """Every log of the k-means step within JAX's bound; of the next step
    too, but where JAX's own f32 value is off the f64 run (module
    docstring)."""
    want, ref = dp["jlogs"][step], dp["logs64"][step]
    excused = set()
    for r in dp["ranks"]:
        assert r["dp"] == 2
        got = r["logs"][step]
        assert set(got) == set(want) == set(ref)
        for k in want:
            if _close(got[k], want[k]):
                continue
            assert step > 0 and not _close(want[k], ref[k]), k
            assert _close(got[k], ref[k]), k
            excused.add(k)
    assert excused <= {"grad_norm_gen"}
    assert dp["ranks"][0]["logs"] == dp["ranks"][1]["logs"]


@pytest.mark.parametrize("step", [0, 1])
def test_dp_state_matches_jax_dp2(dp, step):
    """The VQ after the k-means step and after the next one within JAX's
    bound (the codebook after the init is the k-means of the global
    rows); the generator and the discriminators as the one-process
    trainer is held (module docstring)."""
    got = dp["ranks"][0]["states"][step]
    want = dp["jstates"][step]
    for k, v in want["vq_state"].items():
        np.testing.assert_allclose(np.asarray(got["vq_state"][k]), v, **TOL,
                                   err_msg=k)
    assert bool(got["vq_state"]["inited"])
    for part in ("gen_params", "disc_params"):
        g = _flat(got[part])
        assert g.keys() == want[part].keys()
        n_out = n_all = 0
        for k, v in want[part].items():
            out = np.abs(g[k] - v) > 5e-5 + 2e-3 * np.abs(v)
            n_out += int(out.sum())
            n_all += out.size
        assert n_out <= n_all / 1000, (part, n_out, n_all)
    # the init drew rows of the whole batch, both ranks' halves
    init = dp["draws"][0][1]
    assert (init < dp["n"] // 2).any() and (init >= dp["n"] // 2).any()


def test_dp_ranks_stay_bitwise_equal_and_rank_0_writes(dp):
    for r in dp["ranks"]:
        assert r["lockstep"] == [True, True]
        assert r["path"].endswith("dp.npz")
    assert {"dp.npz", "dp.disc.npz", "dp.gen.adamw.npz",
            "dp.disc.adamw.npz"} <= set(dp["ranks"][0]["files"])
    vq = jckpt.load_params_npz(dp["ranks"][0]["path"])["vq"]
    np.testing.assert_array_equal(
        vq["embed"], np.asarray(dp["ranks"][0]["states"][1]["vq_state"]
                                ["embed"]))
