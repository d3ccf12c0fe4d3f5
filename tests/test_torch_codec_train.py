"""The port's codec GAN trainer (llmvox_tpu_torch/train/codec_trainer.py,
optim.py's codec schedule, codec_data.py, codec_main.py, checkpoint.py's
save_opaque, tools/prepare_data.py and tools/copy_synthesis.py) against
the JAX package's, in f32 on the CPU: two whole steps against JAX's
``make_codec_gan_steps`` pair with JAX's draws passed in, the pretrain
gate, checkpoints and the export read by JAX, the data pipeline and the
CLIs.

f32 leaky ReLUs: a discriminator input within rounding of 0 takes a
different slope in two f32 runs, which changes that sub-discriminator's
gradients by a discrete amount (up to 9% of a bias gradient's largest
element at this size).  The gradient check therefore holds every tensor
to 1e-4 of its largest element, and a sub-discriminator may miss it only
where one side's f32 gradient is itself that far from the port's f64
gradient (a mask that rounding flipped); the op-level tests
(test_torch_codec_ops.py) hold each family's gradients strictly."""
import dataclasses
import json
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llmvox_tpu.codec import codec as jcodec
from llmvox_tpu.tools import copy_synthesis as jcopy
from llmvox_tpu.tools import prepare_data as jprep
from llmvox_tpu.train import checkpoint as jckpt
from llmvox_tpu.train import codec_data as jdata
from llmvox_tpu.train import codec_trainer as jct
from llmvox_tpu.train import vq_train as jvt
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu.utils.config import CodecTrainConfig as JCodecTrainConfig
from llmvox_tpu_torch.codec import codec as tcodec
from llmvox_tpu_torch.codec import seanet as tseanet
from llmvox_tpu_torch.tools import copy_synthesis as tcopy
from llmvox_tpu_torch.tools import prepare_data as tprep
from llmvox_tpu_torch.train import codec_data as tdata
from llmvox_tpu_torch.train import codec_main as tmain
from llmvox_tpu_torch.train import checkpoint as tckpt
from llmvox_tpu_torch.train import codec_trainer as tct
from llmvox_tpu_torch.train import optim as toptim
from llmvox_tpu_torch.train.data import SpeechDataset
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import (codec_train_trees,
                                           init_codec_params, to_numpy,
                                           vq_to_numpy)

TINY_CODEC = JCodecConfig(
    downsamples=(2, 2), n_filters=4, seanet_dimension=16, vq_dim=16,
    vq_bins=32, backbone_input_channels=16, backbone_dim=64,
    backbone_intermediate_dim=96, backbone_num_layers=2,
    n_fft=16, hop_length=4)
TINY_TRAIN = JCodecTrainConfig(batch_size=2, num_samples=3072,
                               vq_kmeans_iters=5, max_steps=100,
                               mpd_periods=(2, 3),
                               mrd_resolutions=((512, 128, 512),),
                               dac_periods=(2,), dac_fft_sizes=(512,),
                               dp_size=1)
TINY_FLAGS = [
    "--batch_size", "2", "--num_samples", "3072", "--vq_kmeans_iters", "5",
    "--mpd_periods", "[2, 3]", "--mrd_resolutions", "[[512, 128, 512]]",
    "--dac_periods", "[2]", "--dac_fft_sizes", "[512]",
    "--downsamples", "[2, 2]", "--n_filters", "4", "--seanet_dimension",
    "16", "--vq_dim", "16", "--vq_bins", "32", "--backbone_input_channels",
    "16", "--backbone_dim", "64", "--backbone_intermediate_dim", "96",
    "--backbone_num_layers", "2", "--n_fft", "16", "--hop_length", "4"]


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


TCODEC = _port(TINY_CODEC, tconfig.CodecConfig)
TTRAIN = _port(TINY_TRAIN, tconfig.CodecTrainConfig)


def _audio(seed, b=2, t=3072):
    return (0.1 * np.random.default_rng(seed).standard_normal((b, t))
            ).astype(np.float32)


def _recording(tx):
    """``tx`` whose state also keeps the last gradients it was given."""
    def init(p):
        return (jax.tree.map(jnp.zeros_like, p), tx.init(p))

    def update(g, s, p):
        u, inner = tx.update(g, s[1], p)
        return u, (g, inner)
    return optax.GradientTransformation(init, update)


def _jax_draws(key, n, bins, cfg):
    """The bandwidth id and VQ rows JAX's step pair draws from ``key``."""
    k_bw, k_vq, _ = jax.random.split(key, 3)
    bw = int(jax.random.randint(k_bw, (), 0, cfg.adanorm_num_embeddings))
    init = (jax.random.permutation(k_vq, n)[:bins] if n >= bins
            else jax.random.randint(k_vq, (bins,), 0, n))
    dead = jax.random.randint(jax.random.fold_in(k_vq, 1), (bins,), 0, n)
    return tct.StepDraws(bw, torch.from_numpy(np.array(init)).long(),
                         torch.from_numpy(np.array(dead)).long())


def _jax_state(tr, tx):
    """JAX's state from the port trainer's (through the bridge), and the
    bridge back to the port's keywords from it, equal."""
    trees = codec_train_trees(tr.state)
    gen = jax.tree.map(jnp.asarray, trees["gen_params"])
    dis = jax.tree.map(jnp.asarray, trees["disc_params"])
    vq = jvt.VQState(**{k: jnp.asarray(v)
                        for k, v in trees["vq_state"].items()})
    state = jct.CodecTrainState(gen, dis, vq, tx.init(gen), tx.init(dis),
                                jnp.int32(0))
    back = codec_train_trees(jax.device_get(state))
    jax.tree.map(np.testing.assert_array_equal, back, trees)
    return state


@pytest.fixture(scope="module")
def pair():
    """JAX's (disc_step, gen_step) for the tiny configs, compiled once,
    with optimizers that record the gradients they are given."""
    tx = _recording(optax.adamw(jct.warmup_cosine_lr(TINY_TRAIN),
                                b1=TINY_TRAIN.adam_b1, b2=TINY_TRAIN.adam_b2))
    ds, gs = jct.make_codec_gan_steps(TINY_CODEC, TINY_TRAIN, tx, tx)
    return jax.jit(ds), jax.jit(gs), tx


class _NarrowTensors(torch.overrides.TorchFunctionMode):
    """Records (the port's file:line, the call) of each torch call whose
    result holds a floating tensor narrower than f64."""

    def __init__(self):
        super().__init__()
        self.narrow = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.dtype != torch.float64):
                f = sys._getframe(1)
                while f and "llmvox_tpu_torch" not in f.f_code.co_filename:
                    f = f.f_back
                where = (f"{os.path.basename(f.f_code.co_filename)}:"
                         f"{f.f_lineno}" if f else "?")
                self.narrow.append((where, getattr(func, "__name__",
                                                   str(func)), t.dtype))
        return out


def _run(pair, n_steps, audio, seed=5, **tkw):
    """n_steps of JAX's pair and of the port (f32 and f64) from one state
    and JAX's draws: per step (JAX logs, the port's logs, JAX's grads,
    the port's f32 and f64 grads), the final JAX state and trainers, and
    the torch calls of the f64 steps that made a tensor narrower than
    f64."""
    ds, gs, tx = pair
    tr = tct.CodecTrainer(TCODEC, TTRAIN, device="cpu", keep_grads=True,
                          **tkw)
    tr64 = tct.CodecTrainer(TCODEC, TTRAIN, device="cpu", keep_grads=True,
                            dtype=torch.float64, **tkw)
    state = _jax_state(tr, tx)
    n = audio.shape[0] * tct.encoded_length(audio.shape[1], TCODEC)
    rng = jax.random.PRNGKey(seed)
    steps, watch = [], _NarrowTensors()
    for _ in range(n_steps):
        key, rng = jax.random.split(rng)
        draws = _jax_draws(key, n, TCODEC.vq_bins, TCODEC)
        state, dl = ds(state, jnp.asarray(audio), key)
        jdg = jax.device_get(state.opt_d[0])
        state, gl = gs(state, jnp.asarray(audio), key)
        jgg = jax.device_get(state.opt_g[0])
        logs = tr.step(audio, draws)
        with watch:
            tr64.step(audio, draws)
        steps.append(({k: float(v) for k, v in {**dl, **gl}.items()}, logs,
                      {"gen": jgg, "disc": jdg},
                      {k: [g.numpy() for g in v] for k, v in tr.grads.items()},
                      {k: [g.numpy() for g in v]
                       for k, v in tr64.grads.items()}))
    return steps, jax.device_get(state), tr, tr64, watch.narrow


@pytest.fixture(scope="module")
def two_steps(pair):
    return _run(pair, 2, _audio(11))


def _unit(path):
    """The sub-discriminator a disc leaf belongs to (mpd/#0, dac/mrd/#1)."""
    parts = path.split("/")
    return "/".join(parts[:3] if parts[0] == "dac" else parts[:2])


# ---------------------------------------------------------------------------
# the schedule and the optimizer
# ---------------------------------------------------------------------------

def test_warmup_cosine_lr_matches_jax():
    for kw in (dict(num_warmup_steps=0, max_steps=100),
               dict(num_warmup_steps=10, max_steps=60),
               dict(num_warmup_steps=3, max_steps=1)):
        jc = JCodecTrainConfig(**kw)
        want = jct.warmup_cosine_lr(jc)
        got = toptim.warmup_cosine_lr(_port(jc, tconfig.CodecTrainConfig))
        for step in (0, 1, 2, 3, 9, 10, 11, 25, 49, 50, 51, 400):
            assert got(step) == float(want(step)), (kw, step)


def test_codec_adamw_updates_as_optax_adamw():
    """optax.adamw(schedule, b1, b2) as the codec trainer builds it: eps
    1e-8, weight decay 1e-4 on every leaf, no clip, the schedule read
    before the count; a warmup's first update is weight decay at lr 0."""
    jc = JCodecTrainConfig(initial_learning_rate=1e-2, num_warmup_steps=2,
                           max_steps=20)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    tx = optax.adamw(jct.warmup_cosine_lr(jc), b1=jc.adam_b1, b2=jc.adam_b2)
    state = tx.init(params)
    jp = jax.tree.map(jnp.asarray, params)
    tp = [torch.tensor(params["a"]), torch.tensor(params["b"]["c"])]
    opt = toptim.AdamW(_port(jc, tconfig.CodecTrainConfig), tp, [True, True])
    for i in range(6):
        grads = jax.tree.map(lambda x: (30.0 ** (i % 2) * rng.standard_normal(
            x.shape)).astype(np.float32), params)
        upd, state = jax.jit(tx.update)(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        assert opt.step([torch.tensor(grads["a"]),
                         torch.tensor(grads["b"]["c"])])
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]["c"]),
                                   atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# two whole steps against JAX's pair
# ---------------------------------------------------------------------------

def test_two_steps_logs_match_jax(two_steps):
    """Step 0 runs the disc half on the uninitialised codebook and the
    k-means init in the gen half; every log within 1e-4 relative."""
    steps, jstate, tr, _, _ = two_steps
    for i, (jl, tl, _, _, _) in enumerate(steps):
        assert set(jl) == set(tl) == set(tct.LOG_KEYS)
        for k in jl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-9,
                                       err_msg=f"step {i} {k}")
    assert int(jstate.step) == tr.iter_num == 2
    assert bool(tr.vq.inited) and bool(jstate.vq_state.inited)


def _compare_grads(step, tr):
    """(tensors off the bound, sub-discriminators with a flipped mask) of
    one step: each gradient against JAX's within 1e-4 of its largest
    element (the scale floored at 1e-6 of the tree's largest); a
    sub-discriminator counts as flipped where one side's f32 gradient is
    that far from the port's f64."""
    _, _, jg, g32, g64 = step
    off, flipped = set(), set()
    for name, mod in (("gen", tr.gen), ("disc", tr.disc)):
        flat = list(tckpt.flatten_pytree(jg[name]).values())
        top = max(float(np.abs(a).max()) for a in flat)
        for path, a, b, c in zip(mod.names, flat, g32[name], g64[name]):
            tol = 1e-4 * max(float(np.abs(a).max()), 1e-6 * top)
            if float(np.abs(b - a).max()) <= tol:
                continue
            off.add(f"{name}/{path}")
            if name == "disc" and (float(np.abs(b - c).max()) > tol or
                                   float(np.abs(a - c).max()) > tol):
                flipped.add(_unit(path))
    return off, flipped


def test_two_steps_gradients_match_jax(two_steps):
    """Every generator gradient within 1e-4 of its largest element (the
    floor: the attention's key bias has an exactly zero gradient, softmax
    being shift invariant, and its f32 values are rounding); every
    discriminator gradient the same but in sub-discriminators with a
    flipped leaky-ReLU mask (module docstring), at most two of the five."""
    steps, _, tr, _, _ = two_steps
    for i, step in enumerate(steps):
        off, flipped = _compare_grads(step, tr)
        bad = {p for p in off if p.startswith("gen/") or
               _unit(p[len("disc/"):]) not in flipped}
        assert not bad, (i, sorted(bad))
        assert len(flipped) <= 2, (i, sorted(flipped))


def test_two_steps_params_and_vq_match_jax(two_steps):
    """After two steps: every parameter within JAX's own bound between
    its step implementations (rtol 2e-3, atol 5e-5), but in the
    sub-discriminators whose masks flipped at a step (their gradients
    moved, and Adam's first steps move an element by about lr whatever
    its gradient's size), at most 1 element in 1000; the VQ state to
    1e-5."""
    steps, jstate, tr, _, _ = two_steps
    flipped = set().union(*(_compare_grads(s, tr)[1] for s in steps))
    for name, jtree, mod in (("gen", jstate.gen_params, tr.gen),
                             ("disc", jstate.disc_params, tr.disc)):
        flat = list(tckpt.flatten_pytree(jtree).values())
        n_out = n_all = 0
        for path, a, p in zip(mod.names, flat, mod.params):
            out = np.abs(p.detach().numpy() - a) > 5e-5 + 2e-3 * np.abs(a)
            n_out += int(out.sum())
            n_all += out.size
            assert not out.any() or (name == "disc" and
                                     _unit(path) in flipped), path
        assert n_out <= n_all / 1000, (name, n_out, n_all)
    vq = vq_to_numpy(tr.vq)
    for k, v in vq_to_numpy(jstate.vq_state).items():
        np.testing.assert_allclose(vq[k], v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_f64_run_is_the_f32_run_to_rounding(two_steps):
    """The port's f64 trainer takes the same steps (every log to 1e-4
    relative), so it is the reference the gradient check measures
    rounding against."""
    steps, _, tr, tr64, _ = two_steps
    assert tr64.gen.params[0].dtype == torch.float64
    for _, tl, _, _, _ in steps:
        assert np.isfinite(list(tl.values())).all()
    logs64 = tr64.validation_metrics(_audio(11))
    np.testing.assert_allclose(tr.validation_metrics(_audio(11))[
        "val_mel_loss"], logs64["val_mel_loss"], rtol=1e-4)


def test_f64_step_makes_no_f32_tensor(two_steps):
    """The f64 trainer's steps (k-means init, then EMA and expiry),
    validation pass and reconstruction compute every floating tensor in
    f64: an f32 island (``ops/nn.py``'s norms, the head, the ISTFT, the
    mel features) that casts with ``.float()`` instead of ``ops.nn.wide``
    would put f32 rounding into the f64 reference that the gradient
    checks measure rounding against."""
    _, _, _, tr64, narrow = two_steps
    watch = _NarrowTensors()
    with watch:
        tr64.validation_metrics(_audio(15))
        tr64.reconstruct(_audio(15))
    assert tr64.iter_num == 2 and bool(tr64.vq.inited)
    assert not narrow + watch.narrow, sorted(set(narrow + watch.narrow))


def test_pretrain_gate_moves_discriminators_by_weight_decay_alone():
    """Under pretrain_mel_steps the disc gradients are zeroed but AdamW
    still runs: each disc param becomes p * (1 - lr * 1e-4) (Adam's term
    is 0 / (0 + eps)), the moments stay 0, and the generator's total is
    the mel and commitment terms alone."""
    # a large rate, so lr * 1e-4 is above f32's rounding of the params
    tcfg = dataclasses.replace(TTRAIN, pretrain_mel_steps=5,
                               initial_learning_rate=0.5)
    tr = tct.CodecTrainer(TCODEC, tcfg, device="cpu")
    before = [p.detach().clone() for p in tr.disc.params]
    logs = tr.step(_audio(12))
    lr = toptim.warmup_cosine_lr(tcfg)(0)
    for b, p, mu in zip(before, tr.disc.params, tr.opt_d.mu):
        torch.testing.assert_close(p.detach(), b - lr * 1e-4 * b,
                                   rtol=0, atol=1e-9)
        assert not mu.any()
    assert any(not torch.equal(b, p) for b, p in zip(before, tr.disc.params))
    np.testing.assert_allclose(
        logs["gen_total"], tcfg.mel_loss_coeff * logs["mel"] +
        tcfg.commit_loss_coeff * logs["commit"], rtol=1e-6)


def test_every_step_impl_runs_the_one_eager_step_and_remat_changes_nothing():
    """JAX's "fused", "split" and "micro" are one computation (its
    test_split_step_matches_fused, test_micro_step_matches_fused); the
    port runs its one step for each, here "fused" plainly and "micro"
    with the encoder and the synthesis recomputed in the backward pass,
    as JAX's micro step does ("split" is the default every other test
    runs): the same logs and gradients from one seed."""
    audio = _audio(14)
    a, b = (tct.CodecTrainer(TCODEC, dataclasses.replace(
        TTRAIN, step_impl=impl), device="cpu", keep_grads=True)
        for impl in ("fused", "micro"))
    la, lb = a.step(audio), b.step(audio)
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=1e-6, err_msg=k)
    for x, y in zip(a.grads["gen"], b.grads["gen"]):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)


def test_refusals():
    # data parallelism runs one rank a card: a dp_size that is not the
    # launch's world size (1 here) is refused (test_torch_parallel_codec.py
    # trains on two ranks)
    with pytest.raises(ValueError, match="world of 1"):
        tct.CodecTrainer(TCODEC, dataclasses.replace(TTRAIN, dp_size=2),
                         device="cpu")
    tr = tct.CodecTrainer(TCODEC, TTRAIN, device="cpu")
    full = tr.validation_metrics(_audio(1), full=True)
    assert {"val_mel_loss", "val_mel_distance", "val_si_snr",
            "val_periodicity", "val_pitch_rmse_cents", "val_voicing_f1",
            "val_pesq", "val_stoi"} <= set(full)
    assert np.isfinite(tr.validation_metrics(_audio(1))["val_mel_loss"])
    assert full["val_mel_loss"] == tr.validation_metrics(
        _audio(1))["val_mel_loss"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tct.CodecTrainer(TCODEC, TTRAIN)


# ---------------------------------------------------------------------------
# checkpoints and the export, read by JAX
# ---------------------------------------------------------------------------

def test_checkpoints_and_export_are_read_by_jax(tmp_path):
    tcfg = dataclasses.replace(TTRAIN, out_dir=str(tmp_path))
    gen = tct.init_generator_params(3, TCODEC)
    head = gen["head"]["w"].copy()
    tr = tct.CodecTrainer(TCODEC, tcfg, device="cpu", gen_params=gen)
    tr.step(_audio(15))
    # the trainer updates copies, not the caller's arrays
    np.testing.assert_array_equal(gen["head"]["w"], head)
    path = tr.save_checkpoint()
    saved = jckpt.load_params_npz(path)
    assert json.load(open(path + ".json")) == {"iter_num": 1}
    jax.tree.map(np.testing.assert_array_equal, saved["gen"],
                 to_numpy(tr.gen.tree()))
    jvq = jax.device_get(jvt.init_vq_state(jax.random.PRNGKey(0), 32, 16))
    assert set(saved["vq"]) == set(jvq._asdict())
    assert bool(saved["vq"]["inited"])
    # the same keys, in the same order, as JAX's trainer writes
    jtree = {"gen": jax.eval_shape(lambda: jct.init_generator_params(
        jax.random.PRNGKey(0), TINY_CODEC)), "vq": jvq._asdict()}
    assert list(np.load(path).files) == list(jckpt.flatten_pytree(jtree))
    jdisc = jax.eval_shape(lambda: jct.init_discriminator_params(
        jax.random.PRNGKey(0), TINY_TRAIN))
    filled = jckpt.fill_like(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jdisc),
        os.path.join(tmp_path, "codec_ckpt.disc.npz"))
    jax.tree.map(np.testing.assert_array_equal, filled,
                 to_numpy(tr.disc.tree()))
    for name in ("gen", "disc"):
        assert os.path.exists(tmp_path / f"codec_ckpt.{name}.adamw.npz")
    # the folded export decodes and encodes equal in both packages
    exp = os.path.join(tmp_path, "codec_inference.npz")
    jckpt.save_params_npz(exp, tr.export_inference_params())
    jc = jcodec.WavCodec.from_pretrained(exp, TINY_CODEC)
    tc = tcodec.WavCodec.from_pretrained(exp, TCODEC, device="cpu",
                                         graphs=False)
    wav = _audio(16, 1, 1000)
    jf, jcodes = jc.encode_infer(wav)
    tf, tcodes = tc.encode_infer(wav)
    np.testing.assert_array_equal(tcodes, np.asarray(jcodes))
    codes = np.random.default_rng(0).integers(0, 32, (1, 40)).astype(np.int32)
    np.testing.assert_allclose(
        tc.decode_codes_eager(codes),
        np.asarray(jc.decode_codes(codes, pad_to_bucket=False)),
        atol=2e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# data and the CLIs
# ---------------------------------------------------------------------------

def _write_wav(path, seed, n, sr):
    pcm = (np.random.default_rng(seed).standard_normal(n) * 3000).astype(
        np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


def test_data_utils_and_batches_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    wav = rng.standard_normal(1000).astype(np.float32)
    for gain in (-6.0, -3.0, -1.0):
        np.testing.assert_array_equal(tdata.gain_normalize(wav, gain),
                                      jdata.gain_normalize(wav, gain))
    for n in (2500, 1000, 300):
        a, b = np.random.default_rng(n), np.random.default_rng(n)
        np.testing.assert_array_equal(tdata.crop_or_repeat(wav, n, a),
                                      jdata.crop_or_repeat(wav, n, b))
    files = [_write_wav(tmp_path / f"a{i}.wav", i, 2000 + 700 * i,
                        16000 if i % 2 else 24000) for i in range(5)]
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join(files))
    for train in (True, False):
        jb = jdata.CodecDataset(str(lst), TINY_TRAIN, train=train,
                                seed=3).batches(2)
        tb = tdata.CodecDataset(str(lst), TTRAIN, train=train,
                                seed=3).batches(2)
        for _ in range(4):
            np.testing.assert_array_equal(next(tb), next(jb))


def test_codec_main_cli_writes_what_jax_reads(tmp_path):
    files = [_write_wav(tmp_path / f"a{i}.wav", i, 4000, 24000)
             for i in range(2)]
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join(files))
    out = tmp_path / "out"
    tmain.main(["--filelist_train", str(lst), "--filelist_val", str(lst),
                "--out_dir", str(out), "--max_steps", "2", "--log_interval",
                "1", "--val_interval", "2", "--val_batch_size", "1",
                "--device", "cpu", *TINY_FLAGS])
    assert json.load(open(out / "codec_ckpt.npz.json")) == {"iter_num": 2}
    recs = [json.loads(l) for l in open(out / "codec.metrics.jsonl")]
    assert [r["step"] for r in recs if "mel" in r] == [1, 2]
    assert any("val_mel_loss" in r for r in recs)
    exp = jckpt.load_params_npz(str(out / "codec_inference.npz"))
    assert exp["codebooks"].shape == (1, 32, 16)
    assert "w" in exp["encoder"]["conv_in"]
    jc = jcodec.WavCodec.from_pretrained(str(out / "codec_inference.npz"),
                                         TINY_CODEC)
    assert np.isfinite(np.asarray(jc.encode_infer(_audio(3, 1, 800))[0])
                       ).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain.main(["--filelist_train", str(lst), "--out_dir",
                        str(tmp_path / "o2"), "--max_steps", "1",
                        *TINY_FLAGS])


@pytest.fixture(scope="module")
def codec_npz(tmp_path_factory):
    """A tiny codec with an encoder (the port's numpy initialisers)."""
    params = init_codec_params(7, TCODEC)
    params["encoder"] = tseanet.init_seanet_encoder(8, TCODEC)
    path = str(tmp_path_factory.mktemp("codec") / "codec.npz")
    jckpt.save_params_npz(path, params)
    return path


def test_prepare_data_cli_matches_jax(tmp_path, codec_npz, monkeypatch):
    """The same manifest and wavs (one at 16 kHz, resampled) through both
    CLIs: the same text ids and codes, the natural EOA stripped."""
    folder = tmp_path / "wavs"
    folder.mkdir()
    items = []
    for i, sr in enumerate((24000, 16000, 24000)):
        _write_wav(folder / f"u{i}.wav", 20 + i, 1500 + 400 * i, sr)
        items.append({"id": f"u{i}", "answer_text": f"hello number {i}."})
    manifest = tmp_path / "data.json"
    manifest.write_text(json.dumps(items))
    args = ["--data_path", str(manifest), "--speech_data_folder",
            str(folder), "--codec_params", codec_npz, "--eoa_token_id", "5"]
    monkeypatch.setattr(jcodec.WavCodec, "from_pretrained", classmethod(
        lambda cls, path, cfg=None: cls(jckpt.load_params_npz(path),
                                        TINY_CODEC)))
    jprep.main(args + ["--out", str(tmp_path / "j.npz")])
    monkeypatch.setattr(tcodec.WavCodec, "from_pretrained", classmethod(
        lambda cls, path, cfg=None, **kw: cls(
            tcodec.load_params_npz(path), TCODEC, **kw)))
    tprep.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    j, t = SpeechDataset(str(tmp_path / "j.npz")), SpeechDataset(
        str(tmp_path / "t.npz"))
    assert len(t) == len(j) == 3
    for a, b in zip(t.samples, j.samples):
        np.testing.assert_array_equal(a.text_ids, b.text_ids)
        np.testing.assert_array_equal(a.codes, b.codes)
        assert 5 not in a.codes


def test_copy_synthesis_cli_matches_jax(tmp_path, codec_npz, monkeypatch):
    """Both CLIs reconstruct the same wav (16 kHz in, resampled) at its
    own length, to 2 PCM16 steps."""
    src = _write_wav(tmp_path / "in.wav", 30, 3000, 16000)
    monkeypatch.setattr(jcodec.WavCodec, "from_pretrained", classmethod(
        lambda cls, path, cfg=None: cls(jckpt.load_params_npz(path),
                                        TINY_CODEC)))
    monkeypatch.setattr(tcodec.WavCodec, "from_pretrained", classmethod(
        lambda cls, path, cfg=None, **kw: cls(
            tcodec.load_params_npz(path), TCODEC, **kw)))
    jcopy.main(["--codec_params", codec_npz, "--inputs", src, "--out_dir",
                str(tmp_path / "j")])
    tcopy.main(["--codec_params", codec_npz, "--inputs", src, "--out_dir",
                str(tmp_path / "t"), "--device", "cpu"])

    def pcm(p):
        with wave.open(str(p), "rb") as w:
            assert w.getframerate() == 24000
            return np.frombuffer(w.readframes(w.getnframes()), "<i2")
    a, b = pcm(tmp_path / "t" / "in_recon.wav"), pcm(tmp_path / "j" /
                                                     "in_recon.wav")
    assert a.shape == b.shape and a.size == 4500
    assert np.abs(a.astype(np.int32) - b).max() <= 2
