"""The port's codec metrics and their CLI (llmvox_tpu_torch/utils/native.py,
codec/{pesq,stoi,metrics,eval}.py, CodecTrainer.validation_metrics(full=
True)) against the JAX package's on the same 16 kHz inputs, on the CPU.

JAX's ``resample_poly`` takes a native Kaiser-sinc FIR when
``csrc/libllmvox_audio.so`` is built (another test file builds it) and
scipy's filter otherwise; the port always takes scipy's.  Every
comparison that resamples pins JAX's side to scipy
(``monkeypatch.setattr(native, "_lib", None)``); the native filter is held
to the port's within tests/test_native.py's interior bound, 5e-3.

Tolerances: the numpy metrics (PESQ, STOI, pitch, SI-SNR) are the same
code on the same arrays, to 1e-6; the mel distance and the mel loss to
1e-5 relative (f32 STFTs in two packages).  The CLI's copy synthesis
compares metrics of reconstructions that differ by f32 rounding between
the packages (a PCM16 step at most once written, asserted): 1e-3
relative plus 1e-3.  The trainer's full validation runs JAX's method on
the port's reconstruction (the generators are held to each other by
test_torch_codec_train.py)."""
import dataclasses
import json
import re
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly as scipy_resample

from llmvox_tpu.codec import eval as jeval
from llmvox_tpu.codec import metrics as jmetrics
from llmvox_tpu.codec import pesq as jpesq
from llmvox_tpu.codec import seanet as jseanet
from llmvox_tpu.codec import stoi as jstoi
from llmvox_tpu.train import codec_trainer as jct
from llmvox_tpu.train import vq_train as jvt
from llmvox_tpu.utils import native as jnative
from llmvox_tpu.utils.config import CodecConfig as JCodecConfig
from llmvox_tpu.utils.config import CodecTrainConfig as JCodecTrainConfig
from llmvox_tpu_torch.codec import eval as teval
from llmvox_tpu_torch.codec import metrics as tmetrics
from llmvox_tpu_torch.codec import pesq as tpesq
from llmvox_tpu_torch.codec import seanet as tseanet
from llmvox_tpu_torch.codec import stoi as tstoi
from llmvox_tpu_torch.train import checkpoint as tckpt
from llmvox_tpu_torch.train import codec_trainer as tct
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import native as tnative
from llmvox_tpu_torch.utils.params import init_codec_params, to_numpy

SR = 16000
# narrow, at the deployed hop and FFT: a 16-point ISTFT leaves spectral
# nulls at f32 rounding in a 1024-point mel analysis, where two packages'
# log-mels disagree by O(1)
TINY = JCodecConfig(n_filters=4, seanet_dimension=16, vq_dim=16,
                    vq_bins=32, backbone_input_channels=16, backbone_dim=32,
                    backbone_intermediate_dim=96, backbone_num_layers=1)
TINY_FLAGS = ["--n_filters", "4", "--seanet_dimension", "16", "--vq_dim",
              "16", "--vq_bins", "32", "--backbone_input_channels", "16",
              "--backbone_dim", "32", "--backbone_intermediate_dim", "96",
              "--backbone_num_layers", "1"]


def _port(cfg, cls, **kw):
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)}, **kw})


def speechish(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """Voiced harmonics under a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.5 * t) ** 2
    return (0.3 * env * voiced + 0.02 * rng.standard_normal(t.size)).astype(
        np.float32)


def _pairs():
    """(name, degraded, clean) at 16 kHz: a tone against a shifted tone,
    speech-like audio against itself and over an SNR ladder."""
    t = np.arange(SR) / SR
    tone = np.sin(2 * np.pi * 220 * t).astype(np.float32)
    other = np.sin(2 * np.pi * 233 * t + 0.3).astype(np.float32)
    clean = speechish(1.5, 0)
    noise = np.random.default_rng(1).standard_normal(clean.size)
    out = [("tone", other, tone), ("identity", clean, clean)]
    p = np.mean(clean ** 2)
    for snr in (40, 20, 10, 0):
        n = noise * np.sqrt(p / 10 ** (snr / 10) / np.mean(noise ** 2))
        out.append((f"snr{snr}", (clean + n).astype(np.float32), clean))
    return out


PAIRS = _pairs()


@pytest.fixture
def scipy_jax(monkeypatch):
    """JAX's resampler pinned to scipy's filter for this test."""
    monkeypatch.setattr(jnative, "_lib", None)


# ---------------------------------------------------------------------------
# utils/native.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("up,down", [(2, 3), (3, 2), (160, 441), (1, 1)])
def test_resample_poly_is_scipy_and_jax(up, down, scipy_jax):
    x = speechish(0.5, 2, 24000)
    got = tnative.resample_poly(x, up * 5, down * 5)
    np.testing.assert_array_equal(got, scipy_resample(x, up, down).astype(
        np.float32))
    np.testing.assert_array_equal(got, jnative.resample_poly(x, up * 5,
                                                             down * 5))
    assert got.dtype == np.float32


def test_native_filter_within_its_interior_bound(monkeypatch):
    """Where JAX's native library is loaded its filter differs from the
    port's (scipy's) by under 5e-3 in the interior (test_native.py)."""
    x = np.sin(2 * np.pi * 440 * np.arange(24000) / 24000).astype(np.float32)
    got = tnative.resample_poly(x, 2, 3)
    want = jnative.resample_poly(x, 2, 3)
    assert len(got) == len(want)
    n = len(got)
    err = np.abs(got[n // 10: -n // 10] - want[n // 10: -n // 10])
    assert err.max() < (5e-3 if jnative.HAVE_NATIVE else 1e-7)


def test_pcm_gain_and_ring_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", None)
    x = np.random.default_rng(3).uniform(-1.2, 1.2, 4096).astype(np.float32)
    pcm = tnative.f32_to_pcm16(x)
    np.testing.assert_array_equal(pcm, jnative.f32_to_pcm16(x))
    np.testing.assert_array_equal(tnative.pcm16_to_f32(pcm),
                                  jnative.pcm16_to_f32(pcm))
    np.testing.assert_array_equal(tnative.gain_normalize(x, -3.0),
                                  jnative.gain_normalize(x, -3.0))
    rings = [tnative.RingBuffer(64), jnative.RingBuffer(64)]
    big = bytes(range(100))
    for ring in rings:
        assert ring.write(b"hello") == 5 and ring.read(3) == b"hel"
        assert ring.write(big) == 62 and ring.available() == 64
        assert ring.read(100) == b"lo" + big[:62]


# ---------------------------------------------------------------------------
# the numpy metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,deg,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_pesq_stoi_pitch_si_snr_match_jax(name, deg, ref, scipy_jax):
    assert abs(tpesq.pesq_wb(ref, deg, SR) - jpesq.pesq_wb(ref, deg, SR)) \
        <= 1e-6
    assert tpesq.pesq(SR, ref, deg) == jpesq.pesq(SR, ref, deg)
    got, want = tstoi.stoi(ref, deg, SR), jstoi.stoi(ref, deg, SR)
    assert abs(got - want) <= 1e-6 or (np.isnan(got) and np.isnan(want))
    for a, b in zip(tmetrics.predict_pitch(deg, SR),
                    jmetrics.predict_pitch(deg, SR)):
        np.testing.assert_allclose(a, b, atol=1e-6, equal_nan=True)
    tp, jp = (tmetrics.pitch_metrics(deg, ref, SR),
              jmetrics.pitch_metrics(deg, ref, SR))
    assert tp.keys() == jp.keys()
    for k in tp:
        assert abs(tp[k] - jp[k]) <= 1e-6, k
    assert abs(tmetrics.si_snr(deg, ref) - jmetrics.si_snr(deg, ref)) <= 1e-6


def test_pesq_falls_on_the_snr_ladder():
    scores = [tmetrics.pesq_score(deg, ref) for name, deg, ref in PAIRS
              if name.startswith("snr")]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("sr", [24000, 16000])
def test_mel_distance_matches_jax(sr):
    x = speechish(1.0, 4, sr)
    y = (0.8 * x + 0.01 * np.random.default_rng(5).standard_normal(
        x.size)).astype(np.float32)
    got = tmetrics.mel_distance(y, x, sr, device="cpu")
    want = jmetrics.mel_distance(y, x, sr)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert tmetrics.mel_distance(torch.from_numpy(y), torch.from_numpy(x),
                                 sr) == got
    assert tmetrics.mel_distance(x, x, sr, device="cpu") == 0.0


def test_evaluate_pair_matches_jax(scipy_jax):
    x = speechish(1.2, 6, 24000)
    y = (x + 0.01 * np.random.default_rng(7).standard_normal(x.size)
         ).astype(np.float32)
    fake = lambda y_hat, sr: float(np.mean(y_hat ** 2)) + 3.0  # noqa: E731
    for m in (tmetrics, jmetrics):
        m.register_plugin("utmos", fake)
    try:
        got = tmetrics.evaluate_pair(y, x, 24000, device="cpu")
        want = jmetrics.evaluate_pair(y, x, 24000)
    finally:
        for m in (tmetrics, jmetrics):
            m.register_plugin("utmos", None)
    assert got.keys() == want.keys() and "utmos" in got and "pesq" in got
    for k in got:
        tol = 1e-5 * abs(want[k]) if k == "mel_distance" else 1e-6
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    # plug-ins come first, as in JAX's order
    tmetrics.register_plugin("pesq", lambda a, b, sr: 3.5)
    tmetrics.register_plugin("stoi", lambda a, b, sr: 0.91)
    try:
        out = tmetrics.evaluate_pair(y, x, 24000, device="cpu")
        assert out["pesq"] == 3.5 and out["stoi"] == 0.91
    finally:
        tmetrics.register_plugin("pesq", None)
        tmetrics.register_plugin("stoi", None)


def test_utmos_score_never_reaches_torch_hub(monkeypatch):
    def no_hub(*a, **k):
        raise AssertionError("torch.hub.load called")
    monkeypatch.setattr(torch.hub, "load", no_hub)
    x = speechish(0.5, 8)
    assert tmetrics.utmos_score(x) is None
    assert "utmos" not in tmetrics.evaluate_pair(x, x, SR, device="cpu")


# ---------------------------------------------------------------------------
# the eval CLI
# ---------------------------------------------------------------------------

def _write_wav(path, wav, sr):
    pcm = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _close_reports(got, want, rtol, atol):
    assert got["n"] == want["n"]
    assert got["mean"].keys() == want["mean"].keys()
    for k, v in want["mean"].items():
        if v is None:
            assert got["mean"][k] is None, k
        else:
            assert abs(got["mean"][k] - v) <= atol + rtol * abs(v), (
                k, got["mean"][k], v)


def test_eval_cli_recon_dir_matches_jax(tmp_path, scipy_jax):
    recon = tmp_path / "recon"
    recon.mkdir()
    refs = []
    for i, (name, sr) in enumerate((("a", 24000), ("b", 16000))):
        y = speechish(1.0 + 0.3 * i, 10 + i, sr)
        _write_wav(tmp_path / f"{name}.wav", y, sr)
        out = f"{name}_recon.wav" if i == 0 else f"{name}.wav"
        _write_wav(recon / out, 0.9 * y + 0.005, sr)
        refs.append(str(tmp_path / f"{name}.wav"))
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join(refs))
    _write_wav(tmp_path / "c.wav", speechish(0.5, 12), SR)   # no recon
    argv = ["--refs", str(lst), str(tmp_path / "c.wav"), "--recon_dir",
            str(recon)]
    got = teval.main(argv + ["--device", "cpu", "--out_json",
                             str(tmp_path / "t.json")])
    want = jeval.main(argv)
    assert got["n"] == 2
    _close_reports(got, want, rtol=1e-5, atol=1e-6)
    saved = json.loads((tmp_path / "t.json").read_text())
    assert saved["n"] == 2 and len(saved["per_file"]) == 2


def test_eval_cli_copy_synthesis_matches_jax(tmp_path, capsys, scipy_jax,
                                             monkeypatch):
    """``--codec_params``: both CLIs copy-synthesize through the same npz
    (the port: ``decode_codes_eager``; JAX: ``decode_codes`` at the exact
    length) and score; the reconstructions differ by at most one PCM16
    step."""
    cfg = _port(TINY, tconfig.CodecConfig)
    params = init_codec_params(0, cfg)
    params["encoder"] = tseanet.init_seanet_encoder(1, cfg)
    npz = tmp_path / "codec.npz"
    tckpt.save_params_npz(str(npz), params)
    # one file at the codec's rate (JAX compiles its encoder op by op and
    # a decode for each length; the other mode covers filelists and 16 kHz)
    refs = [str(tmp_path / "u0.wav")]
    _write_wav(refs[0], speechish(0.8, 20, 24000), 24000)
    argv = ["--refs", *refs, "--codec_params", str(npz), *TINY_FLAGS]
    # JAX's SEANet encoder compiled whole (op by op every op compiles)
    monkeypatch.setattr(jseanet, "apply_seanet_encoder",
                        jax.jit(jseanet.apply_seanet_encoder,
                                static_argnums=2))
    reports, dirs = [], []
    for main, extra in ((teval.main, ["--device", "cpu"]), (jeval.main, [])):
        reports.append(main(argv + extra))
        dirs.append(re.search(r"writing reconstructions to (\S+)",
                              capsys.readouterr().err).group(1))
    steps = 0
    for ref in refs:
        name = ref.split("/")[-1].replace(".wav", "_recon.wav")
        a, b = (np.frombuffer(wave.open(f"{d}/{name}").readframes(-1),
                              np.int16).astype(int) for d in dirs)
        assert a.shape == b.shape
        steps = max(steps, int(np.abs(a - b).max()))
    assert steps <= 1, steps
    print(f"copy synthesis: {steps} PCM16 steps apart; metric gaps "
          + ", ".join(f"{k} {abs(v - reports[1]['mean'][k]):.2e}"
                      for k, v in reports[0]["mean"].items()))
    _close_reports(reports[0], reports[1], rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the codec trainer's full validation
# ---------------------------------------------------------------------------

def test_validation_metrics_full_matches_jax(scipy_jax, monkeypatch):
    tcfg = JCodecTrainConfig(batch_size=2, num_samples=3072,
                             vq_kmeans_iters=5, mpd_periods=(2,),
                             mrd_resolutions=((512, 128, 512),),
                             dac_periods=(2,), dac_fft_sizes=(512,),
                             dp_size=1)
    ttr = tct.CodecTrainer(_port(TINY, tconfig.CodecConfig),
                           _port(tcfg, tconfig.CodecTrainConfig),
                           device="cpu")
    # JAX's trainer on the port's state, without its initialisers (they
    # draw and compile every tree: ~30 s): the method reads only these
    gen = jax.tree.map(jnp.asarray, to_numpy(ttr.gen.tree()))
    vq = jvt.VQState(**{k: jnp.asarray(v.numpy())
                        for k, v in ttr.vq._asdict().items()})
    jtr = types.SimpleNamespace(
        cfg=TINY, tcfg=tcfg,
        state=types.SimpleNamespace(gen_params=gen, vq_state=vq))
    audio = np.stack([speechish(0.5, 30, 24000),
                      0.5 * speechish(0.5, 31, 24000)])
    got = ttr.validation_metrics(audio, full=True)
    # JAX's method on the port's reconstruction: the two generators are
    # held to each other by test_torch_codec_train.py (JAX's eager forward
    # here would compile a few hundred ops, minutes under a loaded suite)
    y_hat = ttr.reconstruct(audio)

    def forward(gen, vq_state, y, *args, **kw):
        assert gen is jtr.state.gen_params and not kw["train"]
        return jnp.asarray(y_hat), None, vq_state
    monkeypatch.setattr(jct, "generator_forward", forward)
    want = jct.CodecTrainer.validation_metrics(jtr, audio, full=True)
    assert got.keys() == want.keys()
    assert {"val_mel_loss", "val_mel_distance", "val_pesq", "val_stoi",
            "val_voicing_f1"} <= set(got)
    for k, v in want.items():
        tol = 1e-5 * abs(v) if "mel" in k else 1e-6
        assert abs(got[k] - v) <= tol, (k, got[k], v)
