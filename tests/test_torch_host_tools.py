"""The port's host tools and its CLIs under ``torchrun``, on the CPU:

- ``tools/warmup_cache.py --batch_streams N`` warms ``BatchTTS`` at N
  streams, as JAX's tool compiles it;
- ``utils/runtime.py``: ``profile_trace`` writes a Chrome trace that holds
  a ``utils/trace.py`` span;
- ``tools/validate_parity.py``: each section skipped without its inputs,
  as JAX's is; the comparisons against the reference's own torch code run
  where ``LLMVOX_REFERENCE`` names its checkout (they skip otherwise, as
  JAX's ``tests/test_convert.py`` skips without one);
- ``serve/ui.py``: the headless ``TerminalDemo`` against the port's
  server (as ``tests/test_server.py`` holds JAX's), the Qt window behind
  ``pytest.importorskip("PyQt5")`` (as ``tests/test_ui_qt.py``);
- the codec CLI under ``torchrun --nproc_per_node 2`` (gloo) against the
  one-process CLI, and the decoder CLI at ``--tp_size 2`` against the
  one-process CLI.  Both launches start with the module's fixture and run
  while the other tests do."""
import builtins
import dataclasses
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from llmvox_tpu_torch.serve import server as tserver
from llmvox_tpu_torch.serve.batch import BatchTTS
from llmvox_tpu_torch.serve.client import post_chunks, to_wave
from llmvox_tpu_torch.tools import validate_parity, warmup_cache
from llmvox_tpu_torch.train import __main__ as train_main
from llmvox_tpu_torch.train import codec_main
from llmvox_tpu_torch.train.checkpoint import load_params_npz
from llmvox_tpu_torch.train.data import Sample, save_prepared
from llmvox_tpu_torch.utils import audio, runtime
from llmvox_tpu_torch.utils import trace as tracing

from tests import test_torch_engine as eng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.environ.get("LLMVOX_REFERENCE", "")

CODEC_FLAGS = [
    "--batch_size", "2", "--num_samples", "3072", "--vq_kmeans_iters", "5",
    "--mpd_periods", "[2, 3]", "--mrd_resolutions", "[[512, 128, 512]]",
    "--dac_periods", "[2]", "--dac_fft_sizes", "[512]",
    "--downsamples", "[2, 2]", "--n_filters", "4", "--seanet_dimension",
    "16", "--vq_dim", "16", "--vq_bins", "32", "--backbone_input_channels",
    "16", "--backbone_dim", "64", "--backbone_intermediate_dim", "96",
    "--backbone_num_layers", "2", "--n_fft", "16", "--hop_length", "4",
    "--max_steps", "2", "--log_interval", "1", "--val_interval", "100",
    "--device", "cpu"]
DECODER_FLAGS = [
    "--batch_size", "4", "--gradient_accumulation_steps", "2",
    "--eval_interval", "4", "--eval_iters", "1", "--log_interval", "1",
    "--dtype", "float32", "--warmup_iters", "1", "--grad_clip", "0.5",
    "--max_iters", "5", "--bucket", "32", "--n_layer", "2", "--n_head",
    "4", "--n_embd", "32", "--block_size", "64", "--vocab_size", "16",
    "--text_embed_dim", "12", "--speech_embed_dim", "20", "--eoa_token_id",
    "15", "--n_draft_heads", "2", "--bias", "true", "--device", "cpu"]
# the decoder trainer's bounds (tests/test_torch_parallel_train.py)
PARAM_TOL = dict(atol=2e-6, rtol=1e-5)
# the codec trainer's, one process against another (tests/
# test_torch_parallel_codec.py): the VQ to JAX's bound, the generator's
# params as the one-process trainer is held to JAX (at most 1 element in
# 1000 outside rtol 2e-3, atol 5e-5: a leaky ReLU's slope may flip)
VQ_TOL = dict(rtol=2e-4, atol=1e-5)


def _write_wav(path, seed, n, sr):
    pcm = (np.random.default_rng(seed).standard_normal(n) * 3000).astype(
        np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


def _torchrun(module, flags, out_dir):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, "--out_dir", str(out_dir)]
        + flags, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The two launches, started at once: the codec CLI data-parallel on
    two ranks and the decoder CLI tensor-parallel on two ranks."""
    d = tmp_path_factory.mktemp("clis")
    files = [_write_wav(d / f"a{i}.wav", i, 4000 + 500 * i,
                        (24000, 16000)[i % 2]) for i in range(4)]
    (d / "files.txt").write_text("\n".join(files))
    codec_flags = CODEC_FLAGS + ["--filelist_train", str(d / "files.txt")]
    rng = np.random.default_rng(0)
    save_prepared(str(d / "data.npz"), [
        Sample(text_ids=rng.integers(0, 384, 12).astype(np.int32),
               codes=rng.integers(0, 16, int(rng.integers(8, 30))
                                  ).astype(np.int32)) for _ in range(8)])
    dec_flags = DECODER_FLAGS + ["--data_path", str(d / "data.npz")]
    procs = {"codec": _torchrun("llmvox_tpu_torch.train.codec_main",
                                codec_flags, d / "codec_dp"),
             "decoder": _torchrun("llmvox_tpu_torch.train",
                                  dec_flags + ["--tp_size", "2"],
                                  d / "dec_tp")}
    yield d, procs, codec_flags, dec_flags
    for p in procs.values():
        p.kill()


def _finish(proc) -> str:
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_codec_cli_under_torchrun_trains_as_one_process(clis):
    """``torchrun --nproc_per_node 2 -m llmvox_tpu_torch.train.codec_main
    --device cpu``: rank 0 alone prints and writes; its checkpoint (the
    generator and the VQ after the k-means step and one more) equals the
    one-process CLI's on the same seeded files to the codec trainer's
    bounds."""
    d, procs, flags, _ = clis
    out = _finish(procs["codec"])
    assert out.count("train files:") == 1 and "2 ranks" in out, out
    codec_main.main(flags + ["--out_dir", str(d / "codec_one")])
    got = load_params_npz(str(d / "codec_dp" / "codec_ckpt.npz"))
    want = load_params_npz(str(d / "codec_one" / "codec_ckpt.npz"))
    for k, v in _flat(want["vq"]).items():
        np.testing.assert_allclose(_flat(got["vq"])[k], v, **VQ_TOL,
                                   err_msg=k)
    g, w = _flat(got["gen"]), _flat(want["gen"])
    assert g.keys() == w.keys()
    n_out = sum(int((np.abs(g[k] - v) > 5e-5 + 2e-3 * np.abs(v)).sum())
                for k, v in w.items())
    assert n_out <= sum(v.size for v in w.values()) / 1000
    with open(d / "codec_dp" / "codec_ckpt.npz.json") as f:
        assert json.load(f) == {"iter_num": 2}


def test_decoder_cli_at_tp2_trains_as_one_process(clis, capsys):
    """``torchrun --nproc_per_node 2 -m llmvox_tpu_torch.train --tp_size
    2``: one tp group of two ranks; rank 0 writes the whole checkpoint in
    the JAX layout, equal to the one-process CLI's to the trainer's
    bounds (biases after the row-parallel matmuls, the clip and draft
    heads included)."""
    d, procs, _, flags = clis
    out = _finish(procs["decoder"])
    assert out.count("dataset:") == 1 and "(dp 1 x tp 2)" in out, out
    train_main.main(flags + ["--out_dir", str(d / "dec_one")])
    assert "tp 2" not in capsys.readouterr().out
    got = _flat(load_params_npz(str(d / "dec_tp" / "ckpt.npz")))
    want = _flat(load_params_npz(str(d / "dec_one" / "ckpt.npz")))
    assert got.keys() == want.keys() and "h/bproj" in want
    for k, v in want.items():
        assert got[k].shape == v.shape
        np.testing.assert_allclose(got[k], v, **PARAM_TOL, err_msg=k)
    opt = np.load(str(d / "dec_tp" / "ckpt.adamw.npz"))
    assert opt["mu/h/wqkv"].shape == want["h/wqkv"].shape


# ---------------------------------------------------------------------------
# warmup_cache, runtime, validate_parity
# ---------------------------------------------------------------------------

def test_warmup_cache_warms_batch_tts_at_batch_streams(capsys, monkeypatch):
    """``--batch_streams 2``: BatchTTS built at 2 streams and run on two
    "warmup." texts with 128-token blocks and cap, as JAX's tool does."""
    calls = []
    real = BatchTTS.tts_batch

    def spy(self, texts, max_tokens=None, **kw):
        calls.append((self.B, self.block, list(texts), max_tokens))
        return real(self, texts, max_tokens, **kw)
    monkeypatch.setattr(BatchTTS, "tts_batch", spy)
    warmup_cache.main([
        "--device", "cpu", "--batch_streams", "2", "--n_layer", "1",
        "--n_head", "2", "--n_embd", "32", "--block_size", "256",
        "--vocab_size", "16", "--text_embed_dim", "12",
        "--speech_embed_dim", "20", "--vq_bins", "16", "--vq_dim", "20",
        "--backbone_input_channels", "20", "--backbone_dim", "32",
        "--backbone_intermediate_dim", "64", "--backbone_num_layers", "1",
        "--n_fft", "128", "--hop_length", "32", "--chunk_buckets", "[4, 8]",
        "--decode_block", "8", "--first_decode_block", "4",
        "--initial_dump_size_1", "4", "--compute_dtype", "float32"])
    assert calls == [(2, 128, ["warmup.", "warmup."], 128)]
    out = capsys.readouterr().out
    assert "batch of 2 streams (block 128; eager)" in out


def test_profile_trace_holds_an_annotated_span(tmp_path):
    with runtime.profile_trace(str(tmp_path)) as prof:
        with tracing.span("llmvox_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    # outside profile_trace a span is no range of a profiler
    assert not tracing.ACTIVE
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "llmvox_span" in names
    assert any("mm" in str(n) for n in names)


def test_validate_parity_skips_each_section_without_its_inputs(tmp_path,
                                                                capsys):
    assert validate_parity.main([]) == 0
    out = capsys.readouterr().out
    assert "decoder: checkpoint not provided/found — skipped" in out
    assert "codec: checkpoint not provided/found — skipped" in out
    ckpt = tmp_path / "d.pt"
    ckpt.write_bytes(b"")
    assert validate_parity.main(["--decoder_ckpt", str(ckpt), "--reference",
                                 str(tmp_path / "none")]) == 0
    assert "reference checkout not provided/found" in capsys.readouterr().out
    assert validate_parity._report("x", np.zeros(3), np.full(3, 1e-3), 1e-2)
    assert not validate_parity._report("x", np.zeros(3), np.ones(3), 1e-2)


def test_validate_parity_decoder_against_the_reference(tmp_path):
    """A reference-format decoder checkpoint (random values) through the
    port and the reference's own GPT: parity."""
    if not os.path.exists(os.path.join(REFERENCE, "src", "model.py")):
        pytest.skip("reference checkout not present (LLMVOX_REFERENCE)")
    from tests.test_convert import CFG, _make_decoder_sd
    sd = _make_decoder_sd(CFG, np.random.default_rng(5), prefix="_orig_mod.")
    blob = {"model": sd, "model_args": dict(
        n_layer=CFG.n_layer, n_head=CFG.n_head, n_embd=CFG.n_embd,
        block_size=CFG.block_size, bias=CFG.bias,
        vocab_size=CFG.vocab_size, dropout=0.0)}
    torch.save(blob, str(tmp_path / "ref.pt"))
    assert validate_parity.validate_decoder(REFERENCE,
                                            str(tmp_path / "ref.pt"))


def test_validate_parity_codec_against_the_reference(tmp_path):
    cfgp = os.path.join(REFERENCE, "WavTokenizer", "configs",
                        "wavtokenizer_smalldata_frame75_3s_nq1_code4096_"
                        "dim512_kmeans200_attn.yaml")
    if not os.path.exists(cfgp):
        pytest.skip("reference checkout not present (LLMVOX_REFERENCE)")
    validate_parity._stub_torchaudio()
    sys.path.insert(0, os.path.join(REFERENCE, "WavTokenizer"))
    try:
        from decoder.pretrained import WavTokenizer
        torch.manual_seed(0)
        model = WavTokenizer.from_hparams0802(cfgp)
        torch.save({"state_dict": model.state_dict()},
                   str(tmp_path / "c.ckpt"))
        del model
        assert validate_parity.validate_codec(
            REFERENCE, str(tmp_path / "c.ckpt"), config_yaml=cfgp)
    finally:
        sys.path.remove(os.path.join(REFERENCE, "WavTokenizer"))


# ---------------------------------------------------------------------------
# serve/ui.py
# ---------------------------------------------------------------------------

def test_terminal_demo_against_the_port_server(tmp_path, monkeypatch):
    """One round trip through TerminalDemo (no PyAudio: playback off):
    the reply saved as a 24 kHz WAV, the audio the server streams for the
    same text."""
    from llmvox_tpu_torch.serve.ui import TerminalDemo
    from llmvox_tpu_torch.utils import params as P
    rng = np.random.default_rng(31)
    weights = (P.init_decoder_params(31, eng.T_DEC),
               rng.standard_normal((eng.T_DEC.text_vocab_size,
                                    eng.T_DEC.text_embed_dim)
                                   ).astype(np.float32),
               P.init_codec_params(32, eng.T_CODEC))
    port = eng._free_port()
    scfg = eng._port_cfg(eng.tconfig.ServeConfig, dataclasses.replace(
        eng.SERVE_CFG, api_host="127.0.0.1", api_port=port,
        scripted_reply="Hi."))
    srv = tserver.build_server(scfg, eng._port_engines(weights,
                                                       eng.SERVE_CFG, 2))
    prompts = iter(["say something short", "exit"])
    monkeypatch.setattr(builtins, "input", lambda *_: next(prompts))
    with eng._Running(srv, port):
        TerminalDemo("127.0.0.1", port, save_dir=str(tmp_path)).chat()
        want = to_wave(post_chunks("127.0.0.1", port, "/tts",
                                   {"text": "say something short"}))
    saved = sorted(tmp_path.glob("reply_*.wav"))
    assert len(saved) == 1
    wav, sr = audio.read_wav(str(saved[0]))
    assert sr == 24000 and wav.shape == (1, len(want)) and len(want) > 0
    # PCM16 on disk
    np.testing.assert_allclose(wav[0], np.clip(want, -1, 1), atol=1e-4)


def test_qt_window_builds_offscreen():
    pytest.importorskip("PyQt5")
    pytest.importorskip("cv2")
    os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
    from llmvox_tpu_torch.serve.ui import build_qt_window
    app, win = build_qt_window(start_threads=False)
    try:
        tabs = win.centralWidget()
        assert [tabs.tabText(i) for i in range(tabs.count())] == [
            "Text Chat", "Voice Chat", "Visual Chat"]
        win.show()
        app.processEvents()
    finally:
        win.close()
        app.processEvents()
