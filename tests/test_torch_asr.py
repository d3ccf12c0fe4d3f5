"""The port's in-framework ASR (``llmvox_tpu_torch/streams/asr.py::
WhisperModelASR``) against the JAX package's ``JAXWhisperASR`` on a tiny
local Whisper (``tests/tiny_hf.py``), on the CPU in f32, following
``tests/test_whisper.py``: transcripts and streamed updates equal, with the
transcribe/translate routing and language detection, the context buckets
and ``asr_ctx_verify``, the batched and long-form paths, the npz load,
suppress tokens and the asyncio bridge; then the CUDA-graph discipline with
the capture stubbed to run on the CPU (the warmup set against the calls
JAX's warmup makes, a bucket not captured raising) and every launch on the
dispatch thread; the host HF pipeline adapter; the factory."""
import asyncio
import base64
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from llmvox_tpu.models import whisper as JW
from llmvox_tpu.streams import asr as jasr
from llmvox_tpu.tools.convert_ckpt import main as convert_main
from llmvox_tpu.train.checkpoint import (load_meta, load_params_npz,
                                         save_params_npz)
from llmvox_tpu.utils.config import ServeConfig as JServeConfig
from llmvox_tpu_torch.models import whisper as TW
from llmvox_tpu_torch.streams import asr as tasr
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils import graphs

from tests.test_whisper import _speechish


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from tests.tiny_hf import build_tiny_whisper
    return build_tiny_whisper(str(tmp_path_factory.mktemp("tiny_whisper")))


@pytest.fixture(scope="module")
def varied_npz(tiny_dir, tmp_path_factory):
    """The tiny Whisper as JAX's ``convert_ckpt whisper`` writes it, its
    weights perturbed (seeded) so that the greedy transcripts differ from
    clip to clip, and more tokens than one block."""
    d = tmp_path_factory.mktemp("varied")
    plain = str(d / "plain.npz")
    convert_main(["whisper", tiny_dir, plain])
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: x + 0.4 * rng.standard_normal(x.shape).astype(np.float32),
        load_params_npz(plain))
    meta = load_meta(plain)
    meta["generation"]["max_length"] = 40
    path = str(d / "varied.npz")
    save_params_npz(path, params, meta=meta)
    return path


def _pair(model: str, **kw):
    """(JAX's ASR, the port's) on ``model``, loaded, from one config."""
    j = jasr.JAXWhisperASR(JServeConfig(asr_model=model, asr_backend="jax",
                                        **kw))
    t = tasr.WhisperModelASR(tconfig.ServeConfig(
        asr_model=model, asr_backend="jax", **kw), device="cpu")
    j.load()
    t.load()
    return j, t


@pytest.fixture(scope="module")
def varied(varied_npz):
    return _pair(varied_npz, asr_ctx_buckets=())


def _b64(audio: np.ndarray) -> str:
    return base64.b64encode((audio * 32767).astype(np.int16).tobytes()
                            ).decode()


# ---------------------------------------------------------------------------
# transcripts against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("language", [None, "en", "zh", "english"])
def test_transcripts_equal_jax(varied, language):
    """Language detection (None, and "english", which resolves through
    transformers' names) and forced languages, on several clips."""
    j, t = varied
    texts = set()
    for seed in range(4):
        audio = _speechish(seed, 1.0 + 0.5 * seed)
        want = j.transcribe(audio, language=language)
        assert t.transcribe(audio, language=language) == want
        texts.add(want)
    assert len(texts) > 1 and max(len(x) for x in texts) > 16


@pytest.mark.parametrize("source,target", [("english", "english"),
                                           ("en", "zh"), (None, None)])
def test_run_asr_routing_equals_jax(varied, source, target):
    """run_asr: base64 int16, peak-normalised; task "translate" iff the
    source differs from the target; no language given: the configured
    default."""
    j, t = varied
    req = {"audio_base64": _b64(0.7 * _speechish(3, 2.5))}
    if source is not None:
        req.update(source_language=source, target_language=target)
    assert t.run_asr(req) == j.run_asr(req)


def test_tiny_hf_dir_load_equals_jax(tiny_dir):
    """The HF-dir load path (converted in memory), the generation config
    and the tokenizer read from the dir."""
    j, t = _pair(tiny_dir)
    assert t.cfg == TW.WhisperConfig(**dataclasses.asdict(j.cfg))
    assert (t.lang_to_id, t.task_to_id, t.no_timestamps_id, t.max_length,
            t.suppress, t.begin_suppress) == (
        j.lang_to_id, j.task_to_id, j.no_timestamps_id, j.max_length,
        j.suppress, j.begin_suppress)
    for seed in range(2):
        audio = _speechish(seed)
        assert t.transcribe(audio) == j.transcribe(audio)
        assert (t.transcribe(audio, task="translate", language="zh")
                == j.transcribe(audio, task="translate", language="zh"))


def test_npz_load_equals_hf_dir(tiny_dir, tmp_path):
    npz = str(tmp_path / "w.npz")
    convert_main(["whisper", tiny_dir, npz])
    _, a_dir = _pair(tiny_dir)
    _, a_npz = _pair(npz)
    assert a_npz.suppress == a_dir.suppress
    assert a_npz.lang_to_id == a_dir.lang_to_id
    audio = _speechish(6)
    assert (a_npz.transcribe(audio, language="en")
            == a_dir.transcribe(audio, language="en"))


def test_stream_updates_equal_jax(varied):
    """Every ``(text, done)`` update of the stream (one a block) equals
    JAX's, done only on the last."""
    j, t = varied
    audio = _speechish(2, 2.0)
    want = list(j.transcribe_stream(audio, language="english"))
    got = list(t.transcribe_stream(audio, language="english"))
    assert got == want and len(got) >= 2
    assert got[-1][1] is True and not any(d for _, d in got[:-1])
    assert t.stream_supported(audio)
    assert not t.stream_supported(np.zeros(16000 * 31, np.float32))


def test_ctx_bucket_stream_equals_full_window(tiny_dir, varied_npz):
    """The context buckets: on the tiny model a short utterance's bucket
    gives the full window's text (JAX's test of the same); the same bucket
    picks as JAX's, and each bucket's stream equal to JAX's there."""
    _, full = _pair(tiny_dir, asr_ctx_buckets=())
    _, buck = _pair(tiny_dir, asr_ctx_buckets=(600, 1200, 3000))
    audio = _speechish(7, 2.0)
    assert buck._pick_ctx(len(audio)) == 600
    want = full.transcribe(audio)
    assert buck.transcribe(audio) == want
    assert list(buck.transcribe_stream(audio))[-1] == (want, True)
    j, t = _pair(varied_npz, asr_ctx_buckets=(600, 1200, 3000))
    assert t.ctx_buckets == j.ctx_buckets == (600, 1200, 3000)
    for n in (0, 2 * 16000, 11 * 16000, 12 * 16000, 29 * 16000):
        assert t._pick_ctx(n) == j._pick_ctx(n)
    for seconds in (2.0, 9.0, 14.0):
        audio = _speechish(7, seconds)
        assert (list(t.transcribe_stream(audio))
                == list(j.transcribe_stream(audio)))


def test_ctx_verify_equals_jax(varied_npz):
    """``asr_ctx_verify``: the last update is the full window's text, and
    the ladder is restored."""
    j, t = _pair(varied_npz, asr_ctx_buckets=(600, 3000),
                 asr_ctx_verify=True)
    audio = _speechish(9, 1.5)
    assert (list(t.transcribe_stream(audio))
            == list(j.transcribe_stream(audio)))
    assert t.ctx_buckets == (600, 3000)


def test_transcribe_batch_equals_sequential_and_jax(varied):
    j, t = varied
    audios = [_speechish(0), _speechish(3, 0.5), _speechish(4, 1.5)]
    for language in (None, "en"):
        want = j.transcribe_batch(audios, language=language)
        assert t.transcribe_batch(audios, language=language) == want
        assert want == [t.transcribe(a, language=language) for a in audios]


def test_transcribe_long_beyond_30s_equals_jax(varied):
    j, t = varied
    audio = _speechish(9, 31.0)
    assert (t.transcribe_long(audio, language="en")
            == j.transcribe_long(audio, language="en"))
    assert (t.transcribe_long(audio, language="en", max_seconds=20.0)
            == j.transcribe_long(audio, language="en", max_seconds=20.0))


def test_suppress_tokens_equal_jax(varied_npz):
    """Suppressed ids (and begin-suppressed ones) are never emitted, in
    the stream and the batch, and the texts equal JAX's."""
    j, t = _pair(varied_npz, asr_ctx_buckets=())
    audio = _speechish(7)
    seen = []
    decode = t.tokenizer.decode
    t.tokenizer.decode = lambda ids, **k: seen.append(list(ids)) or decode(
        ids, **k)
    base = t.transcribe(audio, language="en")
    del t.tokenizer.decode
    ids = sorted(set(seen[-1]), key=seen[-1].index)   # in emission order
    assert len(ids) >= 4
    for asr in (j, t):
        asr.suppress = tuple(ids[:2])
        asr.begin_suppress = tuple(ids[2:4])
    t.tokenizer.decode = lambda ids, **k: seen.append(list(ids)) or decode(
        ids, **k)
    got = t.transcribe(audio, language="en")
    del t.tokenizer.decode
    assert not set(seen[-1]) & set(ids[:2]) and seen[-1][0] not in ids[:4]
    assert got == j.transcribe(audio, language="en") and got != base
    batch = t.transcribe_batch([audio, _speechish(8)], language="en")
    assert batch == j.transcribe_batch([audio, _speechish(8)],
                                       language="en")


def test_transcribe_file_equals_jax(varied, tmp_path):
    from llmvox_tpu_torch.utils.audio import write_wav
    j, t = varied
    path = str(tmp_path / "clip.wav")
    write_wav(path, 0.5 * _speechish(5), 24000)
    y = tasr.load_asr_audio(path, 16000)
    np.testing.assert_array_equal(y, jasr.load_asr_audio(path, 16000))
    assert t.transcribe_file(path, language="en") == j.transcribe_file(
        path, language="en")


def test_transcribe_stream_async_equals_the_stream(varied):
    """The asyncio bridge yields the stream's updates while the loop
    keeps ticking."""
    _, t = varied
    audio = _speechish(6)
    want = list(t.transcribe_stream(audio, language="en"))

    async def go():
        ticks = 0

        async def ticker():
            nonlocal ticks
            while True:
                ticks += 1
                await asyncio.sleep(0.001)

        tick = asyncio.ensure_future(ticker())
        out = [u async for u in t.transcribe_stream_async(audio,
                                                          language="en")]
        tick.cancel()
        return out, ticks

    got, ticks = asyncio.run(asyncio.wait_for(go(), timeout=300))
    assert got == want and ticks > 0


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
    the body; a replay runs it."""
    monkeypatch.setattr(graphs, "_warm", lambda body, device: body())

    def record(body, device, generators=()):
        body()
        return _StubGraph(body)

    monkeypatch.setattr(graphs, "_record", record)


def _graph_asr(model: str, **kw):
    t = tasr.WhisperModelASR(tconfig.ServeConfig(
        asr_model=model, asr_backend="jax", **kw), device="cpu", graphs=True)
    t.load()
    return t


def _jax_warmup_set(asr) -> set:
    """What JAX's warmup compiles, from its calls: (frames, "prep") for a
    forced-prompt prefill, (frames, "detect") for a [sot] prefill, (frames,
    "block") for a decode block, keyed by the bucket log_mel last saw."""
    seen, at = set(), {}
    orig = (JW.log_mel, JW.prefill, JW.decode_block)

    def log_mel(audio, cfg):
        at["frames"] = audio.shape[1] // cfg.hop_length
        return orig[0](audio, cfg)

    def prefill(params, tokens, *a, **k):
        seen.add((at["frames"], "detect" if tokens.shape[1] == 1
                  else "prep"))
        return orig[1](params, tokens, *a, **k)

    def decode_block(*a, **k):
        seen.add((at["frames"], "block"))
        return orig[2](*a, **k)

    JW.log_mel, JW.prefill, JW.decode_block = log_mel, prefill, decode_block
    try:
        asr.warmup()
    finally:
        JW.log_mel, JW.prefill, JW.decode_block = orig
    return seen


@pytest.mark.parametrize("buckets", [(600, 1200), ()])
def test_warmup_captures_what_jax_warmup_compiles(varied_npz, stub_graphs,
                                                  buckets):
    """Per bucket: the prep with the detect prefill inside it (JAX's [sot]
    prefill), the prep for a forced language (the same forced prefill
    JAX compiles), and the decode block; nothing is captured while
    transcribing, and the graph replays give the eager transcripts."""
    j = jasr.JAXWhisperASR(JServeConfig(asr_model=varied_npz,
                                        asr_backend="jax",
                                        asr_ctx_buckets=buckets))
    j.load()
    want = _jax_warmup_set(j)
    t = _graph_asr(varied_npz, asr_ctx_buckets=buckets)
    n0 = graphs.CAPTURES
    t.warmup()
    got = ({(f, "detect" if d else "prep") for f, d in t._preps.graphs}
           | {(f, "block") for f in t._blocks.graphs})
    assert got == want
    frames = sorted({f for f, _ in want})
    assert frames == (sorted(buckets) + [3000] if buckets else [3000])
    assert graphs.CAPTURES == n0 + 3 * len(frames)
    eager = _pair(varied_npz, asr_ctx_buckets=buckets)[1]
    for seconds, lang in ((2.0, None), (9.0, "en"), (20.0, "zh")):
        audio = _speechish(3, seconds)
        assert (t.transcribe(audio, language=lang)
                == eager.transcribe(audio, language=lang))
    assert graphs.CAPTURES == n0 + 3 * len(frames)


def test_a_bucket_warmup_did_not_capture_raises(varied_npz, stub_graphs):
    t = _graph_asr(varied_npz, asr_ctx_buckets=(600, 1200))
    t.warmup()
    del t._blocks.graphs[1200]
    assert t.transcribe(_speechish(1, 2.0)) is not None     # bucket 600
    with pytest.raises(RuntimeError, match="no CUDA graph for 1200"):
        t.transcribe(_speechish(1, 9.0))
    del t._preps.graphs[(600, True)]
    with pytest.raises(RuntimeError, match=r"no CUDA graph for \(600, True"):
        t.transcribe(_speechish(1, 2.0))
    assert t.transcribe(_speechish(1, 2.0), language="en") is not None


def test_every_asr_launch_is_on_the_dispatch_thread(varied, monkeypatch):
    """run_asr from a worker thread (as the server runs it): the frontend,
    encoder, prefills and blocks all run on the device's dispatch thread;
    also the eager batch path's."""
    _, t = varied
    threads = []
    for name in ("log_mel", "encode", "make_cross_kv", "prefill",
                 "decode_block"):
        real = getattr(TW, name)

        def rec(*a, _real=real, **k):
            threads.append(threading.current_thread().name)
            return _real(*a, **k)
        monkeypatch.setattr(TW, name, rec)
    req = {"audio_base64": _b64(_speechish(2, 2.0))}
    worker = threading.Thread(target=lambda: t.run_asr(req))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    n = len(threads)
    assert n >= 6      # mel, encoder, cross-KV, 2 prefills, a block
    t.transcribe_batch([_speechish(0), _speechish(1)])
    assert len(threads) > n
    assert all(name.startswith("dispatch-cpu") for name in threads), threads


# ---------------------------------------------------------------------------
# the host pipeline and the factory
# ---------------------------------------------------------------------------

def test_hf_pipeline_adapter_equals_jax(tiny_dir):
    out = {}
    for side, mod, cls in (("jax", jasr, JServeConfig),
                           ("port", tasr, tconfig.ServeConfig)):
        asr = mod.WhisperASR(cls(asr_model=tiny_dir, asr_device="cpu"))
        out[side] = [asr.run_asr({"audio_base64": _b64(_speechish(s)),
                                  "source_language": src,
                                  "target_language": "en"})
                     for s, src in ((0, "en"), (1, "zh"))]
    assert out["port"] == out["jax"]
    assert (tasr.resolve_whisper_name("small") ==
            jasr.resolve_whisper_name("small") == "openai/whisper-small")
    assert tasr.resolve_whisper_name(tiny_dir) == tiny_dir


def test_build_asr_picks_the_backend_and_the_device():
    cfg = tconfig.ServeConfig()
    assert type(tasr.build_asr(cfg)) is tasr.WhisperASR
    jcfg = dataclasses.replace(cfg, asr_backend="jax")
    asr = tasr.build_asr(jcfg, device="cpu")
    assert type(asr) is tasr.WhisperModelASR and asr.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tasr.build_asr(jcfg)
