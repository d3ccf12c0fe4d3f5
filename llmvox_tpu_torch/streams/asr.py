"""Whisper ASR for voice-chat input: the host HF pipeline, or the
in-framework Whisper on the card.

Counterpart of ``llmvox_tpu/streams/asr.py``.  A request's base64 int16
PCM is peak-normalised to float and transcribed, with task "translate"
iff the source language differs from the target.  ``build_asr`` picks the
backend from ``asr_backend``: "hf" (``WhisperASR``, transformers on
``asr_device``) or "jax" (``WhisperModelASR``, ``models/whisper.py`` on the
replicas' card; in the port the flag value "jax" means the in-framework
model, as it does for the LLM).

On the device (``WhisperModelASR``):
- Each encoder-context bucket (``asr_ctx_buckets``, mel frames) has its
  own static buffers: the padded audio, the forced prompt, the cross-KV,
  the decode state (self-attention caches ``(L, 1, 448, H, hd)``, ``pos``,
  ``done``) and the chain's last token.
- Per bucket, warmup captures a CUDA graph for the prep (``log_mel`` ->
  ``encode`` -> ``make_cross_kv`` -> the forced-prompt ``prefill`` -> the
  first token's argmax), one for the prep with the ``[sot]``
  language-detection prefill inside it (when the model has languages:
  the detected id is written into the forced prompt on the device, so no
  host round trip splits the graph), and one for a 16-token
  ``decode_block``.  A bucket warmup did not capture raises.
- Every launch is issued on the card's dispatch thread
  (``utils/device.py::dispatch_executor``); the calling thread waits on a
  ``Fetch``.  ``transcribe_stream`` issues block N+1 before it waits for
  block N's tokens.
- One transcription at a time (a lock held for a stream's life): the
  buffers are static.  ``transcribe_batch`` (audio over one 30 s window)
  runs eagerly on the card, on fresh tensors.
"""
from __future__ import annotations

import base64
import os
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from llmvox_tpu_torch.models import whisper as W
from llmvox_tpu_torch.utils.config import ServeConfig
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import GraphSet, fill, settle, use_graphs
from llmvox_tpu_torch.utils.params import to_torch


def resolve_whisper_name(name: str) -> str:
    """A bare variant name ("small", "large-v3") maps to the openai hub
    repo, as the reference does; a path or an org-qualified id is used as
    it is, so local models work."""
    if not (os.path.sep in name or "/" in name or os.path.isdir(name)):
        name = f"openai/whisper-{name}"
    return name


def load_asr_audio(path: str, target_sr: int) -> np.ndarray:
    """File -> mono float32 at ``target_sr``, peak-normalised: the
    reference's preprocessing (first channel only, ``y /= max(|y|)``), on
    the stdlib WAV reader and the polyphase resampler."""
    from llmvox_tpu_torch.utils.audio import convert_audio, read_wav
    wav, sr = read_wav(path)
    wav = np.atleast_2d(wav)[:1]       # first channel, like the reference
    y = convert_audio(wav, sr, target_sr, 1).reshape(-1).astype(np.float32)
    peak = np.max(np.abs(y)) if y.size else 0.0
    return y / (peak if peak > 0 else 1.0)


class WhisperASR:
    """The HF ``automatic-speech-recognition`` pipeline on the host
    (``asr_backend`` "hf"), as JAX's ``WhisperASR``."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self.transcriber = None

    def load(self) -> None:
        from transformers import pipeline
        self.transcriber = pipeline(
            "automatic-speech-recognition",
            model=resolve_whisper_name(self.config.asr_model),
            device=self.config.asr_device)
        # English-only checkpoints (*.en) have no lang_to_id and reject a
        # language kwarg entirely: only multilingual models get one
        gc = getattr(self.transcriber.model, "generation_config", None)
        self._multilingual = bool(getattr(gc, "lang_to_id", None))

    def decode_base64_audio(self, audio_base64: str) -> np.ndarray:
        """base64 int16 PCM -> float32, peak-normalised to [-1, 1] (the
        reference's gain: ``y /= max(|y|)``, not a fixed /32768, since an
        absolute gain shifts Whisper's log-mel features)."""
        raw = base64.b64decode(audio_base64)
        pcm = np.frombuffer(raw, dtype=np.int16)
        y = pcm.astype(np.float32)
        peak = np.max(np.abs(y)) if y.size else 0.0
        return y / (peak if peak > 0 else 1.0)

    def run_asr(self, request: Dict) -> str:
        """Transcribe a request with ``audio_base64`` (and source/target
        language): task "translate" iff source != target, and the source
        language passed to generation."""
        if self.transcriber is None:
            self.load()
        audio = self.decode_base64_audio(request["audio_base64"])
        source = request.get("source_language",
                             self.config.asr_default_language)
        target = request.get("target_language", source)
        task = "translate" if source != target else "transcribe"
        kwargs = {"task": task}
        if source and self._multilingual:
            kwargs["language"] = str(source).lower()
        out = self.transcriber(
            {"array": audio, "sampling_rate": int(self.config.asr_sample_rate)},
            generate_kwargs=kwargs,
        )
        return out["text"].strip()

    def transcribe_file(self, path: str, language: Optional[str] = None,
                        task: str = "transcribe") -> str:
        """Load and resample a file, peak-normalise, transcribe."""
        if self.transcriber is None:
            self.load()
        audio = load_asr_audio(path, int(self.config.asr_sample_rate))
        kwargs = {"task": task}
        if language is not None and self._multilingual:
            kwargs["language"] = language.lower()
        out = self.transcriber(
            {"array": audio,
             "sampling_rate": int(self.config.asr_sample_rate)},
            generate_kwargs=kwargs)
        return out["text"]


def refuse_quantized(config) -> None:
    """Raise for ``--quantize`` with the in-framework ASR.  The reference
    cannot serve it: ``llmvox_tpu/ops/quant.py::quantize_whisper_params``
    makes ``dec.h.xwk``/``xwv`` quantized containers, which
    ``llmvox_tpu/models/whisper.py:346-349`` (``make_cross_kv``) hands to
    ``jnp.einsum``, and that raises a TypeError in every mode.  The port
    refuses the combination rather than invent the feature (ROADMAP
    §3)."""
    mode = getattr(config, "quantize", "")
    if mode:
        raise ValueError(
            f"quantize={mode!r} with asr_backend 'jax': the reference's "
            "quantized Whisper does not run (llmvox_tpu/models/whisper.py:"
            "346-349, make_cross_kv feeds the quantized xwk/xwv to "
            "jnp.einsum and raises TypeError), so the in-framework ASR "
            "refuses it (ROADMAP §3); serve the ASR dense (no --quantize) "
            "or with --asr_backend hf")


class _Bucket(NamedTuple):
    """One encoder-context bucket's static buffers."""
    audio: torch.Tensor           # (frames * hop,) f32, padded
    forced: torch.Tensor          # (Tf,) int32, the forced prompt
    cross: W.CrossKV              # (L, 1, frames / 2, H, hd)
    state: W.WhisperDecodeState   # (L, 1, 448, H, hd) caches, pos, done
    tok: torch.Tensor             # (1,) int32: the chain's last token


class WhisperModelASR:
    """The in-framework Whisper (``models/whisper.py``) on ``device``
    behind the same ``run_asr`` interface as :class:`WhisperASR`: the
    port's counterpart of ``llmvox_tpu/streams/asr.py::JAXWhisperASR``
    (``asr_backend`` "jax").

    Decoding is greedy, as JAX's: language detection from the
    <|startoftranscript|> logits restricted to the language tokens, the
    forced prompt [sot, lang, task(, notimestamps)], ``begin_suppress``
    and ``suppress`` on the first token and ``suppress`` on every later
    one, EOS rows frozen on the device.  ``dtype`` casts the floating
    params (None keeps them as loaded); ``graphs`` (None: on for a card)
    serves the prep and decode bodies through CUDA graphs captured by
    ``warmup``.  ``--quantize`` is refused (``refuse_quantized``)."""

    def __init__(self, config: Optional[ServeConfig] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 graphs: Optional[bool] = None):
        self.config = config or ServeConfig()
        refuse_quantized(self.config)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.graphs = graphs
        self.params = None
        self._lock = threading.RLock()

    # -- loading --------------------------------------------------------
    def load(self) -> None:
        """Weights and generation metadata.  ``asr_model`` is an HF
        checkpoint (a dir or a hub name, converted in memory) or a
        ``.npz`` with its ``.json`` meta, as JAX's ``convert_ckpt
        whisper`` writes it (only the tokenizer files are read from
        ``tokenizer_src``)."""
        name = self.config.asr_model
        if name.endswith(".npz") and os.path.isfile(name):
            from llmvox_tpu_torch.utils.params import (load_meta,
                                                       load_params_npz)
            meta = load_meta(name)
            params = load_params_npz(name)
            self.cfg = W.WhisperConfig(**meta["model_args"])
            gen = meta.get("generation", {})
            tok_src = meta.get("tokenizer_src")
        else:
            from transformers import WhisperForConditionalGeneration

            from llmvox_tpu_torch.tools.convert import (
                convert_whisper_state_dict)
            name = resolve_whisper_name(name)
            model = WhisperForConditionalGeneration.from_pretrained(
                name).eval()
            hc, gc = model.config, model.generation_config
            self.cfg = W.WhisperConfig(
                vocab_size=hc.vocab_size, n_mels=hc.num_mel_bins,
                d_model=hc.d_model, enc_layers=hc.encoder_layers,
                dec_layers=hc.decoder_layers,
                enc_heads=hc.encoder_attention_heads,
                dec_heads=hc.decoder_attention_heads,
                enc_ffn=hc.encoder_ffn_dim, dec_ffn=hc.decoder_ffn_dim,
                max_source_positions=hc.max_source_positions,
                max_target_positions=hc.max_target_positions,
                decoder_start_token_id=int(gc.decoder_start_token_id),
                eos_token_id=int(gc.eos_token_id))
            params = convert_whisper_state_dict(
                model.state_dict(), hc.encoder_layers, hc.decoder_layers)
            gen = {
                "lang_to_id": dict(getattr(gc, "lang_to_id", None) or {}),
                "task_to_id": dict(getattr(gc, "task_to_id", None) or {}),
                "no_timestamps_token_id": getattr(
                    gc, "no_timestamps_token_id", None),
                "suppress_tokens": list(
                    getattr(gc, "suppress_tokens", None) or []),
                "begin_suppress_tokens": list(
                    getattr(gc, "begin_suppress_tokens", None) or []),
                "max_length": getattr(gc, "max_length", None),
            }
            tok_src = name
        self._finish_load(params, gen, tok_src)

    def _finish_load(self, params, gen: Dict, tokenizer) -> None:
        """``tokenizer`` is a tokenizer (anything with ``decode(ids,
        skip_special_tokens=True)``) or the source to read a
        ``WhisperTokenizer`` from.  ``self.cfg`` is set."""
        if tokenizer is None or isinstance(tokenizer, str):
            from transformers import WhisperTokenizer
            tokenizer = WhisperTokenizer.from_pretrained(tokenizer)
        self.tokenizer = tokenizer
        self.params = to_torch(params, self.device, self.dtype)
        self.lang_to_id = {k: int(v)
                           for k, v in (gen.get("lang_to_id") or {}).items()}
        self.task_to_id = {k: int(v)
                           for k, v in (gen.get("task_to_id") or {}).items()}
        nt = gen.get("no_timestamps_token_id")
        self.no_timestamps_id = int(nt) if nt is not None else None
        self.suppress = tuple(int(t)
                              for t in gen.get("suppress_tokens") or ())
        self.begin_suppress = tuple(
            int(t) for t in gen.get("begin_suppress_tokens") or ())
        ml = gen.get("max_length")
        self.max_length = int(ml) if ml else self.cfg.max_target_positions
        self.decode_block_size = 16
        # encoder-context bucket ladder (mel frames); () = always the full
        # 30 s window.  Buckets beyond the window are clamped; the full
        # window is always the last rung.
        raw = getattr(self.config, "asr_ctx_buckets", ()) or ()
        full = self.cfg.n_audio_frames
        self.ctx_buckets = tuple(sorted(
            {min(int(b), full) for b in raw} | ({full} if raw else set())))
        self.ctx_verify = bool(getattr(self.config, "asr_ctx_verify",
                                       False))
        self._lang_ids = (torch.tensor(list(self.lang_to_id.values()),
                                       device=self.device)
                          if self.lang_to_id else None)
        self._forced_len = (1 + bool(self.lang_to_id) + bool(self.task_to_id)
                            + (self.no_timestamps_id is not None))
        on = use_graphs(self.device, self.graphs)
        self._buckets: Dict[int, _Bucket] = {}
        self._preps = GraphSet("ASR prep", self.device, on, self._make_prep)
        self._blocks = GraphSet("ASR decode block", self.device, on,
                                self._make_block)

    def _lang_token(self, language: Optional[str]) -> Optional[int]:
        """Language name or code -> language token id, or None to detect.
        Names map to codes through transformers' ``TO_LANGUAGE_CODE``
        where transformers is installed; without it a name ("english")
        resolves to nothing, and the language is detected."""
        if not language or not self.lang_to_id:
            return None
        lang = language.strip().lower()
        try:
            from transformers.models.whisper.tokenization_whisper import (
                TO_LANGUAGE_CODE)
            lang = TO_LANGUAGE_CODE.get(lang, lang)
        except Exception:
            pass
        return self.lang_to_id.get(f"<|{lang}|>")

    # -- device bodies (on the dispatch thread) -------------------------
    def _bucket(self, frames: int) -> _Bucket:
        bk = self._buckets.get(frames)
        if bk is None:
            cfg, dev = self.cfg, self.device
            dtype = self.params["dec"]["tok_emb"].dtype
            shape = (cfg.dec_layers, 1, frames // 2, cfg.dec_heads,
                     cfg.dec_head_dim)
            bk = self._buckets[frames] = _Bucket(
                torch.zeros(frames * cfg.hop_length, device=dev),
                torch.zeros(self._forced_len, dtype=torch.int32, device=dev),
                W.CrossKV(torch.zeros(shape, dtype=dtype, device=dev),
                          torch.zeros(shape, dtype=dtype, device=dev)),
                W.init_whisper_decode_state(cfg, 1, dtype, dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
        return bk

    def _make_prep(self, key):
        """The prep body of ``key = (frames, detect)``: the bucket's audio
        through the encoder into its cross-KV, then (``detect``) the
        ``[sot]`` prefill, whose argmax over the language tokens is written
        into the forced prompt's language slot, then the forced prompt's
        prefill from pos 0 and the first token (``suppress`` and
        ``begin_suppress`` masked) into the bucket's token."""
        frames, detect = key
        bk, cfg, p = self._bucket(frames), self.cfg, self.params

        def body():
            enc = W.encode(p, W.log_mel(bk.audio[None], cfg), cfg)
            cross = W.make_cross_kv(p, enc, cfg)
            bk.cross.k.copy_(cross.k)
            bk.cross.v.copy_(cross.v)
            if detect:
                bk.state.pos.zero_()
                logits, _ = W.prefill(p, bk.forced[None, :1], bk.state,
                                      bk.cross, cfg)
                best = logits[0, 0].float()[self._lang_ids].argmax()
                # index_select, not an index by a 0-d tensor (which reads
                # it back to the host, and a capture cannot)
                bk.forced[1:2].copy_(
                    self._lang_ids.index_select(0, best.view(1)))
            bk.state.pos.zero_()
            bk.state.done.zero_()
            logits, st = W.prefill(p, bk.forced[None], bk.state, bk.cross,
                                   cfg)
            bk.state.pos.copy_(st.pos)
            row = W._suppress(logits[:, -1].float(),
                              self.suppress + self.begin_suppress)
            bk.tok.copy_(row.argmax(dim=-1))
        return body, bk.tok

    def _make_block(self, frames: int):
        """A ``decode_block_size`` greedy block chained on the bucket's
        token and state (both updated in place)."""
        bk, cfg, p = self._bucket(frames), self.cfg, self.params
        out = torch.zeros((1, self.decode_block_size), dtype=torch.int32,
                          device=self.device)

        def body():
            toks, st = W.decode_block(p, bk.tok, bk.state, bk.cross, cfg,
                                      block=self.decode_block_size,
                                      suppress=self.suppress)
            bk.state.pos.copy_(st.pos)
            bk.state.done.copy_(st.done)
            bk.tok.copy_(toks[:, -1])
            out.copy_(toks)
        return body, out

    def _prep(self, key, audio: np.ndarray, forced: List[int]) -> Fetch:
        bk = self._bucket(key[0])
        fill(bk.audio, audio)
        fill(bk.forced, np.asarray(forced, np.int32))
        return Fetch(self._preps.get(key)())

    def _decode(self, frames: int) -> Fetch:
        return Fetch(self._blocks.get(frames)())

    def _issue(self, fn, *args):
        """``fn(*args)`` submitted to the device's dispatch thread; a future
        of the Fetch it returns."""
        return dispatch_executor(self.device).submit(fn, *args)

    @staticmethod
    def _wait(future) -> np.ndarray:
        return future.result().get()

    def warmup(self) -> None:
        """Capture, for every bucket of the ladder (the full window alone
        without one), the prep (and, with languages, the prep that
        detects the language) and the decode block, then ``settle``: the
        set JAX's ``warmup`` compiles by transcribing a short clip in each
        bucket."""
        if self.params is None:
            self.load()
        detects = (False, True) if self.lang_to_id else (False,)
        for frames in self.ctx_buckets or (self.cfg.n_audio_frames,):
            for detect in detects:
                self._issue(self._preps.capture, (frames, detect)).result()
            self._issue(self._blocks.capture, frames).result()
        settle()

    # -- decoding -------------------------------------------------------
    def transcribe_long(self, audio: np.ndarray, task: str = "transcribe",
                        language: Optional[str] = None,
                        max_seconds: Optional[float] = None) -> str:
        """Beyond the 30 s window: disjoint 30 s windows, all through
        ``transcribe_batch``, texts joined."""
        if self.params is None:
            self.load()
        audio = np.asarray(audio, np.float32).reshape(-1)
        if max_seconds:
            audio = audio[: int(max_seconds * self.cfg.sample_rate)]
        win = self.cfg.n_audio_frames * self.cfg.hop_length
        if len(audio) <= win:
            return self.transcribe(audio, task=task, language=language)
        windows = [audio[i: i + win] for i in range(0, len(audio), win)]
        texts = self.transcribe_batch(windows, task=task, language=language)
        return " ".join(t.strip() for t in texts if t.strip())

    def _pick_ctx(self, n_samples: int) -> Optional[int]:
        """Smallest encoder-context bucket (mel frames) that holds the
        utterance plus ~0.5 s of slack (the decoder needs some padded tail
        to place EOS), or None for the full window."""
        if not self.ctx_buckets:
            return None
        need = n_samples // self.cfg.hop_length + 50
        for b in self.ctx_buckets:
            if b >= need:
                return b if b < self.cfg.n_audio_frames else None
        return None

    def _forced(self, lang_id: Optional[int], task: str) -> List[int]:
        """The forced prompt; with languages and no ``lang_id`` its
        language slot holds 0 until the detect prep writes it."""
        forced = [self.cfg.decoder_start_token_id]
        if self.lang_to_id:
            forced.append(0 if lang_id is None else int(lang_id))
        if self.task_to_id:
            forced.append(int(self.task_to_id.get(
                task, next(iter(self.task_to_id.values())))))
        if self.no_timestamps_id is not None:
            forced.append(int(self.no_timestamps_id))
        return forced

    def _prep_single(self, audio: np.ndarray, task: str,
                     language: Optional[str],
                     ctx_frames: Optional[int] = None):
        """Encode, detect the language where none resolves, prefill the
        forced prompt: one prep replay in the bucket of ``ctx_frames``
        (None: the full window).  Returns ``(frames, forced_len,
        first_token)``; the bucket's state and token hold the rest."""
        if self.params is None:
            self.load()
        frames = ctx_frames or self.cfg.n_audio_frames
        lang_id = self._lang_token(language)
        detect = lang_id is None and bool(self.lang_to_id)
        forced = self._forced(lang_id, task)
        first = self._wait(self._issue(
            self._prep, (frames, detect),
            W.pad_or_trim(audio, self.cfg, ctx_frames)[0], forced))
        return frames, len(forced), int(first[0])

    def transcribe(self, audio: np.ndarray, task: str = "transcribe",
                   language: Optional[str] = None) -> str:
        text = ""
        for text, _done in self.transcribe_stream(audio, task=task,
                                                  language=language):
            pass
        return text

    def transcribe_stream(self, audio: np.ndarray,
                          task: str = "transcribe",
                          language: Optional[str] = None):
        """A generator of ``(text_so_far, done)`` after every decode block.
        Greedy decode makes every emitted token final, so a consumer may
        act on a prefix at once.  Block N+1 chains on block N's last token
        on the device and is issued before block N's tokens are waited
        for.  One stream at a time (the bucket's buffers are static)."""
        with self._lock:
            yield from self._stream(np.asarray(audio, np.float32).reshape(-1),
                                    task, language)

    def _stream(self, audio: np.ndarray, task: str,
                language: Optional[str]):
        ctx = self._pick_ctx(len(audio))
        frames, n_forced, first = self._prep_single(audio, task, language,
                                                    ctx_frames=ctx)
        eos = self.cfg.eos_token_id

        def verified(text: str) -> str:
            """``asr_ctx_verify``: a bucketed transcript re-transcribed at
            the full window (the same text in the stable case)."""
            if ctx is None or not self.ctx_verify:
                return text
            saved, self.ctx_buckets = self.ctx_buckets, ()
            try:
                return self.transcribe(audio, task=task, language=language)
            finally:
                self.ctx_buckets = saved

        if first == eos:
            yield verified(""), True
            return
        out = [first]
        max_new = max(self.max_length - n_forced, 1)
        block = self.decode_block_size
        dispatched = 1
        pending = None
        if dispatched < max_new:
            pending = self._issue(self._decode, frames)
            dispatched += block
        while pending is not None:
            nxt = None
            if dispatched + block <= max_new:
                nxt = self._issue(self._decode, frames)   # issue ahead
                dispatched += block
            hit_eos = False
            for t in self._wait(pending)[0].tolist():
                if t == eos:
                    hit_eos = True
                    break
                out.append(t)
                if len(out) >= max_new:
                    hit_eos = True   # budget: stop like the eager path
                    break
            text = self.tokenizer.decode(out, skip_special_tokens=True)
            if hit_eos or nxt is None:
                yield verified(text), True
                if nxt is not None:
                    self._wait(nxt)   # the block issued ahead, unread
                return
            yield text, False
            pending = nxt
        yield verified(
            self.tokenizer.decode(out, skip_special_tokens=True)), True

    def transcribe_batch(self, audios, task: str = "transcribe",
                         language: Optional[str] = None) -> List[str]:
        """N utterances through one encoder / cross-KV / block-decode chain
        with per-row language detection and per-row EOS freezing, eagerly
        on the device (fresh tensors, no graphs), each step issued on the
        dispatch thread.  Returns N strings."""
        if self.params is None:
            self.load()
        cfg, p, dev = self.cfg, self.params, self.device
        n = len(audios)
        batch = np.concatenate([W.pad_or_trim(a, cfg) for a in audios])
        dtype = p["dec"]["tok_emb"].dtype
        sot, eos = cfg.decoder_start_token_id, cfg.eos_token_id
        lang_id = self._lang_token(language)
        detect = lang_id is None and bool(self.lang_to_id)
        live = {}

        def encode():
            mel = W.log_mel(torch.from_numpy(batch).to(dev), cfg)
            live["cross"] = W.make_cross_kv(p, W.encode(p, mel, cfg), cfg)
            if not detect:
                return Fetch(torch.zeros(0))
            st = W.init_whisper_decode_state(cfg, n, dtype, dev)
            logits, _ = W.prefill(
                p, torch.full((n, 1), sot, dtype=torch.int32, device=dev),
                st, live["cross"], cfg)
            rows = logits[:, 0].float()[:, self._lang_ids]
            return Fetch(self._lang_ids[rows.argmax(dim=-1)])

        def first_tokens(forced: np.ndarray):
            st = W.init_whisper_decode_state(cfg, n, dtype, dev)
            logits, st = W.prefill(p, torch.from_numpy(forced).to(dev), st,
                                   live["cross"], cfg)
            rows = W._suppress(logits[:, -1].float(),
                               self.suppress + self.begin_suppress)
            tok = rows.argmax(dim=-1).to(torch.int32)
            # seed the device-side freeze for rows whose first token is EOS
            live["state"], live["tok"] = st._replace(done=tok == eos), tok
            return Fetch(tok)

        def block(size: int):
            toks, st = W.decode_block(p, live["tok"], live["state"],
                                      live["cross"], cfg, block=size,
                                      suppress=self.suppress)
            live["state"], live["tok"] = st, toks[:, -1]
            return Fetch(torch.cat([toks, st.done[:, None].to(torch.int32)],
                                   dim=1))

        detected = self._wait(self._issue(encode))
        forced = np.full((n, 1), sot, np.int32)
        if lang_id is not None or detect:
            langs = (detected if detect else np.full(n, int(lang_id)))
            forced = np.concatenate(
                [forced, np.asarray(langs, np.int32)[:, None]], 1)
        if self.task_to_id:
            tid = int(self.task_to_id.get(
                task, next(iter(self.task_to_id.values()))))
            forced = np.concatenate(
                [forced, np.full((n, 1), tid, np.int32)], 1)
        if self.no_timestamps_id is not None:
            forced = np.concatenate(
                [forced, np.full((n, 1), int(self.no_timestamps_id),
                                 np.int32)], 1)
        first = self._wait(self._issue(first_tokens, forced))
        max_new = max(self.max_length - forced.shape[1], 1)
        outs = [[int(t)] for t in first]
        done = first == eos
        produced = 1
        while produced < max_new and not done.all():
            size = min(self.decode_block_size, max_new - produced)
            got = self._wait(self._issue(block, size))
            for i in range(n):
                outs[i].extend(int(t) for t in got[i, :-1])
            done = got[:, -1].astype(bool)
            produced += size
        texts = []
        for row in outs:
            if eos in row:
                row = row[: row.index(eos)]
            texts.append(self.tokenizer.decode(row,
                                               skip_special_tokens=True))
        return texts

    def stream_supported(self, audio: np.ndarray) -> bool:
        """Streaming transcription covers one model window (30 s); longer
        audio takes the batched multi-window path."""
        if self.params is None:
            self.load()
        win = self.cfg.n_audio_frames * self.cfg.hop_length
        return np.asarray(audio).reshape(-1).shape[0] <= win

    async def transcribe_stream_async(self, audio: np.ndarray,
                                      task: str = "transcribe",
                                      language: Optional[str] = None):
        """:meth:`transcribe_stream` on the event loop: a worker thread
        iterates it (waiting on its fetches; the launches are the dispatch
        thread's) and the ``(text, done)`` updates flow through an asyncio
        queue, so the loop is never held."""
        import asyncio

        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()

        def worker():
            try:
                for item in self.transcribe_stream(audio, task=task,
                                                   language=language):
                    loop.call_soon_threadsafe(q.put_nowait, item)
                loop.call_soon_threadsafe(q.put_nowait, None)
            except BaseException as e:   # surface device errors
                loop.call_soon_threadsafe(q.put_nowait, e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = await q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # -- request interface (the same semantics as WhisperASR) -----------
    decode_base64_audio = WhisperASR.decode_base64_audio

    def transcribe_file(self, path: str, language: Optional[str] = None,
                        task: str = "transcribe") -> str:
        if self.params is None:
            self.load()
        audio = load_asr_audio(path, int(self.config.asr_sample_rate))
        return self.transcribe(audio, task=task, language=language)

    def run_asr(self, request: Dict) -> str:
        """A request's transcript.  Requests are capped at
        ``asr_max_audio_length`` seconds, as the reference caps them, and
        all of it is transcribed, in 30 s windows past the first."""
        if self.params is None:
            self.load()
        audio = self.decode_base64_audio(request["audio_base64"])
        source = request.get("source_language",
                             self.config.asr_default_language)
        target = request.get("target_language", source)
        task = "translate" if source != target else "transcribe"
        return self.transcribe_long(
            audio, task=task, language=source,
            max_seconds=float(self.config.asr_max_audio_length)).strip()


def build_asr(config: Optional[ServeConfig] = None, device="cuda"):
    """ASR factory: ``asr_backend`` "jax" is the in-framework Whisper on
    ``device``; anything else the host HF pipeline (JAX's default)."""
    config = config or ServeConfig()
    if getattr(config, "asr_backend", "hf") == "jax":
        return WhisperModelASR(config, device=device)
    return WhisperASR(config)
