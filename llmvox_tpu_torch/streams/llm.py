"""The in-framework Llama behind the text-stream protocol, on the card.

Counterpart of ``llmvox_tpu/streams/jax_llm.py`` (``--llm_backend jax``,
the B=1 ``JAXStreamModel`` and its factory ``build_jax_stream``): the
prompt prefills the KV cache, then ``block`` tokens generate per device
call and the host streams their text out.  It plugs into the scheduler
like ``ScriptedStream`` (``load()``, ``predict(request) -> iterator of
text deltas``, ending with the eos token string).  In the port the flag
value ``jax`` means the Llama of ``models/llama.py`` on the TTS replicas'
card.

The tokenizer is duck-typed: ``encode(str) -> List[int]``,
``decode(List[int]) -> str`` and ``eos_token_id`` (an HF AutoTokenizer, or
``ByteTokenizer``).  If it has ``apply_chat_template`` the (system,
prompt) pair is formatted with it; otherwise "system\\n\\nuser\\n".

On the device (``LlamaStreamModel``):
- One static ``LlamaDecodeState`` (caches ``(n_layer, 1, S, KV, hd)`` in
  the compute dtype) and a static last-token tensor.  A request's prefill
  resets ``pos`` and writes the first sampled token there, so a block
  takes no input from the host and chains on the device.
- Each ``(block, attn_len)`` decode block is a CUDA graph that ``warmup``
  captures, one per rung of ``attn_buckets``; a block whose rung was not
  captured raises.  The prefill runs eagerly, once per request, in a
  power-of-two bucket (``utils/graphs.py``'s rule that nothing is
  captured while serving holds: the prefill is not a graph).
- Every launch is issued on the card's dispatch thread
  (``utils/device.py::dispatch_executor``), never on the thread that
  iterates ``predict`` (``aiter_stream``'s pump thread in the server); that
  thread waits on a ``Fetch``.
- Sampled decode draws Gumbel noise from a device ``torch.Generator``
  registered with each captured graph, so every replay draws new noise.
- One request generates at a time (a lock held for the life of the
  ``predict`` generator): the state is one static buffer.  JAX's B=1
  stream runs concurrent requests each on its own state; the concurrent
  LLM is the pool below.

``PooledLlamaStreamModel`` (``llm_pool_capacity > 0``) is the counterpart
of JAX's ``PooledJAXStreamModel``: concurrent ``predict`` streams share
the continuous-batching ``serve/llm_pool.py::LLMPool``, and
``predict_streaming`` takes a prompt whose text is still being produced
(the overlapped ``/voicechat``).  Its ``predict`` returns an async
generator, so deltas flow on the server's event loop as the pool's blocks
resolve.
"""
from __future__ import annotations

import threading
import time
from typing import AsyncIterator, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.models import llama
from llmvox_tpu_torch.utils.device import (Fetch, dispatch_executor,
                                           resolve_device)
from llmvox_tpu_torch.utils.graphs import GraphSet, settle, use_graphs
from llmvox_tpu_torch.utils.params import to_torch


def _tokenizer_eos_id(tokenizer) -> int:
    # HF tokenizers may define eos_token_id = None (not just omit it)
    eid = getattr(tokenizer, "eos_token_id", None)
    return int(eid) if eid is not None else -1


def build_prompt_ids(tokenizer, request: Dict) -> List[int]:
    """The reference's prompt build: chat template when the tokenizer has
    one, else plain system/user concatenation."""
    system = request.get("system", "")
    prompt = request.get("prompt", request.get("text", ""))
    if hasattr(tokenizer, "apply_chat_template"):
        messages = [{"role": "system", "content": system},
                    {"role": "user", "content": prompt}]
        return list(tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True))
    text = (system + "\n\n" if system else "") + prompt + "\n"
    return list(tokenizer.encode(text))


def stable_delta(tokenizer, eos_id: int, out: List[int], emitted: str,
                 final: bool = False) -> Tuple[str, str]:
    """Incremental detokenization with hold-back: re-decode the whole
    sequence and emit only the stable new suffix.  A trailing U+FFFD
    means the tokenizer split a multi-byte character across tokens: hold
    it back until the next block completes it."""
    body = [t for t in out if t != eos_id]
    text = tokenizer.decode(body)
    if not final:
        while text.endswith("�"):
            text = text[: -1]
    if not text.startswith(emitted):
        # The tokenizer rewrote earlier output: resync from the longest
        # common prefix so later deltas keep flowing (the rewritten span
        # is lost, it was already emitted differently)
        n = min(len(text), len(emitted))
        common = next((i for i in range(n)
                       if text[i] != emitted[i]), n)
        return text[common:] if len(text) > common else "", text
    return text[len(emitted):], text


class ByteTokenizer:
    """Dependency-free byte-level tokenizer: id = byte + 1, eos = 0
    (``--llm_checkpoint byte``): the stream runs with no downloads.  Pair
    it with a vocab of 384 or more."""
    eos_token_id = 0
    eos_token = "<|eot_id|>"

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        return bytes(i - 1 for i in ids if 0 < i <= 256).decode(
            "utf-8", errors="ignore")


class LlamaStreamModel:
    """The B=1 Llama text stream on ``device`` (``"cuda"`` by default; the
    CPU runs the same bodies eagerly).  ``dtype`` casts the floating
    params and sets the caches' dtype (f32 without it); ``graphs`` (None:
    on for a card) serves the decode blocks through CUDA graphs."""

    def __init__(self, params: Dict, cfg: llama.LlamaConfig, tokenizer, *,
                 block: int = 16, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, max_tokens: int = 512,
                 eos_text: Optional[str] = None, seed: int = 0,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cache_dtype = dtype or torch.float32
        self.params = to_torch(params, self.device, dtype)
        self.tokenizer = tokenizer
        self.block = block
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.max_tokens = max_tokens
        self.eos_id = _tokenizer_eos_id(tokenizer)
        self.eos_text = (eos_text if eos_text is not None
                         else getattr(tokenizer, "eos_token", "")) or ""
        # attention-window buckets for the blocks' attn_len: most of the
        # cache is empty early in a generation, and decode reads it
        self.attn_buckets = tuple(
            b for b in llama.attn_window_ladder(cfg.max_seq_len)
            if b >= block + 1 or b == cfg.max_seq_len)
        self.state = llama.init_llama_decode_state(
            cfg, batch=1, dtype=self.cache_dtype, device=self.device)
        self.tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._blocks = GraphSet(
            "LLM decode block", self.device, use_graphs(self.device, graphs),
            self._make_block,
            generators=(self.generator,) if temperature > 0 else ())
        self._lock = threading.Lock()
        # tokens the blocks generated, and host seconds spent waiting for
        # them, over this model's life
        self.tokens = 0
        self.block_s = 0.0

    def _attn_bucket(self, needed: int) -> int:
        for b in self.attn_buckets:
            if needed <= b:
                return b
        return self.attn_buckets[-1]

    def load(self) -> None:
        pass

    # -- device work (on the dispatch thread) ----------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return llama._sample(logits, self.temperature, self.top_k,
                             self.top_p, self.generator)

    def _make_block(self, key: Tuple[int, int]):
        block, attn_len = key
        out = torch.zeros((1, block), dtype=torch.int32, device=self.device)

        def body():
            toks, new = llama.decode_block(
                self.params, self.tok, self.state, self.cfg, block=block,
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, attn_len=attn_len,
                generator=self.generator)
            self.state.pos.copy_(new.pos)
            self.tok.copy_(toks[:, -1])
            out.copy_(toks)
        return body, out

    def _prefill(self, ids: List[int], bucket: int) -> Fetch:
        """The prompt, right-padded to ``bucket``, in one host-to-device
        copy with its length; ``pos`` reset, the cache filled, the first
        token sampled into the static token."""
        host = np.zeros(bucket + 1, np.int32)
        host[0] = len(ids)
        host[1:1 + len(ids)] = ids
        inp = torch.from_numpy(host)
        if self.device.type == "cuda":
            inp = inp.pin_memory()
        inp = inp.to(self.device, non_blocking=True)
        self.state.pos.zero_()
        # a fresh state (pos=0): the prefill reads only its own bucket
        logits, new = llama.prefill_padded(
            self.params, inp[1:][None], inp[0], self.state, self.cfg,
            attn_len=bucket)
        self.state.pos.copy_(new.pos)
        self.tok.copy_(self._sample(logits))
        return Fetch(self.tok)

    def _decode(self, attn_len: int) -> Fetch:
        return Fetch(self._blocks.get((self.block, attn_len))())

    def _call(self, fn, *args) -> np.ndarray:
        """``fn(*args)`` on the device's dispatch thread; waits here for the
        Fetch it returns."""
        return dispatch_executor(self.device).submit(fn, *args).result().get()

    def warmup(self) -> None:
        """Capture the decode block at every rung of ``attn_buckets`` (on
        a card a CUDA graph each; without graphs one eager pass each), then
        ``settle``.  JAX's B=1 stream compiles each rung on first use; a
        graph cannot be captured while serving."""
        for a in self.attn_buckets:
            self._blocks.capture((self.block, a))
        settle()

    # -- generation --------------------------------------------------------
    def predict(self, request: Dict) -> Iterator[str]:
        """A lazy generator: all device work happens while the consumer
        iterates, one request at a time, its launches on the dispatch
        thread."""

        def inner():
            with self._lock:
                yield from self._generate(request)

        return inner()

    def _generate(self, request: Dict) -> Iterator[str]:
        ids = build_prompt_ids(self.tokenizer, request)
        # bucketed prefill: the prompt padded to the next power of two
        cap = self.cfg.max_seq_len - 1
        ids = ids[-cap:]
        bucket = 16
        while bucket < len(ids):
            bucket *= 2
        bucket = min(bucket, cap)
        first = int(self._call(self._prefill, ids, bucket)[0])
        out: List[int] = [first]
        emitted = ""
        pos = len(ids)     # host mirror of state.pos
        done = first == self.eos_id
        while not done and len(out) < self.max_tokens:
            # fixed block size only: stop one whole block short of
            # capacity instead of a shorter tail block
            if pos + self.block >= self.cfg.max_seq_len:
                break
            t0 = time.perf_counter()
            toks = self._call(self._decode,
                              self._attn_bucket(pos + self.block))
            self.block_s += time.perf_counter() - t0
            pos += self.block
            self.tokens += self.block
            for t in toks[0].tolist():
                out.append(int(t))
                if out[-1] == self.eos_id:
                    done = True
                    break
            delta, emitted = stable_delta(self.tokenizer, self.eos_id, out,
                                          emitted)
            if delta:
                yield delta
        delta, emitted = stable_delta(self.tokenizer, self.eos_id, out,
                                      emitted, final=True)
        if delta:
            yield delta
        if self.eos_text:
            yield self.eos_text


class PooledLlamaStreamModel:
    """The text-stream protocol over the continuous-batching LLM pool
    (``serve/llm_pool.py``): N concurrent ``predict`` streams share one
    batched decode program instead of waiting for the B=1 stream.
    ``predict`` returns an async generator (``aiter_stream`` passes it
    through), so no thread serves a request."""

    def __init__(self, pool, tokenizer, *, max_tokens: int = 512,
                 eos_text: Optional[str] = None):
        self.pool = pool
        self.cfg = pool.cfg
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.eos_id = _tokenizer_eos_id(tokenizer)
        self.eos_text = (eos_text if eos_text is not None
                         else getattr(tokenizer, "eos_token", "")) or ""

    def load(self) -> None:
        pass

    def warmup(self) -> None:
        """The pool's warmup: every program captured before serving."""
        self.pool.warmup()

    def enable_prefix_cache(self, system: str) -> None:
        """Pin the system preamble's KV in the pool: the longest common
        id prefix of two probe prompts (chat templates put their
        generation-prompt tokens after the user content, so it is the part
        every request repeats).  Requests with another system prompt do
        not match and take the plain prefill."""
        a = build_prompt_ids(self.tokenizer, {"system": system,
                                              "prompt": "a"})
        b = build_prompt_ids(self.tokenizer,
                             {"system": system,
                              "prompt": "entirely different probe?"})
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        self.pool.set_prefix(a[:n])

    @staticmethod
    def _request_sampling(request: Dict) -> Optional[Dict]:
        # per-request sampling knobs (honoured by a pool built with
        # per_request_sampling, ignored otherwise)
        sampling = {}
        if "temperature" in request:
            sampling["temperature"] = float(request["temperature"])
        if "top_p" in request:
            sampling["top_p"] = float(request["top_p"])
        if "top_k" in request:
            sampling["top_k"] = int(request["top_k"])
        return sampling or None

    def _max_tokens(self, request: Dict) -> int:
        return min(int(request.get("max_tokens", self.max_tokens)),
                   self.max_tokens)

    def predict_streaming(self, request: Dict, texts) -> AsyncIterator[str]:
        """``predict`` for a prompt whose user text is still being
        produced: ``texts`` is an async iterator of cumulative transcript
        strings (or ``(text, done)`` pairs, as
        ``WhisperModelASR.transcribe_stream_async`` yields them).  Stable
        prompt-id prefixes prefill into the pool while later text still
        decodes; generation starts when the transcript completes.  The
        last ``HOLDBACK`` ids are never submitted early (BPE can merge
        across the boundary); if the tokenizer revises submitted ids, or
        the prompt passes the context cap, the producer raises
        ``PromptRestart`` and the pool recovers with one plain prefill, so
        the text is always ``predict(final_text)``'s."""
        from llmvox_tpu_torch.serve.llm_pool import PromptRestart
        HOLDBACK = 4
        cap = self.pool._ctx_cap()

        async def parts():
            submitted: List[int] = []
            final_ids: List[int] = []
            ok = True
            async for item in texts:
                text = item[0] if isinstance(item, tuple) else item
                ids = build_prompt_ids(self.tokenizer,
                                       {**request, "prompt": text})
                final_ids = ids
                if len(ids) > cap:
                    # over the cap the plain path keeps the tail (the
                    # user's question); streaming would keep the head
                    ok = False
                if not ok:
                    continue            # drain; restart at the end
                if ids[: len(submitted)] != submitted:
                    ok = False
                    continue
                stable = ids[: max(len(submitted), len(ids) - HOLDBACK)]
                new = stable[len(submitted):]
                if new:
                    submitted.extend(new)
                    yield new
            if not ok or len(final_ids) <= len(submitted) \
                    or final_ids[: len(submitted)] != submitted:
                raise PromptRestart(final_ids)
            yield final_ids[len(submitted):]   # non-empty (HOLDBACK >= 1)

        gen = self.pool.generate_streaming_prompt(
            parts(), max_tokens=self._max_tokens(request),
            sampling=self._request_sampling(request))
        return self._detok_stream(gen)

    def predict(self, request: Dict) -> AsyncIterator[str]:
        ids = build_prompt_ids(self.tokenizer, request)
        gen = self.pool.generate(ids, max_tokens=self._max_tokens(request),
                                 sampling=self._request_sampling(request))
        return self._detok_stream(gen)

    def _detok_stream(self, gen) -> AsyncIterator[str]:
        async def agen():
            out: List[int] = []
            emitted = ""
            try:
                async for toks in gen:
                    done = False
                    for t in toks:
                        out.append(int(t))
                        if out[-1] == self.eos_id:
                            done = True
                            break
                    delta, emitted = stable_delta(
                        self.tokenizer, self.eos_id, out, emitted)
                    if delta:
                        yield delta
                    if done:
                        break
            finally:
                # release the slot now, not when the generator is collected
                await gen.aclose()
            delta, emitted = stable_delta(self.tokenizer, self.eos_id, out,
                                          emitted, final=True)
            if delta:
                yield delta
            if self.eos_text:
                yield self.eos_text

        return agen()


def llama_config_of(path: str) -> llama.LlamaConfig:
    """The LlamaConfig an npz's meta carries (``model_args``)."""
    from llmvox_tpu_torch.utils.params import load_meta
    margs = load_meta(path).get("model_args", {})
    return llama.LlamaConfig(**{k: v for k, v in margs.items()
                                if k in llama.LlamaConfig.__dataclass_fields__})


def build_llama_stream(cfg, tokenizer=None, device="cuda",
                       graphs: Optional[bool] = None, params=None):
    """Server-side factory (``--llm_backend jax``): the converted Llama
    params (``cfg.llm_jax_params``, an npz whose meta carries the
    LlamaConfig fields; ``params`` given here replace the npz's arrays),
    the tokenizer named by ``llm_checkpoint`` (the byte tokenizer for
    ``"byte"``), quantized under ``cfg.quantize`` and cast to
    ``compute_dtype``, on ``device``.  With ``llm_pool_capacity > 0`` a
    ``PooledLlamaStreamModel`` over an ``LLMPool`` of that many slots (its
    system prompt's KV cached when ``llm_prefix_cache``), else the B=1
    ``LlamaStreamModel``."""
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.utils.params import load_params_npz

    if params is None:
        params = load_params_npz(cfg.llm_jax_params)
    lcfg = llama_config_of(cfg.llm_jax_params)
    if tokenizer is None:
        if cfg.llm_checkpoint == "byte":
            tokenizer = ByteTokenizer()
        else:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(cfg.llm_checkpoint)
    if cfg.quantize:
        params = quant.quantize_llama_params(params, cfg.quantize)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    if cfg.llm_pool_capacity > 0:
        from llmvox_tpu_torch.serve.llm_pool import LLMPool
        pool = LLMPool(params, lcfg, capacity=cfg.llm_pool_capacity,
                       block=cfg.llm_block, first_block=cfg.llm_first_block,
                       temperature=cfg.llm_temperature, top_k=cfg.llm_top_k,
                       top_p=cfg.llm_top_p, dtype=dtype, device=device,
                       prefill_buckets=tuple(cfg.llm_prefill_buckets),
                       pipeline_depth=cfg.pool_pipeline_depth,
                       spec_k=cfg.llm_spec_k,
                       spec_ladder=tuple(cfg.llm_spec_ladder or ()),
                       prefill_merge=cfg.llm_prefill_merge,
                       chunked_prefill=cfg.llm_chunked_prefill,
                       per_request_sampling=cfg.llm_per_request_sampling,
                       graphs=graphs)
        model = PooledLlamaStreamModel(pool, tokenizer,
                                       max_tokens=cfg.llm_max_tokens,
                                       eos_text=cfg.eos_token)
        if cfg.llm_prefix_cache and cfg.system_prompt:
            model.enable_prefix_cache(cfg.system_prompt)
        return model
    return LlamaStreamModel(params, lcfg, tokenizer, block=cfg.llm_block,
                            temperature=cfg.llm_temperature,
                            top_k=cfg.llm_top_k, top_p=cfg.llm_top_p,
                            max_tokens=cfg.llm_max_tokens,
                            eos_text=cfg.eos_token, device=device,
                            dtype=dtype, graphs=graphs)
