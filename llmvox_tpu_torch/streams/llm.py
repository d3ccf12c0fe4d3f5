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
  LLM is ``LLMPool`` (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

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
        llama.check_dense(cfg)
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


def build_llama_stream(cfg, tokenizer=None, device="cuda",
                       graphs: Optional[bool] = None) -> LlamaStreamModel:
    """Server-side factory (``--llm_backend jax``): the converted Llama
    params (``cfg.llm_jax_params``, an npz whose meta carries the
    LlamaConfig fields), the tokenizer named by ``llm_checkpoint`` (the
    byte tokenizer for ``"byte"``), quantized under ``cfg.quantize`` and
    cast to ``compute_dtype``, on ``device``."""
    from llmvox_tpu_torch.ops import quant
    from llmvox_tpu_torch.utils.params import load_meta, load_params_npz

    if cfg.llm_pool_capacity > 0:
        raise NotImplementedError(
            f"llm_pool_capacity={cfg.llm_pool_capacity}: the pooled LLM "
            "(LLMPool, llmvox_tpu/serve/llm_pool.py) is not ported to "
            "llmvox_tpu_torch yet (ROADMAP queue 1 item 6); 0 serves the "
            "B=1 stream")
    params = load_params_npz(cfg.llm_jax_params)
    margs = load_meta(cfg.llm_jax_params).get("model_args", {})
    lcfg = llama.LlamaConfig(**{k: v for k, v in margs.items()
                                if k in llama.LlamaConfig.__dataclass_fields__})
    if tokenizer is None:
        if cfg.llm_checkpoint == "byte":
            tokenizer = ByteTokenizer()
        else:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(cfg.llm_checkpoint)
    if cfg.quantize:
        params = quant.quantize_llama_params(params, cfg.quantize)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    return LlamaStreamModel(params, lcfg, tokenizer, block=cfg.llm_block,
                            temperature=cfg.llm_temperature,
                            top_k=cfg.llm_top_k, top_p=cfg.llm_top_p,
                            max_tokens=cfg.llm_max_tokens,
                            eos_text=cfg.eos_token, device=device,
                            dtype=dtype, graphs=graphs)
