"""HuggingFace causal-LM text-stream adapter (``--llm_backend hf``).

A copy of ``llmvox_tpu/streams/hf_llm.py``, the behavioural counterpart of
the reference ``StreamModel``: chat-templated (system, user) prompt,
token-by-token deltas via ``TextIteratorStreamer`` with
``skip_special_tokens=False`` (the scheduler needs to see the eos token
string), generation on a worker thread.  The model runs with transformers
on ``llm_device`` (host torch), outside the TTS device path; the
in-framework Llama on the card is ``streams/llm.py``.
"""
from __future__ import annotations

from threading import Thread
from typing import Dict, Iterator

from llmvox_tpu_torch.utils.config import ServeConfig


class HFStreamModel:
    def __init__(self, config: ServeConfig):
        self.config = config
        self.tokenizer = None
        self.model = None

    def load(self) -> None:
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer
        ckpt = self.config.llm_checkpoint
        self.tokenizer = AutoTokenizer.from_pretrained(ckpt)
        self.model = AutoModelForCausalLM.from_pretrained(
            ckpt,
            torch_dtype=(torch.bfloat16
                         if self.config.llm_device != "cpu" else torch.float32),
            use_cache=True,
        ).to(self.config.llm_device)

    def predict(self, request: Dict) -> Iterator[str]:
        from transformers import GenerationConfig, TextIteratorStreamer
        messages = [
            {"role": "system", "content": request["system"]},
            {"role": "user", "content": request["prompt"]},
        ]
        inputs = self.tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True,
            return_tensors="pt", return_dict=True,
        ).to(self.config.llm_device)

        streamer = TextIteratorStreamer(
            self.tokenizer, skip_prompt=True, skip_special_tokens=False)
        gen_cfg = GenerationConfig(
            do_sample=True,
            temperature=self.config.llm_temperature,
            top_p=self.config.llm_top_p,
            top_k=self.config.llm_top_k,
        )
        kwargs = dict(
            input_ids=inputs["input_ids"],
            generation_config=gen_cfg,
            pad_token_id=self.tokenizer.eos_token_id,
            max_new_tokens=self.config.llm_max_tokens,
            streamer=streamer,
        )
        thread = Thread(target=self.model.generate, kwargs=kwargs, daemon=True)
        thread.start()

        def inner():
            try:
                for text in streamer:
                    if text.strip():
                        yield text
            finally:
                thread.join()

        return inner()
