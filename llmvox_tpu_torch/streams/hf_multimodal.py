"""Phi-4-multimodal text-stream adapter (``chat_type`` "multimodal",
``POST /multimodalchat``): speech and vision chat in one model.

A copy of ``llmvox_tpu/streams/hf_multimodal.py``, the counterpart of the
reference ``StreamMultimodalModel``: the
``<|system|>...<|end|><|user|><|image_i|>...<|audio_1|>...`` prompt is
built by hand, base64 int16 audio is scaled to float, and the deltas
stream from transformers on ``llm_device``.
"""
from __future__ import annotations

import base64
import io
from threading import Thread
from typing import Dict, Iterator, List

import numpy as np

from llmvox_tpu_torch.utils.config import ServeConfig


class HFStreamMultimodal:
    def __init__(self, config: ServeConfig):
        self.config = config
        self.model = None
        self.processor = None

    def load(self) -> None:
        import torch
        from transformers import AutoModelForCausalLM, AutoProcessor
        ckpt = self.config.llm_checkpoint
        self.processor = AutoProcessor.from_pretrained(
            ckpt, trust_remote_code=True)
        self.model = AutoModelForCausalLM.from_pretrained(
            ckpt, torch_dtype=torch.bfloat16, trust_remote_code=True,
            attn_implementation="sdpa").to(self.config.llm_device)

    @staticmethod
    def decode_audio(audio_base64: str, sample_rate: int = 16000):
        pcm = np.frombuffer(base64.b64decode(audio_base64), dtype=np.int16)
        return pcm.astype(np.float32) / 32768.0, sample_rate

    @staticmethod
    def decode_images(images_b64: List[str]):
        from PIL import Image
        return [Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB")
                for b in images_b64]

    def predict(self, request: Dict) -> Iterator[str]:
        from transformers import TextIteratorStreamer
        audio = self.decode_audio(request["audio_data"])
        images = self.decode_images(request.get("images_data", []))

        image_tags = "".join(f"<|image_{i + 1}|>" for i in range(len(images)))
        prompt = (f"<|system|>{request['system']}<|end|>"
                  f"<|user|>{image_tags}<|audio_1|><|end|><|assistant|>")
        inputs = self.processor(
            text=prompt, audios=[audio], images=images or None,
            return_tensors="pt").to(self.config.llm_device)
        streamer = TextIteratorStreamer(
            self.processor.tokenizer, skip_prompt=True,
            skip_special_tokens=False)
        kwargs = dict(**inputs, streamer=streamer,
                      max_new_tokens=self.config.llm_max_tokens)
        thread = Thread(target=self.model.generate, kwargs=kwargs, daemon=True)
        thread.start()

        def inner():
            try:
                for delta in streamer:
                    if delta.strip():
                        yield delta
            finally:
                thread.join()

        return inner()
