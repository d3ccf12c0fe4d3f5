"""Qwen2.5-VL vision-language text-stream adapter (``chat_type``
"visual_speech", ``POST /vlmschat``).

A copy of ``llmvox_tpu/streams/hf_vlm.py``, the counterpart of the
reference ``StreamVLM``: a base64 image becomes a PIL image within pixel
bounds, the prompt is chat-templated with it, and the deltas stream with
temperature, top-p and top-k sampling.  The model runs with transformers
wherever torch hosts it (``device_map="auto"``), outside the speech
device path.
"""
from __future__ import annotations

import base64
import io
from threading import Thread
from typing import Dict, Iterator

from llmvox_tpu_torch.utils.config import ServeConfig

MIN_PIXELS = 256 * 28 * 28
MAX_PIXELS = 1280 * 28 * 28


class HFStreamVLM:
    def __init__(self, config: ServeConfig):
        self.config = config
        self.model = None
        self.processor = None

    def load(self) -> None:
        import torch
        from transformers import AutoProcessor, Qwen2_5_VLForConditionalGeneration
        ckpt = self.config.llm_checkpoint
        self.model = Qwen2_5_VLForConditionalGeneration.from_pretrained(
            ckpt, torch_dtype=torch.bfloat16, attn_implementation="sdpa",
            device_map="auto")
        self.processor = AutoProcessor.from_pretrained(
            ckpt, min_pixels=MIN_PIXELS, max_pixels=MAX_PIXELS)

    @staticmethod
    def decode_image(image_base64: str):
        from PIL import Image
        return Image.open(io.BytesIO(base64.b64decode(image_base64))).convert("RGB")

    def predict(self, request: Dict) -> Iterator[str]:
        from transformers import TextIteratorStreamer
        image = self.decode_image(request["image_base64"])
        messages = [
            {"role": "system", "content": request["system"]},
            {"role": "user", "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": request["prompt"]},
            ]},
        ]
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self.processor(text=[text], images=[image],
                                return_tensors="pt").to(self.model.device)
        streamer = TextIteratorStreamer(
            self.processor.tokenizer, skip_prompt=True,
            skip_special_tokens=False)
        kwargs = dict(
            **inputs, streamer=streamer, do_sample=True,
            temperature=self.config.llm_temperature,
            top_p=self.config.llm_top_p, top_k=self.config.llm_top_k,
            max_new_tokens=self.config.llm_max_tokens,
        )
        thread = Thread(target=self.model.generate, kwargs=kwargs, daemon=True)
        thread.start()

        def inner():
            try:
                for delta in streamer:
                    if delta.strip():
                        yield delta
            except Exception as e:  # degrade like the reference (vlm:207-211)
                yield f"Error during generation: {e}"
            finally:
                thread.join()

        return inner()
