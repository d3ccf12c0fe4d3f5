"""Remote text-stream source: a streaming LLM consumed over HTTP.

A copy of ``llmvox_tpu/streams/remote.py``.  The LLM may live on other
GPUs or behind a managed API while this package handles the speech; it
speaks the OpenAI-compatible ``chat/completions`` SSE stream (served by
vLLM, TGI, llama.cpp and others) with the stdlib ``http.client`` only.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

from llmvox_tpu_torch.utils.config import ServeConfig


class RemoteStream:
    """OpenAI-compatible streaming chat endpoint as a TextStream."""

    def __init__(self, config: ServeConfig, base_host: str = "127.0.0.1",
                 base_port: int = 8000, path: str = "/v1/chat/completions",
                 model: Optional[str] = None, api_key: Optional[str] = None,
                 use_tls: bool = False):
        self.config = config
        self.host, self.port, self.path = base_host, base_port, path
        self.model = model or config.llm_checkpoint
        self.api_key = api_key
        self.use_tls = use_tls

    def load(self) -> None:
        pass  # remote endpoint owns its weights

    def predict(self, request: Dict) -> Iterator[str]:
        import http.client
        conn_cls = (http.client.HTTPSConnection if self.use_tls
                    else http.client.HTTPConnection)
        conn = conn_cls(self.host, self.port, timeout=600)
        payload = {
            "model": self.model,
            "messages": [
                {"role": "system", "content": request["system"]},
                {"role": "user", "content": request["prompt"]},
            ],
            "stream": True,
            "temperature": self.config.llm_temperature,
            "top_p": self.config.llm_top_p,
            "max_tokens": self.config.llm_max_tokens,
        }
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        conn.request("POST", self.path, body=json.dumps(payload),
                     headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"LLM endpoint HTTP {resp.status}: "
                               f"{resp.read()[:200]!r}")

        def gen():
            buf = b""
            try:
                while True:
                    chunk = resp.read(4096)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        line = line.strip()
                        if not line.startswith(b"data:"):
                            continue
                        data = line[5:].strip()
                        if data == b"[DONE]":
                            # surface the configured eos token so the
                            # scheduler sees end-of-generation
                            yield self.config.eos_token
                            return
                        try:
                            obj = json.loads(data)
                            delta = obj["choices"][0]["delta"].get("content")
                        except (KeyError, json.JSONDecodeError, IndexError):
                            continue
                        if delta:
                            yield delta
            finally:
                conn.close()

        return gen()
