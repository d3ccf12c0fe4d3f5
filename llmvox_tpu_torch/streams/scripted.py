"""Scripted text stream — the fake LLM for tests and benchmarks.

Yields a fixed list of deltas with an optional per-delta delay (simulating
LLM decode cadence), ending with the configured eos token, so scheduler
behavior (sentence ping-pong, pacing, end-of-generation) is fully
deterministic and clockable.
"""
from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, Sequence


class ScriptedStream:
    def __init__(self, deltas: Sequence[str], *, delay_s: float = 0.0,
                 eos_token: str = "<|eot_id|>", append_eos: bool = True):
        self.deltas = list(deltas)
        self.delay_s = delay_s
        self.eos_token = eos_token
        self.append_eos = append_eos

    def load(self) -> None:
        pass

    def predict(self, request: Dict) -> AsyncIterator[str]:
        async def gen():
            for d in self.deltas:
                if self.delay_s:
                    await asyncio.sleep(self.delay_s)
                yield d
            if self.append_eos:
                yield self.eos_token
        return gen()

    @staticmethod
    def from_text(text: str, words_per_delta: int = 1, **kw) -> "ScriptedStream":
        words = text.split(" ")
        deltas = [
            " ".join(words[i:i + words_per_delta])
            for i in range(0, len(words), words_per_delta)
        ]
        return ScriptedStream(deltas, **kw)
