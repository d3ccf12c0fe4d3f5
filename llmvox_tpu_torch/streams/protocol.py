"""The pluggable text-stream source protocol.

The reference duck-types its sources: ``obj.load()`` then
``obj.predict(request) -> Generator[str]`` (inference/llm_streaming.py:24,44;
vlm_streaming.py:49,97; multimodal_streaming.py:31,59).  We formalize the
same two-method surface — keeping the README's "custom streamer template"
promise — and add an async adapter so sync generators (HF streamers etc.)
plug into the asyncio scheduler without blocking the loop.
"""
from __future__ import annotations

import asyncio
import threading
from typing import AsyncIterator, Dict, Iterator, Protocol, Union, runtime_checkable


@runtime_checkable
class TextStream(Protocol):
    def load(self) -> None:
        """Load model weights / warm up.  Called once at server startup."""
        ...

    def predict(self, request: Dict) -> Union[Iterator[str], AsyncIterator[str]]:
        """Yield text deltas for one request (keys match the reference:
        'system' + 'prompt' | 'audio_data'/'images_data' | 'image_base64')."""
        ...


async def aiter_stream(gen: Union[Iterator[str], AsyncIterator[str]]
                       ) -> AsyncIterator[str]:
    """Adapt a sync or async delta generator to an async iterator.

    Sync generators (e.g. HF TextIteratorStreamer consumers) are drained on
    a worker thread through a queue, so a blocked ``next()`` never stalls
    the event loop — the asyncio counterpart of the reference's daemon
    producer thread (streaming_server.py:513-518).
    """
    if hasattr(gen, "__aiter__"):
        async for item in gen:  # type: ignore[union-attr]
            yield item
        return

    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue(maxsize=256)
    _END = object()

    def pump():
        try:
            for item in gen:  # type: ignore[union-attr]
                asyncio.run_coroutine_threadsafe(q.put(item), loop).result()
        finally:
            asyncio.run_coroutine_threadsafe(q.put(_END), loop).result()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    while True:
        item = await q.get()
        if item is _END:
            break
        yield item
