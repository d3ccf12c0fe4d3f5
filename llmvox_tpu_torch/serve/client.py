"""Minimal streaming client for the TTS server that keeps chunk boundaries.

``http.client`` merges the chunks of a chunked body; this reads the
chunked framing itself, so each audio chunk the scheduler emitted arrives
as one item with its arrival time.
"""
from __future__ import annotations

import json
import socket
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

SAMPLE_RATE = 24000


def stream_chunks(host: str, port: int, path: str, payload: Dict,
                  timeout: float = 600.0) -> Iterator[Tuple[float, bytes]]:
    """POST ``payload`` as JSON; yield (seconds since the request was
    sent, chunk bytes) for each chunk of the response body as it
    arrives."""
    body = json.dumps(payload).encode()
    with socket.create_connection((host, port), timeout=timeout) as sock:
        t0 = time.perf_counter()
        sock.sendall(
            f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f = sock.makefile("rb")
        status = f.readline().decode()
        if " 200 " not in status:
            raise RuntimeError(f"HTTP error: {status.strip()}")
        while f.readline() not in (b"\r\n", b"\n", b""):
            pass
        while True:
            size = int(f.readline().strip() or b"0", 16)
            if size == 0:
                break
            data = f.read(size)
            yield time.perf_counter() - t0, data
            f.readline()


def post_chunks(host: str, port: int, path: str, payload: Dict,
                timeout: float = 600.0) -> List[Tuple[float, bytes]]:
    """POST ``payload`` as JSON; return [(seconds since the request was
    sent, chunk bytes), ...] for every chunk of the response body."""
    return list(stream_chunks(host, port, path, payload, timeout))


def to_wave(chunks: List[Tuple[float, bytes]]) -> np.ndarray:
    """The float32 waveform of a chunk list."""
    return np.frombuffer(b"".join(c for _, c in chunks), dtype="<f4")
