"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card it raises instead of moving to the CPU: the CPU runs the
plain PyTorch versions of the kernels, and only a caller that asks for it
(``device="cpu"``, as the tests do) gets that path.  ``Fetch`` brings a
result back from the card without blocking the issuing thread, and
``dispatch_executor`` is the one thread a device that launches the decode
work of its engines and pools off the asyncio event loop.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

_dispatchers: Dict[torch.device, ThreadPoolExecutor] = {}
_dispatch_lock = threading.Lock()


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        # The JAX reference runs its f32 matmuls and convolutions at full
        # f32 precision (llmvox_tpu/ops/nn.py::mm_precision).  cuDNN runs
        # f32 convolutions in TF32 by default, which keeps ~3 digits, so
        # both TF32 switches are turned off here, where engines and codecs
        # are built.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Fetch:
    """One device-to-host copy, started now and waited for on ``get``.  On
    the CPU it is a copy taken now: the tensor may be a static buffer that
    the next call overwrites (``utils/graphs.py``)."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.event = t.clone(), None

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def dispatch_executor(device: torch.device) -> ThreadPoolExecutor:
    """The dispatch thread of ``device``: one worker that launches the
    decode work of every engine and pool on that device, off the asyncio
    event loop, in submission order.  In JAX a block is one compiled
    program that is enqueued and returns; here it is hundreds of eager
    launches, so they run on this thread and the loop awaits them.  One
    thread a device, not one per replica: PyTorch releases the GIL at every
    op, so two threads issuing at once hand it back and forth at every op
    (measured: twice the real-time factor of one shared thread, PERF.md).
    On a card the thread's current device is ``device`` (the current device
    is per thread, and a replica may live on another card)."""
    if device.type == "cuda" and device.index is None:
        # ``cuda`` without an index is the calling thread's current card
        device = torch.device("cuda", torch.cuda.current_device())
    with _dispatch_lock:
        ex = _dispatchers.get(device)
        if ex is None:
            init, args = ((torch.cuda.set_device, (device.index,))
                          if device.type == "cuda" else (None, ()))
            ex = ThreadPoolExecutor(1, thread_name_prefix=f"dispatch-{device}",
                                    initializer=init, initargs=args)
            _dispatchers[device] = ex
        return ex
