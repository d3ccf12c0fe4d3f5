"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card it raises instead of moving to the CPU: the CPU runs the
plain PyTorch versions of the kernels, and only a caller that asks for it
(``device="cpu"``, as the tests do) gets that path.  ``Fetch`` brings a
result back from the card without blocking the issuing thread.
"""
from __future__ import annotations

import numpy as np
import torch


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
    """One device-to-host copy, started now and waited for on ``get``."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.event = t, None

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
