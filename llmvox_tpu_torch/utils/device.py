"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card it raises instead of moving to the CPU: the CPU runs the
plain PyTorch versions of the kernels, and only a caller that asks for it
(``device="cpu"``, as the tests do) gets that path.
"""
from __future__ import annotations

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
