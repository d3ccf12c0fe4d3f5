"""K4: the int4 weight matmul's wrapper and its plain version.

Replaces ``llmvox_tpu/ops/pallas_quant.py::pallas_int4_matmul`` (kernel
``_int4_mm``), the TPU route of ``--quantize w4``.  On CUDA tensors
``int4_matmul`` launches the hand-written kernel in
``csrc/int4_matmul.cu`` (built at first use by ``ops/build.py``); on CPU
tensors it runs ``plain_int4_matmul``, which computes what the kernel
computes.  Any other device, or inputs the kernel does not take, raise,
on either path.

The function is K4's, not the JAX package's CPU einsum
(``ops/quant.py::int4_matmul``, exact in f32): each dequantized weight is
``bf16(nibble * s)`` with the product in ``s``'s dtype, x is rounded to
bf16, and the bf16 x bf16 products (exact in f32) are summed in f32; the
result takes x's dtype.  The port serves w4 through this function on the
card and on the CPU alike.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from llmvox_tpu_torch.ops import build
from llmvox_tpu_torch.utils.graphs import register_counter

# Kernel launches since the last reset (one per call that launched the
# CUDA kernel; the CPU path does not count).
LAUNCHES = 0
_count_lock = threading.Lock()
register_counter(__name__, "LAUNCHES", _count_lock)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = build.load("int4_matmul")
        fn = lib.llmvox_int4_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plain_int4_matmul(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: x (…, Cin), packed q (Cin/2, Cout)
    int8, scales s (G, 1, Cout) -> (…, Cout) in x's dtype."""
    p, cout = q.shape
    g = s.shape[0]
    qi = q.to(torch.int32).reshape(g, p // g, cout)
    lo = ((qi << 28) >> 28).to(s.dtype)
    hi = (qi >> 4).to(s.dtype)
    w_lo = (lo * s).to(torch.bfloat16).float().reshape(p, cout)
    w_hi = (hi * s).to(torch.bfloat16).float().reshape(p, cout)
    lead, cin = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, cin)
    xe = xf[:, 0::2].to(torch.bfloat16).float()
    xo = xf[:, 1::2].to(torch.bfloat16).float()
    out = xe @ w_lo + xo @ w_hi
    return out.to(x.dtype).reshape(*lead, cout)


def _check(x, q, s):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if not (x.device == q.device == s.device):
        raise ValueError("x, q and s must lie on one device")
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous 2-D int8 tensor (one "
                         f"layer's packed weight); got {q.dtype} "
                         f"{tuple(q.shape)}")
    p, cout = q.shape
    if (s.dim() != 3 or s.shape[1] != 1 or s.shape[2] != cout
            or s.dtype not in _DTYPES or not s.is_contiguous()):
        raise ValueError(f"s must be a contiguous float32 or bfloat16 "
                         f"(G, 1, {cout}) tensor; got {s.dtype} "
                         f"{tuple(s.shape)}")
    g = s.shape[0]
    if g == 0 or p % g:
        raise ValueError(f"{p} packed rows do not split into {g} groups")
    if cout % 16 or q.data_ptr() % 16:
        raise ValueError(f"Cout ({cout}) must be a multiple of 16 and q "
                         f"16-byte aligned")
    if x.dim() == 0 or x.shape[-1] != 2 * p or x.numel() == 0:
        raise ValueError(f"x must be (..., {2 * p}) and not empty; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")


def int4_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(Int4Tensor(q, s))`` as K4 computes it; see
    ``plain_int4_matmul`` for the function."""
    _check(x, q, s)
    if x.device.type == "cpu":
        return plain_int4_matmul(x, q, s)
    fn = _entry()
    lead, cin = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, cin).contiguous()
    m = xf.shape[0]
    p, cout = q.shape
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xf.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 m, p, cout, s.shape[0], _DTYPES[x.dtype], _DTYPES[s.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: cudaError "
                           f"{err}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out.reshape(*lead, cout)
