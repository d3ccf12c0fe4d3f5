"""K1: the decode-attention kernel's wrapper.

Replaces ``llmvox_tpu/ops/pallas_attn.py::pallas_decode_attention``.  On
CUDA tensors it launches the hand-written kernel in
``csrc/decode_attention.cu`` (built at first use by ``ops/build.py``); on
CPU tensors it runs the plain version ``ops/attention.py::decode_attention``.
Any other device, or inputs the kernel does not take, raise.

Unlike the JAX kernel it takes one layer's ``(S, C)`` cache views and no
``layer`` scalar: the port's layer loop is Python, so ``k_cache[l]`` is a
free view.  ``pos`` stays on the device (an int32 0-d tensor) and the
launch reads no host value, so a decode block issues without a sync.
The kernel is one clustered launch of ``CLUSTER`` blocks per head and
needs no scratch memory.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from llmvox_tpu_torch.ops import attention, build
from llmvox_tpu_torch.utils.graphs import register_counter

# Kernel launches since the last reset (one per decode_attention call that
# launched the CUDA kernel; the CPU path does not count).
LAUNCHES = 0
_count_lock = threading.Lock()
register_counter(__name__, "LAUNCHES", _count_lock)

# Blocks per head, one thread-block cluster: ``kCluster`` in the kernel's
# source, 8, the portable cluster size (16 measured slower at served
# depths, PERF.md).
CLUSTER = 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = build.load("decode_attention")
        fn = lib.llmvox_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, pos, n_head):
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, caches and pos must lie on one device")
    if q.dim() != 1 or k.dim() != 2 or k.shape != v.shape:
        raise ValueError(f"expected q (C,), caches (S, C); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    c = q.shape[0]
    if k.shape[1] != c or c % n_head:
        raise ValueError(f"width {c} vs caches {tuple(k.shape)}, "
                         f"n_head {n_head}")
    if c // n_head > 256:
        raise ValueError(f"head_dim {c // n_head} > 256 is not supported")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q and caches must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise ValueError("pos must be a one-element int32 tensor")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q and caches must be contiguous")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     n_head: int) -> torch.Tensor:
    """(C,) attention output of q over cache rows [0..pos]; see
    ``ops/attention.py::decode_attention`` for the function."""
    if q.device.type == "cpu":
        return attention.decode_attention(q, k_cache, v_cache, pos,
                                          n_head=n_head)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, pos, n_head)
    fn = _entry()
    s, c = k_cache.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), s, c, n_head,
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
