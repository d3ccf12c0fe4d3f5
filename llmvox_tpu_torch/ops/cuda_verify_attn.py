"""K3: the batched verify-attention kernel's wrapper.

Replaces ``llmvox_tpu/ops/pallas_attn.py::pallas_verify_attention``, the
attention of speculative decode's verify forward.  On CUDA tensors it
launches the hand-written kernel in ``csrc/verify_attention.cu`` (built at
first use by ``ops/build.py``); on CPU tensors it runs the plain version
``ops/attention.py::batched_verify_attention``.  Any other device, or
inputs the kernel does not take, raise, on either path.

Like K1's and K2's wrappers it takes one layer's ``(B, S, C)`` cache
views and no ``layer`` scalar.  ``pos (B,)`` stays on the device and the
launch reads no host value.  The draft window is at most 16 queries
(``k_draft <= 15``), the head width at most 128 and a multiple of 16
bytes, the caches 16-byte aligned and q 4-byte aligned.  The kernel is one
clustered launch of ``CLUSTER`` blocks per (head, stream) and needs no
scratch memory: the wrapper allocates only the output.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from llmvox_tpu_torch.ops import attention, build
from llmvox_tpu_torch.utils.graphs import register_counter

# Kernel launches since the last reset (one per call that launched the
# CUDA kernel; the CPU path does not count).
LAUNCHES = 0
_count_lock = threading.Lock()
register_counter(__name__, "LAUNCHES", _count_lock)

MAX_QUERIES = 16
MAX_HEAD_DIM = 128
# Blocks per (head, stream), one thread-block cluster: ``kCluster`` in
# ``csrc/attn_cluster.cuh``.
CLUSTER = 8
# streams per call: the grid's z dimension
MAX_STREAMS = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = build.load("verify_attention")
        fn = lib.llmvox_verify_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, pos, n_head):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"verify_attention: unsupported device {q.device}")
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, caches and pos must lie on one device")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (B, n, C), caches (B, S, C); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nq, c = q.shape
    if k.shape[0] != b or k.shape[2] != c or c % n_head:
        raise ValueError(f"q {tuple(q.shape)} vs caches {tuple(k.shape)}, "
                         f"n_head {n_head}")
    if not 1 <= b <= MAX_STREAMS:
        raise ValueError(f"{b} streams; the kernel's grid takes 1 to "
                         f"{MAX_STREAMS}")
    if not 1 <= nq <= MAX_QUERIES:
        raise ValueError(f"{nq} queries per stream; the kernel takes 1 to "
                         f"{MAX_QUERIES}")
    if c // n_head > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {c // n_head} > {MAX_HEAD_DIM} is not "
                         f"supported")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q and caches must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError(f"pos must be an int32 tensor of shape ({b},), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("q, caches and pos must be contiguous")
    # the kernel reads cache rows in 16-byte copies and q in 4-byte pairs
    es = q.element_size()
    if (c // n_head * es) % 16 or (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"head rows of {c // n_head * es} bytes or caches "
                         f"not 16-byte aligned: the kernel reads 16-byte "
                         f"chunks")
    if q.data_ptr() % 4:
        raise ValueError("q not 4-byte aligned: the kernel reads its "
                         "elements in pairs")


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     n_head: int) -> torch.Tensor:
    """(B, n, C) attention outputs, query j of stream b over cache rows
    [0..min(pos[b]+j, S-1)]; see ``ops/attention.py::
    batched_verify_attention`` for the function."""
    _check(q, k_cache, v_cache, pos, n_head)
    if q.device.type == "cpu":
        return attention.batched_verify_attention(q, k_cache, v_cache, pos,
                                                  n_head=n_head)
    fn = _entry()
    b, nq, c = q.shape
    s = k_cache.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), b, s, c, n_head, nq,
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"verify_attention kernel launch failed: "
                           f"cudaError {err}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
