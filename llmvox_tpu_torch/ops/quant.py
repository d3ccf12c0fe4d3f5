"""Int8 / int4 weight quantization for the speech decoder's serving paths.

Counterpart of ``llmvox_tpu/ops/quant.py`` with the same containers, field
names and layouts, so a quantized tree carries over key for key:

- :class:`QuantizedTensor` (``w8``): ``q`` int8 ``(…, Cin, Cout)``, ``s``
  float ``(…, 1, Cout)``, one symmetric scale per output channel over the
  contraction axis; the matmul dequantizes ``q * s`` into its operand.
- :class:`Int8Linear` (``w8a8``): the same storage; activations quantize
  per row at the call site and the product runs in int8 with an exact
  int32 sum (``int8_matmul``).
- :class:`Int4Tensor` (``w4``): ``q`` int8 ``(…, Cin/2, Cout)`` holding two
  4-bit values per byte (logical rows 2i / 2i+1 in the low / high nibble),
  ``s`` float ``(…, G, 1, Cout)``, one scale per group of ``Cin/G`` rows.
  Its matmul is kernel K4 (``ops/cuda_int4_mm.py``).

Each container indexes by layer: ``w[layer]`` slices ``q`` and ``s``
together and is the 2-D container of that layer, as JAX's tree-aware
layer slice gives it.  Quantizers take numpy arrays or tensors and return
containers of CPU tensors; ``utils/params.py::to_torch`` moves them to a
device and casts ``s`` (never ``q``) to the serving dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class _Quantized:
    q: torch.Tensor
    s: torch.Tensor

    def __getitem__(self, index):
        return type(self)(q=self.q[index], s=self.s[index])

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        # the logical dtype: what dequantization produces by default
        return self.s.dtype


class QuantizedTensor(_Quantized):
    """Symmetric per-channel int8 weight, ``w ~= q * s`` (weight-only)."""


class Int8Linear(_Quantized):
    """Int8 weight for int8 x int8 compute with per-row activation scales."""


class Int4Tensor(_Quantized):
    """Symmetric group-wise int4 weight, two values per int8 byte along the
    contraction axis; ``w[..., g*n:(g+1)*n, c] ~= q * s[..., g, 0, c]``."""

    @property
    def shape(self):
        # the LOGICAL weight shape
        return (*self.q.shape[:-2], 2 * self.q.shape[-2], self.q.shape[-1])


QUANTIZED = (QuantizedTensor, Int8Linear, Int4Tensor)
CONTAINERS = {cls.__name__: cls for cls in QUANTIZED}


def _tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.array(w, dtype=np.float32))


def quantize_weight(w, contract_axis: int = -2, cls=None) -> _Quantized:
    """Int8 with one scale per output channel, computed over the
    contraction axis: ``s = max|w| / 127``, ``q = round(w / s)``."""
    w = _tensor(w).float()
    amax = w.abs().amax(dim=contract_axis, keepdim=True)
    s = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return (cls or QuantizedTensor)(q=q, s=s)


def quantize_weight4(w, group: int = 256) -> Int4Tensor:
    """Packed int4 with one scale per ``group`` contraction rows per output
    channel, clipped to ±7; one group when ``Cin % group != 0``."""
    w = _tensor(w).float()
    cin, cout = w.shape[-2], w.shape[-1]
    if cin % 2:
        raise ValueError("int4 packing needs an even contraction dim")
    g = group if group > 0 and cin % group == 0 else cin
    lead = w.shape[:-2]
    wg = w.reshape(*lead, cin // g, g, cout)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    s = amax.clamp_min(1e-8) / 7.0
    q = torch.round(wg / s).clamp(-7, 7).to(torch.int8).reshape(*lead, cin,
                                                                 cout)
    lo, hi = q[..., 0::2, :].to(torch.int32), q[..., 1::2, :].to(torch.int32)
    packed = ((lo & 0xF) | (hi << 4)).to(torch.int8)
    return Int4Tensor(q=packed.contiguous(), s=s)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 (…, Cin/2, Cout) -> int8 (…, Cin, Cout) in [-8, 7]:
    arithmetic shifts in int32 sign-extend each nibble."""
    p = packed.to(torch.int32)
    lo, hi = (p << 28) >> 28, p >> 4
    q = torch.stack([lo, hi], dim=-2).to(torch.int8)   # (…, Cin/2, 2, Cout)
    return q.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                     packed.shape[-1])


def dequantize(w, dtype=None) -> torch.Tensor:
    """Quantized weight -> dense tensor in ``dtype`` (default: the scales'
    dtype), computed in that dtype as JAX does; plain tensors cast."""
    if isinstance(w, (QuantizedTensor, Int8Linear)):
        dtype = dtype or w.s.dtype
        return w.q.to(dtype) * w.s.to(dtype)
    if isinstance(w, Int4Tensor):
        dtype = dtype or w.s.dtype
        q = unpack_int4(w.q)
        cin, cout = q.shape[-2], q.shape[-1]
        ng = w.s.shape[-3]
        qg = q.reshape(*q.shape[:-2], ng, cin // ng, cout).to(dtype)
        return (qg * w.s.to(dtype)).reshape(q.shape)
    return w if dtype is None else w.to(dtype)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (M, K) and (K, N).  On the card this is
    ``torch._int_mm`` (cuBLASLt), whose CUDA path wants more than 16 rows:
    the rows are zero-padded to a multiple of 8 above 16 and cut after."""
    m = a.shape[0]
    if a.device.type == "cuda":
        mp = max(24, -(-m // 8) * 8)
        if mp != m:
            a = torch.cat([a, a.new_zeros((mp - m, a.shape[1]))])
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def int8_matmul(x: torch.Tensor, w: Int8Linear) -> torch.Tensor:
    """``x @ dequant(w)`` with int8 activations: ``sx = max|x| / 127`` per
    row, the int8 product summed exactly in int32, both scales applied to
    the f32 result, cast to x's dtype.  An f32 product would not be exact:
    |sum| reaches 127^2 * 3072 > 2^24."""
    x32 = x.float()
    sx = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    qx = torch.round(x32 / sx).clamp(-127, 127).to(torch.int8)
    lead = x.shape[:-1]
    y = _int_mm(qx.reshape(-1, x.shape[-1]).contiguous(), w.q)
    y = y.reshape(*lead, y.shape[-1])
    scale = sx * w.s.reshape(w.s.shape[-1]).float()
    return (y.float() * scale).to(x.dtype)


def _quantize_named(tree: Dict, names: Sequence[str], cls=QuantizedTensor,
                    keep_w8: Sequence[str] = ()) -> Dict:
    """Replace dict entries whose key is in ``names`` (at any depth) by
    quantized containers; keys in ``keep_w8`` always get the weight-only
    int8 container.  Everything else is kept as it is."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _quantize_named(v, names, cls, keep_w8)
        elif k in names and not isinstance(v, _Quantized):
            if cls is Int4Tensor and k not in keep_w8:
                out[k] = quantize_weight4(v)
            else:
                out[k] = quantize_weight(
                    v, cls=QuantizedTensor if k in keep_w8 else cls)
        else:
            out[k] = v
    return out


def _mode_cls(mode: str):
    if mode == "w8":
        return QuantizedTensor
    if mode == "w8a8":
        return Int8Linear
    if mode == "w4":
        return Int4Tensor
    raise ValueError(f"unknown quantization mode {mode!r} "
                     "(expected 'w8', 'w8a8' or 'w4')")


# the speech decoder's matmul weights, all (…, Cin, Cout)
DECODER_MATMUL_KEYS = ("wqkv", "wo", "wfc", "wproj", "head")
HEAD_KEYS = ("head",)


def quantize_decoder_params(params: Dict, mode: str = "w8") -> Dict:
    """Quantize the speech decoder's matmul weights.  ``wpe``, the norms
    and the draft heads stay full precision; the lm head stays weight-only
    int8 in every mode (its 4096-way argmax is the output token)."""
    return _quantize_named(params, DECODER_MATMUL_KEYS, _mode_cls(mode),
                           keep_w8=HEAD_KEYS)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, _Quantized):
        yield tree.q
        yield tree.s
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params) -> int:
    """Parameter bytes as stored: int8 leaves count one byte per element,
    and an Int4Tensor's packed bytes hold two weights each."""
    total = 0
    for x in _leaves(params):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        else:
            x = np.asarray(x)
            total += x.size * x.dtype.itemsize
    return total
