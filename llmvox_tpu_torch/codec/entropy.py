"""Arithmetic (range) coding for RVQ code streams.

The reference ships an arithmetic coder wired to its Encodec LM
(WavTokenizer/encoder/quantization/ac.py:56-260) — but it is dead code
upstream: ac.py imports ``..binary`` (BitPacker/BitUnpacker), a module the
reference repo does not contain.  This is a working, self-contained
re-implementation of the same scheme: an integer range coder over
per-step quantized CDFs produced by the LM, plus the missing bit-packing
layer.  Everything here is host-side Python/NumPy by design — bit IO is
inherently sequential; the LM pdf evaluation (the FLOPs) runs on the
device (``codec.lm.LMStepper``).  The port's copy of
``llmvox_tpu/codec/entropy.py``: on the same pdfs it writes the same bytes.

Encoder and decoder must consume EXACTLY the same sequence of quantized
CDFs; ``llmvox_tpu_torch.codec.compress`` guarantees that by driving both
sides through the same LM step program.
"""
from __future__ import annotations

import io
from typing import IO, List, Optional

import numpy as np

TOTAL_RANGE_BITS = 24


class BitPacker:
    """Pack single bits (MSB-first) into a byte stream."""

    def __init__(self, fo: IO[bytes]):
        self.fo = fo
        self._acc = 0
        self._n = 0

    def push(self, bit: int) -> None:
        self._acc = (self._acc << 1) | (bit & 1)
        self._n += 1
        if self._n == 8:
            self.fo.write(bytes([self._acc]))
            self._acc = 0
            self._n = 0

    def flush(self) -> None:
        if self._n:
            self.fo.write(bytes([self._acc << (8 - self._n)]))
            self._acc = 0
            self._n = 0


class BitUnpacker:
    """Pull single bits (MSB-first) from a byte stream; None when drained."""

    def __init__(self, fo: IO[bytes]):
        self.fo = fo
        self._acc = 0
        self._n = 0

    def pull(self) -> Optional[int]:
        if self._n == 0:
            byte = self.fo.read(1)
            if not byte:
                return None
            self._acc = byte[0]
            self._n = 8
        self._n -= 1
        return (self._acc >> self._n) & 1


def quantized_cdf(pdf: np.ndarray, total_range_bits: int = TOTAL_RANGE_BITS,
                  roundoff: float = 1e-8, min_range: int = 2) -> np.ndarray:
    """Quantize a pdf into an integer CDF over [0, 2**total_range_bits).

    Matches ``build_stable_quantized_cdf`` (ac.py:18-53): the pdf is
    floored to ``roundoff`` steps (so tiny float drift between platforms
    cannot change the CDF), mixed with a uniform floor of ``min_range``
    per symbol (so rare symbols keep a non-empty range), then cumulated.
    """
    if min_range < 2:
        raise ValueError("min_range must be at least 2")
    pdf = np.asarray(pdf, np.float64)
    if roundoff:
        pdf = np.floor(pdf / roundoff) * roundoff
    total = 1 << total_range_bits
    n = len(pdf)
    alpha = min_range * n / total
    if alpha > 1:
        raise ValueError("reduce min_range (too many symbols for the range)")
    ranges = np.floor((1 - alpha) * total * pdf).astype(np.int64) + min_range
    cdf = np.cumsum(ranges)
    if cdf[-1] > total:
        raise ValueError(f"CDF overflows the range: {cdf[-1]} > {total}")
    return cdf


class ArithmeticCoder:
    """Integer range coder (the push side of ac.py:56-167).

    Keeps the live interval [low, high]; each symbol narrows it to the
    symbol's CDF slice (rescaled into the current width), then any bits on
    which low and high already agree are final and flushed to the stream.
    When the width falls under ``2**total_range_bits`` both bounds are
    doubled (a new uncommitted bit is appended) so the next CDF slice keeps
    integer resolution.
    """

    def __init__(self, fo: IO[bytes],
                 total_range_bits: int = TOTAL_RANGE_BITS):
        assert total_range_bits <= 30
        self.total_range_bits = total_range_bits
        self.packer = BitPacker(fo)
        self.low = 0
        self.high = 0
        self.max_bit = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b_low = self.low >> self.max_bit
            b_high = self.high >> self.max_bit
            if b_low != b_high:
                break
            self.low -= b_low << self.max_bit
            self.high -= b_low << self.max_bit
            self.max_bit -= 1
            self.packer.push(b_low)

    def push(self, symbol: int, cdf: np.ndarray) -> None:
        total = 1 << self.total_range_bits
        while self.delta < total:
            self.low *= 2
            self.high = self.high * 2 + 1
            self.max_bit += 1
        range_low = 0 if symbol == 0 else int(cdf[symbol - 1])
        range_high = int(cdf[symbol]) - 1
        # ceil / floor keep sub-ranges disjoint across symbols
        eff_low = -((-range_low * self.delta) // total)
        eff_high = (range_high * self.delta) // total
        self.high = self.low + eff_high
        self.low = self.low + eff_low
        assert self.low <= self.high
        self._flush_common_prefix()

    def flush(self) -> None:
        while self.max_bit >= 0:
            self.packer.push((self.low >> self.max_bit) & 1)
            self.max_bit -= 1
        self.packer.flush()


class ArithmeticDecoder:
    """The pull side (ac.py:170-260): reads bits until the interval has full
    resolution, then binary-searches the CDF for the unique symbol whose
    rescaled slice contains the current code point."""

    def __init__(self, fo: IO[bytes],
                 total_range_bits: int = TOTAL_RANGE_BITS):
        self.total_range_bits = total_range_bits
        self.unpacker = BitUnpacker(fo)
        self.low = 0
        self.high = 0
        self.current = 0
        self.max_bit = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b_low = self.low >> self.max_bit
            b_high = self.high >> self.max_bit
            if b_low != b_high:
                break
            self.low -= b_low << self.max_bit
            self.high -= b_low << self.max_bit
            self.current -= b_low << self.max_bit
            self.max_bit -= 1

    def pull(self, cdf: np.ndarray) -> Optional[int]:
        total = 1 << self.total_range_bits
        while self.delta < total:
            bit = self.unpacker.pull()
            if bit is None:
                return None
            self.low *= 2
            self.high = self.high * 2 + 1
            self.current = self.current * 2 + bit
            self.max_bit += 1

        lo_idx, hi_idx = 0, len(cdf) - 1
        while True:
            if hi_idx < lo_idx:
                raise RuntimeError("arithmetic decoder: CDF search failed")
            mid = (lo_idx + hi_idx) // 2
            range_low = int(cdf[mid - 1]) if mid > 0 else 0
            range_high = int(cdf[mid]) - 1
            low = -((-range_low * self.delta) // total) + self.low
            high = (range_high * self.delta) // total + self.low
            if self.current < low:
                hi_idx = mid - 1
            elif self.current > high:
                lo_idx = mid + 1
            else:
                self.low, self.high = low, high
                self._flush_common_prefix()
                return mid
