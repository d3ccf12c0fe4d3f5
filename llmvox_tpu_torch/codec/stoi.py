"""Short-Time Objective Intelligibility (STOI) — dependency-free.

The port's copy of ``llmvox_tpu/codec/stoi.py`` (numpy on the host; its
resampler is ``utils/native.py``'s).  The reference evaluates STOI
through the pystoi package (WavTokenizer/metrics/infer.py); this is a
NumPy implementation of the published algorithm (Taal, Hendriks,
Heusdens, Jensen, "An Algorithm for Intelligibility Prediction of
Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011) so the metric is
always available:

1. resample both signals to 10 kHz;
2. remove frames more than 40 dB below the loudest frame (256-sample
   hann frames, 50% overlap) — jointly, by the CLEAN signal's energy;
3. 512-point STFT (256-sample zero-padded hann frames, hop 128);
4. 15 one-third-octave bands, centers 150 Hz * 2^(k/3);
5. over 30-frame segments: normalize the degraded band vector to the
   clean one's energy, clip at (1 + 10^(15/20)) * clean (the beta=-15 dB
   signal-to-distortion lower bound), and average the per-band
   correlation coefficients.

``codec/metrics.py::stoi_score`` prefers a registered plug-in backend,
then pystoi, then this implementation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

FS = 10000              # internal sample rate
N_FRAME = 256           # VAD / analysis frame (25.6 ms)
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG = 30                # frames per intermediate-intelligibility segment
BETA_DB = -15.0         # lower signal-to-distortion bound
DYN_RANGE_DB = 40.0


def _resample(x: np.ndarray, sr_in: int, sr_out: int = FS) -> np.ndarray:
    if sr_in == sr_out:
        return np.asarray(x, np.float64)
    from llmvox_tpu_torch.utils.native import resample_poly
    return np.asarray(resample_poly(np.asarray(x, np.float32), sr_out,
                                    sr_in), np.float64)


def _frames(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    if len(x) < frame:
        return np.zeros((0, frame))
    n = 1 + (len(x) - frame) // hop
    return np.lib.stride_tricks.sliding_window_view(x, frame)[::hop][:n]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray,
                          dyn_range: float = DYN_RANGE_DB
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop frames whose CLEAN energy is > dyn_range dB below the peak
    frame; surviving frames are overlap-added back (hann, 50%)."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    xf = _frames(x, N_FRAME, hop) * w
    yf = _frames(y, N_FRAME, hop) * w
    if len(xf) == 0:
        return x, y
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-300)
    mask = energies > energies.max() - dyn_range
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    if n == 0:
        return np.zeros(0), np.zeros(0)
    out_len = (n - 1) * hop + N_FRAME
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop: i * hop + N_FRAME] += xf[i]
        ys[i * hop: i * hop + N_FRAME] += yf[i]
    return xs, ys


def _third_octave_matrix() -> np.ndarray:
    """(NUM_BANDS, NFFT//2+1) 0/1 matrix selecting each band's bins."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for b in range(NUM_BANDS):
        # each bin belongs to the band whose edges enclose it (nearest-
        # edge assignment like pystoi: pick bins in [lo, hi))
        lo_i = int(np.argmin(np.square(f - lo[b])))
        hi_i = int(np.argmin(np.square(f - hi[b])))
        obm[b, lo_i:hi_i] = 1.0
    return obm


def _band_envelopes(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """(T, NUM_BANDS) one-third-octave magnitudes of 512-pt STFT frames."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    xf = _frames(x, N_FRAME, hop) * w
    spec = np.fft.rfft(xf, NFFT, axis=1)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ obm.T)


def stoi(x: np.ndarray, y: np.ndarray, sr: int) -> float:
    """STOI of degraded ``y`` against clean ``x`` in [~0, 1]."""
    t = min(len(x), len(y))
    x = _resample(np.asarray(x[:t], np.float64), sr)
    y = _resample(np.asarray(y[:t], np.float64), sr)
    x, y = _remove_silent_frames(x, y)
    if len(x) < (SEG + 1) * (N_FRAME // 2) + N_FRAME:
        return float("nan")  # too short after VAD, like pystoi's warning
    obm = _third_octave_matrix()
    ex = _band_envelopes(x, obm)          # (T, bands)
    ey = _band_envelopes(y, obm)
    n_seg = ex.shape[0] - SEG + 1
    # clip bound (1 + 10^(-beta/20)) with beta = -15 dB -> 1 + 5.62: the
    # degraded envelope may overshoot the clean one by ~16.4 dB before
    # the SDR lower bound kicks in (Taal 2011 eq. 3; pystoi's BETA)
    beta = 10.0 ** (-BETA_DB / 20.0)
    corrs = []
    for m in range(n_seg):
        cx = ex[m: m + SEG]               # (SEG, bands)
        cy = ey[m: m + SEG]
        # scale the degraded segment to the clean one's energy per band
        alpha = np.sqrt(np.sum(cx ** 2, axis=0)
                        / (np.sum(cy ** 2, axis=0) + 1e-300))
        cyn = cy * alpha[None]
        # clip: the degraded envelope cannot help more than beta allows
        cyn = np.minimum(cyn, cx * (1.0 + beta))
        cxm = cx - cx.mean(axis=0, keepdims=True)
        cym = cyn - cyn.mean(axis=0, keepdims=True)
        num = np.sum(cxm * cym, axis=0)
        den = (np.linalg.norm(cxm, axis=0) * np.linalg.norm(cym, axis=0)
               + 1e-300)
        corrs.append(num / den)
    return float(np.mean(corrs))
