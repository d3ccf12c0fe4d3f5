"""Codec quality metrics (reference WavTokenizer/metrics/*).

Counterpart of ``llmvox_tpu/codec/metrics.py``.  Built-in metrics:
- ``mel_distance``: safe-log mel L1 (the reference's core validation
  metric), through ``codec/mel.py::mel_spectrogram`` on the device of its
  input (the card for the codec trainer's validation, ``device`` for
  host arrays);
- ``si_snr``: scale-invariant SNR;
- ``pitch_metrics``: periodicity, pitch and voicing F1 with the
  reference's post-processing (metrics/periodicity.py: A-weighted silence
  gating at -60 dB, unvoiced threshold 0.21, NaN voicing masks) over a
  vectorized YIN tracker (numpy on the host); torchcrepe slots in as the
  ``"crepe"`` plug-in backend.

``pesq_score`` and ``stoi_score`` take a registered plug-in, then the
optional ``pesq`` / ``pystoi`` package, then the built-in implementation
(``codec/pesq.py``, ``codec/stoi.py``).  ``utmos_score`` takes a
registered plug-in (``codec/utmos.py::register`` registers the
in-framework scorer) and otherwise returns None: the port downloads no
model (JAX's falls back to a ``torch.hub`` checkpoint).

Batch evaluation over a decoded test set: ``llmvox_tpu_torch.codec.eval``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.mel import mel_spectrogram, safe_log
from llmvox_tpu_torch.utils.device import resolve_device
from llmvox_tpu_torch.utils.native import resample_poly

# Plug-in backends: name -> callable.  Lets deployments (and tests) inject
# a scorer without the optional package or checkpoint, e.g.
# ``register_plugin("utmos", my_predictor)`` where my_predictor takes
# (wav, sr) and returns a float.
_PLUGINS: Dict[str, Callable] = {}


def register_plugin(name: str, fn: Optional[Callable]) -> None:
    """Register (or, with ``fn=None``, remove) a metric backend.
    Names: ``"pesq"``, ``"stoi"``, ``"utmos"``, ``"crepe"``."""
    if fn is None:
        _PLUGINS.pop(name, None)
    else:
        _PLUGINS[name] = fn


def _host(x) -> np.ndarray:
    """A waveform (numpy or tensor) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def mel_distance(y_hat, y, sample_rate: int = 24000,
                 device="cuda") -> float:
    """Mean |safe_log mel(y_hat) - safe_log mel(y)| of two (T,) waveforms.
    Tensors are used on their own device; host arrays go to ``device``."""
    def mel(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32)).to(
                resolve_device(device))
        return safe_log(mel_spectrogram(x[None], sample_rate=sample_rate))
    return float((mel(y_hat) - mel(y)).abs().mean())


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    est = est - est.mean()
    ref = ref - ref.mean()
    t = min(len(est), len(ref))
    est, ref = est[:t], ref[:t]
    s = (np.dot(est, ref) / (np.dot(ref, ref) + 1e-9)) * ref
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + 1e-9) / (np.dot(e, e) + 1e-9)))


SILENCE_THRESHOLD_DB = -60.0      # metrics/periodicity.py:9
UNVOICED_THRESHOLD = 0.21         # metrics/periodicity.py:10
_CREPE_WINDOW = 1024              # torchcrepe.WINDOW_SIZE
_REF_DB = 20.0                    # torchcrepe.loudness.REF_DB


def _yin_f0(x: np.ndarray, sr: int, frame: int = _CREPE_WINDOW,
            hop: Optional[int] = None, fmin: float = 50.0,
            fmax: float = 550.0, threshold: float = 0.1
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized YIN pitch tracker (de Cheveigné & Kawahara 2002).

    Returns per-frame (f0, periodicity) where periodicity is
    ``1 - cmndf(tau*)`` — the standard aperiodicity complement, playing the
    role of torchcrepe's periodicity in metrics/periodicity.py.  Frame
    geometry matches CREPE's (window 1024, hop sr/100) so the silence mask
    in :func:`predict_pitch` lines up 1:1.

    All frames are processed at once: the difference function comes from
    one batched FFT cross-correlation plus energy cumsums, the CMNDF trough
    is found with the absolute-threshold rule (first dip below 0.1, walked
    to its local minimum), and the lag is refined by parabolic
    interpolation — the steps that make YIN octave-stable where a raw
    autocorrelation peak-pick is not.
    """
    hop = hop or sr // 100
    win = frame // 2
    lag_min = max(1, int(sr / fmax))
    lag_max = min(win - 1, int(sr / fmin))
    if len(x) < frame or lag_max <= lag_min:
        z = np.zeros(0)
        return z, z
    frames = np.lib.stride_tricks.sliding_window_view(
        np.asarray(x, np.float64), frame)[::hop]
    n = frames.shape[0]

    # difference fn d(tau) = e0 + e(tau) - 2 c(tau), tau in [0, lag_max]
    nfft = 1 << int(np.ceil(np.log2(frame + win)))
    spec_full = np.fft.rfft(frames, nfft)
    spec_win = np.fft.rfft(frames[:, :win], nfft)
    cc = np.fft.irfft(np.conj(spec_win) * spec_full, nfft)[:, :lag_max + 1]
    csum = np.cumsum(frames ** 2, axis=1)
    e0 = csum[:, win - 1]
    taus = np.arange(lag_max + 1)
    e_tau = csum[:, taus + win - 1] - np.where(
        taus > 0, csum[:, np.maximum(taus - 1, 0)], 0.0)
    d = np.maximum(e0[:, None] + e_tau - 2.0 * cc, 0.0)

    # cumulative-mean-normalized difference
    cmndf = np.ones_like(d)
    cums = np.cumsum(d[:, 1:], axis=1)
    cmndf[:, 1:] = d[:, 1:] * taus[1:] / np.maximum(cums, 1e-12)

    # absolute threshold: first lag under `threshold`, else the global min
    region = cmndf[:, lag_min:lag_max + 1]
    below = region < threshold
    has_below = below.any(axis=1)
    first = np.argmax(below, axis=1)
    best = np.where(has_below, first, np.argmin(region, axis=1)) + lag_min
    rows = np.arange(n)
    # walk the first-below pick down to its local minimum
    for _ in range(64):
        nxt = np.minimum(best + 1, lag_max)
        step = has_below & (cmndf[rows, nxt] < cmndf[rows, best])
        if not step.any():
            break
        best = np.where(step, nxt, best)

    # parabolic interpolation of the trough
    lo = np.maximum(best - 1, 0)
    hi = np.minimum(best + 1, lag_max)
    y0, y1, y2 = cmndf[rows, lo], cmndf[rows, best], cmndf[rows, hi]
    denom = y0 - 2.0 * y1 + y2
    delta = np.where(np.abs(denom) > 1e-12,
                     0.5 * (y0 - y2) / np.where(denom == 0, 1, denom), 0.0)
    tau = best + np.clip(delta, -1.0, 1.0)
    tau = np.where((best > lag_min) & (best < lag_max), tau,
                   best.astype(np.float64))

    f0 = sr / np.maximum(tau, 1e-9)
    periodicity = np.clip(1.0 - y1, 0.0, 1.0)
    periodicity = np.where(e0 < 1e-10, 0.0, periodicity)   # digital silence
    return f0, periodicity


def _a_weighting_db(freqs: np.ndarray, min_db: float = -80.0) -> np.ndarray:
    """IEC 61672 A-weighting curve in dB (librosa.A_weighting)."""
    f2 = np.asarray(freqs, np.float64) ** 2
    c1, c2, c3, c4 = 20.6 ** 2, 107.7 ** 2, 737.9 ** 2, 12194.0 ** 2
    num = c4 * f2 ** 2
    den = (f2 + c1) * np.sqrt((f2 + c2) * (f2 + c3)) * (f2 + c4)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = 2.0 + 20.0 * np.log10(np.where(den > 0, num / den, 0.0))
    return np.maximum(w, min_db)


def _silence_mask(x: np.ndarray, sr: int,
                  threshold_db: float = SILENCE_THRESHOLD_DB) -> np.ndarray:
    """Low-energy frame detection (metrics/periodicity.py:46-64): hann
    power spectrogram (window 1024, hop sr/100, no centering, no padding),
    A-perceptual weighting minus REF_DB, mean-over-frequency < threshold."""
    hop = sr // 100
    frame = _CREPE_WINDOW
    if len(x) < frame:
        return np.zeros(0, bool)
    frames = np.lib.stride_tricks.sliding_window_view(
        np.asarray(x, np.float64), frame)[::hop]
    window = np.hanning(frame + 1)[:-1]
    power = np.abs(np.fft.rfft(frames * window, frame)) ** 2
    db = 10.0 * np.log10(np.maximum(power, 1e-10))
    db = np.maximum(db, db.max() - 80.0)       # librosa power_to_db top_db
    freqs = np.fft.rfftfreq(frame, 1.0 / sr)
    perceptual = db + _a_weighting_db(freqs)[None] - _REF_DB
    return perceptual.mean(axis=1) < threshold_db


def predict_pitch(audio: np.ndarray, sr: int = 16000,
                  silence_threshold: float = SILENCE_THRESHOLD_DB,
                  unvoiced_threshold: float = UNVOICED_THRESHOLD
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (pitch, periodicity) with the reference's post-processing
    (metrics/periodicity.py:16-69): silence frames get periodicity 0, and
    frames with periodicity under the unvoiced threshold get pitch NaN.

    The F0/periodicity estimator is the built-in YIN tracker, or a
    registered ``"crepe"`` plug-in backend (``register_plugin("crepe",
    fn)`` with ``fn(audio, sr) -> (pitch, periodicity)``) when torchcrepe
    and its checkpoint are available.
    """
    audio = np.asarray(audio, np.float64)
    if "crepe" in _PLUGINS:
        pitch, periodicity = (np.asarray(a, np.float64)
                              for a in _PLUGINS["crepe"](audio, sr))
    else:
        pitch, periodicity = _yin_f0(audio, sr)
    silence = _silence_mask(audio, sr, silence_threshold)
    t = min(len(periodicity), len(silence))
    periodicity = periodicity[:t].copy()
    pitch = pitch[:t].copy()
    periodicity[silence[:t]] = 0.0
    pitch[periodicity < unvoiced_threshold] = np.nan
    return pitch, periodicity


def pitch_metrics(y_hat: np.ndarray, y: np.ndarray, sr: int = 16000,
                  unvoiced_threshold: float = UNVOICED_THRESHOLD
                  ) -> Dict[str, float]:
    """Periodicity RMSE, voiced-pitch RMSE in cents, voicing F1 — the
    metric definitions of ``calculate_periodicity_metrics``
    (metrics/periodicity.py:72-105) over :func:`predict_pitch`."""
    f0_t, per_t = predict_pitch(y, sr, unvoiced_threshold=unvoiced_threshold)
    f0_p, per_p = predict_pitch(y_hat, sr,
                                unvoiced_threshold=unvoiced_threshold)
    t = min(len(f0_t), len(f0_p))
    f0_t, per_t, f0_p, per_p = f0_t[:t], per_t[:t], f0_p[:t], per_p[:t]
    if t == 0:
        return {"periodicity": 0.0, "pitch_rmse_cents": 0.0,
                "voicing_f1": 0.0}
    periodicity = float(np.sqrt(np.mean((per_p - per_t) ** 2)))
    voiced_t = ~np.isnan(f0_t)
    voiced_p = ~np.isnan(f0_p)
    both = voiced_t & voiced_p
    if both.any():
        cents = 1200.0 * (np.log2(f0_t[both]) - np.log2(f0_p[both]))
        pitch = float(np.sqrt(np.mean(cents ** 2)))
    else:
        pitch = 0.0
    tp = float((voiced_t & voiced_p).sum())
    fp = float((~voiced_t & voiced_p).sum())
    fn = float((voiced_t & ~voiced_p).sum())
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"periodicity": periodicity, "pitch_rmse_cents": pitch,
            "voicing_f1": f1}


def pesq_score(y_hat: np.ndarray, y: np.ndarray,
               sr: int = 16000) -> Optional[float]:
    """Wideband PESQ (experiment.py:246-255): a registered backend first,
    then the pesq package, else the built-in implementation
    (``codec/pesq.py``)."""
    if "pesq" in _PLUGINS:
        return float(_PLUGINS["pesq"](y_hat, y, sr))
    try:
        from pesq import pesq
    except ImportError:
        from llmvox_tpu_torch.codec.pesq import pesq_wb
        return float(pesq_wb(y, y_hat, sr))
    return float(pesq(sr, y, y_hat, "wb", on_error=1))


def stoi_score(y_hat: np.ndarray, y: np.ndarray,
               sr: int = 16000) -> Optional[float]:
    """STOI intelligibility (metrics/infer.py uses pystoi): a registered
    backend first, then the pystoi package, else the built-in
    implementation (``codec/stoi.py``)."""
    if "stoi" in _PLUGINS:
        return float(_PLUGINS["stoi"](y_hat, y, sr))
    try:
        from pystoi import stoi
        t = min(len(y_hat), len(y))
        return float(stoi(y[:t], y_hat[:t], sr, extended=False))
    except ImportError:
        from llmvox_tpu_torch.codec.stoi import stoi
        return float(stoi(y, y_hat, sr))


def utmos_score(y_hat: np.ndarray, sr: int = 16000) -> Optional[float]:
    """UTMOS MOS prediction (metrics/UTMOS.py counterpart): the registered
    backend (``codec/utmos.py::register``), else None."""
    if "utmos" in _PLUGINS:
        return float(_PLUGINS["utmos"](y_hat, sr))
    return None


def evaluate_pair(y_hat, y, sample_rate: int = 24000,
                  device="cuda") -> Dict[str, float]:
    """Every metric for one (reconstruction, reference) pair of (T,)
    waveforms (numpy, or tensors on a device for the mel distance); the
    others run on the host at 16 kHz."""
    out = {"mel_distance": mel_distance(y_hat, y, sample_rate, device)}
    y_hat, y = _host(y_hat), _host(y)
    out["si_snr"] = si_snr(y_hat, y)
    y16 = resample_poly(y, 16000, sample_rate)
    yh16 = resample_poly(y_hat, 16000, sample_rate)
    out.update(pitch_metrics(yh16, y16))
    p = pesq_score(yh16, y16)
    if p is not None:
        out["pesq"] = p
    s = stoi_score(yh16, y16)
    if s is not None:
        out["stoi"] = s
    u = utmos_score(yh16)
    if u is not None:
        out["utmos"] = u
    return out
