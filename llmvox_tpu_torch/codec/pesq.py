"""Wideband PESQ (ITU-T P.862.2) — dependency-free.

The port's copy of ``llmvox_tpu/codec/pesq.py`` (numpy on the host; its
resampler is ``utils/native.py``'s).  The reference evaluates PESQ
through the optional ``pesq`` package (WavTokenizer/metrics/infer.py:
60-75, decoder/experiment.py:246-255); like ``codec/stoi.py`` for pystoi,
this is a NumPy implementation of the published algorithm structure so
the metric is available without it:

1. resample both signals to 16 kHz (wideband mode);
2. level-align each signal to a fixed active-speech power measured in
   the 325-3250 Hz band (P.862 §10.1);
3. global time alignment by FFT cross-correlation of 4 ms energy
   envelopes (P.862's per-utterance realignment is replaced by one
   whole-file delay: codec-eval pairs are sample-aligned or carry one
   constant codec latency);
4. perceptual model: 32 ms Hann frames, 50 % overlap -> power spectrum
   -> 49 Bark bands (uniform on the Traunmueller scale over
   100 Hz-8 kHz) -> partial linear-frequency-response compensation of
   the reference (clipped at +/-10 dB, see inline note) and short-term
   gain compensation of the degraded signal -> Zwicker-law loudness;
5. disturbance: per-cell masked difference (deadzone 0.25*min), a
   symmetric (L3-over-bands) and an asymmetric (Bark-spectrum-ratio
   weighted, L1-over-bands) frame disturbance, aggregated over time as
   an L6 norm within ~320 ms intervals and an L2 norm across them,
   frames weighted down in silence;
6. raw score 4.5 - 0.1*d_sym - 0.0309*d_asym, mapped to MOS-LQO by the
   P.862.2 logistic y = 0.999 + 4/(1 + exp(-1.3669 x + 3.8224)) (so an
   identical pair scores 4.644, matching the reference package).

NOT ITU-conformance-tested: the ITU test vectors are not in the repository,
and per-utterance realignment / bad-interval iteration are intentionally
omitted.  The disturbance scale is calibrated so an identity pair is
exact and additive-noise MOS falls monotonically over a 40->0 dB SNR
ladder with sensible absolute values (tests/test_metrics.py).

``codec/metrics.py::pesq_score`` prefers a registered plug-in backend,
then the pesq package, then this implementation.
"""
from __future__ import annotations

import numpy as np

FS = 16000                 # wideband internal rate
N_FRAME = 512              # 32 ms
HOP = 256                  # 50 % overlap
N_BARK = 49
F_LO, F_HI = 100.0, 8000.0
TARGET_POW = 1e-2          # active-band power both signals are scaled to
INTERVAL = 20              # frames per ~320 ms aggregation interval
# Disturbance scales: our loudness domain is more compressed than ITU's
# internal calibration (different absolute-power convention), so the raw
# frame disturbances span ~0-0.35 (sym) / ~0-3 (asym) where P.862's span
# ~0-45 each (its per-frame clip).  These factors bridge the domains so
# the published 0.1 / 0.0309 weights apply: fixed so identity is exact,
# the additive-white-noise ladder spans MOS ~4.3 (40 dB SNR) -> ~1.1
# (0 dB), and a fully-deleted signal lands ~2 — see module docstring.
D_SYM_CAL = 80.0
D_ASYM_CAL = 14.0


def _resample(x: np.ndarray, sr_in: int) -> np.ndarray:
    if sr_in == FS:
        return np.asarray(x, np.float64)
    from llmvox_tpu_torch.utils.native import resample_poly
    return np.asarray(resample_poly(np.asarray(x, np.float32), FS, sr_in),
                      np.float64)


def _frames(x: np.ndarray) -> np.ndarray:
    if len(x) < N_FRAME:
        x = np.pad(x, (0, N_FRAME - len(x)))
    n = 1 + (len(x) - N_FRAME) // HOP
    return np.lib.stride_tricks.sliding_window_view(x, N_FRAME)[::HOP][:n]


def _level_align(x: np.ndarray) -> np.ndarray:
    """Scale to fixed power in the 325-3250 Hz speech band (P.862 §10.1)."""
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / FS)
    band = (f >= 325.0) & (f <= 3250.0)
    p_band = np.sum(np.abs(spec[band]) ** 2) / (len(x) ** 2 / 2)
    # guard: silence in the speech band -> fall back to full-band power
    if p_band < 1e-12:
        p_band = max(float(np.mean(x ** 2)), 1e-12)
    return x * np.sqrt(TARGET_POW / p_band)


def _global_delay(ref: np.ndarray, deg: np.ndarray,
                  max_ms: float = 500.0) -> int:
    """Whole-file delay of deg vs ref from 4 ms energy envelopes."""
    env_hop = FS // 250                       # 4 ms
    n = min(len(ref), len(deg)) // env_hop
    if n < 4:
        return 0
    er = (ref[:n * env_hop].reshape(n, env_hop) ** 2).sum(1)
    ed = (deg[:n * env_hop].reshape(n, env_hop) ** 2).sum(1)
    er -= er.mean()
    ed -= ed.mean()
    m = int(2 ** np.ceil(np.log2(2 * n)))
    xc = np.fft.irfft(np.fft.rfft(ed, m) * np.conj(np.fft.rfft(er, m)), m)
    lags = np.concatenate([np.arange(m // 2), np.arange(-m // 2, 0)])
    max_lag = int(max_ms / 1000 * 250)
    ok = np.abs(lags) <= min(max_lag, n - 2)
    best = lags[ok][int(np.argmax(xc[ok]))]
    return int(best) * env_hop


def _bark_edges() -> np.ndarray:
    """49 band edges uniform on the Traunmueller Bark scale, 100-8000 Hz."""
    def to_bark(f):
        return 26.81 * f / (1960.0 + f) - 0.53

    def from_bark(z):
        return 1960.0 * (z + 0.53) / (26.28 - z)

    z = np.linspace(to_bark(F_LO), to_bark(F_HI), N_BARK + 1)
    return from_bark(z)


def _band_matrix(edges: np.ndarray) -> np.ndarray:
    """(N_BARK, nfft//2+1) 0/1 summation matrix over FFT bins."""
    f = np.fft.rfftfreq(N_FRAME, 1.0 / FS)
    m = np.zeros((N_BARK, len(f)))
    idx = np.searchsorted(edges, f, side="right") - 1
    for b in range(N_BARK):
        m[b, idx == b] = 1.0
    # make sure no band is empty (low bands at 31.25 Hz resolution)
    for b in range(N_BARK):
        if m[b].sum() == 0:
            c = 0.5 * (edges[b] + edges[b + 1])
            m[b, int(np.argmin(np.abs(f - c)))] = 1.0
    return m


def _threshold(centers: np.ndarray) -> np.ndarray:
    """Absolute hearing threshold per band, Terhardt's approximation,
    calibrated so full-scale amplitude 1.0 == 90 dB SPL."""
    khz = centers / 1000.0
    tq_db = (3.64 * khz ** -0.8
             - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
             + 1e-3 * khz ** 4)
    return 10.0 ** ((tq_db - 90.0) / 10.0) * 0.5   # 0.5 = sine power @ A=1


def _loudness(p: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """Zwicker-law specific loudness (P.862 §10.2.6); zero below
    threshold."""
    sl = (p0 / 0.5) ** 0.23
    ratio = np.maximum(p / p0, 0.0)
    loud = sl * ((0.5 + 0.5 * ratio) ** 0.23 - 1.0)
    return np.where(ratio > 1.0, loud, 0.0)


def _bark_spectra(x: np.ndarray, band_mat: np.ndarray) -> np.ndarray:
    fr = _frames(x) * np.hanning(N_FRAME)
    spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2 / N_FRAME
    return spec @ band_mat.T                      # (T, N_BARK)


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = FS,
            _debug: dict | None = None) -> float:
    """Wideband PESQ MOS-LQO of ``deg`` against clean ``ref``."""
    ref = _level_align(_resample(np.asarray(ref, np.float64), sr))
    deg = _level_align(_resample(np.asarray(deg, np.float64), sr))

    d = _global_delay(ref, deg)
    if d > 0:
        deg = deg[d:]
    elif d < 0:
        ref = ref[-d:]
    t = min(len(ref), len(deg))
    ref, deg = ref[:t], deg[:t]

    edges = _bark_edges()
    centers = np.sqrt(edges[:-1] * edges[1:])
    band_mat = _band_matrix(edges)
    p0 = _threshold(centers)

    pr = _bark_spectra(ref, band_mat)             # (T, B) pitch power
    pd = _bark_spectra(deg, band_mat)
    nt = min(len(pr), len(pd))
    pr, pd = pr[:nt], pd[:nt]
    if nt == 0:
        return 1.0

    # speech-active frames of the reference drive every average below
    fr_pow_r = pr.sum(1)
    fr_pow_d = pd.sum(1)
    active = fr_pow_r > 1e-4 * max(fr_pow_r.max(), 1e-30)
    if not active.any():
        active = np.ones(nt, bool)

    # partial compensation of the REFERENCE for linear frequency
    # response (P.862 §10.2.4): per-band average ratio clipped +/-20 dB
    num = (pd[active] + 1e3 * p0).mean(0)
    den = (pr[active] + 1e3 * p0).mean(0)
    # P.862 bounds this at +/-20 dB; our loudness domain is more
    # compressive than ITU's internal calibration, so +/-20 dB would
    # forgive outright band deletion — +/-10 dB still covers realistic
    # linear (telephone-band) filtering without absorbing dropouts.
    comp = np.clip(num / den, 10.0 ** -1.0, 10.0 ** 1.0)
    pr_eq = pr * comp

    # short-term gain compensation of the DEGRADED signal (§10.2.5):
    # per-frame audible-power ratio, smoothed over ~3 frames, clipped
    aud_r = (pr_eq * (pr_eq > p0)).sum(1) + 1e-30
    aud_d = (pd * (pd > p0)).sum(1) + 1e-30
    g = aud_r / aud_d
    kernel = np.ones(3) / 3.0
    if nt >= 3:
        g = np.convolve(g, kernel, mode="same")
    g = np.clip(g, 3e-4, 5.0)
    pd_eq = pd * g[:, None]

    lr = _loudness(pr_eq, p0[None, :])
    ld = _loudness(pd_eq, p0[None, :])

    # masked disturbance (§10.2.7)
    diff = ld - lr
    mask = 0.25 * np.minimum(ld, lr)
    dist = np.sign(diff) * np.maximum(np.abs(diff) - mask, 0.0)

    # asymmetry factor from the Bark spectrum ratio (§10.2.8)
    h = ((pd_eq + 50.0 * p0) / (pr_eq + 50.0 * p0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))

    w = np.full(N_BARK, 1.0 / N_BARK)             # uniform Bark widths
    d_frame = ((np.abs(dist) ** 3 @ w) ** (1.0 / 3.0))
    da_frame = (np.abs(dist) * h) @ w

    # frames with almost no reference energy contribute at reduced
    # weight (silence does not mask additive noise in the score, but
    # must not dominate it either)
    fw = np.where(active, 1.0, 0.3)
    # audible-power emphasis (quiet frames weigh less, §10.2.9)
    emph = ((fr_pow_r + 1e5 * p0.sum()) / (1e2 * TARGET_POW)) ** 0.04
    fw = fw * np.clip(emph, 0.5, 2.0)

    def aggregate(dv: np.ndarray) -> float:
        dv = dv * fw
        n_int = int(np.ceil(nt / INTERVAL))
        pad = n_int * INTERVAL - nt
        dvp = np.pad(dv, (0, pad)).reshape(n_int, INTERVAL)
        l6 = (np.mean(dvp ** 6, axis=1)) ** (1.0 / 6.0)
        return float(np.sqrt(np.mean(l6 ** 2)))

    d_sym = aggregate(d_frame) * D_SYM_CAL
    d_asym = aggregate(da_frame) * D_ASYM_CAL
    if _debug is not None:
        _debug.update(d_sym=d_sym / D_SYM_CAL, d_asym=d_asym / D_ASYM_CAL)

    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    mos = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(np.clip(mos, 1.0, 4.644))


def pesq(sr: int, ref: np.ndarray, deg: np.ndarray,
         mode: str = "wb") -> float:
    """Signature-compatible shim for the ``pesq`` package's entry point
    (metrics/infer.py:60-75 calls ``pesq(sr, ref, deg, 'wb')``)."""
    if mode != "wb":
        raise ValueError("only wideband (P.862.2) mode is implemented")
    return pesq_wb(ref, deg, sr)
