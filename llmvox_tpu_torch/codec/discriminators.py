"""GAN discriminators for codec training.

Counterpart of ``llmvox_tpu/codec/discriminators.py``, with the same
params (weight-norm ``{g, v, b}`` convs, kernels (KH, KW, Cin, Cout)) and
channel-last tensors; audio enters as (B, T):

- the multi-period discriminator (HiFi-GAN periods 2, 3, 5, 7, 11): audio
  folded to (T / p, p), 5 strided Conv2d stages and a post conv;
- the multi-resolution discriminator (vocos: rectangular-window magnitude
  STFTs at 1024 / 2048 / 512) and its Conv2d stack;
- DAC's discriminator: an MPD per period and a complex multi-band MRD per
  FFT size (2048 / 1024 / 512), after DC removal and 0.8 peak
  normalisation;
- the MS-STFT discriminator (Encodec's; the trainer does not use it).

The initialisers draw uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) kernels
from numpy: JAX's shapes and distributions, not its values.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from llmvox_tpu_torch.codec.mel import stft
from llmvox_tpu_torch.codec.seanet import pad_reflect, wn_init
from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.ops.istft import device_window

LRELU = 0.1


def _wn_conv2d_init(rng: np.random.Generator, kh, kw, cin, cout) -> Dict:
    bound = float(np.sqrt(1.0 / (kh * kw * cin)))
    w = rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)
    return wn_init(w)


def _wn_conv2d(p: Dict, x: torch.Tensor, stride=(1, 1),
               padding=(0, 0)) -> torch.Tensor:
    return nn.conv2d(x, nn.effective_weight(p), p["b"], stride=stride,
                     padding=padding)


# ---------------------------------------------------------------------------
# multi-period (vocos)
# ---------------------------------------------------------------------------

PERIODS = (2, 3, 5, 7, 11)
_MPD_CH = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]


def _init_period(rng) -> Dict:
    convs = [_wn_conv2d_init(rng, 5, 1, cin, cout) for cin, cout in _MPD_CH]
    return {"convs": convs, "post": _wn_conv2d_init(rng, 3, 1, 1024, 1)}


def init_mpd(seed: int, periods: Tuple[int, ...] = PERIODS) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [_init_period(rng) for _ in periods]


def fold_period(x: torch.Tensor, period: int) -> torch.Tensor:
    """(B, T) -> (B, T / p, p, 1), reflect-padded to a multiple of p."""
    b, t = x.shape
    if t % period:
        x = pad_reflect(x, 0, period - t % period, dim=1)
    return x.reshape(b, -1, period, 1)


def apply_dac_mpd(p: Dict, x: torch.Tensor, period: int) -> List:
    """The period stack's maps: every stage's activation, then the post
    conv's score map (DAC's MPD returns them all)."""
    h = fold_period(x, period)
    maps = []
    for i, conv in enumerate(p["convs"]):
        stride = (3, 1) if i < 4 else (1, 1)
        h = nn.leaky_relu(_wn_conv2d(conv, h, stride, (2, 0)), LRELU)
        maps.append(h)
    maps.append(_wn_conv2d(p["post"], h, padding=(1, 0)))
    return maps


def apply_discriminator_p(p: Dict, x: torch.Tensor, period: int):
    """(flat score (B, n), feature maps: stages 1..4 and the post conv)."""
    maps = apply_dac_mpd(p, x, period)
    score = maps[-1]
    return score.reshape(score.shape[0], -1), maps[1:]


# ---------------------------------------------------------------------------
# multi-resolution (vocos)
# ---------------------------------------------------------------------------

RESOLUTIONS = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
_MRD_SPECS = [((7, 5), (2, 2), (3, 2)), ((5, 3), (2, 1), (2, 1)),
              ((5, 3), (2, 2), (2, 1)), ((3, 3), (2, 1), (1, 1)),
              ((3, 3), (2, 2), (1, 1))]


def init_mrd(seed: int, resolutions=RESOLUTIONS,
             channels: int = 64) -> List[Dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in resolutions:
        convs, cin = [], 1
        for kshape, _, _ in _MRD_SPECS:
            convs.append(_wn_conv2d_init(rng, *kshape, cin, channels))
            cin = channels
        out.append({"convs": convs,
                    "post": _wn_conv2d_init(rng, 3, 3, channels, 1)})
    return out


def apply_discriminator_r(p: Dict, x: torch.Tensor, resolution):
    """Rectangular-window magnitude STFT, (B, bins, frames, 1) -> the
    Conv2d stack: (flat score, feature maps: 5 stages and the post)."""
    n_fft, hop, win = resolution
    s = stft(x, n_fft=n_fft, hop_length=hop, win_length=win,
             windowed=False).abs()
    h = s.transpose(1, 2)[..., None]
    fmap = []
    for conv, (_, stride, pad) in zip(p["convs"], _MRD_SPECS):
        h = nn.leaky_relu(_wn_conv2d(conv, h, stride, pad), LRELU)
        fmap.append(h)
    score = _wn_conv2d(p["post"], h, padding=(1, 1))
    fmap.append(score)
    return score.reshape(score.shape[0], -1), fmap


# ---------------------------------------------------------------------------
# DAC (MPD + complex multi-band MRD)
# ---------------------------------------------------------------------------

DAC_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
DAC_FFTS = (2048, 1024, 512)
_DAC_MRD_SPECS = [((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                  ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                  ((3, 3), (1, 1), (1, 1))]


def init_dac(seed: int, periods=PERIODS, fft_sizes=DAC_FFTS,
             bands=DAC_BANDS) -> Dict:
    rng = np.random.default_rng(seed)
    mpds = [_init_period(rng) for _ in periods]
    mrds = []
    for _ in fft_sizes:
        band_convs = []
        for _ in bands:
            convs, cin = [], 2
            for kshape, _, _ in _DAC_MRD_SPECS:
                convs.append(_wn_conv2d_init(rng, *kshape, cin, 32))
                cin = 32
            band_convs.append(convs)
        mrds.append({"band_convs": band_convs,
                     "post": _wn_conv2d_init(rng, 3, 3, 32, 1)})
    return {"mpd": mpds, "mrd": mrds}


def dac_preprocess(x: torch.Tensor) -> torch.Tensor:
    """DC removal and 0.8 peak normalisation."""
    x = x - x.mean(dim=-1, keepdim=True)
    peak = x.abs().amax(dim=-1, keepdim=True)
    return 0.8 * x / (peak + 1e-9)


def apply_dac_mrd(p: Dict, x: torch.Tensor, n_fft: int,
                  bands=DAC_BANDS) -> List:
    """Rectangular-window complex STFT as (B, frames, bins, 2) real and
    imaginary channels, a conv stack per band, the bands joined on the
    frequency axis, the post conv: every band stage's map, then the
    score map."""
    s = stft(x, n_fft=n_fft, hop_length=n_fft // 4, windowed=False)
    h_full = torch.view_as_real(s)
    nbins = n_fft // 2 + 1
    fmap, band_outs = [], []
    for (lo, hi), convs in zip(bands, p["band_convs"]):
        band = h_full[:, :, int(lo * nbins): int(hi * nbins), :]
        for conv, (_, stride, pad) in zip(convs, _DAC_MRD_SPECS):
            band = nn.leaky_relu(_wn_conv2d(conv, band, stride, pad), LRELU)
            fmap.append(band)
        band_outs.append(band)
    h = torch.cat(band_outs, dim=2)
    fmap.append(_wn_conv2d(p["post"], h, padding=(1, 1)))
    return fmap


def apply_dac(params: Dict, x: torch.Tensor, periods=PERIODS,
              fft_sizes=DAC_FFTS, bands=DAC_BANDS) -> List[List]:
    """One list of feature maps per sub-discriminator, the score map
    last in each."""
    x = dac_preprocess(x)
    out = [apply_dac_mpd(p, x, per) for p, per in zip(params["mpd"], periods)]
    out += [apply_dac_mrd(p, x, f, bands)
            for p, f in zip(params["mrd"], fft_sizes)]
    return out


# ---------------------------------------------------------------------------
# MS-STFT (Encodec's; not used by the trainer)
# ---------------------------------------------------------------------------

MSSTFT_FFTS = (1024, 2048, 512)
_MSSTFT_DILATIONS = (1, 2, 4)


def init_msstft(seed: int, fft_sizes=MSSTFT_FFTS,
                filters: int = 32) -> List[Dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in fft_sizes:
        convs, cin = [_wn_conv2d_init(rng, 3, 9, 2, filters)], filters
        for _ in _MSSTFT_DILATIONS:
            convs.append(_wn_conv2d_init(rng, 3, 9, cin, filters))
        convs.append(_wn_conv2d_init(rng, 3, 3, cin, filters))
        out.append({"convs": convs,
                    "post": _wn_conv2d_init(rng, 3, 3, filters, 1)})
    return out


def apply_msstft_one(p: Dict, x: torch.Tensor, n_fft: int,
                     lrelu: float = 0.2):
    """Window-normalised uncentered complex STFT (real and imaginary
    channels) -> Conv2d stack with time dilations: (flat score, the
    stages' maps; the post conv is not among them)."""
    s = stft(x, n_fft=n_fft, hop_length=n_fft // 4, center=False)
    s = s / device_window(n_fft, x.device,
                          nn.wide_dtype(x.dtype)).square().sum().sqrt()
    h = torch.view_as_real(s)
    fmap = []
    for i, conv in enumerate(p["convs"]):
        if i == 0:
            h = _wn_conv2d(conv, h, padding=(1, 4))
        elif i <= len(_MSSTFT_DILATIONS):
            d = _MSSTFT_DILATIONS[i - 1]
            h = nn.conv2d(h, nn.effective_weight(conv), conv["b"],
                          stride=(1, 2), padding=(d, 4), rhs_dilation=(d, 1))
        else:
            h = _wn_conv2d(conv, h, padding=(1, 1))
        h = nn.leaky_relu(h, lrelu)
        fmap.append(h)
    score = _wn_conv2d(p["post"], h, padding=(1, 1))
    return score.reshape(score.shape[0], -1), fmap


def apply_msstft(params: List[Dict], x: torch.Tensor,
                 fft_sizes=MSSTFT_FFTS):
    scores, fmaps = [], []
    for p, f in zip(params, fft_sizes):
        s, fm = apply_msstft_one(p, x, f)
        scores.append(s)
        fmaps.append(fm)
    return scores, fmaps
