"""AMS / RASTA-PLP / MFCC / GFCC feature extraction
(``sincformer_tpu/dsp/features.py``), batched over any leading dimensions
where the JAX package ``vmap``s.

Every per-frame stage is a strided framing, one batched real FFT and a
matrix product. The filterbank, window and DCT matrices are built in float64
with numpy and cast to float32, as the JAX package builds them, and kept per
device. Two points differ in form, not in function:

  * the RASTA single-pole recurrence ``y[n] = f[n] + 0.98 y[n-1]`` (a
    ``lax.scan`` over frames in JAX) is linear, so it is a product with the
    lower-triangular matrix of powers of 0.98, in blocks of 512 frames with a
    carry: a few launches on the card instead of one per frame;
  * with the default constants the per-frame AMS window (640 samples → 80
    decimated) is shorter than one 128-sample AMS segment, so the per-frame
    AMS features are identically zero, as in the JAX package and its
    reference; :func:`extract_ams` itself handles longer inputs.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig, FeatureConfig
from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
from sincformer_tpu_torch.utils.signal import (dct_matrix, frame_signal,
                                               hamming_window, num_frames)

RASTA_POLE = 0.98
_RASTA_FIR = (0.2, 0.1, 0.0, -0.1, -0.2)
_RASTA_BLOCK = 512
_DEVICE_CONSTANTS = {}


def _const(make, *args, device) -> torch.Tensor:
    """``make(*args)`` (a numpy array) as a tensor on ``device``, made once
    per device."""
    key = (make.__name__, args, str(device))
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = torch.from_numpy(
            np.ascontiguousarray(make(*args))).to(device)
    return _DEVICE_CONSTANTS[key]


def _pad_to_frame(x: torch.Tensor, frame: int) -> torch.Tensor:
    if x.shape[-1] < frame:
        return torch.nn.functional.pad(x, (0, frame - x.shape[-1]))
    return x


# ═══ AMS ═════════════════════════════════════════════════════════════════════

@functools.lru_cache(maxsize=4)
def _ams_band_weights(fs: int, fcfg: FeatureConfig = FeatureConfig()):
    """(num_bands, n_bins) triangular modulation-band matrix."""
    n_bins = fcfg.ams_fft_size // 2 + 1
    mod_fs = fs / fcfg.ams_decimate
    freq_bins = np.arange(n_bins) * mod_fs / fcfg.ams_fft_size
    centers = np.linspace(fcfg.ams_low_hz, fcfg.ams_high_hz,
                          fcfg.ams_num_bands + 2)
    w = np.zeros((fcfg.ams_num_bands, n_bins), dtype=np.float32)
    for b in range(fcfg.ams_num_bands):
        lo, mid, hi = centers[b], centers[b + 1], centers[b + 2]
        rise = (freq_bins >= lo) & (freq_bins <= mid)
        fall = (freq_bins > mid) & (freq_bins <= hi)
        w[b, rise] = (freq_bins[rise] - lo) / (mid - lo + 1e-10)
        w[b, fall] = (hi - freq_bins[fall]) / (hi - mid + 1e-10)
    return w


def extract_ams(signal: torch.Tensor, fs: Optional[int] = None,
                num_bands: Optional[int] = None,
                fcfg: FeatureConfig = FeatureConfig()) -> torch.Tensor:
    """AMS features of a (..., L) segment: rectify → decimate by 8 →
    128-sample segments (hop 64) → Hamming → 256-point rFFT magnitude → 15
    triangular bands → mean over segments. Returns (..., num_bands); zeros
    when no complete segment fits."""
    fs = fs or AudioConfig().sample_rate
    nb = num_bands or fcfg.ams_num_bands
    x = signal.to(torch.float32).abs()
    dec = x[..., ::fcfg.ams_decimate]
    seg_len = fcfg.ams_segments
    hop = seg_len - fcfg.ams_overlap
    if num_frames(dec.shape[-1], seg_len, hop) == 0:
        return x.new_zeros(x.shape[:-1] + (nb,))
    segs = frame_signal(dec, seg_len, hop)                 # (..., S, 128)
    win = _const(hamming_window, seg_len, False, device=x.device)
    mag = torch.fft.rfft(segs * win, n=fcfg.ams_fft_size, dim=-1).abs()
    bands = mag @ _const(_ams_band_weights, fs, fcfg, device=x.device).T
    return bands.mean(dim=-2)


# ═══ RASTA-PLP ═══════════════════════════════════════════════════════════════

def hz_to_bark(f):
    """6 * arcsinh(f / 600)."""
    return 6.0 * np.arcsinh(np.asarray(f) / 600.0)


def bark_to_hz(z):
    """600 * sinh(z / 6)."""
    return 600.0 * np.sinh(np.asarray(z) / 6.0)


@functools.lru_cache(maxsize=4)
def _iir_powers(n: int):
    """(n + 1, n): rows 0..n-1 the lower-triangular matrix
    ``P[i, j] = 0.98^(i-j)`` (i >= j), row n the carry's decay
    ``0.98^(i+1)``; float64 powers cast to float32."""
    i = np.arange(n)
    lower = np.tril(RASTA_POLE ** np.maximum(i[:, None] - i[None, :], 0))
    return np.concatenate([lower, RASTA_POLE ** (i[None, :] + 1.0)]
                          ).astype(np.float32)


def rasta_filter(x: torch.Tensor) -> torch.Tensor:
    """RASTA band-pass along the last axis: numerator
    [0.2, 0.1, 0, -0.1, -0.2] as a causal FIR, denominator [1, -0.98] as
    the triangular product described in the module docstring."""
    t = x.shape[-1]
    xp = torch.nn.functional.pad(x, (4, 0))
    fir = sum(b * xp[..., 4 - k: t + 4 - k] for k, b in enumerate(_RASTA_FIR))
    block = min(t, _RASTA_BLOCK)
    powers = _const(_iir_powers, block, device=x.device)
    out, carry = [], None
    for start in range(0, t, block):
        f = fir[..., start:start + block]
        n = f.shape[-1]
        y = f @ powers[:n, :n].T
        if carry is not None:
            y = y + carry[..., None] * powers[block, :n]
        carry = y[..., -1]
        out.append(y)
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


@functools.lru_cache(maxsize=4)
def _bark_filterbank(fs: int, fft_size: int, num_filters: int):
    """((num_filters, fft//2+1) triangular bark filterbank, equal-loudness
    weights at the band centres)."""
    bark_centers = np.linspace(hz_to_bark(0.0), hz_to_bark(fs / 2.0),
                               num_filters + 2)
    hz_centers = bark_to_hz(bark_centers)
    freq_bins = np.arange(fft_size // 2 + 1) * fs / fft_size
    fb = np.zeros((num_filters, fft_size // 2 + 1), dtype=np.float32)
    for i in range(num_filters):
        lo, mid, hi = hz_centers[i], hz_centers[i + 1], hz_centers[i + 2]
        rise = (freq_bins >= lo) & (freq_bins <= mid)
        fall = (freq_bins > mid) & (freq_bins <= hi)
        fb[i, rise] = (freq_bins[rise] - lo) / (mid - lo + 1e-10)
        fb[i, fall] = (hi - freq_bins[fall]) / (hi - mid + 1e-10)
    f = bark_to_hz(bark_centers[1:-1])
    eq = (f ** 2 / (f ** 2 + 1.6e5)).astype(np.float32)
    return fb, eq


def _bark_fb(fs, fft_size, num_filters):
    return _bark_filterbank(fs, fft_size, num_filters)[0]


def _bark_eq(fs, fft_size, num_filters):
    return _bark_filterbank(fs, fft_size, num_filters)[1]


def extract_rasta_plp(signal: torch.Tensor, fs: Optional[int] = None,
                      num_coeffs: Optional[int] = None,
                      fcfg: FeatureConfig = FeatureConfig(),
                      acfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Per-utterance RASTA-PLP coefficients: power spectrum → bark bands →
    log → RASTA filter → exp → equal loudness → cube root → mean over frames
    → DCT. (..., N) → (..., num_coeffs)."""
    fs = fs or acfg.sample_rate
    nc = num_coeffs or fcfg.rasta_num_coeff
    frame, hop, fft = acfg.frame_size, acfg.hop_size, acfg.fft_size
    x = _pad_to_frame(signal.to(torch.float32), frame)
    dev = x.device
    frames = frame_signal(x, frame, hop) * _const(hamming_window, frame,
                                                  False, device=dev)
    power = torch.fft.rfft(frames, n=fft, dim=-1).abs() ** 2    # (..., T, F)
    bands = (fs, fft, fcfg.rasta_num_bands)
    bark = (power @ _const(_bark_fb, *bands, device=dev).T).transpose(-1, -2)
    rasta = rasta_filter(torch.log(bark + 1e-10))               # (..., B, T)
    eq = _const(_bark_eq, *bands, device=dev)
    loud = (torch.exp(rasta) * eq[:, None]) ** (1.0 / 3.0)
    mean_spec = loud.mean(dim=-1)                               # (..., B)
    return mean_spec @ _const(dct_matrix, fcfg.rasta_num_bands, nc,
                              device=dev).T


# ═══ MFCC ════════════════════════════════════════════════════════════════════

def hz_to_mel(f):
    """2595 * log10(1 + f / 700)."""
    return 2595.0 * np.log10(1 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    """700 * (10^(m / 2595) - 1)."""
    return 700.0 * (10 ** (np.asarray(m) / 2595.0) - 1)


@functools.lru_cache(maxsize=4)
def mel_filterbank(num_filters: int, fft_size: int, fs: int) -> np.ndarray:
    """Integer-bin mel filterbank with the floor((fft + 1) * hz / fs) bin
    mapping of the JAX package and its reference."""
    mel_pts = np.linspace(hz_to_mel(0), hz_to_mel(fs / 2), num_filters + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((fft_size + 1) * hz_pts / fs).astype(int)
    fb = np.zeros((num_filters, fft_size // 2 + 1), dtype=np.float32)
    for i in range(num_filters):
        for j in range(bins[i], bins[i + 1]):
            if j < fb.shape[1]:
                fb[i, j] = (j - bins[i]) / (bins[i + 1] - bins[i] + 1e-10)
        for j in range(bins[i + 1], bins[i + 2]):
            if j < fb.shape[1]:
                fb[i, j] = (bins[i + 2] - j) / (bins[i + 2] - bins[i + 1]
                                                + 1e-10)
    return fb


def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """pre[0] = x[0], pre[n] = x[n] - 0.97 x[n-1]."""
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)


def _mfcc_frames(signal: torch.Tensor, fs: int, fcfg: FeatureConfig,
                 acfg: AudioConfig, num_coeffs: int) -> torch.Tensor:
    """Per-frame MFCC matrix (..., T, num_coeffs)."""
    frame, hop = acfg.frame_size, acfg.hop_size
    pre = _pad_to_frame(pre_emphasis(signal.to(torch.float32)), frame)
    dev = pre.device
    frames = frame_signal(pre, frame, hop) * _const(hamming_window, frame,
                                                    False, device=dev)
    power = torch.fft.rfft(frames, n=fcfg.mfcc_fft_size, dim=-1).abs() ** 2
    mel = power @ _const(mel_filterbank, fcfg.mfcc_num_filters,
                         fcfg.mfcc_fft_size, fs, device=dev).T
    return torch.log(mel + 1e-10) @ _const(dct_matrix, fcfg.mfcc_num_filters,
                                           num_coeffs, device=dev).T


def extract_mfcc(signal: torch.Tensor, fs: Optional[int] = None,
                 num_coeffs: Optional[int] = None,
                 fcfg: FeatureConfig = FeatureConfig(),
                 acfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Mean-over-frames MFCC vector (..., num_coeffs)."""
    fs = fs or acfg.sample_rate
    nc = num_coeffs or fcfg.mfcc_num_coeff
    return _mfcc_frames(signal, fs, fcfg, acfg, nc).mean(dim=-2)


# ═══ GFCC ════════════════════════════════════════════════════════════════════

def _cube_root(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def extract_gfcc(signal: torch.Tensor, fs: Optional[int] = None,
                 num_coeffs: Optional[int] = None,
                 gfb: Optional[GammatoneFilterbank] = None,
                 fcfg: FeatureConfig = FeatureConfig(),
                 acfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Mean-over-frames GFCC vector: gammatone bank → 10 ms channel
    energies → cube root → DCT. (..., N) → (..., num_coeffs)."""
    fs = fs or acfg.sample_rate
    nc = num_coeffs or fcfg.gfcc_num_coeff
    gfb = gfb or GammatoneFilterbank(sample_rate=fs)
    hop = fs // fcfg.gfcc_decimate_rate
    nf = signal.shape[-1] // hop
    if nf == 0:
        return signal.new_zeros(signal.shape[:-1] + (nc,),
                                dtype=torch.float32)
    energy2 = gfb.filter(signal).abs() ** 2                 # (..., C, N)
    ce = frame_signal(energy2, hop, hop)[..., :nf, :].mean(dim=-1)
    d = _const(dct_matrix, gfb.num_channels, nc, device=ce.device)
    coeffs = _cube_root(ce).transpose(-1, -2) @ d.T          # (..., nf, K)
    return coeffs.mean(dim=-2)


# ═══ Unified FeatureExtractor ════════════════════════════════════════════════

class FeatureExtractor:
    """[AMS | RASTA-PLP | MFCC | GFCC] per-frame features and their context
    stacking, on the input's device."""

    def __init__(self, fs: Optional[int] = None,
                 fcfg: FeatureConfig = FeatureConfig(),
                 acfg: AudioConfig = AudioConfig()):
        self.fs = fs or acfg.sample_rate
        self.fcfg = fcfg
        self.acfg = acfg
        self.gfb = GammatoneFilterbank(sample_rate=self.fs)
        self.context = fcfg.context_frames

    @property
    def raw_feature_dim(self) -> int:
        return self.fcfg.raw_dim

    @property
    def feature_dim(self) -> int:
        return self.fcfg.dim

    def extract_frame_features(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., N) → (..., T, 54) concatenated features."""
        acfg, fcfg, fs = self.acfg, self.fcfg, self.fs
        frame, hop = acfg.frame_size, acfg.hop_size
        x = _pad_to_frame(signal.to(torch.float32), frame)
        lead, n = x.shape[:-1], x.shape[-1]
        t = num_frames(n, frame, hop)

        filtered = self.gfb.filter(x)                    # (..., C, N)

        # AMS: a window of 4 frames (640 samples) per frame; frames whose
        # window would be cut short are zero. With the default constants
        # every window gives zero (see the module docstring).
        win_len = frame * 4
        ams = x.new_zeros(lead + (t, fcfg.ams_num_bands))
        full = num_frames(n, win_len, hop)
        if full > 0 and win_len // fcfg.ams_decimate >= fcfg.ams_segments:
            segs = frame_signal(x, win_len, hop)[..., :full, :]
            ams[..., :full, :] = extract_ams(segs, fs, fcfg=fcfg)

        # RASTA-PLP: one vector for the whole utterance, repeated
        plp = extract_rasta_plp(x, fs, fcfg=fcfg, acfg=acfg)
        rasta = plp[..., None, :].expand(lead + (t, plp.shape[-1]))

        mfcc = _mfcc_frames(x, fs, fcfg, acfg, fcfg.mfcc_num_coeff)[..., :t, :]

        # GFCC per frame: a 10 ms window centred on the frame's centre, its
        # mean energy as a difference of the running sum of channel energy
        dec_hop = fs // fcfg.gfcc_decimate_rate
        centers = np.arange(t) * hop + frame // 2
        ch_start = np.maximum(0, centers - dec_hop // 2)
        ch_end = np.minimum(n, centers + dec_hop // 2)
        energy2 = filtered.abs() ** 2
        csum = torch.nn.functional.pad(torch.cumsum(energy2, dim=-1), (1, 0))
        dev = x.device
        seg_sum = (csum[..., torch.from_numpy(ch_end).to(dev)]
                   - csum[..., torch.from_numpy(ch_start).to(dev)])
        seg_len = torch.from_numpy(
            np.maximum(ch_end - ch_start, 1).astype(np.float32)).to(dev)
        ce = (seg_sum / seg_len).transpose(-1, -2)       # (..., T, C)
        valid = torch.from_numpy(ch_end > ch_start).to(dev)[:, None]
        d = _const(dct_matrix, self.gfb.num_channels, fcfg.gfcc_num_coeff,
                   device=dev)
        gfcc = torch.where(valid, _cube_root(ce) @ d.T,
                           torch.zeros((), device=dev))

        return torch.cat([ams, rasta, mfcc, gfcc], dim=-1)

    def add_context(self, features: torch.Tensor) -> torch.Tensor:
        """(..., T, D) → (..., T, D * (2 ctx + 1)): each frame with its ctx
        neighbours on both sides, the edges repeated."""
        ctx = self.context
        t, d = features.shape[-2:]
        first = features[..., :1, :].expand(features.shape[:-2] + (ctx, d))
        last = features[..., -1:, :].expand(features.shape[:-2] + (ctx, d))
        padded = torch.cat([first, features, last], dim=-2)
        windows = padded.unfold(-2, 2 * ctx + 1, 1)      # (..., T, D, 2ctx+1)
        return windows.transpose(-1, -2).reshape(features.shape[:-2]
                                                 + (t, -1))
