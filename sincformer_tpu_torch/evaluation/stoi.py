"""Short-Time Objective Intelligibility
(``sincformer_tpu/evaluation/stoi.py``).

  * :func:`stoi_torch` - the per-frame spectral-correlation STOI (the
    reference's fallback without pystoi), batched over leading axes on the
    device. It is what :func:`compute_stoi` runs by default: pystoi is not
    installed.
  * :func:`stoi_full` - Taal et al. (2011) STOI (10 kHz analysis, silent
    frames removed, 15 one-third octave bands, 384 ms segments, -15 dB
    clipping) on the host in numpy and scipy, the JAX package's code.
  * :func:`stoi_full_torch` - the same algorithm with fixed shapes on the
    device: the silent frames compacted by a stable argsort, overlap-added
    and framed again, segments masked by validity; 10 kHz by the FFT-domain
    resampler.
  * :func:`compute_stoi` - the dispatcher: pystoi when installed, else the
    simplified STOI.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.utils.signal import (frame_signal, overlap_add,
                                               resample_poly_fft)


# ─── Simplified STOI (the reference's fallback) ──────────────────────────────

def stoi_torch(clean: torch.Tensor, enhanced: torch.Tensor,
               fs: int = 8000) -> torch.Tensor:
    """Simplified STOI in [0, 1] of equal-length (..., N) waveforms: each
    signal normalised to unit RMS, 25.6 ms symmetric-Hann frames at 50 %
    overlap, per frame the correlation of the clean magnitude spectrum with
    the enhanced one rescaled to the clean frame's energy, clipped to
    [-1, 1], averaged over frames."""
    frame_len = int(0.0256 * fs)
    hop = frame_len // 2
    clean = clean / (torch.sqrt(torch.mean(clean ** 2, -1, keepdim=True))
                     + 1e-10)
    enhanced = enhanced / (torch.sqrt(torch.mean(enhanced ** 2, -1,
                                                 keepdim=True)) + 1e-10)
    win = torch.from_numpy(np.hanning(frame_len).astype(np.float32)).to(
        clean.device)
    cs = torch.abs(torch.fft.rfft(frame_signal(clean, frame_len, hop) * win,
                                  dim=-1))
    es = torch.abs(torch.fft.rfft(frame_signal(enhanced, frame_len, hop)
                                  * win, dim=-1))
    clean_energy = torch.sqrt(torch.sum(cs ** 2, -1, keepdim=True) + 1e-10)
    en = es / (torch.sqrt(torch.sum(es ** 2, -1, keepdim=True)) + 1e-10)
    en = en * clean_energy
    num = torch.sum(cs * en, -1)
    den = torch.sqrt(torch.sum(cs ** 2, -1) * torch.sum(en ** 2, -1)) + 1e-10
    corr = torch.clamp(num / den, -1.0, 1.0)
    return torch.clamp(torch.mean(corr, -1), 0.0, 1.0)


# ─── Full STOI (Taal 2011 / pystoi algorithm) ────────────────────────────────

_FS_STOI = 10000
_N_FRAME = 256
_NFFT = 512
_NUMBAND = 15
_MINFREQ = 150.0
_N_SEG = 30
_BETA = -15.0
_DYN_RANGE = 40.0


@functools.lru_cache(maxsize=2)
def _third_octave_bands():
    """One-third octave band matrix (NUMBAND, NFFT//2+1), pystoi-style."""
    f = np.linspace(0, _FS_STOI, _NFFT + 1)[: _NFFT // 2 + 1]
    k = np.arange(_NUMBAND)
    cf = 2.0 ** (k / 3.0) * _MINFREQ
    lo = 2.0 ** ((2 * k - 1) / 6.0) * _MINFREQ
    hi = 2.0 ** ((2 * k + 1) / 6.0) * _MINFREQ
    obm = np.zeros((_NUMBAND, len(f)))
    for i in range(_NUMBAND):
        f_bin_lo = np.argmin((f - lo[i]) ** 2)
        f_bin_hi = np.argmin((f - hi[i]) ** 2)
        obm[i, f_bin_lo:f_bin_hi] = 1.0
    return obm, cf


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    """Drop frames whose clean energy is >dyn_range below the max frame."""
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    starts = np.arange(n) * hop
    xf = np.stack([x[s:s + framelen] for s in starts]) * w
    yf = np.stack([y[s:s + framelen] for s in starts]) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-16)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # re-overlap-add the retained frames
    out_len = (len(xf) - 1) * hop + framelen if len(xf) else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(len(xf)):
        s = i * hop
        xs[s:s + framelen] += xf[i]
        ys[s:s + framelen] += yf[i]
    return xs, ys


def stoi_full(clean, enhanced, fs: int = 8000, extended: bool = False) -> float:
    """Faithful Taal et al. 2011 STOI (the pystoi algorithm), host-side.

    Use for gold intelligibility numbers; matches pystoi to float precision
    on common signals. Not jittable (silent-frame removal is data-dependent).
    """
    from scipy.signal import resample_poly

    x = np.asarray(clean, np.float64)
    y = np.asarray(enhanced, np.float64)
    m = min(len(x), len(y))
    x, y = x[:m], y[:m]
    if fs != _FS_STOI:
        g = np.gcd(int(fs), _FS_STOI)
        x = resample_poly(x, _FS_STOI // g, fs // g)
        y = resample_poly(y, _FS_STOI // g, fs // g)
    hop = _N_FRAME // 2
    if len(x) < _N_FRAME:
        return 0.0
    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _N_FRAME, hop)
    if len(x) < _N_FRAME:
        return 0.0

    w = np.hanning(_N_FRAME + 2)[1:-1]
    n = (len(x) - _N_FRAME) // hop + 1
    starts = np.arange(n) * hop
    xf = np.stack([x[s:s + _N_FRAME] for s in starts]) * w
    yf = np.stack([y[s:s + _N_FRAME] for s in starts]) * w
    xs = np.abs(np.fft.rfft(xf, n=_NFFT, axis=1))
    ys = np.abs(np.fft.rfft(yf, n=_NFFT, axis=1))

    obm, _ = _third_octave_bands()
    xb = np.sqrt(obm @ (xs ** 2).T)     # (bands, frames)
    yb = np.sqrt(obm @ (ys ** 2).T)
    if xb.shape[1] < _N_SEG:
        return 0.0

    if extended:
        # extended STOI (Jensen & Taal 2016): row/column normalised
        # segments, no clipping; d_m = (1/N) Σ_n x̃_nᵀỹ_n over the N=30
        # doubly-normalised frame columns. Dividing by N (not the band
        # count) is what makes ESTOI(x, x) = 1 — the analytic self-score
        # anchor that the independent witness cross-check enforces
        # (tests/test_stoi_cross.py; both transcriptions originally
        # carried the same 1/J slip, worth remembering).
        scores = []
        for m0 in range(_N_SEG, xb.shape[1] + 1):
            xseg = xb[:, m0 - _N_SEG:m0]
            yseg = yb[:, m0 - _N_SEG:m0]
            xn = (xseg - xseg.mean(1, keepdims=True))
            xn /= (np.linalg.norm(xn, axis=1, keepdims=True) + 1e-16)
            yn = (yseg - yseg.mean(1, keepdims=True))
            yn /= (np.linalg.norm(yn, axis=1, keepdims=True) + 1e-16)
            xn = (xn - xn.mean(0, keepdims=True))
            xn /= (np.linalg.norm(xn, axis=0, keepdims=True) + 1e-16)
            yn = (yn - yn.mean(0, keepdims=True))
            yn /= (np.linalg.norm(yn, axis=0, keepdims=True) + 1e-16)
            scores.append(np.sum(xn * yn) / _N_SEG)
        return float(np.mean(scores))

    c = 10 ** (-_BETA / 20.0)
    d = []
    for m0 in range(_N_SEG, xb.shape[1] + 1):
        xseg = xb[:, m0 - _N_SEG:m0]
        yseg = yb[:, m0 - _N_SEG:m0]
        alpha = np.sqrt(np.sum(xseg ** 2, axis=1, keepdims=True)
                        / (np.sum(yseg ** 2, axis=1, keepdims=True) + 1e-16))
        ay = yseg * alpha
        yprime = np.minimum(ay, xseg * (1 + c))
        xm = xseg - xseg.mean(1, keepdims=True)
        ym = yprime - yprime.mean(1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-16)
        d.append(np.mean(corr))
    return float(np.mean(d))


def stoi_full_torch(clean, enhanced, fs: int = 8000,
                    device="cuda") -> torch.Tensor:
    """Full Taal-2011 STOI of two equal-length (N,) signals with fixed
    shapes on ``device``: :func:`stoi_full`'s algorithm but for the
    resampler to 10 kHz (FFT-domain here, polyphase on the host). Silent
    frames are moved behind the kept ones by a stable argsort and zeroed,
    the kept frames overlap-added and framed again, and the 30-frame
    segments that reach past the kept frames are masked out."""
    x, y = f32_on(clean, device), f32_on(enhanced, device)
    if fs != _FS_STOI:
        x = resample_poly_fft(x, fs, _FS_STOI)
        y = resample_poly_fft(y, fs, _FS_STOI)
    hop = _N_FRAME // 2
    w = torch.from_numpy(np.hanning(_N_FRAME + 2)[1:-1].astype(
        np.float32)).to(x.device)
    xf = frame_signal(x, _N_FRAME, hop) * w            # (T, L)
    yf = frame_signal(y, _N_FRAME, hop) * w
    t = xf.shape[0]

    energies = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=1)
                                  + 1e-16)
    valid = energies > (torch.max(energies) - _DYN_RANGE)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    keep = valid[order][:, None].to(xf.dtype)
    xf = xf[order] * keep
    yf = yf[order] * keep
    n_valid = torch.sum(valid)

    total = (t - 1) * hop + _N_FRAME
    xf = frame_signal(overlap_add(xf, hop, total), _N_FRAME, hop) * w
    yf = frame_signal(overlap_add(yf, hop, total), _N_FRAME, hop) * w

    xs = torch.abs(torch.fft.rfft(xf, n=_NFFT, dim=1))
    ys = torch.abs(torch.fft.rfft(yf, n=_NFFT, dim=1))
    obm = torch.from_numpy(_third_octave_bands()[0].astype(np.float32)).to(
        x.device)
    xb = torch.sqrt(torch.einsum("bf,tf->bt", obm, xs ** 2))   # (bands, T)
    yb = torch.sqrt(torch.einsum("bf,tf->bt", obm, ys ** 2))

    n_seg = t - _N_SEG + 1
    if n_seg < 1:
        return torch.zeros((), device=x.device)
    seg_idx = torch.from_numpy(np.arange(n_seg)[:, None]
                               + np.arange(_N_SEG)[None, :]).to(x.device)
    xseg = xb[:, seg_idx]                                  # (bands, M, 30)
    yseg = yb[:, seg_idx]
    seg_valid = (torch.arange(n_seg, device=x.device) + _N_SEG) <= n_valid

    c = 10.0 ** (-_BETA / 20.0)
    alpha = torch.sqrt(torch.sum(xseg ** 2, -1, keepdim=True)
                       / (torch.sum(yseg ** 2, -1, keepdim=True) + 1e-16))
    yprime = torch.minimum(yseg * alpha, xseg * (1 + c))
    xm = xseg - torch.mean(xseg, -1, keepdim=True)
    ym = yprime - torch.mean(yprime, -1, keepdim=True)
    corr = (torch.sum(xm * ym, -1)
            / (torch.linalg.vector_norm(xm, dim=-1)
               * torch.linalg.vector_norm(ym, dim=-1) + 1e-16))
    per_seg = torch.mean(corr, dim=0)                      # (M,)
    denom = torch.clamp(torch.sum(seg_valid), min=1)
    return torch.sum(torch.where(seg_valid, per_seg,
                                 torch.zeros_like(per_seg))) / denom


# ─── Dispatcher ──────────────────────────────────────────────────────────────

def compute_stoi(clean_signal, enhanced_signal, fs: Optional[int] = None,
                 extended: bool = False, method: str = "auto",
                 device="cuda") -> float:
    """STOI of two host signals (cut to the shorter). ``method``: "auto"
    (pystoi when installed, else the simplified STOI), "full" (the host
    Taal-2011 STOI) or "simplified" (on ``device``); 0.0 for a signal
    shorter than one frame."""
    fs = fs or AudioConfig().sample_rate
    m = min(len(clean_signal), len(enhanced_signal))
    clean = np.asarray(clean_signal[:m], np.float64)
    enhanced = np.asarray(enhanced_signal[:m], np.float64)
    if method == "auto":
        try:
            from pystoi import stoi as _pystoi
            return float(_pystoi(clean, enhanced, fs, extended=extended))
        except ImportError:
            method = "simplified"
    if method == "full":
        return stoi_full(clean, enhanced, fs, extended=extended)
    if m < int(0.0256 * fs):
        return 0.0
    return float(stoi_torch(f32_on(clean, device), f32_on(enhanced, device),
                            fs))
