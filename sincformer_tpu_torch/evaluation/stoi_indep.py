"""Independent STOI implementation, transcribed directly from the paper.

Source: C. H. Taal, R. C. Hendriks, R. Heusdens, J. Jensen, "An Algorithm
for Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
IEEE TASLP 19(7), 2011 — §II (algorithm definition) and the published
MATLAB reference semantics it specifies (hanning windows, bin-snapped
one-third-octave edges, sliding 30-frame segments).

Purpose: this file is a CONFORMANCE WITNESS for
``evaluation/stoi.py::stoi_full``. It is a copy of
``sincformer_tpu/evaluation/stoi_indep.py``, line for line. It was written from the paper, NOT from
stoi_full, and deliberately shares no code with it — plain NumPy, different
decomposition. tests/test_stoi_cross.py asserts the two implementations
agree to ~1e-10 on 10 kHz inputs (no resampling in the path): agreement of
two independent transcriptions is evidence that BOTH match the standard,
which self-frozen golden tables cannot provide (they only catch drift from
yesterday's output). The ecosystem oracle (pystoi, reference
evaluation/stoi.py:47-48) is environment-blocked here.

Deliberately unoptimised: clarity over speed (this never runs in the
training or serving path).
"""

from __future__ import annotations

import numpy as np

FS = 10000          # internal sample rate demanded by the algorithm
FRAME = 256         # analysis frame length (25.6 ms @ 10 kHz)
HOP = 128           # 50 % overlap
NFFT = 512          # zero-padded DFT size
NUM_BANDS = 15      # one-third-octave bands
MIN_CF = 150.0      # centre frequency of the lowest band (Hz)
SEG = 30            # frames per intermediate-intelligibility segment (384 ms)
BETA = -15.0        # lower signal-to-distortion bound (dB)
DYN_RANGE = 40.0    # silent-frame energy range (dB)


def _hanning(n: int) -> np.ndarray:
    """MATLAB ``hanning(n)``: symmetric, WITHOUT the zero endpoints —
    sin²(πk/(n+1)) for k = 1..n. (numpy.hanning includes the zeros.)"""
    k = np.arange(1, n + 1)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n + 1)))


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose CLEAN energy is > DYN_RANGE dB below the loudest
    frame, then overlap-add the survivors back into time signals
    (paper §II-A; 50 %-overlap hanning OLA reconstructs to ~unity gain)."""
    w = _hanning(FRAME)
    starts = np.arange(0, len(x) - FRAME + 1, HOP)
    if len(starts) == 0:
        return x, y
    frames_x = np.stack([x[s:s + FRAME] * w for s in starts])
    frames_y = np.stack([y[s:s + FRAME] * w for s in starts])
    energy = 20.0 * np.log10(np.linalg.norm(frames_x, axis=1)
                             / np.sqrt(FRAME) + np.finfo(np.float64).eps)
    keep = energy - np.max(energy) + DYN_RANGE > 0
    kept = np.flatnonzero(keep)
    if kept.size == 0:
        return x[:0], y[:0]
    out_len = (kept.size - 1) * HOP + FRAME
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for out_i, j in enumerate(kept):
        o = out_i * HOP
        xs[o:o + FRAME] += frames_x[j]
        ys[o:o + FRAME] += frames_y[j]
    return xs, ys


def _stdft(x: np.ndarray) -> np.ndarray:
    """Short-time DFT magnitudes: hanning(FRAME) windows, hop HOP, NFFT
    zero-padded bins. Returns (num_frames, NFFT//2 + 1) magnitudes."""
    w = _hanning(FRAME)
    starts = np.arange(0, len(x) - FRAME + 1, HOP)
    frames = np.stack([x[s:s + FRAME] * w for s in starts])
    return np.abs(np.fft.rfft(frames, NFFT, axis=1))


def _third_octave_matrix() -> np.ndarray:
    """(NUM_BANDS, NFFT//2+1) 0/1 band-membership matrix with the band
    edges SNAPPED to the nearest DFT bin frequency (paper's published
    analysis matrix): band j spans bins [nearest(fl_j), nearest(fr_j))."""
    f = np.linspace(0, FS, NFFT + 1)[:NFFT // 2 + 1]
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_CF * 2.0 ** (k / 3.0)
    fl = np.sqrt(cf * MIN_CF * 2.0 ** ((k - 1) / 3.0))
    fr = np.sqrt(cf * MIN_CF * 2.0 ** ((k + 1) / 3.0))
    a = np.zeros((NUM_BANDS, f.size))
    for j in range(NUM_BANDS):
        lo = int(np.argmin((f - fl[j]) ** 2))
        hi = int(np.argmin((f - fr[j]) ** 2))
        a[j, lo:hi] = 1.0
    return a


def stoi_independent(clean: np.ndarray, degraded: np.ndarray,
                     fs: int = FS, extended: bool = False) -> float:
    """STOI per Taal 2011 (``extended=True``: ESTOI per Jensen & Taal
    2016 — time- then band-normalized segment inner products, no
    clipping). ``fs`` must be 10 kHz — this witness deliberately has NO
    resampler so the cross-check isolates the core algorithm (the
    resampler is a separate conformance question)."""
    if fs != FS:
        raise ValueError(
            f"stoi_independent takes {FS} Hz input only (got {fs} Hz); "
            f"resample first — see module docstring")
    x = np.asarray(clean, np.float64)
    y = np.asarray(degraded, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]

    x, y = _remove_silent_frames(x, y)
    if len(x) < FRAME + (SEG - 1) * HOP:
        return float("nan")   # too little active speech for one segment

    band = _third_octave_matrix()
    # (J, M) one-third-octave band amplitudes: sqrt of band-summed powers
    xb = np.sqrt(band @ (_stdft(x).T ** 2))
    yb = np.sqrt(band @ (_stdft(y).T ** 2))
    m_frames = xb.shape[1]
    if m_frames < SEG:
        return float("nan")

    eps = np.finfo(np.float64).eps
    if extended:
        # ESTOI (Jensen & Taal 2016): for each 30-frame segment, remove
        # means and normalize over TIME (rows), then over BANDS (columns);
        # the intelligibility index is the mean elementwise inner product
        # scaled by 1/J. No SDR clipping in the extended measure.
        def _norm(a, axis):
            a = a - np.mean(a, axis=axis, keepdims=True)
            return a / (np.linalg.norm(a, axis=axis, keepdims=True) + eps)

        # 1/N (frame count), NOT 1/J: the doubly-normalised frame columns
        # are unit vectors, so ESTOI(x, x) = (1/N)·N = 1 exactly — the
        # self-score anchor (tests/test_stoi_cross.py).
        scores = []
        for m in range(SEG, m_frames + 1):
            xs = _norm(_norm(xb[:, m - SEG:m], 1), 0)
            ys = _norm(_norm(yb[:, m - SEG:m], 1), 0)
            scores.append(float(np.sum(xs * ys)) / SEG)
        return float(np.mean(scores))

    clip = 10.0 ** (-BETA / 20.0)
    d_sum = 0.0
    count = 0
    # sliding segments, hop ONE frame (paper: m = N .. M)
    for m in range(SEG, m_frames + 1):
        xs = xb[:, m - SEG:m]                      # (J, SEG)
        ys = yb[:, m - SEG:m]
        # per-band energy normalisation of the degraded segment (Eq. 2)
        alpha = np.sqrt(np.sum(xs ** 2, axis=1)
                        / (np.sum(ys ** 2, axis=1) + eps))[:, None]
        # clipped SDR bound (Eq. 3)
        yp = np.minimum(ys * alpha, xs * (1.0 + clip))
        # per-band correlation coefficient (Eq. 5)
        xn = xs - np.mean(xs, axis=1, keepdims=True)
        yn = yp - np.mean(yp, axis=1, keepdims=True)
        num = np.sum(xn * yn, axis=1)
        den = (np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1)
               + eps)
        d_sum += float(np.sum(num / den))
        count += NUM_BANDS
    return d_sum / count
