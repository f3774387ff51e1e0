"""ITU-T P.862 (PESQ) narrowband implementation — full algorithm structure.

A copy of ``sincformer_tpu/evaluation/p862.py`` (numpy and scipy on the
host), line for line, so that both packages score PESQ with the same code.

The reference repo obtains true PESQ from the ITU C library and falls back
to a log-spectral-distortion proxy when it is absent
(the reference's ``evaluation/pesq_eval.py:19-85``). This module closes the
gap between those two extremes: a complete host-side implementation of the
P.862 narrowband *algorithm* (every stage of §10 of the standard):

  1. level alignment of both signals to 1e7 target power in the
     350–3250 Hz band,
  2. the standard IRS receive filter (FFT-domain piecewise-dB response)
     plus a DC block and an input IIR biquad cascade (100 Hz HP ×
     3.6 kHz LP, the P.862 input-characteristic structure),
  3. VAD envelope extraction, crude alignment by log-VAD cross-correlation,
     utterance segmentation, and per-utterance fine time alignment via a
     confidence-weighted histogram of per-frame delays,
  4. the psychoacoustic model: 32 ms Hann frames → Bark-band pitch powers
     → per-band frequency compensation → per-frame gain compensation →
     Zwicker loudness transform → masked (deadzone) disturbance and
     asymmetric disturbance,
  5. aggregation: ½-overlapped 20-frame "syllable" L6 norms, L2 over time,
     per-frame audible-power weighting, and the P.862 MOS map
     ``4.5 − 0.1·d_sym − 0.0309·d_asym``.

Documented deviations from the ITU reference implementation:

  * The 42 Bark band tables (centres, widths, bin mapping, absolute
    hearing threshold) are CONSTRUCTED from published psychoacoustic
    formulas — a 7·asinh(f/650) Bark warp with uniform band widths and the
    Terhardt absolute-threshold curve — because the ITU numeric tables are
    not available in this environment for transcription. The algorithm
    structure, filter characteristics, Zwicker exponent schedule, masking,
    asymmetry and aggregation constants match the standard, so scores
    track P.862 closely but are not bit-identical.
    ``tests/test_p862.py`` contains an oracle test that compares against
    the ITU C library automatically whenever ``pesq`` is installed.
  * ``split_align`` (mid-utterance delay jumps, for time-VARYING delay
    such as VoIP jitter) is not implemented: enhancement chains evaluated
    here are time-invariant, so one constant delay per utterance suffices.
    Bad-frame re-alignment in the cognitive model is omitted for the same
    reason.

Perfectly-identical inputs score exactly 4.5 (zero disturbance), matching
P.862's ceiling.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FS = 8000
DOWNSAMPLE = 32                      # VAD / alignment block size
SEARCHBUFFER = 75                    # padding, in DOWNSAMPLE units
DATAPADDING = int(320 * FS / 1000)   # 320 ms zero padding at the end
ALIGN_NFFT = 512                     # fine-alignment frame
NF = 256                             # 32 ms perceptual frame
NB = 42                              # Bark bands (narrowband)
SP = 6.910853e-6                     # power scaling factor (P.862 NB)
SL = 1.866055e-1                     # loudness scaling factor (P.862 NB)
TARGET_POWER = 1e7
ZWICKER_POWER = 0.23
MIN_UTTERANCE = 50                   # VAD units (50·4 ms = 200 ms speech)
JOIN_GAP = 50                        # VAD units of silence joined over

# Standard IRS receive characteristic, (Hz, dB) breakpoints — the published
# mask applied by P.862 to both signals in narrowband mode.
_IRS_DB = np.array([
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12),
    (700, 12), (800, 12), (1000, 12), (1300, 12), (1600, 12), (2000, 12),
    (2500, 12), (3000, 12), (3250, 12), (3500, 4), (4000, -200),
], np.float64)

# Flat 350–3250 Hz band-pass used only to measure power for level alignment.
_LEVEL_BP_DB = np.array([
    (0, -500), (300, -500), (350, 0), (3250, 0), (3500, -500),
    (4000, -500),
], np.float64)


# ─── Bark band construction (documented deviation — see module docstring) ──

def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _bark_inv(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


def _terhardt_db(f):
    """Terhardt (1979) absolute threshold of hearing, dB SPL."""
    f = np.maximum(np.asarray(f, np.float64), 1.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


def _make_bands():
    z_edges = np.linspace(0.0, float(_bark(FS / 2)), NB + 1)
    centre_bark = 0.5 * (z_edges[:-1] + z_edges[1:])
    width_bark = np.diff(z_edges)
    edges_hz = _bark_inv(z_edges)
    centre_hz = _bark_inv(centre_bark)

    n_bins = NF // 2 + 1
    freqs = np.arange(n_bins) * (FS / NF)
    band_of_bin = np.clip(np.searchsorted(edges_hz, freqs,
                                          side="right") - 1, 0, NB - 1)
    bins_per_band = np.bincount(band_of_bin, minlength=NB).astype(np.float64)
    # density correction: a band whose Hz width is under-sampled by the FFT
    # grid gets compensated so equal power densities give equal band powers
    width_hz = np.diff(edges_hz)
    correction = width_hz / (np.maximum(bins_per_band, 1.0) * (FS / NF))

    # absolute threshold in internal power units, anchored so the 1 kHz
    # threshold sits at 100 (the order of magnitude of the ITU mid-band
    # table entries)
    thr_db = _terhardt_db(centre_hz)
    abs_thresh = 10.0 ** (thr_db / 10.0) * (100.0
                                            / 10.0 ** (_terhardt_db(1000.0)
                                                       / 10.0))
    return (centre_bark, width_bark, centre_hz, band_of_bin, correction,
            abs_thresh)


(_CENTRE_BARK, _WIDTH_BARK, _CENTRE_HZ, _BAND_OF_BIN, _CORRECTION,
 _ABS_THRESH) = _make_bands()


# ─── Stage 1-2: level alignment and input filtering ────────────────────────

def _apply_piecewise_filter(x: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Filter by a piecewise-linear (Hz, dB) magnitude response, applied in
    the FFT domain over the whole signal (pesqdsp.c apply_filter)."""
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.arange(len(spec)) * (FS / n)
    gain_db = np.interp(freqs, table[:, 0], table[:, 1])
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), n)


def _band_power(x: np.ndarray) -> float:
    y = _apply_piecewise_filter(x, _LEVEL_BP_DB)
    pad = SEARCHBUFFER * DOWNSAMPLE
    active = y[pad:len(y) - pad] if len(y) > 2 * pad else y
    return float(np.mean(active ** 2)) + 1e-20


def _fix_power_level(x: np.ndarray) -> np.ndarray:
    return x * np.sqrt(TARGET_POWER / _band_power(x))


def _dc_block(x: np.ndarray) -> np.ndarray:
    y = x - np.mean(x)
    ramp = min(DOWNSAMPLE, len(y) // 2)
    if ramp > 0:
        w = np.linspace(0.0, 1.0, ramp, endpoint=False)
        y = y.copy()
        y[:ramp] *= w
        y[-ramp:] *= w[::-1]
    return y


_INPUT_SOS = None


def _input_sos():
    """Biquad cascade matching the ITU input filter's STRUCTURE (a chain of
    second-order sections band-limiting to the narrowband telephone range):
    a 4th-order 100 Hz high-pass plus a 2nd-order 3.6 kHz low-pass, applied
    as one sos cascade. The ITU numeric coefficients (pesq dsp.c
    InIIR_Hsos) are not available offline; the band edges and roll-off
    orders here follow the P.862 §10.1 input characteristic. Documented
    deviation — see module docstring."""
    global _INPUT_SOS
    if _INPUT_SOS is None:
        from scipy.signal import butter
        hp = butter(4, 100.0 / (FS / 2), "high", output="sos")
        lp = butter(2, 3600.0 / (FS / 2), "low", output="sos")
        _INPUT_SOS = np.concatenate([hp, lp], axis=0)
    return _INPUT_SOS


def _input_filter(x: np.ndarray) -> np.ndarray:
    """DC block + ITU-structure IIR cascade (both signals receive the
    identical filter)."""
    from scipy.signal import sosfilt
    y = _dc_block(x)
    return sosfilt(_input_sos(), y)


# ─── Stage 3: VAD and time alignment ───────────────────────────────────────

def _apply_vad(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-32-sample block VAD with iteratively refined noise floor
    (pesqdsp.c apply_VAD). Returns (vad, log_vad)."""
    n_blocks = len(x) // DOWNSAMPLE
    blocks = x[:n_blocks * DOWNSAMPLE].reshape(n_blocks, DOWNSAMPLE)
    vad = np.mean(blocks ** 2, axis=1)
    level_min = np.max(vad) * 1e-4
    if level_min <= 0:
        return np.zeros(n_blocks), np.zeros(n_blocks)
    vad = np.maximum(vad, level_min)
    thresh = np.mean(vad)
    for _ in range(12):
        noise = vad[vad <= thresh]
        if len(noise) == 0:
            break
        mu, sd = np.mean(noise), np.std(noise)
        new_thresh = mu + 2.0 * sd
        if abs(new_thresh - thresh) < 1e-12:
            break
        thresh = new_thresh
    noise_level = max(float(np.mean(vad[vad <= thresh]))
                      if np.any(vad <= thresh) else level_min, 1e-20)
    vad_norm = vad / noise_level
    log_vad = np.where(vad_norm > 1.0, np.log(vad_norm), 0.0)
    return vad_norm, log_vad


def _crude_align(log_vad_ref: np.ndarray, log_vad_deg: np.ndarray) -> int:
    """Whole-signal delay estimate (in samples) from log-VAD
    cross-correlation (pesqdsp.c crude_align)."""
    n = max(len(log_vad_ref), len(log_vad_deg))
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    r = np.fft.rfft(log_vad_ref, nfft)
    d = np.fft.rfft(log_vad_deg, nfft)
    corr = np.fft.irfft(np.conj(r) * d, nfft)
    lags = np.concatenate([np.arange(0, n), np.arange(-n, 0)])
    vals = np.concatenate([corr[:n], corr[nfft - n:]])
    return int(lags[np.argmax(vals)]) * DOWNSAMPLE


def _find_utterances(vad: np.ndarray) -> List[Tuple[int, int]]:
    """Speech sections in VAD units: ≥MIN_UTTERANCE long, gaps shorter than
    JOIN_GAP joined (pesqdsp.c id_searchwindows/id_utterances)."""
    speech = vad > 1.0
    sections: List[Tuple[int, int]] = []
    start = None
    for i, s in enumerate(speech):
        if s and start is None:
            start = i
        elif not s and start is not None:
            sections.append((start, i))
            start = None
    if start is not None:
        sections.append((start, len(speech)))
    # join across short gaps
    joined: List[Tuple[int, int]] = []
    for sec in sections:
        if joined and sec[0] - joined[-1][1] < JOIN_GAP:
            joined[-1] = (joined[-1][0], sec[1])
        else:
            joined.append(sec)
    # ≥ MIN_UTTERANCE (50 units = 200 ms), per the constant's definition:
    # a shorter blip carries no alignment evidence and must not get its
    # own fine-alignment delay (was MIN_UTTERANCE//10)
    out = [s for s in joined if s[1] - s[0] >= MIN_UTTERANCE]
    return out or ([(0, len(speech))] if len(speech) else [])


def _fine_align(ref: np.ndarray, deg: np.ndarray, start: int, stop: int,
                crude_delay: int) -> int:
    """Per-utterance delay: confidence-weighted histogram of per-frame
    cross-correlation peaks (pesqdsp.c time_align). Sample units."""
    hop = ALIGN_NFFT // 4
    max_lag = ALIGN_NFFT // 2
    hist = np.zeros(2 * max_lag + 1)
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(ALIGN_NFFT)
                               / ALIGN_NFFT))
    for fstart in range(start, stop - ALIGN_NFFT, hop):
        r = ref[fstart:fstart + ALIGN_NFFT] * window
        dstart = fstart + crude_delay
        if dstart < 0 or dstart + ALIGN_NFFT > len(deg):
            continue
        d = deg[dstart:dstart + ALIGN_NFFT] * window
        # cross-correlate via FFT; compress peaks (ITU uses |.|^0.125)
        nfft = 2 * ALIGN_NFFT
        corr = np.fft.irfft(np.conj(np.fft.rfft(r, nfft))
                            * np.fft.rfft(d, nfft), nfft)
        lags = np.concatenate([np.arange(0, max_lag + 1),
                               np.arange(-max_lag, 0)])
        vals = np.abs(np.concatenate([corr[:max_lag + 1],
                                      corr[nfft - max_lag:]]))
        if np.max(vals) <= 0:
            continue
        v = vals ** 0.125
        hist[lags + max_lag] += v * (v >= 0.99 * np.max(v))
    if np.max(hist) <= 0:
        return crude_delay
    # triangular smoothing (~1 ms wide) before the argmax
    kern = np.array([0.25, 0.5, 1.0, 0.5, 0.25])
    smooth = np.convolve(hist, kern, mode="same")
    return crude_delay + int(np.argmax(smooth)) - max_lag


# ─── Stage 4: psychoacoustic model ─────────────────────────────────────────

def _frame_pitch_powers(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Hann-windowed 32 ms frames at given sample offsets → (F, NB) Bark
    band powers (pesqmod.c short_term_fft + freq_warping)."""
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(NF) / NF))
    frames = np.stack([x[s:s + NF] for s in starts])
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    out = np.zeros((len(starts), NB))
    np.add.at(out.T, _BAND_OF_BIN, spec.T)
    return out * _CORRECTION * SP


def _total_audible(pp: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """Per-frame power summed over bands above factor·threshold
    (pesqmod.c total_audible)."""
    audible = np.where(pp > _ABS_THRESH * factor, pp, 0.0)
    return np.sum(audible[:, 1:], axis=1)


def _loudness(pp: np.ndarray) -> np.ndarray:
    """Zwicker intensity→loudness warping with the P.862 low-band exponent
    schedule (pesqmod.c intensity_warping_of)."""
    h = np.where(_CENTRE_BARK < 4.0, 6.0 / (_CENTRE_BARK + 2.0), 1.0)
    h = np.minimum(h, 2.0) ** 0.15
    gamma = ZWICKER_POWER * h
    thr = _ABS_THRESH
    loud = ((thr / 0.5) ** gamma
            * ((0.5 + 0.5 * pp / thr) ** gamma - 1.0)) * SL
    return np.where(pp > thr, loud, 0.0)


def _pseudo_lp(d: np.ndarray, p: float) -> np.ndarray:
    """Width-weighted Lp over bands, per frame (pesqmod.c pseudo_Lp)."""
    w = _WIDTH_BARK[None, 1:]
    total_w = np.sum(_WIDTH_BARK[1:])
    r = np.sum((np.abs(d[:, 1:]) * w) ** p, axis=1) / total_w
    return r ** (1.0 / p) * total_w


def pesq_p862(ref_sig: np.ndarray, deg_sig: np.ndarray,
              fs: int = FS) -> float:
    """P.862 narrowband PESQ MOS (raw, in [-0.5, 4.5])."""
    ref = np.asarray(ref_sig, np.float64)
    deg = np.asarray(deg_sig, np.float64)
    if fs != FS:
        raise ValueError(f"p862 narrowband requires fs={FS}, got {fs}")
    m = min(len(ref), len(deg))
    ref, deg = ref[:m], deg[:m]
    if m < NF * 2:
        return 1.0

    pad = SEARCHBUFFER * DOWNSAMPLE
    ref = np.concatenate([np.zeros(pad), ref, np.zeros(pad + DATAPADDING)])
    deg = np.concatenate([np.zeros(pad), deg, np.zeros(pad + DATAPADDING)])

    # level align + filters (both signals, identically)
    ref = _fix_power_level(ref)
    deg = _fix_power_level(deg)
    ref = _apply_piecewise_filter(ref, _IRS_DB)
    deg = _apply_piecewise_filter(deg, _IRS_DB)
    ref = _input_filter(ref)
    deg = _input_filter(deg)

    # VAD + alignment
    vad_ref, log_vad_ref = _apply_vad(ref)
    _vad_deg, log_vad_deg = _apply_vad(deg)
    crude = _crude_align(log_vad_ref, log_vad_deg)
    utterances = _find_utterances(vad_ref)
    # per-frame delay map (samples), constant within an utterance
    hop = NF // 2
    n_frames = (len(ref) - NF) // hop + 1
    delay = np.full(n_frames, crude, np.int64)
    for (u0, u1) in utterances:
        s0, s1 = u0 * DOWNSAMPLE, u1 * DOWNSAMPLE
        d = _fine_align(ref, deg, s0, min(s1, len(ref)), crude)
        f0 = max(0, s0 // hop)
        f1 = min(n_frames, max(f0 + 1, s1 // hop))
        delay[f0:f1] = d

    starts_ref = np.arange(n_frames) * hop
    starts_deg = np.clip(starts_ref + delay, 0, len(deg) - NF)
    pp_ref = _frame_pitch_powers(ref, starts_ref)
    pp_deg = _frame_pitch_powers(deg, starts_deg)

    # per-band frequency compensation over speech-active frames
    active = _total_audible(pp_ref) > 1e7
    if not np.any(active):
        active = np.ones(n_frames, bool)
    avg_ref = np.mean(pp_ref[active], axis=0)
    avg_deg = np.mean(pp_deg[active], axis=0)
    band_gain = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    pp_ref_comp = pp_ref * band_gain[None, :]

    # per-frame gain compensation, first-order smoothed
    num = _total_audible(pp_ref_comp) + 5e3
    den = _total_audible(pp_deg) + 5e3
    ratio = num / den
    h = np.empty(n_frames)
    prev = ratio[0] if n_frames else 1.0
    for i in range(n_frames):
        prev = 0.2 * prev + 0.8 * ratio[i]
        h[i] = prev
    h = np.clip(h, 3e-4, 5.0)
    pp_deg_comp = pp_deg * h[:, None]

    loud_ref = _loudness(pp_ref_comp)
    loud_deg = _loudness(pp_deg_comp)

    # masked (deadzone) disturbance
    d = loud_deg - loud_ref
    m_mask = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m_mask, 0.0)

    # asymmetric disturbance
    r = ((pp_deg_comp + 50.0) / (pp_ref_comp + 50.0)) ** 1.2
    r = np.where(r < 3.0, 0.0, np.minimum(r, 12.0))
    d_asym = d * r

    frame_d = _pseudo_lp(d, 2.0)
    frame_da = _pseudo_lp(d_asym, 1.0)

    # per-frame audible-power weighting + cap
    w = ((_total_audible(pp_ref_comp) + 1e5) / 1e7) ** 0.04
    frame_d = np.minimum(frame_d / w, 45.0)
    frame_da = np.minimum(frame_da / w, 45.0)

    def _lpq(fd: np.ndarray, p_syl: float = 6.0, p_time: float = 2.0,
             syl: int = 20) -> float:
        if len(fd) == 0:
            return 0.0
        acc, n = 0.0, 0
        for s in range(0, len(fd), syl // 2):
            chunk = fd[s:s + syl]
            acc += np.mean(chunk ** p_syl) ** (p_time / p_syl)
            n += 1
        return float((acc / n) ** (1.0 / p_time))

    d_ind = _lpq(frame_d)
    a_ind = _lpq(frame_da)
    return float(np.clip(4.5 - 0.1 * d_ind - 0.0309 * a_ind, -0.5, 4.5))


# ─── P.862.1 MOS-LQO mapping ──────────────────────────────────────────────────

# Published constants of the ITU-T P.862.1 (2003) output mapping, Eq. 1:
# a monotone logistic from raw P.862 score x to listening-quality MOS.
_LQO_FLOOR = 0.999
_LQO_CEIL = 4.999
_LQO_SLOPE = -1.4945
_LQO_OFFSET = 4.6607


def mos_lqo(raw_pesq: float) -> float:
    """ITU-T P.862.1 mapping: raw P.862 score → MOS-LQO.

    y = 0.999 + (4.999 − 0.999) / (1 + e^(−1.4945·x + 4.6607))

    The mapping's published anchors are analytic: y(−∞) = 0.999,
    y(+∞) = 4.999, and the inflection at x = 4.6607/1.4945 ≈ 3.1186 maps
    to the midpoint 2.999 (tests/test_p862.py pins these, so a constant
    transcription error cannot survive). The ecosystem ``pesq`` library
    applies this same mapping for its MOS-LQO outputs
    (reference evaluation/pesq_eval.py:40-42 consumes raw 'nb' scores)."""
    x = float(raw_pesq)
    return _LQO_FLOOR + (_LQO_CEIL - _LQO_FLOOR) / (
        1.0 + np.exp(_LQO_SLOPE * x + _LQO_OFFSET))


def mos_lqo_inverse(lqo: float) -> float:
    """Inverse of :func:`mos_lqo` (P.862.1 Eq. 2 direction), for mapping
    published MOS-LQO conformance figures back to raw-score space."""
    y = float(lqo)
    y = min(max(y, _LQO_FLOOR + 1e-12), _LQO_CEIL - 1e-12)
    return (np.log((_LQO_CEIL - _LQO_FLOOR) / (y - _LQO_FLOOR) - 1.0)
            - _LQO_OFFSET) / _LQO_SLOPE


def mnru(signal: np.ndarray, q_db: float, seed: int = 0) -> np.ndarray:
    """ITU-T P.810 narrowband MNRU (Modulated Noise Reference Unit):
    speech-correlated noise at ratio ``q_db``,

        y(n) = x(n) · (1 + 10^(−Q/20) · N(n)),   N ~ N(0, 1).

    The MNRU is the standard's own calibration apparatus: P.862's
    subjective validation anchors quality on MNRU conditions spanning
    roughly Q = 5…45 dB, so a conformant implementation must be strictly
    monotone in Q with a wide dynamic range over that span and approach
    the identical-signal ceiling as Q → ∞. Those derivable behaviors are
    pinned in tests/test_p862.py::TestMNRUConformance — standard-derived
    anchors, not self-frozen goldens (full absolute
    conformance still requires the ITU test vectors / C oracle, see
    docs/PESQ_CONFORMANCE.md)."""
    x = np.asarray(signal, np.float64)
    n = np.random.default_rng(seed).standard_normal(x.shape)
    return (x * (1.0 + 10.0 ** (-q_db / 20.0) * n)).astype(np.float64)
