"""Seedable synthetic speech and noise (``sincformer_tpu/data/synthetic.py``,
numpy on the host): the same seed gives the same arrays bit for bit.

Used by ``train --synthetic N`` and by tests; no dataset is needed.
"""

from __future__ import annotations

import numpy as np

from sincformer_tpu_torch.config import AudioConfig


def synthetic_speech(duration: float = 2.0, fs: int | None = None
                     ) -> np.ndarray:
    """Formant-sum "speech": 5 sinusoids × √|sin 3 Hz| envelope, peak-normed
    (exactly the reference demo signal, main.py:51-63)."""
    fs = fs or AudioConfig().sample_rate
    t = np.linspace(0, duration, int(fs * duration), endpoint=False)
    clean = (0.5 * np.sin(2 * np.pi * 250 * t)
             + 0.3 * np.sin(2 * np.pi * 500 * t)
             + 0.2 * np.sin(2 * np.pi * 1000 * t)
             + 0.15 * np.sin(2 * np.pi * 2000 * t)
             + 0.1 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32)
    envelope = np.abs(np.sin(2 * np.pi * 3 * t)) ** 0.5
    clean = clean * envelope
    return (clean / np.max(np.abs(clean))).astype(np.float32)


def synthetic_speech_varied(duration: float = 2.0, fs: int | None = None,
                            seed: int = 0) -> np.ndarray:
    """A randomized speech-like utterance drawn from ``seed``: a speaker
    f0 (90-220 Hz) with intonation drift and 5 Hz vibrato; voiced segments
    as harmonics under three random formant resonances with a 1/f tilt;
    unvoiced noise bursts around a random fricative centre; silences; 10 ms
    raised-cosine ramps. Deterministic in ``(duration, fs, seed)`` and
    peak-normalised like :func:`synthetic_speech`.
    """
    fs = fs or AudioConfig().sample_rate
    rng = np.random.default_rng(seed)
    n = int(fs * duration)
    out = np.zeros(n, np.float32)
    f0_base = rng.uniform(90.0, 220.0)
    ramp = int(fs * 0.010)
    pos = 0
    voiced_any = False
    while pos < n:
        seg_len = min(int(fs * rng.uniform(0.08, 0.30)), n - pos)
        if seg_len < ramp * 2:
            break
        kind = rng.choice(("voiced", "unvoiced", "silence"),
                          p=(0.60, 0.25, 0.15))
        t = np.arange(seg_len) / fs
        if kind == "voiced":
            voiced_any = True
            f0 = f0_base * rng.uniform(0.85, 1.25)
            drift = rng.uniform(-0.15, 0.15)          # octave/segment slope
            inst_f0 = f0 * (1.0 + drift * t / max(t[-1], 1e-6))
            phase = 2 * np.pi * np.cumsum(inst_f0) / fs
            vibrato = 0.02 * np.sin(2 * np.pi * 5.0 * t
                                    + rng.uniform(0, 2 * np.pi))
            formants = np.array([rng.uniform(300, 800),
                                 rng.uniform(900, 2200),
                                 rng.uniform(2300, 3400)])
            bws = np.array([rng.uniform(60, 120), rng.uniform(80, 180),
                            rng.uniform(120, 260)])
            n_harm = max(1, int((0.45 * fs) / f0))
            k = np.arange(1, n_harm + 1)[:, None]         # (H, 1)
            fk = k * f0                                    # harmonic freqs
            res = (1.0 / (1.0 + ((fk - formants[None, :]) / bws[None, :])
                          ** 2)).sum(axis=1)               # (H, 1)→(H,)
            amp = (res.ravel() * (f0 / fk.ravel()) ** 0.5)  # spectral tilt
            seg = (amp[:, None] * np.sin(k * (phase + vibrato)[None, :]
                                         + rng.uniform(0, 2 * np.pi,
                                                       (n_harm, 1)))
                   ).sum(axis=0)
            seg = seg / (np.max(np.abs(seg)) + 1e-8)
        elif kind == "unvoiced":
            spec = np.fft.rfft(rng.standard_normal(seg_len))
            f = np.fft.rfftfreq(seg_len, 1.0 / fs)
            fc = rng.uniform(1500, 3600)
            bw = rng.uniform(400, 1200)
            spec *= np.exp(-0.5 * ((f - fc) / bw) ** 2)
            seg = np.fft.irfft(spec, seg_len)
            seg = 0.5 * seg / (np.max(np.abs(seg)) + 1e-8)
        else:
            seg = np.zeros(seg_len)
        env = np.ones(seg_len)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        out[pos:pos + seg_len] = (seg * env
                                  * rng.uniform(0.35, 1.0)).astype(np.float32)
        pos += seg_len
    if not voiced_any:          # degenerate draw: guarantee signal content
        return synthetic_speech_varied(duration, fs, seed + 104729)
    return (out / (np.max(np.abs(out)) + 1e-8)).astype(np.float32)


def synthetic_noise(num_samples: int, scale: float = 0.3,
                    seed: int | None = None) -> np.ndarray:
    """White noise (reference main.py:66 / pipeline fallback noise)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(num_samples) * scale).astype(np.float32)


def _shaped_noise(num_samples: int, alpha: float, rng) -> np.ndarray:
    """Gaussian noise with a 1/f^alpha magnitude envelope (FFT shaping)."""
    fs = AudioConfig().sample_rate
    spec = np.fft.rfft(rng.standard_normal(num_samples))
    f = np.fft.rfftfreq(num_samples, 1.0 / fs)
    shape = 1.0 / np.maximum(f, 1.0) ** alpha
    out = np.fft.irfft(spec * shape, num_samples)
    return (out / (np.std(out) + 1e-8)).astype(np.float32)


def synthetic_noise_bank(num_samples: int, seed: int | None = 0
                         ) -> dict:
    """Seedable stand-ins for the reference's 4-type NOISEX grid
    (config.py noise_types: babble/white/factory1/destroyerengine) so the
    full 4-noise x 4-SNR evaluation protocol runs without the corpus:

      * white            — flat Gaussian
      * babble           — 8 overlapped speech-like streams (randomized
                           formants + syllabic 2-5 Hz envelopes)
      * factory1         — pink-ish broadband + 50 Hz machinery harmonics
                           + Poisson impact bursts
      * destroyerengine  — low-frequency engine harmonics (~35 Hz
                           fundamental) + broadband hiss

    These match the noise CLASSES (spectral shape / modulation character),
    not the NOISEX recordings — scores on them are self-consistent across
    methods but not comparable to published NOISEX numbers.
    """
    fs = AudioConfig().sample_rate
    rng = np.random.default_rng(seed)
    bank = {"white": (rng.standard_normal(num_samples) * 0.3
                      ).astype(np.float32)}

    # babble: overlapped randomized talkers
    t = np.arange(num_samples) / fs
    babble = np.zeros(num_samples, np.float32)
    for _ in range(8):
        f0 = rng.uniform(120, 300)
        talker = np.zeros(num_samples, np.float32)
        for k, amp in enumerate((0.5, 0.3, 0.2, 0.12), start=1):
            talker += amp * np.sin(
                2 * np.pi * (f0 * k * rng.uniform(0.9, 1.1)) * t
                + rng.uniform(0, 2 * np.pi)).astype(np.float32)
        env = np.abs(np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t
                            + rng.uniform(0, 2 * np.pi))) ** 0.7
        babble += talker * env.astype(np.float32)
    bank["babble"] = (0.3 * babble / (np.std(babble) + 1e-8)
                      ).astype(np.float32)

    # factory1: broadband + mains-harmonic hum + impact bursts
    fac = 0.6 * _shaped_noise(num_samples, 0.5, rng)
    for k, amp in ((1, 0.4), (2, 0.25), (3, 0.15)):
        fac += amp * np.sin(2 * np.pi * 50 * k * t
                            + rng.uniform(0, 2 * np.pi))
    n_hits = max(1, int(num_samples / fs * 3))
    for pos in rng.integers(0, max(1, num_samples - fs // 8), n_hits):
        length = int(fs * 0.03)
        burst = (rng.standard_normal(length)
                 * np.exp(-np.arange(length) / (fs * 0.008)))
        fac[pos:pos + length] += 2.5 * burst[:len(fac[pos:pos + length])]
    bank["factory1"] = (0.3 * fac / (np.std(fac) + 1e-8)).astype(np.float32)

    # destroyerengine: strong LF periodicity + hiss
    eng = 0.35 * _shaped_noise(num_samples, 0.3, rng)
    f0 = 35.0
    for k, amp in ((1, 0.6), (2, 0.45), (3, 0.3), (4, 0.2), (6, 0.12)):
        eng += amp * np.sin(2 * np.pi * f0 * k * t
                            + rng.uniform(0, 2 * np.pi))
    bank["destroyerengine"] = (0.3 * eng / (np.std(eng) + 1e-8)
                               ).astype(np.float32)
    return bank
