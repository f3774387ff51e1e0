"""PESQ (``sincformer_tpu/evaluation/pesq.py``): the ITU C library when it
is installed, else the native P.862 of ``evaluation/p862.py`` (host numpy),
else the log-spectral-distortion proxy, which also runs batched on the
device (:func:`pesq_proxy_torch`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig, EvalConfig
from sincformer_tpu_torch.evaluation.common import f32_on
from sincformer_tpu_torch.utils.signal import frame_signal


def pesq_proxy_torch(clean: torch.Tensor, enhanced: torch.Tensor,
                     fs: int = 8000) -> torch.Tensor:
    """The LSD proxy of equal-length (..., N) waveforms: 32 ms frames at
    50 % overlap, the log-spectral distortion per frame, 4.5 − 0.5 × its
    mean, clipped to [-0.5, 4.5]."""
    frame_size = int(0.032 * fs)
    hop = frame_size // 2
    cs = torch.abs(torch.fft.rfft(frame_signal(clean, frame_size, hop),
                                  dim=-1))
    es = torch.abs(torch.fft.rfft(frame_signal(enhanced, frame_size, hop),
                                  dim=-1))
    lsd = torch.sqrt(torch.mean(
        (torch.log(cs + 1e-10) - torch.log(es + 1e-10)) ** 2, dim=-1))
    return torch.clamp(4.5 - torch.mean(lsd, dim=-1) * 0.5, -0.5, 4.5)


def _pesq_lsd_proxy(clean: np.ndarray, enhanced: np.ndarray, fs: int,
                    device="cuda") -> float:
    if min(len(clean), len(enhanced)) < int(0.032 * fs):
        return 1.0
    return float(pesq_proxy_torch(f32_on(clean, device),
                                  f32_on(enhanced, device), fs))


def compute_pesq(clean_signal, enhanced_signal, fs: Optional[int] = None,
                 mode: Optional[str] = None, impl: Optional[str] = None,
                 device="cuda") -> float:
    """PESQ of two host signals (cut to the shorter). ``impl`` (default
    ``EvalConfig.pesq_impl``): "auto" takes the C library when installed,
    else the native P.862; "clib", "native" and "proxy" force one source
    (the proxy runs on ``device``)."""
    ecfg = EvalConfig()
    fs = fs or AudioConfig().sample_rate
    mode = mode or ecfg.pesq_mode
    impl = impl or ecfg.pesq_impl
    m = min(len(clean_signal), len(enhanced_signal))
    clean = np.asarray(clean_signal[:m], np.float64)
    enhanced = np.asarray(enhanced_signal[:m], np.float64)
    if impl in ("auto", "clib"):
        try:
            from pesq import pesq as _pesq
            return float(_pesq(fs, clean, enhanced, mode))
        except ImportError:
            if impl == "clib":
                raise
        except Exception as e:  # the C code can fail on very short input
            print(f"PESQ computation failed: {e}")
            return 0.0
    if impl in ("auto", "native"):
        try:
            from sincformer_tpu_torch.evaluation.p862 import pesq_p862
            return pesq_p862(clean, enhanced, fs)
        except Exception as e:
            if impl == "native":
                raise
            print(f"native P.862 failed ({e}); falling back to LSD proxy")
    return _pesq_lsd_proxy(clean, enhanced, fs, device)
