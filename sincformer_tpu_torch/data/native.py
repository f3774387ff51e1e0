"""ctypes bindings to the native host audio runtime (``native/wavio.cpp``,
the JAX package's ``data/native.py``): RIFF/WAVE decoding to mono float32
and linear resampling, what ``load_audio`` takes, and the library's SNR
mixing with tiled noise (``mix_snr``, ``data.audio.add_noise_at_snr``'s
arithmetic in double precision) and right-zero-padded batch assembly
(``batch_pad``). ``available`` says whether the library loads.

The library is built at first use with the host C++ compiler (``CXX``,
default ``g++``) into ``sincformer_tpu_torch/_build/`` (git-ignored), its
file name keyed by a hash of the source, as the CUDA kernels are
(``ops/build.py``); nothing is written into ``native/``. Without a
compiler or the source ``wav_read_mono`` returns None, and
``data/audio.load_audio`` reads WAV through scipy instead. ``reads`` counts
the files decoded by the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from sincformer_tpu_torch.ops.build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "wavio.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False
reads = 0


def library_path() -> str:
    """Where the library built from the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libsincwav-{digest}.so")


def build() -> str:
    """Compile ``native/wavio.cpp`` unless its library exists; returns the
    library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.wav_num_samples.restype = ctypes.c_long
    lib.wav_num_samples.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.wav_read_mono.restype = ctypes.c_long
    lib.wav_read_mono.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_long]
    lib.resample_linear.restype = None
    lib.resample_linear.argtypes = [ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long]
    lib.mix_snr.restype = None
    lib.mix_snr.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                            ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
    lib.batch_pad.restype = None
    lib.batch_pad.argtypes = [ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(ctypes.c_long), ctypes.c_long,
                              ctypes.c_long, ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds (at first use) and loads."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_read_mono(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode a WAV file to mono float32: (samples, sample rate), or None
    when the library is missing or cannot read the file."""
    global reads
    lib = _load()
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.wav_num_samples(path.encode(), ctypes.byref(sr))
    if n <= 0:
        return None
    buf = np.empty(n, np.float32)
    got = lib.wav_read_mono(path.encode(), _fptr(buf), n)
    if got <= 0:
        return None
    reads += 1
    return buf[:got], int(sr.value)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampling (``utils.signal.resample_linear``'s
    index mapping); needs the library, which a successful
    :func:`wav_read_mono` has loaded."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(int(len(x) * sr_out / sr_in), np.float32)
    lib.resample_linear(_fptr(x), len(x), _fptr(out), len(out))
    return out


def mix_snr(clean: np.ndarray, noise: np.ndarray,
            snr_db: float) -> Optional[np.ndarray]:
    """clean + noise scaled to ``snr_db`` (noise tiled to clean's length);
    None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    clean = np.ascontiguousarray(clean, np.float32)
    noise = np.ascontiguousarray(noise, np.float32)
    out = np.empty(len(clean), np.float32)
    lib.mix_snr(_fptr(clean), len(clean), _fptr(noise), len(noise),
                float(snr_db), _fptr(out))
    return out


def batch_pad(signals, max_len: int) -> Optional[np.ndarray]:
    """(len(signals), max_len) float32: each signal cut or right-padded
    with zeros to ``max_len``; None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    lens = np.asarray([len(s) for s in signals], np.int64)
    flat = np.ascontiguousarray(np.concatenate(
        [np.asarray(s, np.float32) for s in signals]))
    out = np.empty((len(signals), max_len), np.float32)
    lib.batch_pad(_fptr(flat),
                  lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                  len(signals), max_len, _fptr(out))
    return out
