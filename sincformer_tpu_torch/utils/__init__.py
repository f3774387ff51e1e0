"""Shared numeric utilities: windows, framing, the DCT, resampling and
the Hilbert envelope."""

from sincformer_tpu_torch.utils.signal import (  # noqa: F401
    hamming_window, hann_window, frame_signal, num_frames, dct_matrix,
    dct_ortho, resample_linear, resample_poly_fft, hilbert_envelope)
