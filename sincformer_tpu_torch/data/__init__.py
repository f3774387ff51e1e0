"""The host-side input pipeline: audio files, noise mixing, synthetic
speech and noise, and the training datasets."""

from sincformer_tpu_torch.data.audio import (  # noqa: F401
    load_audio, add_noise_at_snr)
from sincformer_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_speech, synthetic_speech_varied, synthetic_noise)
from sincformer_tpu_torch.data.loader import (  # noqa: F401
    WaveformDataset, find_speech_files, load_noise_signals,
    train_test_split, batch_iterator)
