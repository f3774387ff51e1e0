"""Dataset discovery, splits and the batch iterator
(``sincformer_tpu/data/loader.py``, numpy on the host).

  * the seed-42 shuffled 90/10 split of the speech files;
  * round-robin (noise, SNR) assignment per utterance index;
  * every batch padded to the dataset's ``max_len`` (the parity mode), or
    utterances grouped into quantised-length buckets and padded within
    their bucket, with the true ``lengths`` alongside.

Given the same seed and epoch, the batches, their order and ``lengths`` are
the JAX package's.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from sincformer_tpu_torch.config import AudioConfig, DataConfig
from sincformer_tpu_torch.data.audio import add_noise_at_snr, load_audio


def find_speech_files(timit_dir: str | None = None,
                      max_files: int | None = None,
                      seed: int = 42) -> List[str]:
    """Recursive TIMIT discovery (reference conformer_pipeline.py:341-354):
    sorted-unique glob of **/*.WAV|wav; seeded subsample when capped."""
    timit_dir = timit_dir or DataConfig().timit_dir
    files: List[str] = []
    for pat in ("**/*.WAV", "**/*.wav"):
        files.extend(glob.glob(os.path.join(timit_dir, pat), recursive=True))
    files = sorted(set(files))
    if max_files and len(files) > max_files:
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(files), max_files, replace=False)
        files = [files[i] for i in sorted(idx)]
    return files


def load_noise_signals(fs: int | None = None,
                       noisex_dir: str | None = None,
                       synth_fallback: bool | str = True,
                       seed: int | None = 0) -> Dict[str, np.ndarray]:
    """Load the NOISEX-92 noise bank; synthetic fallback when absent
    (reference conformer_pipeline.py:356-369).

    synth_fallback: False → no fallback; True / "white" → white noise
    (the reference's own fallback and this repo's recorded training/eval
    protocol); "multi" → the 4-class synthetic bank
    (data/synthetic.py::synthetic_noise_bank) so the reference's full
    4-noise × 4-SNR grid protocol runs without the corpus."""
    dcfg = DataConfig()
    fs = fs or AudioConfig().sample_rate
    noisex_dir = noisex_dir or dcfg.noisex_dir
    noises = {}
    for noise_type in dcfg.noise_types:
        path = os.path.join(noisex_dir, f"{noise_type}.wav")
        if os.path.exists(path):
            try:
                noises[noise_type] = load_audio(path, fs)
            except Exception:
                pass
    if not noises and synth_fallback:
        if synth_fallback == "multi":
            from sincformer_tpu_torch.data.synthetic import synthetic_noise_bank
            noises = synthetic_noise_bank(fs * 30, seed)
        else:
            rng = np.random.default_rng(seed)
            noises["white"] = (rng.standard_normal(fs * 30) * 0.3
                               ).astype(np.float32)
    return noises


def heldout_noises(noises: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Disjoint noise crops for validation and calibration mixtures.

    ``add_noise_at_snr`` always crops ``noise[:len(clean)]``, so every
    training epoch reuses the same leading noise samples and a model can
    learn that realisation. Rolling each noise array by half its length
    takes validation crops from the tail half, disjoint from every training
    crop shorter than half the array."""
    return {k: np.roll(np.asarray(v, np.float32), len(v) // 2)
            for k, v in noises.items()}


def train_test_split(files: Sequence[str], seed: int = 42,
                     train_fraction: float = 0.9,
                     max_train: int | None = None,
                     max_test: int | None = None
                     ) -> Tuple[List[str], List[str]]:
    """Seed-42 permuted 90/10 split (reference conformer_pipeline.py:381-390;
    uses the legacy RandomState to reproduce the exact split)."""
    rs = np.random.RandomState(seed)
    indices = rs.permutation(len(files))
    split = int(train_fraction * len(files))
    train = [files[i] for i in indices[:split]]
    test = [files[i] for i in indices[split:]]
    if max_train:
        train = train[:max_train]
    if max_test:
        test = test[:max_test]
    return train, test


@dataclass
class WaveformDataset:
    """(noisy, clean) waveform pairs with round-robin noise×SNR assignment
    (reference conformer_pipeline.py:153-189).

    Stores variable-length pairs; padding happens at batch time.
    """
    pairs: List[Tuple[np.ndarray, np.ndarray]]
    max_len: int

    @classmethod
    def from_files(cls, clean_files: Sequence[str],
                   noise_signals: Dict[str, np.ndarray],
                   snr_levels: Sequence[float] | None = None,
                   fs: int | None = None, max_len: int | None = None,
                   min_len_frames: int = 4) -> "WaveformDataset":
        acfg = AudioConfig()
        dcfg = DataConfig()
        fs = fs or acfg.sample_rate
        snr_levels = list(snr_levels or dcfg.snr_levels)
        max_len = max_len or int(fs * dcfg.max_wave_seconds)
        noise_keys = list(noise_signals.keys())
        pairs = []
        for i, f in enumerate(clean_files):
            try:
                clean = load_audio(f, fs)
                if len(clean) < acfg.frame_size * min_len_frames:
                    continue
            except Exception:
                continue
            noise = noise_signals[noise_keys[i % len(noise_keys)]]
            snr = snr_levels[i % len(snr_levels)]
            noisy = add_noise_at_snr(clean, noise, snr)
            if len(clean) > max_len:
                clean, noisy = clean[:max_len], noisy[:max_len]
            pairs.append((noisy, clean))
        return cls(pairs=pairs, max_len=max_len)

    @classmethod
    def from_arrays(cls, clean_signals: Sequence[np.ndarray],
                    noise_signals: Dict[str, np.ndarray],
                    snr_levels: Sequence[float] | None = None,
                    fs: int | None = None,
                    max_len: int | None = None) -> "WaveformDataset":
        """In-memory variant (synthetic data, tests)."""
        acfg = AudioConfig()
        dcfg = DataConfig()
        fs = fs or acfg.sample_rate
        snr_levels = list(snr_levels or dcfg.snr_levels)
        max_len = max_len or int(fs * dcfg.max_wave_seconds)
        noise_keys = list(noise_signals.keys())
        pairs = []
        for i, clean in enumerate(clean_signals):
            clean = np.asarray(clean, np.float32)
            noise = noise_signals[noise_keys[i % len(noise_keys)]]
            snr = snr_levels[i % len(snr_levels)]
            noisy = add_noise_at_snr(clean, noise, snr)
            if len(clean) > max_len:
                clean, noisy = clean[:max_len], noisy[:max_len]
            pairs.append((noisy, clean))
        return cls(pairs=pairs, max_len=max_len)

    def __len__(self) -> int:
        return len(self.pairs)


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x, (0, n - len(x))) if len(x) < n else x[:n]


def remix_for_stage(clean_signals: Sequence[np.ndarray],
                    noises: Dict[str, np.ndarray],
                    snr_levels: Sequence[float], max_len: int,
                    epoch: int) -> WaveformDataset:
    """Mix the clean sources at the given SNRs, the (noise, SNR) assignment
    rotated by ``epoch`` (the training curriculum's per-epoch mixing, and
    the validation and calibration sets at epoch 0)."""
    keys = list(noises.keys())
    pairs = []
    for i, clean in enumerate(clean_signals):
        clean = np.asarray(clean, np.float32)[:max_len]
        noise = noises[keys[(i + epoch) % len(keys)]]
        snr = snr_levels[(i + epoch) % len(snr_levels)]
        pairs.append((add_noise_at_snr(clean, noise, snr), clean))
    return WaveformDataset(pairs=pairs, max_len=max_len)


def batch_iterator(ds: WaveformDataset, batch_size: int,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, bucketed: bool = False,
                   bucket_quantum: int = 4000,
                   epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield padded (noisy, clean, lengths) batches.

    ``bucketed=False`` (parity mode): every batch padded to ds.max_len, like
    the reference's fixed 4-s padding (conformer_pipeline.py:184-189).
    ``bucketed=True``: sort utterances into quantised-length buckets and pad
    within the bucket only: denser batches with few distinct shapes.
    """
    n = len(ds.pairs)
    order = np.arange(n)
    rng = np.random.default_rng(seed + epoch)
    if shuffle:
        rng.shuffle(order)

    if not bucketed:
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            # drop a trailing partial batch only if a full batch was already
            # emitted — otherwise a small dataset would silently train on
            # NOTHING (zero batches)
            if len(idx) < batch_size and drop_last and s > 0:
                break
            noisy = np.stack([_pad_to(ds.pairs[i][0], ds.max_len)
                              for i in idx])
            clean = np.stack([_pad_to(ds.pairs[i][1], ds.max_len)
                              for i in idx])
            lengths = np.array([min(len(ds.pairs[i][0]), ds.max_len)
                                for i in idx], np.int32)
            yield {"noisy": noisy, "clean": clean, "lengths": lengths}
        return

    # bucketed: group indices by quantised length
    buckets: Dict[int, List[int]] = {}
    for i in order:
        length = min(len(ds.pairs[i][0]), ds.max_len)
        q = int(np.ceil(length / bucket_quantum) * bucket_quantum)
        buckets.setdefault(q, []).append(i)

    def _emit(idx, q):
        noisy = np.stack([_pad_to(ds.pairs[i][0], q) for i in idx])
        clean = np.stack([_pad_to(ds.pairs[i][1], q) for i in idx])
        lengths = np.array([min(len(ds.pairs[i][0]), q) for i in idx],
                           np.int32)
        return {"noisy": noisy, "clean": clean, "lengths": lengths}

    # Full batches ride their own bucket shape; per-bucket remainders are
    # pooled and re-padded to the LARGEST bucket shape, so the compiled
    # shape set stays {one per bucket} instead of {one per partial size}.
    # Batch EMISSION order is shuffled across buckets:
    # ascending-length emission every epoch systematically biases SGD
    # (short utterances always first, long always last) and differs from
    # the parity mode for reasons unrelated to padding density.
    remainder: List[int] = []
    q_max = max(buckets)
    batches: List[Tuple[List[int], int]] = []
    for q in sorted(buckets):
        idxs = buckets[q]
        full_end = (len(idxs) // batch_size) * batch_size
        for s in range(0, full_end, batch_size):
            batches.append((idxs[s:s + batch_size], q))
        remainder.extend(idxs[full_end:])
    for s in range(0, len(remainder), batch_size):
        idx = remainder[s:s + batch_size]
        # drop a trailing partial only if something else exists —
        # a small dataset must not silently yield zero batches
        if len(idx) < batch_size and drop_last and batches:
            break
        batches.append((idx, q_max))
    emit_order = (rng.permutation(len(batches)) if shuffle
                  else range(len(batches)))
    for bi in emit_order:
        yield _emit(*batches[bi])
