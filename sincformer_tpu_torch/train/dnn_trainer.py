"""Training half of the original paper's mask-DNN pipeline
(``sincformer_tpu/train/dnn_trainer.py``):

  * per-utterance preprocessing: mix → AMS / RASTA-PLP / MFCC / GFCC
    features ± 5 frames of context → oracle mask (IRM, PCIRM, or the
    fixed-step OPT-PCIRM) on the gammatone grid, with the JAX package's
    ``.npz`` cache, so a cache written by either package serves the other;
  * the frame-level dataset, z-scored by the training statistics, NaNs
    scrubbed, clipped to ±10;
  * optional stacked-RBM pretraining (``models/rbm.py``) of the hidden
    layers on at most 50,000 sigmoid-squashed frames;
  * Adam behind a global-norm clip of 5.0 with ReduceLROnPlateau
    (patience 5, × 0.5, threshold 1e-6) and, after 3 consecutive NaN
    epochs, a fresh model and optimizer at 0.1 × the learning rate;
  * best and final checkpoints with the optimizer state and the schedule's
    progress (rate, plateau counter, best validation loss, epoch), from
    which ``train(resume=True)`` continues without pretraining again.

:class:`DNNTrainer` is the serving ``pipeline.DNNPipeline`` with these. The
preprocessing runs on the pipeline's device (the card by default): the JAX
package pins it to the host CPU, which keeps its TPU free, a concern the
card does not share. Each signal is zero-padded to a multiple of 2,000
samples as in JAX, since the whole-utterance RASTA-PLP mean runs over the
padding. Random draws come from explicit generators: the weights from
``seed`` (flax's initialisers), each epoch's dropout from ``seed · 997 +
epoch``, the minibatch order from ``np.random.default_rng(seed)`` (JAX's
permutations), the RBMs' samples as ``models/rbm.py`` says.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sincformer_tpu_torch.config import (AudioConfig, DataConfig, DNNConfig,
                                         RBMConfig)
from sincformer_tpu_torch.data.audio import add_noise_at_snr, load_audio
from sincformer_tpu_torch.data.loader import (find_speech_files,
                                              heldout_noises,
                                              load_noise_signals)
from sincformer_tpu_torch.dsp.features import FeatureExtractor
from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
from sincformer_tpu_torch.masks.irm import compute_irm
from sincformer_tpu_torch.masks.opt_pcirm import (compute_snr_boundaries,
                                                  quantize_pcirm)
from sincformer_tpu_torch.masks.pcirm import (compute_correlation_coefficients,
                                              compute_pcirm,
                                              compute_phase_differences)
from sincformer_tpu_torch.models.dnn import create_dnn, load_rbm_weights
from sincformer_tpu_torch.models.rbm import pretrain_dnn_with_rbm
from sincformer_tpu_torch.pipeline import DNNPipeline
from sincformer_tpu_torch.train.state import (guard_nan_update,
                                              make_adam_plateau,
                                              newest_checkpoint,
                                              read_step_meta,
                                              restore_training_state,
                                              set_injected_lr)


def compute_oracle_mask(clean_m, clean_p, noise_m, noise_p, noisy_m, noisy_p,
                        mask_type: str) -> torch.Tensor:
    """The training target from the gammatone magnitudes and phases
    (C, T) of the clean, noise and noisy signals."""
    if mask_type == "irm":
        return compute_irm(clean_m, noise_m)
    rho_s, rho_n = compute_correlation_coefficients(noisy_m, clean_m, noise_m)
    phi1, phi2 = compute_phase_differences(noisy_p, clean_p, noise_p)
    pcirm = compute_pcirm(clean_m, noise_m, rho_s, rho_n, phi1, phi2)
    if mask_type == "pcirm":
        return pcirm
    if mask_type == "opt_pcirm":
        return quantize_pcirm(pcirm, compute_snr_boundaries()[0])
    return compute_irm(clean_m, noise_m)


@torch.inference_mode()
def _preprocess(noisy, clean, noise_trim, mask_type: str,
                fe: FeatureExtractor, gfb: GammatoneFilterbank):
    raw = fe.extract_frame_features(noisy)
    features = fe.add_context(raw)
    clean_m, clean_p = gfb.get_tf_magnitudes(clean)
    noise_m, noise_p = gfb.get_tf_magnitudes(noise_trim)
    noisy_m, noisy_p = gfb.get_tf_magnitudes(noisy)
    t = min(clean_m.shape[1], features.shape[0])
    mask = compute_oracle_mask(clean_m[:, :t], clean_p[:, :t],
                               noise_m[:, :t], noise_p[:, :t],
                               noisy_m[:, :t], noisy_p[:, :t], mask_type)
    return features[:t], mask.T


def cache_key(clean: np.ndarray, noise: np.ndarray, snr, mask_type: str
              ) -> str:
    """``{md5(clean)[:16]}_{md5(noise[:16000])[:8]}_{snr}_{mask_type}``,
    the JAX package's key: the noise's identity is part of it."""
    h = hashlib.md5(np.asarray(clean).tobytes()).hexdigest()[:16]
    hn = hashlib.md5(np.asarray(noise[:16000]).tobytes()).hexdigest()[:8]
    return f"{h}_{hn}_{snr}_{mask_type}"


def process_single_utterance(clean: np.ndarray, noise: np.ndarray,
                             snr_db: float, mask_type: str,
                             fe: FeatureExtractor, gfb: GammatoneFilterbank,
                             cache_dir: Optional[str] = None,
                             cache_key: Optional[str] = None,
                             pad_quantum: int = 2000, device="cuda"
                             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """mix → features → oracle mask on ``device``, with the ``.npz`` cache:
    (features (T, 594), mask (T, 64)) as float32 numpy, or None for a
    signal shorter than two frames. The three signals are zero-padded to a
    multiple of ``pad_quantum`` samples and only the frames inside the true
    length kept; the padding still enters the whole-utterance RASTA-PLP
    mean, as in JAX."""
    if cache_dir and cache_key:
        cache_file = os.path.join(cache_dir, f"{cache_key}.npz")
        if os.path.exists(cache_file):
            try:
                data = np.load(cache_file)
                return data["features"], data["mask"]
            except Exception:
                pass                    # a corrupted cache is recomputed
    acfg = AudioConfig()
    n_true = len(clean)
    if n_true < acfg.frame_size * 2:
        return None
    noisy = add_noise_at_snr(clean, noise, snr_db)
    noise_trim = noise[:n_true]
    if len(noise_trim) < n_true:
        noise_trim = np.pad(noise_trim, (0, n_true - len(noise_trim)))
    n_pad = int(np.ceil(n_true / pad_quantum) * pad_quantum)
    t_true = (n_true - acfg.frame_size) // acfg.hop_size + 1

    def pad(x):
        return torch.from_numpy(np.pad(np.asarray(x, np.float32),
                                       (0, n_pad - n_true))).to(device)

    features, mask_t = _preprocess(pad(noisy), pad(clean), pad(noise_trim),
                                   mask_type, fe, gfb)
    features_np = features[:t_true].cpu().numpy().astype(np.float32)
    mask_np = mask_t[:t_true].cpu().numpy().astype(np.float32)   # (T, 64)
    if cache_dir and cache_key:
        os.makedirs(cache_dir, exist_ok=True)
        try:
            np.savez_compressed(os.path.join(cache_dir, f"{cache_key}.npz"),
                                features=features_np, mask=mask_np)
        except OSError:
            pass
    return features_np, mask_np


class FrameDataset:
    """Concatenated frame-level (features, mask) pairs, z-scored (by the
    given statistics, else by their own, a std under 1e-6 taken as 1),
    non-finite values scrubbed, features clipped to ±10 and masks to
    [0, 1]."""

    def __init__(self, features_list: Sequence[np.ndarray],
                 masks_list: Sequence[np.ndarray],
                 feat_mean: Optional[np.ndarray] = None,
                 feat_std: Optional[np.ndarray] = None):
        feats, masks = [], []
        for f, m in zip(features_list, masks_list):
            n = min(f.shape[0], m.shape[0])
            if n > 0:
                feats.append(f[:n])
                masks.append(m[:n])
        if feats:
            raw = np.nan_to_num(np.concatenate(feats, 0),
                                nan=0.0, posinf=0.0, neginf=0.0)
            raw_masks = np.nan_to_num(np.concatenate(masks, 0),
                                      nan=0.0, posinf=1.0, neginf=0.0)
            if feat_mean is None:
                self.feat_mean = raw.mean(0).astype(np.float32)
                self.feat_std = raw.std(0).astype(np.float32)
                self.feat_std[self.feat_std < 1e-6] = 1.0
            else:
                self.feat_mean = feat_mean
                self.feat_std = feat_std
            normalized = np.clip((raw - self.feat_mean) / self.feat_std,
                                 -10.0, 10.0)
            self.features = normalized.astype(np.float32)
            self.masks = np.clip(raw_masks, 0.0, 1.0).astype(np.float32)
        else:
            self.features = np.zeros((0, 1), np.float32)
            self.masks = np.zeros((0, 1), np.float32)
            self.feat_mean = np.zeros(1, np.float32)
            self.feat_std = np.ones(1, np.float32)

    def __len__(self):
        return self.features.shape[0]


class DNNTrainer(DNNPipeline):
    """Train and serve the mask DNN of ``mask_type``. ``dcfg`` holds the
    sizes and the Adam settings; ``use_rbm_pretrain`` the RBM stage."""

    def __init__(self, mask_type: str = "pcirm",
                 use_rbm_pretrain: bool = True, device="cuda",
                 model_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None, seed: int = 0,
                 logger=None, dcfg: DNNConfig = DNNConfig(),
                 acfg: AudioConfig = AudioConfig(),
                 rcfg: RBMConfig = RBMConfig()):
        super().__init__(mask_type, device, model_dir, None, dcfg, acfg)
        self.use_rbm = use_rbm_pretrain
        self.rcfg = rcfg
        self.cache_dir = cache_dir or DataConfig().cache_dir
        self.seed = seed
        self.logger = logger
        self._lr = dcfg.learning_rate
        self.tx = None                      # train.state.PlateauAdam
        self.opt_state = None
        self.nan_count = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self._progress: Dict = {}

    # ── data ────────────────────────────────────────────────────────────

    def prepare_arrays(self, clean_signals: Sequence[np.ndarray],
                       noises: Dict[str, np.ndarray],
                       snr_levels: Sequence[float] | None = None,
                       test_fraction: float = 0.1, use_cache: bool = False,
                       n_test: int | None = None
                       ) -> Tuple[FrameDataset, FrameDataset]:
        """In-memory data: utterance i takes noise ``i mod #noises`` and
        SNR ``i mod #SNRs``; the last ``n_test`` (else ``test_fraction``)
        utterances are the test set and mix with held-out noise crops.
        The split counts the test utterances that survived preprocessing,
        so a dropped one never moves an utterance across it. The test set
        is z-scored by the training statistics."""
        snr_levels = list(snr_levels or DataConfig().snr_levels)
        keys = list(noises.keys())
        hold = heldout_noises(noises)
        n_jobs = len(clean_signals)
        test_start = (n_jobs - n_test if n_test is not None
                      else int(n_jobs * (1 - test_fraction)))
        outs = []
        for i, clean in enumerate(clean_signals):
            bank = hold if i >= test_start else noises
            noise = bank[keys[i % len(keys)]]
            snr = snr_levels[i % len(snr_levels)]
            ck = (cache_key(clean, noise, snr, self.mask_type) if use_cache
                  else None)
            outs.append(process_single_utterance(
                np.asarray(clean, np.float32), noise, snr, self.mask_type,
                self.fe, self.gfb, self.cache_dir if use_cache else None, ck,
                device=self.device))
        feats = [o[0] for o in outs if o is not None]
        masks = [o[1] for o in outs if o is not None]
        n_te_ok = sum(1 for o in outs[test_start:] if o is not None)
        split = max(1, len(feats) - n_te_ok)
        train = FrameDataset(feats[:split], masks[:split])
        self.feat_mean, self.feat_std = train.feat_mean, train.feat_std
        test = FrameDataset(feats[split:], masks[split:],
                            train.feat_mean, train.feat_std)
        return train, test

    def prepare_data(self, max_train: int | None = None,
                     max_test: int | None = None):
        """TIMIT and NOISEX-92 from disk: a seed-42 90/10 permutation split,
        the boundary counted on the files that loaded, cached features."""
        files = find_speech_files()
        if not files:
            raise RuntimeError(f"No speech files in {DataConfig().timit_dir}")
        idx = np.random.RandomState(DataConfig().train_split_seed
                                    ).permutation(len(files))
        split = int(0.9 * len(files))
        train_files = [files[i] for i in idx[:split]][:max_train]
        test_files = [files[i] for i in idx[split:]][:max_test]
        noises = load_noise_signals(self.fs)
        signals, n_test_loaded = [], 0
        for f in train_files:
            try:
                signals.append(load_audio(f, self.fs))
            except Exception:
                continue
        for f in test_files:
            try:
                signals.append(load_audio(f, self.fs))
                n_test_loaded += 1
            except Exception:
                continue
        frac = len(test_files) / max(len(train_files) + len(test_files), 1)
        return self.prepare_arrays(signals, noises, test_fraction=frac,
                                   n_test=n_test_loaded, use_cache=True)

    # ── state ───────────────────────────────────────────────────────────

    def _init_model_state(self, lr: float, seed: int) -> None:
        """A fresh model drawn from ``seed`` and a fresh Adam at ``lr``."""
        self.model = create_dnn(self.feature_dim, self.mask_dim, self.dcfg
                                ).training_init(
            torch.Generator().manual_seed(seed)).to(self.device).eval()
        self.tx = make_adam_plateau(lr)
        self.opt_state = self.tx.init(self.params())
        self.nan_count = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self.step = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _rbm_pretrain(self, train_ds: FrameDataset, verbose: bool) -> bool:
        """Stacked CD-1 on the sigmoid of the first 50,000 frames; the
        weights go into the hidden layers unless one is not finite or
        passes 100 in magnitude. Returns whether they were loaded."""
        n = min(len(train_ds), self.rcfg.max_samples)
        data = 1.0 / (1.0 + np.exp(-np.clip(train_ds.features[:n], -10, 10)))
        sizes = ([self.feature_dim]
                 + [self.dcfg.hidden_units] * self.dcfg.hidden_layers)
        weights = pretrain_dnn_with_rbm(data, sizes, verbose=verbose,
                                        seed=self.seed, device=self.device,
                                        rcfg=self.rcfg)
        for w, _vb, _hb in weights:
            if not np.all(np.isfinite(w)) or np.abs(w).max() > 100:
                if verbose:
                    print("  ! degenerate RBM weights — skipping load")
                return False
        load_rbm_weights(self.model, weights)
        return True

    # ── steps ───────────────────────────────────────────────────────────

    def train_minibatch(self, feats: torch.Tensor, masks: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
        """One step: the MSE of the mask, its gradients, the NaN guard, the
        clipped Adam update at the state's rate. Returns the loss, a device
        scalar."""
        params = self.params()
        with torch.enable_grad():
            pred = self.model(feats, generator)
            loss = torch.mean((pred - masks) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads, is_bad = guard_nan_update(list(grads), loss.detach(),
                                         params.values())
        self.tx.update(params, grads, self.opt_state)
        self.nan_count += is_bad.to(torch.int32)
        self.step += 1
        return loss.detach()

    def train_epoch(self, feats: torch.Tensor, masks: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """One step per minibatch of ``feats`` (nb, B, F) and ``masks``
        (nb, B, C), in order; returns the mean loss (a device scalar, NaN
        when a step's loss was)."""
        return torch.stack([self.train_minibatch(f, m, generator)
                            for f, m in zip(feats, masks)]).mean()

    @torch.no_grad()
    def validate(self, feats: torch.Tensor, masks: torch.Tensor) -> float:
        return float(torch.mean((self.model(feats) - masks) ** 2))

    # ── training loop ───────────────────────────────────────────────────

    def train(self, train_ds: FrameDataset, test_ds: FrameDataset,
              epochs: int | None = None, batch_size: int | None = None,
              verbose: bool = True, resume: bool = False) -> List[dict]:
        """Train from a fresh model (RBM-pretrained unless disabled), or,
        with ``resume=True``, from the newest checkpoint across the best
        and final families: its weights and Adam state, and from its
        sidecar the learning rate, plateau counter, best validation loss
        and epoch; a resume does not pretrain again. Returns one history
        entry per epoch."""
        epochs = epochs or self.dcfg.epochs
        batch_size = batch_size or self.dcfg.batch_size
        self._init_model_state(self._lr, self.seed)

        start_epoch, resume_lr, resume_best, resume_plateau = 0, None, None, 0
        resume_path = None
        if resume:
            resume_path = newest_checkpoint(
                self.model_dir, (self.BEST_NAME, self.FINAL_NAME))
            if resume_path is None and verbose:
                print("  --resume requested but no checkpoint found — "
                      "starting fresh")
        if resume_path is not None:
            self.load_model(resume_path)
            meta = read_step_meta(resume_path)
            resume_lr = meta.get("lr")
            resume_best = meta.get("best_val")
            resume_plateau = int(meta.get("plateau", 0))
            start_epoch = min(int(meta.get("epoch", -1)) + 1, epochs)
            # a resume that runs no epoch is followed by save_model(),
            # which must keep the schedule's state
            self._progress = {k: meta[k] for k in
                              ("lr", "plateau", "best_val", "epoch")
                              if k in meta}
            if verbose:
                print(f"  Resuming from {resume_path} at step {self.step} → "
                      f"epoch {start_epoch + 1}/{epochs}"
                      + (f" (LR {resume_lr:.2e})" if resume_lr else ""))
        elif self.use_rbm and len(train_ds) > 0:
            self._rbm_pretrain(train_ds, verbose)

        n = len(train_ds)
        batch_size = max(1, min(batch_size, n))   # small sets: one batch
        nb = max(1, n // batch_size)
        usable = nb * batch_size
        rng_np = np.random.default_rng(self.seed)
        dev = self.device
        test_f = torch.from_numpy(test_ds.features).to(dev)
        test_m = torch.from_numpy(test_ds.masks).to(dev)

        best_val = (float(resume_best) if resume_best is not None
                    else float("inf"))
        nan_epochs = 0
        history = []
        lr = float(resume_lr) if resume_lr is not None else self._lr
        plateau = resume_plateau
        if resume_lr is not None:
            set_injected_lr(self.opt_state, lr)
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            perm = rng_np.permutation(n)[:usable]
            feats = torch.from_numpy(train_ds.features[perm]).to(dev).reshape(
                nb, batch_size, -1)
            masks = torch.from_numpy(train_ds.masks[perm]).to(dev).reshape(
                nb, batch_size, -1)
            gen = torch.Generator(device=dev).manual_seed(
                self.seed * 997 + epoch)
            tr_loss = float(self.train_epoch(feats, masks, gen))

            if not np.isfinite(tr_loss):
                nan_epochs += 1
                if nan_epochs >= 3:
                    if verbose:
                        print("  ! 3 NaN epochs — re-initializing model at "
                              "0.1x LR")
                    lr = lr * 0.1
                    self._init_model_state(lr, self.seed + 7 + epoch)
                    nan_epochs = 0
                continue
            nan_epochs = 0

            va_loss = (self.validate(test_f, test_m) if len(test_ds)
                       else tr_loss)
            if va_loss < best_val - 1e-6:          # ReduceLROnPlateau
                best_val = va_loss
                plateau = 0
                self._progress = {"lr": lr, "plateau": plateau,
                                  "best_val": best_val, "epoch": epoch}
                self.save_model(self.BEST_NAME)
            else:
                plateau += 1
                if plateau >= 5:
                    lr *= 0.5
                    plateau = 0
                    set_injected_lr(self.opt_state, lr)
                    if verbose:
                        print(f"    LR reduced to {lr:.2e}")
            self._progress = {"lr": lr, "plateau": plateau,
                              "best_val": best_val, "epoch": epoch}
            entry = {"epoch": epoch, "train_loss": tr_loss,
                     "val_loss": va_loss, "lr": lr,
                     "epoch_seconds": time.time() - t0}
            history.append(entry)
            if self.logger is not None:
                self.logger.log({"pipeline": "dnn", **entry})
            if verbose:
                print(f"  Epoch {epoch + 1:3d}/{epochs} | "
                      f"Train: {tr_loss:.5f} | Val: {va_loss:.5f} | "
                      f"LR {lr:.1e} | {time.time() - t0:.1f}s", flush=True)
        return history

    # ── model I/O ───────────────────────────────────────────────────────

    def _sidecar(self) -> dict:
        """The serving sidecar and the schedule's progress (rate, plateau
        counter, best validation loss, epoch), which ``resume`` reads."""
        return {**super()._sidecar(), **self._progress}

    def load_model(self, path: Optional[str] = None) -> str:
        """As the serving pipeline, and the Adam state (with its learning
        rate) and NaN count of a full checkpoint."""
        path = super().load_model(path)
        opt, self.nan_count = restore_training_state(path, self.device)
        if opt is not None:
            opt.setdefault("lr", self._lr)
            self.tx, self.opt_state = make_adam_plateau(opt["lr"]), opt
        return path


# the JAX package names its training pipeline so, in this module
DNNPipeline = DNNTrainer
