"""Training half of the DCSE pipeline (``sincformer_tpu/train/dcse_trainer.py``):
:class:`DCSETrainer`, the serving ``pipeline.DCSEPipeline`` with the loss,
the train and eval steps, the epoch loop with best-by-validation
checkpointing and the validation-calibrated output gain, and full
checkpoints (the optimizer state, the NaN count and the BatchNorm
statistics beside the weights).

The recipe is the JAX package's: AdamW (``DCSEConfig.lr`` 5e-4, ``betas``
(0.9, 0.98), ``weight_decay`` 0.01) behind a global-norm clip of
``grad_clip`` 5.0 on the warmup-cosine schedule
(``train/state.make_adamw``), a NaN-guarded step,
and the loss SI-SNR + ``mag_loss_weight`` · L1 of the magnitudes + the
multi-resolution STFT loss.

Random draws come from explicit generators: the weights from ``seed``
(``SpeechEnhancer.training_init``, flax's initialisers) and dropout from
``seed + 1`` on the pipeline's device. A training forward (dropout on, a
``conv_norm="batch"`` model normalising by the batch and stepping its
running statistics once) and the step make no host synchronisation; the
losses are read once per epoch. Kernel K1 runs every forward
(``attn_impl="speech"``) and, with ``fused_ffn`` and dropout 0, kernel K3
too, both under autograd with their plain backward.

Data parallelism (``mesh=``, as JAX's trainer takes it) works as the
flagship trainer's (``train/agent_trainer.py``): rank 0's state on every
rank, each rank's block of every batch, the gradients and losses averaged
over the ranks before the guard and the clip, validation split and
all-reduced, rank 0 alone writing. Inside the step the "batch" BatchNorm
statistics are the global B × T's (``models/conformer.batch_norm``), so
the running statistics agree on every rank, and the MR-STFT spectral
convergence is global; SI-SNR and the magnitude L1 are means over equal
per-rank shapes and stay local.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig, DataConfig
from sincformer_tpu_torch.data.loader import (WaveformDataset, batch_iterator,
                                              find_speech_files,
                                              heldout_noises,
                                              load_noise_signals,
                                              train_test_split)
from sincformer_tpu_torch.dsp.stft import istft, stft
from sincformer_tpu_torch.models.dcse import default_speech_enhancer
from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel.mesh import (blocks_for_ranks, data_rank,
                                                rank_seed, shard_batch)
from sincformer_tpu_torch.pipeline import DCSEPipeline
from sincformer_tpu_torch.train.losses import (multi_resolution_stft_loss,
                                               si_snr_loss)
from sincformer_tpu_torch.train.state import (VAL_PROTOCOL, guard_nan_update,
                                              make_adamw, merge_train_meta,
                                              newest_checkpoint,
                                              read_train_meta,
                                              restore_training_state)


class DCSETrainer(DCSEPipeline):
    """Train and serve the DCSE SpeechEnhancer. The training settings are
    the model's ``DCSEConfig`` (lr, dropout, epochs, batch size, loss
    weight). ``seed`` draws the weights (unless a checkpoint or a state was
    loaded) and the dropout masks; ``logger`` (a
    ``utils.observability.MetricsLogger``) takes one record per epoch.
    Without ``model``, the model is ``default_speech_enhancer()``.
    ``compute_dtype`` other than None (the JAX package's bf16 path) is not
    ported: kernels K1 and K3 are float32 kernels. ``mesh`` (a DeviceMesh
    with a ``"data"`` axis) makes the training data-parallel over its
    ranks."""

    _CKPT_NAMES = ("conformer_final", "best_conformer")

    def __init__(self, model=None, device="cuda", output_gain: float = 1.0,
                 audio: AudioConfig = AudioConfig(),
                 model_dir: Optional[str] = None, seed: int = 0,
                 logger=None, compute_dtype=None, mesh=None):
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype (bf16 DCSE training) is not ported: kernels "
                "K1 and K3 compute in float32 (ROADMAP.md Queue 1)")
        super().__init__(model or default_speech_enhancer(), device,
                         output_gain, audio, model_dir)
        self.seed = seed
        self.mesh = mesh
        self.logger = logger
        self.tx = None                      # train.state.AdamW
        self.opt_state = None
        self.nan_count = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self.dropout_generator = None
        self._weights_loaded = False

    # ── data ────────────────────────────────────────────────────────────

    def prepare_data(self, max_train: int | None = None,
                     max_test: int | None = None
                     ) -> Tuple[WaveformDataset, WaveformDataset]:
        """TIMIT found on disk → the seed-42 split → round-robin noise × SNR
        mixing; validation mixes with held-out noise crops."""
        files = find_speech_files()
        if not files:
            raise RuntimeError(f"No speech files in {DataConfig().timit_dir}")
        train_files, test_files = train_test_split(
            files, max_train=max_train, max_test=max_test)
        fs = self.audio.sample_rate
        noises = load_noise_signals(fs)
        return (WaveformDataset.from_files(train_files, noises, fs=fs),
                WaveformDataset.from_files(test_files, heldout_noises(noises),
                                           fs=fs))

    # ── checkpoints: the serving ones plus the optimizer state ─────────

    def load_state(self, state_dict, buffers=None) -> None:
        super().load_state(state_dict, buffers)
        self._weights_loaded = True

    def params(self):
        return dict(self.model.named_parameters())

    def load_model(self, path: Optional[str] = None) -> str:
        """As the serving pipeline, and the optimizer state and NaN count of
        a full checkpoint (none from a serving one)."""
        path = super().load_model(path)
        self._weights_loaded = True
        self.opt_state, self.nan_count = restore_training_state(path,
                                                                self.device)
        return path

    # ── state ───────────────────────────────────────────────────────────

    def init_state(self, epochs: int, steps_per_epoch: int,
                   init_params: Optional[bool] = None,
                   reset_optimizer: bool = True) -> None:
        """The AdamW optimizer for ``epochs`` × ``steps_per_epoch`` steps
        and its zero state (``reset_optimizer=False`` keeps a restored
        one), a fresh dropout generator, and, unless weights were loaded or
        drawn already (``init_params`` overrides), weights drawn from
        ``seed``."""
        if init_params is None:
            init_params = not self._weights_loaded
        if init_params:
            self.model.training_init(torch.Generator().manual_seed(self.seed))
            self._weights_loaded = True
        c = self.model.config
        self.tx = make_adamw(c.lr, epochs, steps_per_epoch, c.betas,
                             c.weight_decay, c.grad_clip)
        if reset_optimizer or self.opt_state is None:
            self.opt_state = self.tx.init(self.params())
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(rank_seed(self.seed, self.mesh)
                                            + 1)
        if self.mesh is not None:
            collectives.broadcast_(
                [*self.model.parameters(), *self.model.buffers(),
                 *self.opt_state["mu"].values(),
                 *self.opt_state["nu"].values()], self.mesh)

    # ── loss and steps ──────────────────────────────────────────────────

    def _loss(self, noisy: torch.Tensor, clean: torch.Tensor, train: bool):
        """(total, (sisnr, enhanced waveform)). ``train``: dropout drawn
        from the dropout generator and, with ``conv_norm="batch"``,
        BatchNorm on the batch's statistics, its running ones stepped."""
        a = self.audio
        n_fft, hop, frame = a.fft_size, a.hop_size, a.frame_size
        noisy_spec = stft(noisy, n_fft, hop, frame)
        clean_spec = stft(clean, n_fft, hop, frame)
        enh_r, enh_i, _ = self.model(
            noisy_spec.real, noisy_spec.imag,
            generator=self.dropout_generator if train else None)
        enh_wav = istft(torch.complex(enh_r, enh_i), n_fft, hop, frame,
                        length=clean.shape[-1])
        loss_sisnr = si_snr_loss(enh_wav, clean)
        enh_mag = torch.sqrt(enh_r ** 2 + enh_i ** 2 + 1e-8)
        clean_mag = torch.sqrt(clean_spec.real ** 2 + clean_spec.imag ** 2
                               + 1e-8)
        loss_mag = torch.mean(torch.abs(enh_mag - clean_mag))
        loss_stft = multi_resolution_stft_loss(enh_wav, clean)
        total = (loss_sisnr + self.model.config.mag_loss_weight * loss_mag
                 + loss_stft)
        return total, (-loss_sisnr, enh_wav)

    def loss_and_grads(self, noisy: torch.Tensor, clean: torch.Tensor):
        """A training forward and its gradients: (loss, sisnr, grads in the
        order of :meth:`params`, None for a parameter nothing reads)."""
        params = list(self.params().values())
        with collectives.data_parallel(self.mesh):
            loss, (sisnr, _) = self._loss(noisy, clean, True)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        loss, sisnr, *grads = collectives.average_over_ranks(
            [loss.detach(), sisnr.detach(), *grads], self.mesh)
        return loss, sisnr, list(grads)

    def train_step(self, noisy: torch.Tensor, clean: torch.Tensor):
        """One step: loss, gradients, the NaN guard (a non-finite loss or
        gradient zeroes every gradient; the optimizer still steps and the
        NaN count goes up), the clipped AdamW update. Returns the (loss,
        sisnr) device scalars."""
        if self.tx is None:
            raise RuntimeError("no optimizer state: call init_state() or "
                               "train() first")
        loss, sisnr, grads = self.loss_and_grads(noisy, clean)
        params = self.params()
        grads, is_bad = guard_nan_update(grads, loss, params.values())
        self.tx.update(params, grads, self.opt_state)
        self.nan_count += is_bad.to(torch.int32)
        self.step += 1
        return loss, sisnr

    def eval_step(self, noisy: torch.Tensor, clean: torch.Tensor,
                  lengths: torch.Tensor):
        """(loss, sisnr, Σ log α, count) of a deterministic forward: α =
        ⟨clean, enh⟩ / ‖enh‖² per utterance over its true samples;
        utterances with α outside (1e-3, 1e3) or not finite are left
        out. With a mesh the inputs are this rank's block and the results
        the global batch's."""
        return self._eval(noisy, clean, lengths, self.mesh)

    @torch.no_grad()
    def _eval(self, noisy, clean, lengths, mesh):
        with collectives.data_parallel(mesh):
            loss, (sisnr, enh) = self._loss(noisy, clean, False)
        m = (torch.arange(clean.shape[-1], device=clean.device)[None, :]
             < lengths[:, None]).to(clean.dtype)
        alpha = (torch.sum(clean * enh * m, -1)
                 / (torch.sum(enh * enh * m, -1) + 1e-12))
        valid = torch.isfinite(alpha) & (alpha > 1e-3) & (alpha < 1e3)
        lg_sum = torch.sum(torch.where(
            valid, torch.log(torch.clamp(alpha, min=1e-12)),
            torch.zeros_like(alpha)))
        return collectives.mean_and_sum_over_ranks(
            (loss, sisnr), (lg_sum, torch.sum(valid)), mesh)

    # ── training loop ───────────────────────────────────────────────────

    def _tensors(self, batch, *keys):
        return [torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in keys]

    def _validate(self, test_ds: WaveformDataset, batch_size: int,
                  bucketed: bool):
        out = [self._eval(*self._tensors(b, "noisy", "clean", "lengths"),
                          mesh)
               for b, mesh in blocks_for_ranks(batch_iterator(
                   test_ds, batch_size, shuffle=False, drop_last=False,
                   bucketed=bucketed), self.mesh)]
        return [[float(x) for x in row] for row in out]   # one sync

    def train(self, train_ds: WaveformDataset, test_ds: WaveformDataset,
              epochs: int | None = None, batch_size: int | None = None,
              verbose: bool = True, bucketed: bool = False,
              resume: bool = False) -> List[dict]:
        """Training with best-by-validation checkpoints; returns one history
        entry per epoch (the JAX package's keys).

        ``resume=True`` restores the newest checkpoint across the final and
        best families (weights, BatchNorm statistics, optimizer state, step
        and NaN count) and continues from the epoch after it; the best
        validation loss comes from the best family's sidecar when it was
        measured under the same ``VAL_PROTOCOL``, else from validating the
        restored model. Otherwise a trainer with no optimizer yet makes one
        (:meth:`init_state`) and one that has it carries on."""
        cfg = self.model.config
        epochs = epochs or cfg.epochs
        batch_size = batch_size or cfg.batch_size
        steps_per_epoch = max(1, len(train_ds) // batch_size)
        start_epoch = 0
        resume_path = None
        primary = data_rank(self.mesh) == 0
        verbose = verbose and primary
        if resume:
            collectives.barrier(self.mesh)       # rank 0's writes are done
            resume_path = newest_checkpoint(self.model_dir, self._CKPT_NAMES)
            if resume_path is None and verbose:
                print("  resume requested but no checkpoint found — "
                      "starting fresh")
        if resume_path is not None:
            self.load_model(resume_path)
            self.init_state(epochs, steps_per_epoch, init_params=False,
                            reset_optimizer=False)
            start_epoch = min(self.step // steps_per_epoch, epochs)
            if verbose:
                print(f"  Resuming from {resume_path} at step {self.step} → "
                      f"epoch {start_epoch + 1}/{epochs}")
        elif self.tx is None:
            self.init_state(epochs, steps_per_epoch, reset_optimizer=False)

        best_val = float("inf")
        if resume_path is not None and start_epoch > 0:
            meta = read_train_meta(self.model_dir, "best_conformer")
            if (meta and np.isfinite(meta.get("best_val", np.inf))
                    and meta.get("val_protocol") == VAL_PROTOCOL):
                best_val = float(meta["best_val"])
            else:
                finite = [row[0] for row in self._validate(
                    test_ds, batch_size, bucketed) if np.isfinite(row[0])]
                if finite:
                    best_val = float(np.mean(finite))

        history = []
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses, sisnrs = [], []      # device scalars: one sync an epoch
            for batch in batch_iterator(train_ds, batch_size, shuffle=True,
                                        seed=self.seed, epoch=epoch,
                                        bucketed=bucketed):
                loss, sisnr = self.train_step(*self._tensors(
                    shard_batch(self.mesh, batch), "noisy", "clean"))
                losses.append(loss)
                sisnrs.append(sisnr)
            n_b = len(losses)
            tr_loss = float(torch.stack(losses).sum() / n_b) if n_b else 0.0
            tr_sisnr = float(torch.stack(sisnrs).sum() / n_b) if n_b else 0.0

            rows = self._validate(test_ds, batch_size, bucketed)
            finite = [r for r in rows if np.isfinite(r[0])]
            # an all-NaN validation epoch is never an improvement
            va_loss = (float(np.mean([r[0] for r in finite])) if finite
                       else float("inf"))
            va_sisnr = (float(np.mean([r[1] for r in finite])) if finite
                        else 0.0)
            lg = [r for r in finite if np.isfinite(r[2])]
            lg_n = sum(int(r[3]) for r in lg)
            if lg_n > 0:
                # one geometric mean over every valid validation utterance
                self.output_gain = float(np.exp(sum(r[2] for r in lg)
                                                / lg_n))

            improved = va_loss < best_val
            if improved:
                best_val = va_loss
                if primary:
                    self.save_model("best_conformer")
                    merge_train_meta(self.model_dir, "best_conformer",
                                     {"best_val": va_loss, "epoch": epoch,
                                      "step": int(self.step),
                                      "val_protocol": VAL_PROTOCOL})
            entry = {"epoch": epoch, "train_loss": tr_loss,
                     "val_loss": va_loss, "val_sisnr": va_sisnr,
                     "nan_count": int(self.nan_count),
                     "epoch_seconds": time.time() - t0}
            history.append(entry)
            if self.logger is not None and primary:
                self.logger.log({"pipeline": "dcse", **entry})
            if verbose:
                print(f"  Epoch {epoch + 1:3d}/{epochs} | "
                      f"Train: {tr_loss:.4f} (SI-SNR: {tr_sisnr:+.2f}) | "
                      f"Val: {va_loss:.4f} (SI-SNR: {va_sisnr:+.2f}) | "
                      f"{time.time() - t0:.1f}s {'*' if improved else ''}",
                      flush=True)
        if verbose:
            print(f"\n  Best validation loss: {best_val:.4f}")
        return history
