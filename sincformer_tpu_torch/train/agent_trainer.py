"""Training half of the flagship pipeline
(``sincformer_tpu/train/agent_trainer.py``): the loss, the train and eval
steps, the curriculum loop with its per-epoch re-mixing, the Gumbel
temperature annealing, the validation-calibrated output gain, and best,
final and resumable checkpoints: :class:`SincformerTrainer`, the serving
``pipeline.SincformerPipeline`` with the training methods and the optimizer
state in its checkpoints (the JAX package keeps both halves in one class).

Curriculum (train/curriculum.py), one loss for every stage with the stage's
terms switched by scalars:

  stage 1: SI-SNR + 0.5·L1-magnitude + MR-STFT + mask MSE against the oracle
           PCIRM, high SNRs only;
  stage 2: + the perceptual STOI loss, a widening SNR range;
  stage 3: + the VQ loss, every SNR, and with ``use_adversarial`` the
           LSGAN generator term and feature matching against a multi-scale
           spectral discriminator (``train/adversarial.py``), which takes its
           own Adam step after each generator step.

Random draws come from explicit generators: the weights from ``seed``,
dropout from ``seed + 1``, the Gumbel routing from ``seed + 2`` and the
discriminator's weights from ``seed + 5`` (the JAX package's keys), all on
the pipeline's device. One step makes no
host synchronisation: the NaN guard, the clip and the AdamW update stay on
the device; the losses are read once per epoch.

Data parallelism (``mesh=``, a DeviceMesh with a ``"data"`` axis, JAX's
``mesh``): the parameters and optimizer states start as rank 0's; each rank
takes its block of every batch that ``batch_iterator`` yields to one
process (``parallel.shard_batch``); the batch-wide reductions inside the
step are global (``parallel/collectives.py``: the MAA statistics, the
episodic write and its counts, the MR-STFT spectral convergence, the NaN
flag), the gradients and the reported losses are averaged over the ranks
before the guard and the clip, and the discriminator's step is
data-parallel the same way. Validation batches are split too (a batch
that does not divide runs whole on every rank) and their sums
all-reduced. Only rank 0 writes checkpoints, sidecars and logs; a resume
reads after a barrier. The ranks' parameters stay bit-identical. Each rank
draws its dropout and Gumbel noise from its own generators (seeds offset
by the rank; rank 0's are a single process's), where JAX draws the global
batch's.

Tensor parallelism (a mesh with a ``"model"`` axis of several ranks, as in
JAX, ``parallel/sharding.py``): after the broadcast each rank keeps only
its slice of every parameter the JAX rule splits, and of its AdamW
moments; the forward and backward run inside
``collectives.model_parallel`` (each split layer computes its column block
and gathers); the clip and the NaN guard read the gradients' global norm
(``collectives.global_norm``); the replicated leaves' gradients are
averaged over the model ranks, so they stay bit-identical. The
ranks of one model group take the same rows and draw the same noise. A
checkpoint gathers every leaf and is written whole by the first rank, in
the unsharded format; a resume re-shards it. The discriminator stays
replicated, as in JAX.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.agents.metacog import SincformerMetacog
from sincformer_tpu_torch.config import (AGENTS, AudioConfig,
                                         DataConfig, LossConfig,
                                         MetacogConfig)
from sincformer_tpu_torch.data.loader import (WaveformDataset, batch_iterator,
                                              heldout_noises, remix_for_stage)
from sincformer_tpu_torch.dsp.stft import istft, stft
from sincformer_tpu_torch.masks.pcirm import (compute_correlation_coefficients,
                                              compute_pcirm,
                                              compute_phase_differences)
from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel.mesh import (blocks_for_ranks, data_rank,
                                                model_rank, rank_seed,
                                                shard_batch)
from sincformer_tpu_torch.parallel.sharding import (shard_state_params,
                                                    split_flags)
from sincformer_tpu_torch.pipeline import SincformerPipeline
from sincformer_tpu_torch.train.adversarial import (MultiScaleDiscriminator,
                                                    discriminator_loss,
                                                    feature_matching_loss,
                                                    generator_loss)
from sincformer_tpu_torch.train.curriculum import CurriculumScheduler
from sincformer_tpu_torch.train.losses import (PerceptualSTOILoss,
                                               mse_mask_loss,
                                               multi_resolution_stft_loss,
                                               si_snr_loss)
from sincformer_tpu_torch.train.state import (VAL_PROTOCOL, Adam,
                                              broadcast_state,
                                              gathered_state,
                                              guard_nan_update, guarded,
                                              make_adamw, merge_train_meta,
                                              newest_checkpoint,
                                              opt_state_to,
                                              read_train_meta,
                                              restore_checkpoint,
                                              restore_training_state,
                                              save_checkpoint)

LR = 5e-4           # peak of the warmup-cosine schedule
DISC_LR = 2e-4      # the discriminator's constant Adam rate


def default_metacog(**overrides) -> SincformerMetacog:
    """The flagship as the ``train`` verb builds it, as in the JAX package:
    the fine stream read at import (:data:`config.AGENTS`, from
    ``SINCFORMER_PA_FINE_ACT`` and ``SINCFORMER_PA_FINE_FEATS``), the depth
    from ``SINCFORMER_MSA_BLOCKS``; ``overrides`` (e.g. ``cpea_impl="ssm"``,
    ``pa_impl="reference"``) set any field."""
    kw = {"msa_blocks": int(os.environ.get("SINCFORMER_MSA_BLOCKS", "4")),
          "pa_fine_act": AGENTS.pa_fine_act,
          "pa_fine_feats": AGENTS.pa_fine_feats}
    kw.update(overrides)
    return SincformerMetacog(MetacogConfig(**kw))


class SincformerTrainer(SincformerPipeline):
    """Curriculum training of the flagship, and its serving. ``seed`` draws
    the weights (when none were loaded), the dropout masks and the Gumbel
    noise; ``logger`` (a ``utils.observability.MetricsLogger``) takes one
    record per epoch. ``use_adversarial=True`` adds the discriminator
    (``self.disc``, with its Adam state ``disc_opt_state``): its term enters
    the loss in stage 3, and every training step is followed by its own
    step, gated by the stage (:meth:`disc_step`); a full checkpoint then has
    a ``<name>_disc`` sibling at the generator's step. As in the JAX
    pipeline, training starts from weights drawn from ``seed`` unless a
    checkpoint or a state was loaded (``load_model``, ``load_state``,
    ``load_disc_state``): a model given to the constructor is its
    skeleton. ``mesh`` (a DeviceMesh with a ``"data"`` axis) makes the
    training data-parallel over its ranks (module docstring)."""

    _CKPT_NAMES = ("sincformer_final", "best_sincformer")

    def __init__(self, model=None, device="cuda", output_gain: float = 1.0,
                 audio: AudioConfig = AudioConfig(),
                 model_dir: Optional[str] = None, seed: int = 0,
                 logger=None, use_adversarial: bool = False, mesh=None):
        super().__init__(model, device, output_gain, audio, model_dir)
        loss = LossConfig()
        self.seed = seed
        self.mesh = mesh
        self.perceptual_weight = loss.perceptual_weight
        self.vq_weight = loss.commitment_weight
        self.mask_mse_weight = loss.mask_mse_weight
        self.adv_weight = loss.adversarial_weight
        self.disc = (MultiScaleDiscriminator(self.audio.n_freq).to(
            self.device) if use_adversarial else None)
        self.disc_tx = Adam(DISC_LR) if use_adversarial else None
        self.disc_opt_state = None
        # the detached (enhanced, clean) magnitudes of the last training
        # forward: what the discriminator's step takes
        self.last_mags = None
        self.disc_loss = None
        self.stoi_loss = PerceptualSTOILoss(self.audio.sample_rate,
                                            self.audio.fft_size)
        self.logger = logger
        self.curriculum = CurriculumScheduler()
        self.tx = None                     # train.state.AdamW
        self.opt_state = None
        self.nan_count = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self.dropout_generator = None
        self.routing_generator = None
        self._weights_loaded = False
        self._disc_loaded = False

    # ── checkpoints: the serving ones plus the optimizer state ─────────

    def load_state(self, state_dict, buffers=None) -> None:
        if any(split_flags(self.model)):   # whole tensors: unsplit skeleton
            self.model = type(self.model)(self.model.config).to(
                self.device).eval()
        super().load_state(state_dict, buffers)
        self._weights_loaded = True

    def load_disc_state(self, params, opt_state=None) -> None:
        """Load the discriminator's parameters (every one, by name) and,
        given, its Adam state ``{"mu", "nu", "count"}``."""
        self.disc.load_state_dict(dict(params), strict=True)
        self._disc_loaded = True
        if opt_state is not None:
            self.disc_opt_state = opt_state_to(opt_state, self.device)

    def save_model(self, name: Optional[str] = None,
                   quantize: bool = False) -> Optional[str]:
        """As the serving pipeline, the optimizer state and NaN count
        included once training has made them; the discriminator with its
        Adam state goes to the ``<name>_disc`` family at the generator's
        step. With a model axis every model rank calls it (the split
        leaves are gathered) and the first writes; the others return
        None."""
        if model_rank(self.mesh) != 0:
            self._checkpoint_state(quantize)
            return None
        path = super().save_model(name, quantize)
        if (not quantize and self.opt_state is not None
                and self.disc is not None
                and self.disc_opt_state is not None):
            save_checkpoint(os.path.join(self.model_dir,
                                         (name or self.FINAL_NAME) + "_disc"),
                            {"params": dict(self.disc.named_parameters()),
                             "opt_state": self.disc_opt_state}, self.step)
        return path

    def _checkpoint_state(self, quantize: bool) -> dict:
        """As the serving pipeline's; with a model axis every split
        parameter and its AdamW moments gathered whole (a collective)."""
        return gathered_state(super()._checkpoint_state(quantize),
                              self.model, self.mesh)

    def load_model(self, path: Optional[str] = None) -> str:
        """As the serving pipeline (the model rebuilt as the checkpoint's
        variant and sizes, whatever the constructor was given), and the
        optimizer state and NaN count of a full checkpoint (none from a
        serving one)."""
        path = super().load_model(path)
        self.opt_state, self.nan_count = restore_training_state(path,
                                                                self.device)
        return path

    def _enhanced_spec(self, wav, spec):
        with collectives.model_parallel(self.mesh):
            return super()._enhanced_spec(wav, spec)

    # ── state ───────────────────────────────────────────────────────────

    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable leaves, by name (CPEA K and b separately)."""
        return dict(self.model.named_parameters())

    def init_state(self, epochs: int, steps_per_epoch: int,
                   init_params: Optional[bool] = None,
                   reset_optimizer: bool = True) -> None:
        """The optimizer for ``epochs`` × ``steps_per_epoch`` steps and its
        zero state (``reset_optimizer=False`` keeps a restored one), fresh
        generators, and, unless weights were loaded or drawn already
        (``init_params`` overrides), weights drawn from ``seed``. With the
        adversarial branch, the same for the discriminator: weights drawn
        from ``seed + 5`` unless loaded, and its Adam state."""
        if init_params is None:
            init_params = not self._weights_loaded
        if init_params:
            self.model.init_params(torch.Generator().manual_seed(self.seed))
            self._weights_loaded = True
        self.tx = make_adamw(LR, epochs, steps_per_epoch)
        if reset_optimizer or self.opt_state is None:
            self.opt_state = self.tx.init(self.params())
        if self.disc is not None:
            if init_params or not self._disc_loaded:
                self.disc.init_params(
                    torch.Generator().manual_seed(self.seed + 5))
                self._disc_loaded = True
            if reset_optimizer or self.disc_opt_state is None:
                self.disc_opt_state = self.disc_tx.init(
                    dict(self.disc.named_parameters()))
        seed = rank_seed(self.seed, self.mesh)
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.routing_generator = torch.Generator(
            device=self.device).manual_seed(seed + 2)
        if self.mesh is not None:
            self._broadcast_state()
            self.opt_state = shard_state_params(self.model, self.opt_state,
                                                self.mesh)

    def _broadcast_state(self) -> None:
        """Rank 0's parameters, buffers and optimizer states on every rank
        of the mesh (also the discriminator's); a split parameter's slice
        and moments go over the data axis only."""
        extra = []
        if self.disc is not None:
            extra = [*self.disc.parameters(),
                     *self.disc_opt_state["mu"].values(),
                     *self.disc_opt_state["nu"].values()]
        broadcast_state(self.model, self.opt_state, self.mesh, extra)

    # ── loss ────────────────────────────────────────────────────────────

    def _loss(self, noisy: torch.Tensor, clean: torch.Tensor, train: bool,
              use_perceptual: float, use_vq: float, gumbel_tau=None,
              use_mask_mse: Optional[float] = None,
              use_adv: Optional[float] = None):
        """(total, aux). ``use_perceptual``, ``use_vq``, ``use_mask_mse``
        and ``use_adv`` weight their terms (0 or 1 by curriculum stage);
        every term is computed whatever its weight, as in the JAX package.
        The adversarial term (given ``use_adv`` and a discriminator) reads
        the discriminator's parameters but gives them no gradient."""
        a = self.audio
        n_fft, hop, frame = a.fft_size, a.hop_size, a.frame_size
        noisy_spec = stft(noisy, n_fft, hop, frame)
        clean_spec = stft(clean, n_fft, hop, frame)
        out = self.model(noisy, noisy_spec.real, noisy_spec.imag, train=train,
                         gumbel_tau=gumbel_tau,
                         dropout_generator=(self.dropout_generator
                                            if train else None),
                         routing_generator=(self.routing_generator
                                            if train else None))
        enh_r, enh_i = out["enhanced_real"], out["enhanced_imag"]
        enh_wav = istft(torch.complex(enh_r, enh_i), n_fft, hop, frame,
                        length=clean.shape[-1])

        loss_sisnr = si_snr_loss(enh_wav, clean)
        enh_mag = torch.sqrt(enh_r ** 2 + enh_i ** 2 + 1e-8)
        clean_mag = torch.sqrt(clean_spec.real ** 2 + clean_spec.imag ** 2
                               + 1e-8)
        loss_mag = torch.mean(torch.abs(enh_mag - clean_mag))
        loss_stft = multi_resolution_stft_loss(enh_wav, clean)
        loss_stoi = self.stoi_loss(enh_mag.transpose(1, 2),
                                   clean_mag.transpose(1, 2))
        total = (loss_sisnr + 0.5 * loss_mag + loss_stft
                 + use_perceptual * self.perceptual_weight * loss_stoi
                 + use_vq * self.vq_weight * out["vq_loss"])
        if use_mask_mse is not None:
            # mask-domain supervision against the oracle PCIRM on the STFT
            # grid, from the mixture's own (clean, noise) decomposition
            with torch.no_grad():
                noise_r = noisy_spec.real - clean_spec.real
                noise_i = noisy_spec.imag - clean_spec.imag
                noise_mag = torch.sqrt(noise_r ** 2 + noise_i ** 2 + 1e-8)
                noisy_mag = torch.sqrt(noisy_spec.real ** 2
                                       + noisy_spec.imag ** 2 + 1e-8)
                phi1, phi2 = compute_phase_differences(
                    torch.atan2(noisy_spec.imag, noisy_spec.real),
                    torch.atan2(clean_spec.imag, clean_spec.real),
                    torch.atan2(noise_i, noise_r))
                rho_s, rho_n = compute_correlation_coefficients(
                    noisy_mag, clean_mag, noise_mag, per_unit=True)
                oracle = compute_pcirm(clean_mag, noise_mag, rho_s, rho_n,
                                       phi1, phi2)
            t_m = out["mask_mag"].shape[1]
            loss_mask = mse_mask_loss(out["mask_mag"], oracle[:, :t_m])
            total = total + use_mask_mse * self.mask_mse_weight * loss_mask
        if use_adv is not None and self.disc is not None:
            outs_fake = self.disc(enh_mag)
            outs_real = self.disc(clean_mag)
            g_loss = (generator_loss(outs_fake)
                      + 0.1 * feature_matching_loss(outs_real, outs_fake))
            total = total + use_adv * self.adv_weight * g_loss
        aux = {"sisnr": -loss_sisnr, "stoi_loss": loss_stoi,
               "vq_loss": out["vq_loss"], "enh_mag": enh_mag,
               "clean_mag": clean_mag, "enh_wav": enh_wav, "out": out}
        return total, aux

    def loss_and_grads(self, noisy: torch.Tensor, clean: torch.Tensor,
                       use_perceptual: float, use_vq: float, gumbel_tau=None,
                       use_mask_mse: Optional[float] = 1.0,
                       use_adv: Optional[float] = None):
        """A training forward and its gradients: (loss, sisnr, grads in the
        order of :meth:`params`, None for a parameter nothing reads). The
        model's buffers (MAA statistics, episodic bank, usage counters)
        take their training updates, and ``last_mags`` the detached
        magnitudes that the discriminator's step takes."""
        params = list(self.params().values())
        with collectives.data_parallel(self.mesh), \
                collectives.model_parallel(self.mesh):
            loss, aux = self._loss(noisy, clean, True, use_perceptual,
                                   use_vq, gumbel_tau, use_mask_mse, use_adv)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        self.last_mags = (aux["enh_mag"].detach(), aux["clean_mag"].detach())
        loss, sisnr, *grads = collectives.average_over_ranks(
            [loss.detach(), aux["sisnr"].detach(), *grads], self.mesh)
        return loss, sisnr, collectives.average_replicated(
            grads, split_flags(self.model), self.mesh)

    def disc_loss_and_grads(self, enh_mag: torch.Tensor,
                            clean_mag: torch.Tensor):
        """The discriminator's LSGAN loss on (clean, enhanced) magnitudes
        and its gradients, in the order of ``disc.named_parameters()``."""
        params = list(self.disc.parameters())
        with torch.enable_grad():
            dl = discriminator_loss(self.disc(clean_mag), self.disc(enh_mag))
            grads = torch.autograd.grad(dl, params, allow_unused=True)
        dl, *grads = collectives.average_over_ranks([dl.detach(), *grads],
                                                    self.mesh)
        return dl, list(grads)

    def disc_step(self, use_adv: float) -> torch.Tensor:
        """The discriminator's step on the magnitudes of the last training
        forward: its gradients times ``use_adv``, the NaN guard, the clipped
        Adam update. The update is taken at ``use_adv`` = 0 too (zero
        gradients: the count advances and the moments decay), as in JAX.
        Returns the loss, a device scalar."""
        dl, grads = self.disc_loss_and_grads(*self.last_mags)
        params = dict(self.disc.named_parameters())
        grads = [None if g is None else g * use_adv for g in grads]
        grads, _ = guard_nan_update(grads, dl, params.values())
        self.disc_tx.update(params, grads, self.disc_opt_state)
        return dl

    def train_step(self, noisy: torch.Tensor, clean: torch.Tensor,
                   use_perceptual: float, use_vq: float, gumbel_tau=None,
                   use_mask_mse: float = 1.0, use_adv: float = 0.0):
        """One step: loss, gradients, the NaN guard (a non-finite loss or
        gradient zeroes every gradient, and the optimizer still steps), the
        clipped AdamW update; with the adversarial branch, then the
        discriminator's step (:meth:`disc_step`), whose loss is kept in
        ``disc_loss``. Returns the (loss, sisnr) device scalars."""
        if self.tx is None:
            raise RuntimeError("no optimizer state: call init_state() or "
                               "train() first")
        adv = use_adv if self.disc is not None else None
        loss, sisnr, grads = self.loss_and_grads(
            noisy, clean, use_perceptual, use_vq, gumbel_tau, use_mask_mse,
            adv)
        params = self.params()
        grads, is_bad, norm = guarded(grads, loss, params, self.model,
                                      self.mesh)
        self.tx.update(params, grads, self.opt_state, norm=norm)
        self.nan_count += is_bad.to(torch.int32)
        self.step += 1
        if self.disc is not None:
            self.disc_loss = self.disc_step(use_adv)
        return loss, sisnr

    def eval_step(self, noisy: torch.Tensor, clean: torch.Tensor,
                  lengths: torch.Tensor):
        """(loss, sisnr, Σ log α, count): α = ⟨clean, enh⟩ / ‖enh‖² per
        utterance over its true samples, the oracle output gain; utterances
        with α outside (1e-3, 1e3) or not finite are left out. With a mesh
        the inputs are this rank's block and the results the global
        batch's (the means averaged, the sums summed over the ranks)."""
        return self._eval(noisy, clean, lengths, self.mesh)

    @torch.no_grad()
    def _eval(self, noisy, clean, lengths, mesh):
        with collectives.data_parallel(mesh), \
                collectives.model_parallel(self.mesh):
            loss, aux = self._loss(noisy, clean, False, 1.0, 1.0)
        enh = aux["enh_wav"]
        m = (torch.arange(clean.shape[-1], device=clean.device)[None, :]
             < lengths[:, None]).to(clean.dtype)
        alpha = (torch.sum(clean * enh * m, -1)
                 / (torch.sum(enh * enh * m, -1) + 1e-12))
        valid = torch.isfinite(alpha) & (alpha > 1e-3) & (alpha < 1e3)
        lg_sum = torch.sum(torch.where(
            valid, torch.log(torch.clamp(alpha, min=1e-12)),
            torch.zeros_like(alpha)))
        return collectives.mean_and_sum_over_ranks(
            (loss, aux["sisnr"]), (lg_sum, torch.sum(valid)), mesh)

    # ── curriculum data ─────────────────────────────────────────────────

    remix_for_stage = staticmethod(remix_for_stage)

    def _tensors(self, batch, *keys):
        return [torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in keys]

    def _validate(self, test_ds: WaveformDataset, batch_size: int):
        out = [self._eval(*self._tensors(b, "noisy", "clean", "lengths"),
                          mesh)
               for b, mesh in blocks_for_ranks(batch_iterator(
                   test_ds, batch_size, shuffle=False, drop_last=False),
                   self.mesh)]
        return [[float(x) for x in row] for row in out]   # one sync

    def _restore_disc(self, resume_path: str, verbose: bool) -> None:
        """The discriminator and its Adam state from the ``_disc`` sibling
        saved at the generator's step; a checkpoint without one (saved
        without the adversarial branch) leaves the fresh discriminator,
        with a RuntimeWarning."""
        dpath = os.path.join(os.path.dirname(resume_path) + "_disc",
                             os.path.basename(resume_path))
        if os.path.isdir(dpath):
            restored = restore_checkpoint(dpath)
            self.load_disc_state(restored["params"], restored["opt_state"])
            if verbose:
                print(f"  Restored discriminator from {dpath}")
        else:
            warnings.warn(
                f"adversarial resume: no discriminator checkpoint at {dpath} "
                f"(a generator-only checkpoint); the discriminator restarts "
                f"from init", RuntimeWarning)

    # ── training loop ───────────────────────────────────────────────────

    def train(self, clean_train: Sequence[np.ndarray],
              clean_test: Sequence[np.ndarray],
              noises: Dict[str, np.ndarray], epochs: Optional[int] = None,
              batch_size: int = 8, max_len: Optional[int] = None,
              verbose: bool = True, resume: bool = False) -> List[dict]:
        """Curriculum training from clean sources; returns one history
        entry per epoch (the JAX package's keys).

        ``resume=True`` restores the newest checkpoint across the final and
        best families (parameters, buffers, optimizer state, step and NaN
        count) and continues from the epoch after the one it was saved at.
        Otherwise a pipeline with no training state yet makes one
        (:meth:`init_state`) and one that has it carries on, as in JAX."""
        fs = self.audio.sample_rate
        max_len = max_len or int(fs * DataConfig().max_wave_seconds)
        epochs = epochs or self.curriculum.total_epochs
        steps_per_epoch = max(1, len(clean_train) // batch_size)
        start_epoch = 0
        resume_path = None
        primary = data_rank(self.mesh) == 0      # its model group saves
        writer = primary and model_rank(self.mesh) == 0
        verbose = verbose and writer
        if resume:
            collectives.barrier(self.mesh)       # rank 0's writes are done
            resume_path = newest_checkpoint(self.model_dir, self._CKPT_NAMES)
            if resume_path is None and verbose:
                print("  --resume requested but no checkpoint found — "
                      "starting fresh")
        if resume_path is not None:
            self.load_model(resume_path)
            self.init_state(epochs, steps_per_epoch, init_params=False,
                            reset_optimizer=False)
            start_epoch = min(self.step // steps_per_epoch, epochs)
            if verbose:
                print(f"  Resuming from {resume_path} at step {self.step} → "
                      f"epoch {start_epoch + 1}/{epochs}")
            if self.disc is not None:
                self._restore_disc(resume_path, verbose)
        elif self.tx is None:
            # a state already made or restored (load_model) carries on
            self.init_state(epochs, steps_per_epoch, reset_optimizer=False)

        test_ds = self.remix_for_stage(clean_test, heldout_noises(noises),
                                       list(DataConfig().snr_levels),
                                       max_len, 0)
        best_val = float("inf")
        if resume_path is not None and start_epoch > 0:
            meta = read_train_meta(self.model_dir, "best_sincformer")
            if (meta and np.isfinite(meta.get("best_val", np.inf))
                    and meta.get("val_protocol") == VAL_PROTOCOL):
                best_val = float(meta["best_val"])
            else:
                finite = [row[0] for row in self._validate(test_ds,
                                                           batch_size)
                          if np.isfinite(row[0])]
                if finite:
                    best_val = float(np.mean(finite))

        history = []
        last_stage = None
        for epoch in range(start_epoch, epochs):
            stage = self.curriculum.get_stage(epoch)
            if verbose and stage["stage"] != last_stage:
                print(f"  → {stage['description']}")
                last_stage = stage["stage"]
            loss_type = stage["loss_type"]
            use_perc = 1.0 if "perceptual" in loss_type else 0.0
            use_vq = 1.0 if stage["use_vq"] else 0.0
            use_mmse = 1.0 if "mse" in loss_type else 0.0
            use_adv = 1.0 if "adversarial" in loss_type else 0.0
            # Gumbel temperature 2.0 → 0.5 over the run
            gumbel_tau = max(0.5, 2.0 * float(np.exp(
                -3.0 * epoch / max(epochs - 1, 1))))

            train_ds = self.remix_for_stage(clean_train, noises,
                                            stage["snr_levels"], max_len,
                                            epoch)
            t0 = time.time()
            losses, sisnrs = [], []      # device scalars: one sync an epoch
            for batch in batch_iterator(train_ds, batch_size, shuffle=True,
                                        seed=self.seed, epoch=epoch):
                batch = shard_batch(self.mesh, batch)
                noisy, clean = self._tensors(batch, "noisy", "clean")
                loss, sisnr = self.train_step(noisy, clean, use_perc, use_vq,
                                              gumbel_tau, use_mmse, use_adv)
                losses.append(loss)
                sisnrs.append(sisnr)
            n_b = len(losses)
            tr_loss = float(torch.stack(losses).sum() / n_b) if n_b else 0.0
            tr_sisnr = float(torch.stack(sisnrs).sum() / n_b) if n_b else 0.0

            rows = self._validate(test_ds, batch_size)
            finite = [r for r in rows if np.isfinite(r[0])]
            # an all-NaN validation epoch is never an improvement
            va_loss = (float(np.mean([r[0] for r in finite])) if finite
                       else float("inf"))
            va_sisnr = (float(np.mean([r[1] for r in finite])) if finite
                        else 0.0)
            lg = [r for r in finite if np.isfinite(r[2])]
            lg_n = sum(int(r[3]) for r in lg)
            if lg_n > 0:
                # this epoch's weights with this epoch's calibrated gain
                self.output_gain = float(np.exp(sum(r[2] for r in lg)
                                                / lg_n))

            improved = va_loss < best_val
            if improved:
                best_val = va_loss
                if primary:
                    self.save_model("best_sincformer")
                if writer:
                    merge_train_meta(self.model_dir, "best_sincformer",
                                     {"best_val": va_loss, "epoch": epoch,
                                      "step": int(self.step),
                                      "val_protocol": VAL_PROTOCOL})
            entry = {"epoch": epoch, "stage": stage["stage"],
                     "train_loss": tr_loss, "val_loss": va_loss,
                     "val_sisnr": va_sisnr,
                     "nan_count": int(self.nan_count),
                     "epoch_seconds": time.time() - t0}
            history.append(entry)
            if self.logger is not None and writer:
                self.logger.log({"pipeline": "sincformer", **entry})
            if verbose:
                print(f"  Epoch {epoch + 1:3d}/{epochs} "
                      f"[S{stage['stage']}] | "
                      f"Train: {tr_loss:.4f} (SI-SNR: {tr_sisnr:+.2f}) | "
                      f"Val: {va_loss:.4f} (SI-SNR: {va_sisnr:+.2f}) | "
                      f"{time.time() - t0:.1f}s {'*' if improved else ''}",
                      flush=True)
        return history
