"""RBM layer-wise pretraining by contrastive divergence
(``sincformer_tpu/models/rbm.py``): Bernoulli-Bernoulli RBMs with sigmoid
units, ΔW = lr·(⟨v h⟩_data − ⟨v h⟩_recon)/B, stacked over the DNN's hidden
layers.

The Bernoulli samples compare a unit's probability with a uniform draw.
:meth:`RBM.cd_step` takes its uniforms as an argument (2k + 1 tensors, in
the order the JAX package draws them), so that a test can hand both
packages the same ones; training draws them from a seeded
``torch.Generator`` on the data's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sincformer_tpu_torch.config import RBMConfig
from sincformer_tpu_torch.utils.device import resolve_device

Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _sigmoid_clipped(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(torch.clamp(x, -500.0, 500.0))


def cd_uniform_shapes(batch: int, n_visible: int, n_hidden: int,
                      k: int) -> List[Tuple[int, int]]:
    """The shapes of the 2k + 1 uniforms one CD-k step takes, in order:
    the data's hidden sample, then per Gibbs step a visible and a hidden
    sample."""
    return [(batch, n_hidden)] + [(batch, n_visible), (batch, n_hidden)] * k


class RBM:
    """Bernoulli-Bernoulli RBM with CD-k. ``W`` (visible, hidden) is drawn
    from N(0, 0.01²) with ``torch.Generator().manual_seed(seed)`` on the
    CPU and moved to ``device``; the biases start at zero. ``device`` is the
    card unless the caller asks for the CPU; it raises without CUDA."""

    def __init__(self, n_visible: int, n_hidden: int,
                 learning_rate: float | None = None, k_steps: int | None = None,
                 seed: int = 0, rcfg: RBMConfig = RBMConfig(),
                 device="cuda"):
        self.n_visible = n_visible
        self.n_hidden = n_hidden
        self.lr = learning_rate or rcfg.learning_rate
        self.k = k_steps or rcfg.k_steps
        self.rcfg = rcfg
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.W = (0.01 * torch.randn((n_visible, n_hidden), generator=g)
                  ).to(self.device)
        self.v_bias = torch.zeros(n_visible, device=self.device)
        self.h_bias = torch.zeros(n_hidden, device=self.device)

    @property
    def params(self) -> Params:
        return self.W, self.v_bias, self.h_bias

    @staticmethod
    def sample_hidden(params: Params, v: torch.Tensor,
                      u: Optional[torch.Tensor] = None):
        """(P(h=1 | v), the sample ``prob > u``; None without ``u``)."""
        w, _vb, hb = params
        prob = _sigmoid_clipped(v @ w + hb)
        return prob, None if u is None else (prob > u).to(prob.dtype)

    @staticmethod
    def sample_visible(params: Params, h: torch.Tensor,
                       u: Optional[torch.Tensor] = None):
        w, vb, _hb = params
        prob = _sigmoid_clipped(h @ w.T + vb)
        return prob, None if u is None else (prob > u).to(prob.dtype)

    @torch.no_grad()
    def cd_step(self, params: Params, v_data: torch.Tensor,
                uniforms: Sequence[torch.Tensor], lr: float | None = None,
                k: int | None = None) -> Tuple[Params, torch.Tensor]:
        """One CD-k update of ``params`` on the batch ``v_data`` (B,
        visible) with the 2k + 1 ``uniforms`` of :func:`cd_uniform_shapes`;
        returns (new params, the reconstruction's mean squared error)."""
        lr = self.lr if lr is None else lr
        k = self.k if k is None else k
        b = v_data.shape[0]
        pos_h_prob, h_sample = self.sample_hidden(params, v_data, uniforms[0])
        pos_assoc = v_data.T @ pos_h_prob
        neg_v_prob, neg_h_prob = v_data, pos_h_prob
        for i in range(k):
            neg_v_prob, _ = self.sample_visible(params, h_sample,
                                                uniforms[1 + 2 * i])
            neg_h_prob, h_sample = self.sample_hidden(params, neg_v_prob,
                                                      uniforms[2 + 2 * i])
        neg_assoc = neg_v_prob.T @ neg_h_prob
        w, vb, hb = params
        w = w + lr * (pos_assoc - neg_assoc) / b
        vb = vb + lr * torch.mean(v_data - neg_v_prob, dim=0)
        hb = hb + lr * torch.mean(pos_h_prob - neg_h_prob, dim=0)
        err = torch.mean((v_data - neg_v_prob) ** 2)
        return (w, vb, hb), err

    def contrastive_divergence(
            self, v_data, generator: Optional[torch.Generator] = None
    ) -> float:
        """One CD-k step (:meth:`cd_step`) on the batch ``v_data`` that
        updates this RBM's ``W``, ``v_bias`` and ``h_bias``; returns the
        reconstruction error. The uniforms are drawn from ``generator``
        (the device's default generator without one)."""
        v = torch.as_tensor(v_data, dtype=torch.float32).to(self.device)
        params, err = self.cd_step(self.params, v, self.draw_uniforms(
            v.shape[0], generator))
        self.W, self.v_bias, self.h_bias = params
        return float(err)

    def draw_uniforms(self, batch: int, generator: Optional[torch.Generator]
                      ) -> List[torch.Tensor]:
        return [torch.rand(s, generator=generator, device=self.device)
                for s in cd_uniform_shapes(batch, self.n_visible,
                                           self.n_hidden, self.k)]

    def train(self, data, epochs: int | None = None,
              batch_size: int | None = None, verbose: bool = True,
              seed: int = 0) -> List[float]:
        """CD-k over shuffled minibatches: each epoch takes the first
        ``n_batches × batch_size`` of ``np.random.default_rng(seed)``'s
        permutation (the JAX package's order) and draws its uniforms from a
        generator seeded ``seed·1000 + epoch``. Returns the mean
        reconstruction error of each epoch (one host read per epoch)."""
        epochs = epochs or self.rcfg.epochs
        batch_size = batch_size or self.rcfg.batch_size
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        n = data.shape[0]
        batch_size = min(batch_size, n)
        n_batches = max(1, n // batch_size)
        usable = n_batches * batch_size
        params = self.params
        errors = []
        rng = np.random.default_rng(seed)
        for epoch in range(epochs):
            perm = torch.from_numpy(rng.permutation(n)[:usable]).to(
                self.device)
            batches = data[perm].reshape(n_batches, batch_size, -1)
            gen = torch.Generator(device=self.device).manual_seed(
                seed * 1000 + epoch)
            errs = []
            for batch in batches:
                params, err = self.cd_step(
                    params, batch, self.draw_uniforms(batch_size, gen))
                errs.append(err)
            errors.append(float(torch.stack(errs).mean()))
            if verbose:
                print(f"  RBM Epoch {epoch + 1}/{epochs}: "
                      f"Reconstruction Error = {errors[-1]:.6f}")
        self.W, self.v_bias, self.h_bias = params
        return errors

    @torch.no_grad()
    def transform(self, data) -> torch.Tensor:
        """Hidden probabilities, the next layer's input."""
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        return self.sample_hidden(self.params, data)[0]

    def get_weights(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return tuple(t.cpu().numpy() for t in self.params)


def pretrain_dnn_with_rbm(data, layer_sizes: List[int], verbose: bool = True,
                          seed: int = 0, device="cuda",
                          rcfg: RBMConfig = RBMConfig()):
    """Stacked layer-wise pretraining: RBM i (seed ``seed + i``) on the
    hidden probabilities of RBM i - 1. Returns [(W, v_bias, h_bias)] per
    layer as numpy arrays. Runs on the card unless ``device`` is the CPU."""
    device = resolve_device(device)
    rbm_weights = []
    current = torch.as_tensor(data, dtype=torch.float32).to(device)
    for i in range(len(layer_sizes) - 1):
        if verbose:
            print(f"\n--- RBM Layer {i + 1}: {layer_sizes[i]} → "
                  f"{layer_sizes[i + 1]} ---")
        rbm = RBM(layer_sizes[i], layer_sizes[i + 1], seed=seed + i,
                  rcfg=rcfg, device=device)
        rbm.train(current, verbose=verbose, seed=seed + i)
        rbm_weights.append(rbm.get_weights())
        current = rbm.transform(current)
    return rbm_weights
