"""OPT-PCIRM, the hard mask with a PSO-optimised middle step
(``sincformer_tpu/masks/opt_pcirm.py``):

  n = -log2(lc / (lc + 1)),  lc = 10^(LC/10), LC = -15 dB
  s_m = ((m - 1) / M)^n      (M = 3: {0, ≈0.004, ≈0.13})
  each unit takes the step of the bucket its PCIRM falls in.

``compute_opt_pcirm(use_pso=True)`` searches the middle step with the
particle swarm (``optim/pso.py``) for the STOI of the scalar-gain
reconstruction; each swarm iteration is one batched call on the PCIRM's
device: every particle's quantized mask, reconstruction and STOI at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig, OptPCIRMConfig, PSOConfig


def compute_snr_boundaries(local_criterion_db: float | None = None,
                           num_steps: int | None = None,
                           ocfg: OptPCIRMConfig = OptPCIRMConfig()
                           ) -> Tuple[np.ndarray, float]:
    """(step values (M,), exponent n), host numpy constants."""
    lc_db = (local_criterion_db if local_criterion_db is not None
             else ocfg.local_criterion_db)
    m_steps = num_steps or ocfg.num_steps
    lc = 10.0 ** (lc_db / 10.0)
    n_exp = -np.log2(lc / (lc + 1.0))
    steps = np.array([((m - 1) / m_steps) ** n_exp
                      for m in range(1, m_steps + 1)])
    return steps, float(n_exp)


def quantize_pcirm(pcirm: torch.Tensor, step_values,
                   middle_value=None) -> torch.Tensor:
    """Each unit takes the step value of its bucket: value m where
    bounds[m] <= p < bounds[m + 1], bounds = [0, s_2, ..., s_M, 1] in
    float32, and the last value from 1 on. ``middle_value`` replaces s_2
    (M >= 3): a number, or a tensor that broadcasts against ``pcirm``
    (e.g. (N, 1, 1) for N candidates at once, giving (N, ...))."""
    steps = np.asarray(step_values, dtype=np.float32)
    m = len(steps)
    bounds = np.concatenate([[0.0], steps[1:], [1.0]]).astype(np.float32)
    values = [torch.tensor(float(v), dtype=torch.float32,
                           device=pcirm.device) for v in steps]
    if middle_value is not None and m >= 3:
        values[1] = torch.as_tensor(middle_value, dtype=torch.float32,
                                    device=pcirm.device)
    out = torch.zeros_like(pcirm)
    for i in range(m):
        in_bucket = (pcirm >= float(bounds[i])) & (pcirm < float(bounds[i + 1]))
        out = torch.where(in_bucket, values[i], out)
    return torch.where(pcirm >= float(bounds[-1]), values[-1], out)


def reconstruct_scalar_gain(mask: torch.Tensor, noisy_signal: torch.Tensor,
                            frame_size: int = 160,
                            hop: int = 80) -> torch.Tensor:
    """Channel-averaged per-frame scalar gain, overlap-added: every frame's
    noisy samples scaled by the mask's mean over channels, each sample
    divided by the number of frames over it. ``mask`` (..., C, T),
    ``noisy_signal`` (N,) → (..., N)."""
    n = noisy_signal.shape[-1]
    t = mask.shape[-1]
    gains = torch.mean(mask, dim=-2)                       # (..., T)
    idx = np.arange(t)[:, None] * hop + np.arange(frame_size)[None, :]
    valid = idx < n
    flat = np.minimum(idx, n - 1).reshape(-1)
    weight = np.zeros(n, np.float32)
    np.add.at(weight, flat, valid.astype(np.float32).reshape(-1))
    dev = noisy_signal.device
    flat_t = torch.from_numpy(flat).to(dev)
    valid_t = torch.from_numpy(valid.astype(np.float32)).to(dev)
    contrib = (gains[..., :, None] * valid_t).reshape(*gains.shape[:-1], -1)
    gain_sum = torch.zeros(*gains.shape[:-1], n, dtype=contrib.dtype,
                           device=dev).index_add_(
        -1, flat_t, contrib * noisy_signal[flat_t])
    return gain_sum / torch.from_numpy(np.maximum(weight, 1.0)).to(dev)


def compute_opt_pcirm(pcirm, noisy_signal=None, clean_signal=None,
                      fs: int | None = None, num_steps: int | None = None,
                      use_pso: bool = True, pso_config: dict | None = None,
                      rng=None, fitness: str = "simplified"):
    """OPT-PCIRM of a (C, T) PCIRM tensor: (mask, step values, middle).

    ``use_pso=False``: the fixed-step quantization. With the swarm, the
    middle step maximises the STOI of ``reconstruct_scalar_gain`` against
    ``clean_signal``: ``fitness="simplified"`` is ``stoi_torch`` (the
    reference's fallback STOI) over all particles in one call,
    ``"full"`` the Taal-2011 ``stoi_full_torch`` per particle. ``rng`` is
    the swarm's ``np.random.Generator``; ``pso_config`` overrides
    ``PSOConfig``'s fields."""
    acfg = AudioConfig()
    fs = fs or acfg.sample_rate
    steps, _ = compute_snr_boundaries(num_steps=num_steps)

    if not use_pso:
        return (quantize_pcirm(pcirm, steps), steps,
                steps[1] if len(steps) > 1 else None)

    from sincformer_tpu_torch.optim.pso import ParticleSwarmOptimizer

    batched_fitness = opt_pcirm_fitness(pcirm, noisy_signal, clean_signal,
                                        fs, fitness, steps)
    pcfg = PSOConfig()
    params = dict(num_particles=pcfg.num_particles, max_iter=pcfg.max_iter,
                  w=pcfg.w, c1=pcfg.c1, c2=pcfg.c2, bounds=pcfg.bounds)
    if pso_config:
        params.update(pso_config)
    pso = ParticleSwarmOptimizer(batched_fitness=batched_fitness,
                                 maximize=True, **params)
    best_x, _ = pso.optimize(rng=rng)
    return quantize_pcirm(pcirm, steps, middle_value=best_x), steps, best_x


def opt_pcirm_fitness(pcirm: torch.Tensor, noisy_signal, clean_signal,
                      fs: int | None = None, fitness: str = "simplified",
                      steps=None):
    """The swarm's fitness: a function of (N,) middle-step values that
    returns their (N,) STOIs (numpy), each the STOI against
    ``clean_signal`` of ``reconstruct_scalar_gain`` of the PCIRM quantized
    with that middle step, computed on the PCIRM's device: all N at once
    for ``fitness="simplified"`` (``stoi_torch``), one
    ``stoi_full_torch`` each for ``"full"``."""
    from sincformer_tpu_torch.evaluation.stoi import (stoi_full_torch,
                                                      stoi_torch)
    acfg = AudioConfig()
    fs = fs or acfg.sample_rate
    steps = compute_snr_boundaries()[0] if steps is None else steps
    dev = pcirm.device
    noisy = torch.as_tensor(np.asarray(noisy_signal, np.float32), device=dev)
    clean = torch.as_tensor(np.asarray(clean_signal, np.float32), device=dev)

    def batched_fitness(xs: np.ndarray) -> np.ndarray:
        middle = torch.as_tensor(np.asarray(xs, np.float32),
                                 device=dev)[:, None, None]
        cand = quantize_pcirm(pcirm, steps, middle_value=middle)
        enhanced = reconstruct_scalar_gain(cand, noisy, acfg.frame_size,
                                           acfg.hop_size)         # (N, n)
        if fitness == "full":
            scores = torch.stack([stoi_full_torch(clean, e, fs, device=dev)
                                  for e in enhanced])
        else:
            scores = stoi_torch(clean.expand_as(enhanced), enhanced, fs)
        return scores.cpu().numpy()

    return batched_fitness


def apply_opt_pcirm(noisy_tf, opt_pcirm):
    """Enhanced = OPT-PCIRM ⊙ noisy."""
    return noisy_tf * opt_pcirm
