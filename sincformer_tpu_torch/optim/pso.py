"""Particle swarm optimisation with a batched fitness
(``sincformer_tpu/optim/pso.py``, numpy in both packages: the same
``np.random.Generator`` gives the same swarm):

    v ← w·v + c1·r1·(pbest − x) + c2·r2·(gbest − x)
    x ← x + v        (velocity clamped to ±0.5·range, reflecting bounds,
                      stop when std(x) < 1e-6)

Every iteration evaluates the whole swarm in one call of
``batched_fitness`` ((N,) positions → (N,) fitness values) and updates the
global best once per iteration (synchronous PSO).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from sincformer_tpu_torch.config import PSOConfig


class ParticleSwarmOptimizer:
    """Scalar-parameter PSO (the OPT-PCIRM middle-step search).

    Args:
        batched_fitness: (N,) positions → (N,) fitness values.
        fitness_fn: a scalar x → fitness instead, looped on the host.
        maximize: maximise (STOI) or minimise.
    """

    def __init__(self, fitness_fn: Optional[Callable] = None,
                 batched_fitness: Optional[Callable] = None,
                 num_particles: int | None = None, max_iter: int | None = None,
                 w: float | None = None, c1: float | None = None,
                 c2: float | None = None,
                 bounds: Tuple[float, float] | None = None,
                 maximize: bool = True, verbose: bool = False,
                 pcfg: PSOConfig = PSOConfig()):
        if batched_fitness is None and fitness_fn is None:
            raise ValueError("need fitness_fn or batched_fitness")
        if batched_fitness is None:
            def batched_fitness(xs):
                return np.array([float(fitness_fn(float(x))) for x in xs])
        self.batched_fitness = batched_fitness
        self.N = num_particles or pcfg.num_particles
        self.max_iter = max_iter or pcfg.max_iter
        self.w = pcfg.w if w is None else w
        self.c1 = pcfg.c1 if c1 is None else c1
        self.c2 = pcfg.c2 if c2 is None else c2
        self.lb, self.ub = bounds or pcfg.bounds
        self.maximize = maximize
        self.verbose = verbose
        self.history = {"gbest_fitness": [], "gbest_position": [],
                        "mean_fitness": []}

    def optimize(self, rng: np.random.Generator | None = None
                 ) -> Tuple[float, float]:
        """Run the swarm. Returns (best_position, best_fitness)."""
        rng = rng or np.random.default_rng()
        lb, ub = self.lb, self.ub
        sign = 1.0 if self.maximize else -1.0

        x = rng.uniform(lb, ub, self.N)
        v = rng.uniform(-(ub - lb) * 0.1, (ub - lb) * 0.1, self.N)

        fit = sign * np.asarray(self.batched_fitness(x), dtype=np.float64)
        pbest_x = x.copy()
        pbest_f = fit.copy()
        g_idx = int(np.argmax(fit))
        gbest_x, gbest_f = x[g_idx], fit[g_idx]
        self._record(gbest_f * sign, gbest_x, fit * sign)

        max_v = (ub - lb) * 0.5
        for it in range(self.max_iter):
            r1 = rng.random(self.N)
            r2 = rng.random(self.N)
            v = (self.w * v + self.c1 * r1 * (pbest_x - x)
                 + self.c2 * r2 * (gbest_x - x))
            v = np.clip(v, -max_v, max_v)
            x = x + v
            low = x < lb                    # reflecting boundaries
            high = x > ub
            x[low] = lb
            v[low] = np.abs(v[low]) * 0.5
            x[high] = ub
            v[high] = -np.abs(v[high]) * 0.5

            fit = sign * np.asarray(self.batched_fitness(x), dtype=np.float64)
            improved = fit > pbest_f
            pbest_f[improved] = fit[improved]
            pbest_x[improved] = x[improved]
            b = int(np.argmax(pbest_f))
            if pbest_f[b] > gbest_f:
                gbest_f = pbest_f[b]
                gbest_x = pbest_x[b]

            self._record(gbest_f * sign, gbest_x, fit * sign)
            if self.verbose and (it + 1) % 10 == 0:
                print(f"  PSO iter {it + 1}/{self.max_iter}: "
                      f"gbest={gbest_x:.4f}, fitness={gbest_f * sign:.4f}")
            if np.std(x) < 1e-6:            # converged
                if self.verbose:
                    print(f"  PSO converged at iteration {it + 1}")
                break

        return float(gbest_x), float(gbest_f * sign)

    def _record(self, gf, gx, fits):
        self.history["gbest_fitness"].append(float(gf))
        self.history["gbest_position"].append(float(gx))
        self.history["mean_fitness"].append(float(np.mean(fits)))

    def get_convergence_history(self):
        return self.history
