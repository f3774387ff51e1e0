"""Classical optimizers: the particle swarm of OPT-PCIRM."""

from sincformer_tpu_torch.optim.pso import (  # noqa: F401
    ParticleSwarmOptimizer)
