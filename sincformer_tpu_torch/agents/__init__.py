"""The multi-agent Sincformer-metacog stack (``sincformer_tpu/agents/``):
the SincConv front-end, the perception, correlation-phase, mask-synthesis
and arbitration agents, the episodic memory, and the wired model
:class:`SincformerMetacog`."""

from sincformer_tpu_torch.agents.sincnet import (  # noqa: F401
    SincConv1d)
from sincformer_tpu_torch.agents.perception import (  # noqa: F401
    PerceptionAgent)
from sincformer_tpu_torch.agents.cpea import (  # noqa: F401
    CorrelationPhaseEstimationAgent)
from sincformer_tpu_torch.agents.msa import (  # noqa: F401
    MaskSynthesisAgent)
from sincformer_tpu_torch.agents.maa import (  # noqa: F401
    MetacognitiveArbitrationAgent)
from sincformer_tpu_torch.agents.memory import (  # noqa: F401
    EpisodicMemory)
from sincformer_tpu_torch.agents.metacog import (  # noqa: F401
    SincformerMetacog)
