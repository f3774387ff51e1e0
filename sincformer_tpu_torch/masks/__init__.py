"""Oracle time-frequency masks: IRM, PCIRM and OPT-PCIRM."""

from sincformer_tpu_torch.masks.irm import (  # noqa: F401
    compute_irm, apply_irm)
from sincformer_tpu_torch.masks.pcirm import (  # noqa: F401
    compute_correlation_coefficients, compute_phase_differences,
    compute_pcirm, compute_pcirm_from_signals, apply_pcirm)
from sincformer_tpu_torch.masks.opt_pcirm import (  # noqa: F401
    compute_snr_boundaries, quantize_pcirm, compute_opt_pcirm,
    apply_opt_pcirm)
