"""Training: the losses and the flagship's curriculum (the trainers are
``agent_trainer``, ``dcse_trainer`` and ``dnn_trainer``)."""

from sincformer_tpu_torch.train.losses import (  # noqa: F401
    si_snr_loss, multi_resolution_stft_loss, mse_mask_loss,
    PerceptualSTOILoss, perceptual_stoi_loss)
from sincformer_tpu_torch.train.curriculum import (  # noqa: F401
    CurriculumScheduler)
