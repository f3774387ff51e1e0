"""Three-stage curriculum of flagship training
(``sincformer_tpu/train/curriculum.py``): the same stage dictionaries.

Stage 1 (15 ep): high-SNR [5,10], MSE mask loss.
Stage 2 (20 ep): progressive SNR widening, MSE+perceptual.
Stage 3 (15 ep): all SNRs, VQ on, perceptual+VQ+adversarial.
"""

from __future__ import annotations

from typing import Dict, List

from sincformer_tpu_torch.config import CurriculumConfig


class CurriculumScheduler:
    """Epoch → stage info."""

    def __init__(self, ccfg: CurriculumConfig = CurriculumConfig()):
        self.stage1_epochs = ccfg.stage1_epochs
        self.stage2_epochs = ccfg.stage2_epochs
        self.stage3_epochs = ccfg.stage3_epochs
        self.total_epochs = (self.stage1_epochs + self.stage2_epochs
                             + self.stage3_epochs)

    def get_stage(self, epoch: int) -> Dict:
        if epoch < self.stage1_epochs:
            return {
                "stage": 1,
                "snr_levels": [5, 10],
                "use_vq": False,
                "use_soft_mask": True,
                "loss_type": "mse",
                "description": "Stage 1: High-SNR + soft mask only",
            }
        if epoch < self.stage1_epochs + self.stage2_epochs:
            progress = (epoch - self.stage1_epochs) / self.stage2_epochs
            snr_levels: List[int] = ([0, 5, 10] if progress < 0.33
                                     else [-5, 0, 5, 10])
            return {
                "stage": 2,
                "snr_levels": snr_levels,
                "use_vq": False,
                "use_soft_mask": True,
                "loss_type": "mse+perceptual",
                "description": (f"Stage 2: Progressive low-SNR "
                                f"(SNRs={snr_levels})"),
            }
        return {
            "stage": 3,
            "snr_levels": [-5, 0, 5, 10],
            "use_vq": True,
            "use_soft_mask": False,
            "loss_type": "perceptual+vq+adversarial",
            "description": "Stage 3: VQ activation + intelligibility loss",
        }

    def print_schedule(self):
        """Print the schedule, one paragraph per stage."""
        print("=" * 60)
        print("Curriculum Learning Schedule")
        print("=" * 60)
        lens = [self.stage1_epochs, self.stage2_epochs, self.stage3_epochs]
        for epoch in range(self.total_epochs):
            stage = self.get_stage(epoch)
            if epoch in (0, self.stage1_epochs,
                         self.stage1_epochs + self.stage2_epochs):
                print(f"\n--- {stage['description']} ---")
                print(f"  Epochs: {epoch} - "
                      f"{epoch + lens[stage['stage'] - 1] - 1}")
                print(f"  SNR levels: {stage['snr_levels']}")
                print(f"  VQ active: {stage['use_vq']}")
                print(f"  Loss: {stage['loss_type']}")
