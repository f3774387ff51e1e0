"""Multi-scale spectral discriminator and its LSGAN losses
(``sincformer_tpu/train/adversarial.py``): three Conv1d sub-discriminators
at 1x, 2x and 4x temporal average pooling of a (B, T, F) magnitude
spectrogram, the LSGAN discriminator and generator losses and feature
matching.

Each convolution is weight-normalised as the JAX package does it:
W = g · V / sqrt(Σ_(k, in) V² + 1e-12) per output channel, computed in the
forward pass (``torch.nn.utils.weight_norm`` has no eps and norms over
other dimensions). Convolutions and pools use flax's SAME padding: the
output has ceil(T / stride) steps and the padding, total =
max((out - 1)·stride + k - T, 0), puts total // 2 on the left; the pool
counts the padded zeros in its mean. Features and logits are returned
time-major, (B, T', C), as in JAX; the parameters carry flax's names
(``disc_{i}.conv_{j}.kernel_v``, ``.gain``, ``.bias``, ``disc_{i}.head``)
with each kernel as torch holds it, (out, in, k).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sincformer_tpu_torch.models.conformer import same_pad

CHANNEL_SETS = ((64, 128, 256, 512), (64, 128, 256), (32, 64, 128))


class NormedConv(nn.Module):
    """Weight-normalised convolution over time on (B, C, T) input."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.kernel_v = nn.Parameter(torch.zeros(features, in_channels,
                                                 kernel_size))
        self.gain = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.kernel_v ** 2, dim=(1, 2)) + 1e-12)
        w = (self.kernel_v / norm[:, None, None]) * self.gain[:, None, None]
        y = F.conv1d(same_pad(x, self.kernel_size, self.stride), w,
                     stride=self.stride)
        return y + self.bias[:, None]


class SubDiscriminator(nn.Module):
    """k=5 convolutions (stride 2 but the last) with LeakyReLU 0.2, then a
    k=3 head to one logit per step."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.n_convs = len(channels)
        cin = in_channels
        for i, ch in enumerate(channels):
            stride = 2 if i < len(channels) - 1 else 1
            self.add_module(f"conv_{i}", NormedConv(cin, ch, 5, stride))
            cin = ch
        self.head = NormedConv(cin, 1, 3, 1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, C, T) → (logits (B, T', 1), features [(B, T_i, C_i)])."""
        feats = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.2)
            feats.append(x.transpose(1, 2))
        return self.head(x).transpose(1, 2), feats


class MultiScaleDiscriminator(nn.Module):
    """Three sub-discriminators on the spectrogram and on its 2x and 4x
    average-pooled versions (window 4, stride 2, SAME)."""

    def __init__(self, n_freq: int = 129):
        super().__init__()
        for i, chs in enumerate(CHANNEL_SETS):
            self.add_module(f"disc_{i}", SubDiscriminator(n_freq, chs))

    def init_params(self, generator: torch.Generator
                    ) -> "MultiScaleDiscriminator":
        """Seeded weights as flax initialises them: LeCun-normal V
        (truncated at two standard deviations), gains 1, biases 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel_v"):
                    fan_in = p.shape[1] * p.shape[2]
                    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                    w = torch.empty(p.shape)
                    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                          generator=generator)
                    p.copy_(w * std)
                elif name.endswith("gain"):
                    p.fill_(1.0)
                else:
                    p.zero_()
        return self

    def forward(self, spec: torch.Tensor):
        """(B, T, F) magnitude spectrogram → [(logits, features)] per
        scale."""
        outs = []
        x = spec.transpose(1, 2)
        for i in range(len(CHANNEL_SETS)):
            outs.append(getattr(self, f"disc_{i}")(x))
            if i < len(CHANNEL_SETS) - 1:
                x = F.avg_pool1d(same_pad(x, 4, 2), 4, 2)
        return outs


def discriminator_loss(disc_outs_real, disc_outs_fake) -> torch.Tensor:
    """LSGAN discriminator loss, averaged over the scales."""
    total = 0.0
    for (real_logits, _), (fake_logits, _) in zip(disc_outs_real,
                                                  disc_outs_fake):
        total = total + (torch.mean((real_logits - 1.0) ** 2)
                         + torch.mean(fake_logits ** 2))
    return total / len(disc_outs_real)


def generator_loss(disc_outs_fake) -> torch.Tensor:
    """LSGAN generator loss, averaged over the scales."""
    total = 0.0
    for fake_logits, _ in disc_outs_fake:
        total = total + torch.mean((fake_logits - 1.0) ** 2)
    return total / len(disc_outs_fake)


def feature_matching_loss(disc_outs_real, disc_outs_fake) -> torch.Tensor:
    """L1 between the real and the fake intermediate features, the real
    ones detached, summed over layers and averaged over the scales."""
    total = 0.0
    for (_, real_feats), (_, fake_feats) in zip(disc_outs_real,
                                                disc_outs_fake):
        for rf, ff in zip(real_feats, fake_feats):
            total = total + torch.mean(torch.abs(ff - rf.detach()))
    return total / len(disc_outs_real)
