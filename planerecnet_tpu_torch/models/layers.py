"""Shared building blocks (counterpart of ``planerecnet_tpu/models/layers.py``).

The JAX package's ``TorchBatchNorm`` is torch's ``nn.BatchNorm2d``. In eval
mode both compute ``(x - mean) * rsqrt(var + eps) * weight + bias`` with the
running statistics. In train mode both normalise with the batch's biased
variance and update the running variance with the Bessel-corrected one;
torch's ``momentum`` is one minus flax's (0.1 in the backbone, 0.01 in the
depth decoder).

In the bf16 mode the convolutions run in bf16 under ``torch.autocast``,
and the norms, as the JAX package's, in f32: ``TorchBatchNorm`` returns
f32 and flax's ``GroupNorm`` takes the f32 of its parameters, so the
residual sums and the ReLUs after them stay f32. ``BatchNorm2d`` and
``GroupNorm`` below are torch's with their input in f32 (the same module
in f32 mode); torch's autocast would keep a bf16 BatchNorm in bf16, and a
GroupNorm in bf16 on the CPU and f32 on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from planerecnet_tpu_torch.ops.image import ReflectPad2d


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` in f32 whatever its input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in f32 whatever its input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class ReflectConvBNReLU(nn.Sequential):
    """[2x nearest upsample] + ReflectionPad(1) + 3x3 conv + BN(eps=1e-3) +
    ReLU, the depth decoder's block (with ``upsample``, its ``deconv``).
    The pad is ``ops.image.ReflectPad2d``, whose backward is deterministic
    on the card.

    The Sequential indices give the reference's state_dict keys: conv at 1
    and BN at 2, or at 2 and 3 behind the upsample.
    """

    def __init__(self, cin: int, cout: int, upsample: bool = False):
        layers = ([nn.Upsample(scale_factor=2, mode="nearest")]
                  if upsample else [])
        super().__init__(*layers, ReflectPad2d(1),
                         nn.Conv2d(cin, cout, 3),
                         BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                         nn.ReLU())
