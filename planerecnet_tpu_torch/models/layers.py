"""Shared building blocks (counterpart of ``planerecnet_tpu/models/layers.py``).

The JAX package's ``TorchBatchNorm`` is torch's ``nn.BatchNorm2d``; in eval
mode both compute ``(x - mean) * rsqrt(var + eps) * weight + bias``.
"""

from __future__ import annotations

from torch import nn


class ReflectConvBNReLU(nn.Sequential):
    """[2x nearest upsample] + ReflectionPad(1) + 3x3 conv + BN(eps=1e-3) +
    ReLU, the depth decoder's block (with ``upsample``, its ``deconv``).

    The Sequential indices give the reference's state_dict keys: conv at 1
    and BN at 2, or at 2 and 3 behind the upsample.
    """

    def __init__(self, cin: int, cout: int, upsample: bool = False):
        layers = ([nn.Upsample(scale_factor=2, mode="nearest")]
                  if upsample else [])
        super().__init__(*layers, nn.ReflectionPad2d(1),
                         nn.Conv2d(cin, cout, 3),
                         nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                         nn.ReLU())
