"""Shared building blocks (counterpart of ``planerecnet_tpu/models/layers.py``).

The JAX package's ``TorchBatchNorm`` is torch's ``nn.BatchNorm2d``. In eval
mode both compute ``(x - mean) * rsqrt(var + eps) * weight + bias`` with the
running statistics. In train mode both normalise with the batch's biased
variance and update the running variance with the Bessel-corrected one;
torch's ``momentum`` is one minus flax's (0.1 in the backbone, 0.01 in the
depth decoder).
"""

from __future__ import annotations

from torch import nn

from planerecnet_tpu_torch.ops.image import ReflectPad2d


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
                         nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                         nn.ReLU())
