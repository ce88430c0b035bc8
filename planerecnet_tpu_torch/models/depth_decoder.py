"""Depth decoder with the cross-task mask injection (NCHW).

Counterpart of ``planerecnet_tpu/models/depth_decoder.py``: an FPN-style
decoder over C5..C2 with reflection-padded conv+BN blocks, nearest-2x
deconv blocks and a Softplus head at 1/2 input resolution. At the coarsest
level it injects the instance masks of every grid cell: the detached mask
features times the detached kernels of all levels, one batched matmul
over N = sum S^2 channels, sigmoid, 1x1 conv to F channels, resized x0.25.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from planerecnet_tpu_torch.models.layers import ReflectConvBNReLU
from planerecnet_tpu_torch.ops.image import resize_bilinear


class DepthDecoderFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_cells: int,
                 num_features: int = 256):
        """``in_channels``: C2..C5 widths; ``num_cells``: sum of S^2 over
        the instance levels."""
        super().__init__()
        f, f2, f4 = num_features, num_features // 2, num_features // 4
        c5, c4, c3, c2 = reversed(list(in_channels))
        self.conv1x1 = nn.Sequential(nn.Conv2d(num_cells, f, 1))
        self.latlayer1 = nn.Conv2d(c5, f, 1)
        self.conv1 = ReflectConvBNReLU(f, f)
        self.deconv1 = ReflectConvBNReLU(f, f, upsample=True)
        self.refine_conv = ReflectConvBNReLU(2 * f, f2)
        self.latlayer2 = nn.Conv2d(c4, f, 1)
        self.conv2 = ReflectConvBNReLU(f, f2)
        self.deconv2 = ReflectConvBNReLU(2 * f2, f2, upsample=True)
        self.latlayer3 = nn.Conv2d(c3, f, 1)
        self.conv3 = ReflectConvBNReLU(f, f2)
        self.deconv3 = ReflectConvBNReLU(2 * f2, f2, upsample=True)
        self.latlayer4 = nn.Conv2d(c2, f, 1)
        self.conv4 = ReflectConvBNReLU(f, f2)
        self.deconv4 = ReflectConvBNReLU(2 * f2, f4, upsample=True)
        self.depth_pred = nn.Sequential(nn.ReflectionPad2d(1),
                                        nn.Conv2d(f4, 1, 3))

    def forward(self, feature_maps: Sequence[torch.Tensor],
                seg_preds: torch.Tensor,
                kernel_preds: Sequence[torch.Tensor]) -> torch.Tensor:
        b, k, h, w = seg_preds.shape
        # --- dynamic-conv mask assembly over all grid cells ---
        flat_kernels = torch.cat(
            [kp.permute(0, 2, 3, 1).reshape(b, -1, k) for kp in kernel_preds],
            dim=1).detach()                                   # (B, N, K)
        seg = seg_preds.detach().reshape(b, k, h * w)
        masks = torch.sigmoid(torch.matmul(flat_kernels, seg))
        masks = masks.reshape(b, -1, h, w).to(seg_preds.dtype)
        masks = self.conv1x1(masks)
        masks = resize_bilinear(masks, (h // 4, w // 4))

        c5, c4, c3, c2 = reversed(list(feature_maps))
        x = self.deconv1(self.conv1(self.latlayer1(c5)))
        x = self.refine_conv(torch.cat([x, x * masks], dim=1))
        l2 = self.conv2(self.latlayer2(c4))
        x = self.deconv2(torch.cat([l2, x], dim=1))
        l3 = self.conv3(self.latlayer3(c3))
        x = self.deconv3(torch.cat([l3, x], dim=1))
        l4 = self.conv4(self.latlayer4(c2))
        x = self.deconv4(torch.cat([l4, x], dim=1))
        return F.softplus(self.depth_pred(x))
