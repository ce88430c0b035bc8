"""ResNet-50/101 backbone with DCNv2 blocks, returning C2..C5 (NCHW).

Counterpart of ``planerecnet_tpu/models/backbone.py``. Module names follow
the reference's torch state_dict (``backbone.layers.{stage}.{block}...``).
A block's deformable conv2 replaces the 3x3 conv, chosen per block by
``_stage_plan``:
  * first block of a stage: ``use_dcn = dcn_layers[s] >= blocks``
  * block i >= 1: ``use_dcn = (i + dcn_layers[s]) >= blocks and
    i % dcn_interval == 0``
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from planerecnet_tpu_torch.config import BackboneConfig
from planerecnet_tpu_torch.models.layers import BatchNorm2d
from planerecnet_tpu_torch.ops.dcn import deform_conv2d


class DeformableConv2d(nn.Module):
    """DCNv2 block: ``offset_conv`` predicts 2K offsets (always in f32),
    ``modulator_conv`` K modulators (``2*sigmoid``); offsets are clamped to
    ±max(H, W)/4 of this block's input, then the deformable sampling and the
    product with ``regular_conv``'s weight run as ``ops.dcn.deform_conv2d``.
    Takes and returns NCHW. ``deterministic`` (set by
    ``PlaneRecNet.set_deterministic``) selects the backward that sums in a
    fixed order on the card.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = kernel_size * kernel_size
        conv_kw = dict(kernel_size=kernel_size, stride=stride,
                       padding=padding)
        self.offset_conv = nn.Conv2d(cin, 2 * k, **conv_kw)
        self.modulator_conv = nn.Conv2d(cin, k, **conv_kw)
        # Holds the deformable conv's OIHW weight and bias; never called.
        self.regular_conv = nn.Conv2d(cin, cout, bias=use_bias, **conv_kw)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.deterministic = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Sub-pixel sampling positions lose too much precision in bf16.
        with torch.autocast(x.device.type, enabled=False):
            offset = self.offset_conv(x.float())
        modulator = 2.0 * torch.sigmoid(self.modulator_conv(x))
        h, w = x.shape[-2:]
        max_offset = max(h, w) / 4.0
        offset = offset.clamp(-max_offset, max_offset)

        dtype = self.dtype or x.dtype
        weight = self.regular_conv.weight.permute(2, 3, 1, 0)   # HWIO
        out = deform_conv2d(
            x.to(dtype).permute(0, 2, 3, 1).contiguous(),
            offset.permute(0, 2, 3, 1).contiguous(),
            modulator.float().permute(0, 2, 3, 1).contiguous(),
            weight.to(dtype), self.regular_conv.bias,
            stride=self.stride, padding=self.padding,
            kernel_size=self.kernel_size, deterministic=self.deterministic)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """torchvision-style bottleneck, stride on conv2. The deformable conv2
    gets ``padding=dilation`` but undilated taps, as the reference does."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, dilation: int = 1,
                 use_dcn: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        if use_dcn:
            self.conv2 = DeformableConv2d(planes, planes, 3, stride=stride,
                                          padding=dilation, dtype=dtype)
        else:
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            BatchNorm2d(out)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


def _stage_plan(layers: Sequence[int], dcn_layers: Sequence[int],
                dcn_interval: int, atrous_layers: Sequence[int] = ()):
    """Per-stage (planes, blocks, stride, dilation, dcn flags) build plan.

    An atrous stage increments the cumulative dilation and gets stride 1;
    the dilation persists into later stages' FIRST blocks, while non-first
    blocks always use dilation 1.
    """
    plan = []
    planes = (64, 128, 256, 512)
    strides = (1, 2, 2, 2)
    dilation = 1
    for s, blocks in enumerate(layers):
        dcn = dcn_layers[s] if s < len(dcn_layers) else 0
        stride = strides[s] if s < 4 else 2
        if s in atrous_layers:
            dilation += 1
            stride = 1
        flags = []
        for i in range(blocks):
            if i == 0:
                flags.append(dcn >= blocks)
            else:
                flags.append(((i + dcn) >= blocks) and (i % dcn_interval == 0))
        plan.append((planes[s] if s < 4 else 512, blocks, stride, dilation,
                     tuple(flags)))
    return plan


class ResNetBackbone(nn.Module):
    """ResNet stem + bottleneck stages; ``forward`` returns C2..C5."""

    def __init__(self, layers: Tuple[int, ...],
                 dcn_layers: Tuple[int, ...] = (0, 0, 0, 0),
                 dcn_interval: int = 1, atrous_layers: Tuple[int, ...] = (),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layers = nn.ModuleList()
        inplanes = 64
        for planes, blocks, stride, dilation, dcn_flags in _stage_plan(
                layers, dcn_layers, dcn_interval, atrous_layers):
            stage = []
            for i in range(blocks):
                if i == 0:
                    # A projection whenever stride != 1 or channels change,
                    # also when an atrous stage forced stride 1.
                    has_ds = stride != 1 or inplanes != planes * 4
                    stage.append(Bottleneck(inplanes, planes, stride, has_ds,
                                            dilation, dcn_flags[i], dtype))
                    inplanes = planes * 4
                else:
                    stage.append(Bottleneck(inplanes, planes,
                                            use_dcn=dcn_flags[i],
                                            dtype=dtype))
            self.layers.append(nn.Sequential(*stage))

    @property
    def channels(self) -> Tuple[int, ...]:
        return (256, 512, 1024, 2048)[:len(self.layers)]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return tuple(outs)


def construct_backbone(cfg: BackboneConfig,
                       dtype: Optional[torch.dtype] = None) -> ResNetBackbone:
    if max(cfg.selected_layers) + 1 > len(cfg.layers):
        raise ValueError("extra backbone stages beyond the ResNet's are not "
                         "supported (no preset selects them)")
    return ResNetBackbone(layers=tuple(cfg.layers),
                          dcn_layers=tuple(cfg.dcn_layers),
                          dcn_interval=cfg.dcn_interval,
                          atrous_layers=tuple(cfg.atrous_layers),
                          dtype=dtype)
