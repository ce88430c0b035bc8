"""SOLOv2 instance and mask heads (NCHW).

Counterpart of ``planerecnet_tpu/models/heads.py``; module names follow the
reference's torch state_dict (``inst_head.cate_tower.{3i}`` conv,
``.{3i+1}`` GroupNorm; ``mask_head.convs_all_levels.{l}.conv{j}.{0,1}``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from planerecnet_tpu_torch.config import SOLOv2Config
from planerecnet_tpu_torch.models.backbone import DeformableConv2d
from planerecnet_tpu_torch.models.layers import GroupNorm
from planerecnet_tpu_torch.ops.image import point_sample_grid, resize_bilinear


def bias_init_with_prob(prior_prob: float) -> float:
    """Focal-loss prior bias."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def _with_coords(x: torch.Tensor) -> torch.Tensor:
    """Append the (x, y) coord-conv channels to NCHW ``x``."""
    b, _, h, w = x.shape
    coord = point_sample_grid(h, w, device=x.device).to(x.dtype)
    coord = coord.permute(2, 0, 1)[None].expand(b, 2, h, w)
    return torch.cat([x, coord], dim=1)


def _gn(c: int) -> GroupNorm:
    return GroupNorm(32, c, eps=1e-5)


class SOLOv2InsHead(nn.Module):
    """Per level: append coord channels, resize to S x S, run the kernel and
    cate towers (shared across levels) and predict ``cate_pred``
    (num_classes) and ``kernel_pred`` (num_kernels)."""

    def __init__(self, cfg: SOLOv2Config, num_classes: int, in_channels: int,
                 dtype=None):
        super().__init__()
        self.num_grids = cfg.num_grids
        c = cfg.instance_channels

        def make_conv(cin):
            if cfg.use_dcn_in_instance:
                return DeformableConv2d(cin, c, use_bias=False, dtype=dtype)
            return nn.Conv2d(cin, c, 3, padding=1, bias=False)

        for name, cin in (("kernel", in_channels + 2), ("cate", in_channels)):
            layers = []
            for i in range(cfg.num_instance_convs):
                layers += [make_conv(cin if i == 0 else c), _gn(c), nn.ReLU()]
            setattr(self, f"{name}_tower", nn.Sequential(*layers))
        self.cate_pred = nn.Conv2d(c, num_classes, 3, padding=1)
        self.kernel_pred = nn.Conv2d(c, cfg.num_kernels, 3, padding=1)
        self.prior_bias = bias_init_with_prob(cfg.focal_loss_init_pi)

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        cate_preds, kernel_preds = [], []
        for idx, feat in enumerate(features):
            s = self.num_grids[idx]
            kernel_feat = resize_bilinear(_with_coords(feat), (s, s))
            cate_feat = kernel_feat[:, :-2]
            kernel_preds.append(self.kernel_pred(self.kernel_tower(kernel_feat)))
            cate_preds.append(self.cate_pred(self.cate_tower(cate_feat)))
        return cate_preds, kernel_preds


class SOLOv2MaskHead(nn.Module):
    """Level i gets i (conv+GN+ReLU, 2x bilinear upsample) steps to reach
    1/4 scale, with coord channels appended at level 3 only; the levels are
    summed and a 1x1 conv + GN + ReLU gives ``num_masks`` channels."""

    def __init__(self, cfg: SOLOv2Config, in_channels: int):
        super().__init__()
        mc = cfg.masks_channels
        self.num_levels = len(cfg.masks_in_features)

        def conv_gn_relu(cin):
            return nn.Sequential(nn.Conv2d(cin, mc, 3, padding=1, bias=False),
                                 _gn(mc), nn.ReLU())

        levels = []
        for i in range(self.num_levels):
            cin = in_channels + (2 if i == 3 else 0)
            levels.append(nn.ModuleDict({
                f"conv{j}": conv_gn_relu(cin if j == 0 else mc)
                for j in range(max(i, 1))}))
        self.convs_all_levels = nn.ModuleList(levels)
        self.conv_pred = nn.Sequential(
            nn.Conv2d(mc, cfg.num_masks, 1, bias=False), _gn(cfg.num_masks),
            nn.ReLU())

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(features) != self.num_levels:
            raise ValueError(f"{len(features)} levels, expected "
                             f"{self.num_levels}")
        out = self.convs_all_levels[0]["conv0"](features[0])
        for i in range(1, self.num_levels):
            x = _with_coords(features[i]) if i == 3 else features[i]
            for j in range(i):
                x = self.convs_all_levels[i][f"conv{j}"](x)
                x = resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]))
            out = out + x
        return self.conv_pred(out)
