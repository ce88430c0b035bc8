"""PlaneRecNet top-level model (counterpart of
``planerecnet_tpu/models/planerecnet.py``).

From one RGB image it predicts SOLOv2-style instances of planar surfaces and
a dense depth map over one shared backbone pyramid. ``forward`` takes
normalised (B, H, W, 3) images and returns the raw-pred dict in the JAX
package's layouts:
  ``cate_preds``:   list per level, (B, S, S, num_classes) logits
  ``kernel_preds``: list per level, (B, S, S, num_kernels)
  ``mask_pred``:    (B, H/4, W/4, num_masks) mask features
  ``depth_pred``:   (B, H/2, W/2, 1) softplus depth
The modules inside run NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.models.backbone import (DeformableConv2d,
                                                   construct_backbone)
from planerecnet_tpu_torch.models.depth_decoder import DepthDecoderFPN
from planerecnet_tpu_torch.models.fpn import build_fpn
from planerecnet_tpu_torch.models.heads import SOLOv2InsHead, SOLOv2MaskHead
from planerecnet_tpu_torch.ops.image import resize_bilinear

# The instance branch always has four levels (p2 halved, p3, p4, p5).
NUM_INSTANCE_LEVELS = 4


def compute_dtype(cfg: PlaneRecNetConfig) -> Optional[torch.dtype]:
    """bf16 when the config asks for it, else None (float32); "auto" is
    float32."""
    if cfg.compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


class PlaneRecNet(nn.Module):
    def __init__(self, cfg: PlaneRecNetConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = construct_backbone(cfg.backbone, dtype=self.dtype)
        chans = self.backbone.channels
        self.fpn = build_fpn(cfg.fpn,
                             [chans[i] for i in cfg.fpn.selected_layers])
        self.inst_head = SOLOv2InsHead(cfg.solov2, cfg.num_classes,
                                       cfg.fpn.num_features, dtype=self.dtype)
        self.mask_head = SOLOv2MaskHead(cfg.solov2, cfg.fpn.num_features)
        num_cells = sum(s * s for s in
                        cfg.solov2.num_grids[:NUM_INSTANCE_LEVELS])
        self.depth_decoder = DepthDecoderFPN(
            [chans[i] for i in cfg.depth.selected_layers], num_cells,
            num_features=cfg.depth.num_features)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self):
        """Fresh weights from the global torch generator: xavier-uniform
        convs with zero bias outside the backbone, the focal prior on
        ``cate_pred``'s bias, zero DCN offset/modulator convs (each DCN
        starts as a regular conv)."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith("backbone"):
                nn.init.xavier_uniform_(m.weight)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(self.inst_head.cate_pred.bias,
                          self.inst_head.prior_bias)
        for m in self.modules():
            if isinstance(m, DeformableConv2d):
                for conv in (m.offset_conv, m.modulator_conv):
                    nn.init.zeros_(conv.weight)
                    nn.init.zeros_(conv.bias)

    def set_deterministic(self, flag: bool) -> "PlaneRecNet":
        """Make every DCN layer's backward sum in a fixed order on the card
        (the train CLI's ``--reproductablity``)."""
        for m in self.modules():
            if isinstance(m, DeformableConv2d):
                m.deterministic = flag
        return self

    def train(self, mode: bool = True) -> "PlaneRecNet":
        """Train mode; with ``cfg.freeze_bn`` every BatchNorm, backbone and
        depth decoder alike, keeps using and keeping its running
        statistics."""
        super().train(mode)
        if mode and self.cfg.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> Dict:
        cfg = self.cfg
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feats = self.backbone(x.permute(0, 3, 1, 2))
            features = self.fpn([feats[i] for i in cfg.fpn.selected_layers])
            # Instance branch: halve p2 so the level strides are 8, 8, 16, 32.
            p2 = features[0]
            ins_feats = [resize_bilinear(p2, (p2.shape[-2] // 2,
                                              p2.shape[-1] // 2)),
                         *features[1:NUM_INSTANCE_LEVELS]]
            cate_preds, kernel_preds = self.inst_head(ins_feats)
            n_mask = len(cfg.solov2.masks_in_features)
            mask_pred = self.mask_head(features[:n_mask])
            depth_pred = self.depth_decoder(
                [feats[i] for i in cfg.depth.selected_layers], mask_pred,
                kernel_preds)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {
            "cate_preds": [nhwc(t) for t in cate_preds],
            "kernel_preds": [nhwc(t) for t in kernel_preds],
            "mask_pred": nhwc(mask_pred),
            "depth_pred": nhwc(depth_pred),
        }
