"""Feature pyramid with the reference's fine-to-coarse accumulator (NCHW).

Counterpart of ``planerecnet_tpu/models/fpn.py``: inputs arrive high-res to
low-res (C2..C5) and a running sum is resized DOWN to each next level before
being added to that level's lateral, unlike a classic top-down FPN.
``top_down=True`` is the classic one (mmdetection's, SOLOv2's): each
coarser sum resized UP to the next finer level and added to its lateral.
Under a spatial context ``rows`` (``parallel/halo.py::Rows``) the levels
are in the layout its rule gives them, and the resizes' sizes are global.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from planerecnet_tpu_torch.config import FPNConfig
from planerecnet_tpu_torch.models.layers import conv2d
from planerecnet_tpu_torch.ops.image import resize_bilinear, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_features: int = 256,
                 start_level: int = 0, interpolation_mode: str = "bilinear",
                 high_level_mode: Optional[str] = None,
                 relu_pred_layers: bool = True, top_down: bool = False):
        super().__init__()
        self.top_down = top_down
        if high_level_mode not in (None, "original"):
            raise ValueError(f"high_level_mode {high_level_mode!r}: no preset "
                             "uses it and the port does not build it")
        self.start_level = start_level
        self.interpolation_mode = interpolation_mode
        self.high_level_mode = high_level_mode
        self.relu_pred_layers = relu_pred_layers
        used = list(in_channels)[start_level:]
        self.lateral_convs = nn.ModuleList(
            nn.Conv2d(c, num_features, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(num_features, num_features, 3, padding=1) for _ in used)

    def forward(self, inputs: Sequence[torch.Tensor], rows=None
                ) -> List[torch.Tensor]:
        resize = (resize_nearest if self.interpolation_mode == "nearest"
                  else resize_bilinear)
        laterals = []
        x = None
        pairs = list(zip(self.lateral_convs, inputs[self.start_level:]))
        for conv, feat in (reversed(pairs) if self.top_down else pairs):
            lat = conv(feat)
            size = (feat.shape[-2] if rows is None else rows.rows_of(feat),
                    feat.shape[-1])
            x = lat if x is None else lat + resize(x, size, rows).to(
                lat.dtype)
            laterals.append(x)
        if self.top_down:
            laterals.reverse()

        outs = []
        for conv, lat in zip(self.fpn_convs, laterals):
            p = conv2d(conv, lat, rows)
            outs.append(F.relu(p) if self.relu_pred_layers else p)

        if self.high_level_mode == "original":
            # max_pool2d(kernel=1, stride=2) is stride-2 subsampling.
            top = outs[-1] if rows is None else rows.whole(outs[-1])
            top = top[:, :, ::2, ::2]
            outs.append(top if rows is None else rows.local(top))
        return outs


def build_fpn(cfg: FPNConfig, in_channels: Sequence[int]) -> FPN:
    return FPN(in_channels, num_features=cfg.num_features,
               start_level=cfg.start_level or 0,
               interpolation_mode=cfg.interpolation_mode,
               high_level_mode=cfg.high_level_mode,
               relu_pred_layers=cfg.relu_pred_layers,
               top_down=cfg.top_down)
