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
The modules inside run NCHW. With ``cfg.use_depth`` False (SOLOv2) no
depth decoder is built and ``depth_pred`` is left out. With
``cfg.allow_tf32`` False (SOLOv2) the forward's convolutions run in full
f32 (``tf32_switches``; the training step holds its backward to it too).

``forward(x, spatial=rows)`` is the forward of one rank of the spatial
mesh axis (``parallel/halo.py::Rows``): ``x`` holds this rank's rows of
the images, every map is row-sharded or whole as the context's rule
gives it, the instance head runs on its S x S grids whole on every rank,
and the dict returned is the whole images' on every rank.

``cfg.remat_backbone`` decides, call by call, whether the backbone's
blocks are recomputed in the backward (``resolve_remat``): the JAX
package's rule with the card's own fitting point, measured on an H100.

An inference call on a card (autograd off, eval mode, no ``spatial``)
replays a CUDA graph of the forward, one per input shape
(``utils/graphs.py``): the first call at a shape runs eagerly, the second
captures. Work on a call's outputs follows it (``model.graphs.follow``,
the runner's post-processing).
``train()``, ``.to()`` and ``load_state_dict(assign=True)`` drop the
graphs; an in-place ``load_state_dict`` needs nothing. A parameter swapped
by other means (``p.data = ...``, a submodule's own ``.to``) is not seen:
call ``model.graphs.clear()``.
"""

from __future__ import annotations

import contextlib
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
from planerecnet_tpu_torch.utils import graphs

# ``remat_backbone="auto"``'s fitting point: the input's bytes, B * H * W
# times the compute dtype's itemsize, at which PRN-101's f32 training step
# without remat would reach 90% of the card's memory, by the line through
# its peaks at 8 and 16 x640x640 (17.923 and 34.259 GiB: batch 34.12,
# ``chip_smoke.py``'s phase 7b on an "NVIDIA H100 80GB HBM3, 700.00 W"),
# and that card's memory (``total_memory``); another card scales it by its
# own memory. PRN-50's default 8x640x640 f32 step (13,107,200 B) and
# PRN-101's at 16 (26,214,400 B) stay without remat.
REMAT_FIT_BYTES = 55_904_367
REMAT_FIT_CARD_BYTES = 85_017_493_504


def resolve_remat(setting, grad: bool, input_bytes: int,
                  card_bytes: Optional[int]) -> bool:
    """Whether the backbone recomputes its blocks in the backward. True and
    False force it; "auto" remats only where gradients flow (``grad``), on
    a card (``card_bytes``, its memory; None on the CPU), and for an input
    of more than the card's fitting point."""
    if setting is True or setting is False:
        return setting
    if setting != "auto":
        raise ValueError(f"remat_backbone {setting!r}")
    if not grad or card_bytes is None:
        return False
    return input_bytes > REMAT_FIT_BYTES * card_bytes / REMAT_FIT_CARD_BYTES


def compute_dtype(cfg: PlaneRecNetConfig) -> Optional[torch.dtype]:
    """bf16 when the config asks for it, else None (float32); "auto" is
    float32."""
    if cfg.compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


@contextlib.contextmanager
def tf32_switches(cfg: PlaneRecNetConfig):
    """PyTorch's global TF32 switches as ``cfg.allow_tf32`` asks, for the
    extent of the block: with False, cuDNN's convolutions and the matrix
    products run in full f32 and the switches are put back after; with
    True nothing is touched."""
    if cfg.allow_tf32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class PlaneRecNet(nn.Module):
    def __init__(self, cfg: PlaneRecNetConfig):
        super().__init__()
        # The instance branch's levels: p2 halved, p3, p4, p5 and, with
        # ``solov2.num_instance_levels`` 5, p6 resized to p5's size.
        if cfg.solov2.num_instance_levels not in (4, 5):
            raise ValueError("solov2.num_instance_levels must be 4 or 5, "
                             f"not {cfg.solov2.num_instance_levels}")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = construct_backbone(cfg.backbone, dtype=self.dtype)
        chans = self.backbone.channels
        self.fpn = build_fpn(cfg.fpn,
                             [chans[i] for i in cfg.fpn.selected_layers])
        self.inst_head = SOLOv2InsHead(cfg.solov2, cfg.num_classes,
                                       cfg.fpn.num_features, dtype=self.dtype)
        self.mask_head = SOLOv2MaskHead(cfg.solov2, cfg.fpn.num_features)
        if cfg.use_depth:
            num_cells = sum(s * s for s in cfg.solov2.num_grids[
                :cfg.solov2.num_instance_levels])
            self.depth_decoder = DepthDecoderFPN(
                [chans[i] for i in cfg.depth.selected_layers], num_cells,
                num_features=cfg.depth.num_features)
        self.graphs = graphs.Graphs()
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
        if mode:
            self.graphs.clear()
        if mode and self.cfg.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        if assign:
            self.graphs.clear()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def graphed(self, x: torch.Tensor, spatial=None) -> bool:
        """Whether a call goes through the CUDA graphs: an inference call
        (autograd off, eval mode) of the whole images (no ``spatial``) on
        a card, that ``graphs.usable`` allows."""
        return (spatial is None and x.is_cuda and not self.training
                and not torch.is_grad_enabled() and graphs.usable(self))

    def forward(self, x: torch.Tensor, spatial=None,
                borrow: bool = False) -> Dict:
        """The raw outputs. ``borrow``: a replay may return the graph's own
        outputs, which the next call at this shape overwrites, unless a
        forward hook on the model takes them (the runner, which reads
        them through ``graphs.follow``)."""
        if not self.graphed(x, spatial):
            self.graphs.last = None
            return self._forward(x, spatial)
        return self.graphs.run(graphs.numerics(), self._forward, (x,),
                               PlaneRecNet.forward,
                               copy=not borrow or bool(self._forward_hooks))

    def _forward(self, x: torch.Tensor, spatial=None) -> Dict:
        cfg, rows = self.cfg, spatial
        remat = resolve_remat(
            cfg.remat_backbone, torch.is_grad_enabled(),
            x.shape[0] * x.shape[1] * x.shape[2]
            * (2 if self.dtype == torch.bfloat16 else 4),
            torch.cuda.get_device_properties(x.device).total_memory
            if x.device.type == "cuda" else None)
        with tf32_switches(cfg), torch.autocast(
                x.device.type, dtype=torch.bfloat16,
                enabled=self.dtype == torch.bfloat16):
            feats = self.backbone(x.permute(0, 3, 1, 2), rows, remat=remat)
            features = self.fpn([feats[i] for i in cfg.fpn.selected_layers],
                                rows)
            # Instance branch: halve p2 so the level strides are 8, 8, 16, 32.
            p2 = features[0]
            h2 = p2.shape[-2] if rows is None else rows.rows_of(p2)
            ins_feats = [resize_bilinear(p2, (h2 // 2, p2.shape[-1] // 2),
                                         rows),
                         *features[1:4]]
            if cfg.solov2.num_instance_levels == 5:
                p5, p6 = features[3:5]
                h5 = p5.shape[-2] if rows is None else rows.rows_of(p5)
                ins_feats.append(resize_bilinear(p6, (h5, p5.shape[-1]),
                                                 rows))
            if rows is not None:
                ins_feats = [rows.whole(f) for f in ins_feats]
            cate_preds, kernel_preds = self.inst_head(ins_feats)
            n_mask = len(cfg.solov2.masks_in_features)
            mask_pred = self.mask_head(features[:n_mask], rows)
            if cfg.use_depth:
                depth_pred = self.depth_decoder(
                    [feats[i] for i in cfg.depth.selected_layers], mask_pred,
                    kernel_preds, rows)
            if rows is not None:
                mask_pred = rows.whole(mask_pred)
                if cfg.use_depth:
                    depth_pred = rows.whole(depth_pred)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        out = {
            "cate_preds": [nhwc(t) for t in cate_preds],
            "kernel_preds": [nhwc(t) for t in kernel_preds],
            "mask_pred": nhwc(mask_pred),
        }
        if cfg.use_depth:
            out["depth_pred"] = nhwc(depth_pred)
        return out


# How often inference calls ran eagerly (the first at a shape), captured
# their graph (the second) and replayed it (every later one).
PlaneRecNet.forward.eager = 0
PlaneRecNet.forward.captures = 0
PlaneRecNet.forward.replays = 0
