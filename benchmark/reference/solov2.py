"""SOLOv2-R101-DCN's training step in plain PyTorch: the yardstick of the
``solov2_r101dcn`` cells.

Written from the SOLO repository (WXinlong/SOLO: ``configs/solov2/
solov2_r101_dcn_fpn_8gpu_3x.py``, ``mmdet/models/anchor_heads/
solov2_head.py``, ``mmdet/models/mask_heads/mask_feat_head.py``), the
mmdetection 1.x ResNet and FPN it builds on, and the paper (SOLOv2,
arXiv:2003.10152). It imports nothing of the program: the plain layers
of ``benchmark/reference/model.py`` (ResNet bottlenecks, the modulated
deformable convolution by plain gathers, GroupNorm blocks, the mask
feature head) and nothing else. Module names give the program's
state-dict keys, so that one seeded weight set loads into both.

* Backbone: ResNet-101, DCNv2 in every block of stages 3-5
  (``stage_with_dcn=(False, True, True, True)``: 4 + 23 + 3 = 30), style
  "pytorch" (the stride on conv2); the stem and stage 2 frozen
  (``frozen_stages=1``: no gradient, run without autograd); every
  BatchNorm on its running statistics (``norm_eval``).
* FPN: 1x1 laterals to 256 channels, the top-down sum with a 2x nearest
  upsample (``F.interpolate(scale_factor=2)``), 3x3 output convs, no
  activation; P6 = ``max_pool2d(P5, 1, stride=2)`` (``num_outs=5``).
* Instance head (``SOLOv2Head``): levels P2 resized by 1/2, P3, P4, P5 and
  P6 resized to P5's size (``split_feats``), grids (40, 36, 24, 16, 12);
  coordinates appended, resized to the grid; the kernel tower (input
  258 channels) and the category tower (256) each 4 DCNv2 convs of 512
  channels with GroupNorm(32) and ReLU (``use_dcn_in_tower``), then a 3x3
  conv to the 256 dynamic 1x1 kernels and one to the class logits.
* Mask feature head (``MaskFeatHead``): P2-P5 to 1/4 scale, 128
  channels, coordinates at P5, summed, 1x1 conv to 256 with GroupNorm.
* Targets (``solov2_target_single``): for each level and image, the
  instances whose sqrt(box area) lies in the level's scale range, in
  order; each takes the cells of its sigma-shrunk (0.2) box around its
  mass centre, clamped to the centre cell +-1, and writes its label into
  them (a later instance overwrites an earlier one); every (cell,
  instance) pair is a positive, its target the mask rescaled to 1/4.
* Loss: dice (``1 - 2 sum(p t) / (sum p^2 + 0.001 + sum t^2 + 0.001)``,
  p the sigmoid of the mask features times the cell's kernel) over every
  positive, mean, times 3; sigmoid focal (alpha 0.25, gamma 2) over every
  cell and class, summed, over the positive cells plus one.
* SGD: the gradients' global L2 norm clipped to 35 (``clip_grad_norm_``,
  ``max_norm / (norm + 1e-6)``), weight decay 1e-4 added, momentum 0.9
  (the first step's buffer the gradient itself), at the scheduled lr.

Departures, each deliberate:
* The DCNv2 layer is the program's (and PlaneRecNet's): separate offset
  (18) and modulator (9) convolutions, modulators ``2 * sigmoid``, offsets
  clamped to +-max(H, W)/4, where mmcv's ``ModulatedDeformConvPack`` has
  one 27-channel ``conv_offset`` and ``sigmoid``. The clamp is not reached
  at the benchmark's weights.
* A position's cell is ``floor(x / size * g)`` in f32 (SOLO: ``(x /
  size) // (1 / g)`` in f64), and the mass centre is the f32 sum over the
  pixels, not ``ndimage``'s f64: they differ only at a cell's edge.
* The positives are held in ``max_positives`` slots an image and level,
  instance by instance; ``max_positives >= 9 * max_instances`` keeps
  them all.
* ``step`` runs the batch in blocks of images (memory), with each term's
  normaliser (positives, positive cells) taken over the whole batch
  first: exact, as BatchNorm uses its running statistics and GroupNorm is
  per image.
* Convolutions and matrix products in f32 with TF32 off (the caller's
  ``check.exact_f32``).

Layouts as the program's: ``forward`` takes normalised (B, H, W, 3) RGB
and returns ``cate_preds`` / ``kernel_preds`` (lists of (B, S, S, C)) and
``mask_pred`` (B, H/4, W/4, 256).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import (Backbone, DeformableConv2d, MaskHead,
                                       coords, gn, normalise, resize)
from benchmark.reference.train import learning_rate

NUM_LEVELS = 5


class FPN(nn.Module):
    """mmdetection 1.x's FPN: top-down, nearest 2x, no activation; P6 by
    stride-2 subsampling of P5."""

    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1)
                                           for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs):
        lats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lats) - 1, 0, -1):
            lats[i - 1] = lats[i - 1] + F.interpolate(
                lats[i], scale_factor=2, mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, lats)]
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return outs


class SOLOv2Head(nn.Module):
    def __init__(self, sv: Dict, num_classes: int, cin: int):
        super().__init__()
        c = sv["instance_channels"]
        self.num_grids = sv["num_grids"]
        for name, first in (("kernel", cin + 2), ("cate", cin)):
            layers = []
            for i in range(sv["num_instance_convs"]):
                layers += [DeformableConv2d(first if i == 0 else c, c,
                                            use_bias=False), gn(c),
                           nn.ReLU()]
            setattr(self, f"{name}_tower", nn.Sequential(*layers))
        self.cate_pred = nn.Conv2d(c, num_classes, 3, padding=1)
        self.kernel_pred = nn.Conv2d(c, sv["num_kernels"], 3, padding=1)

    def forward(self, feats):
        cates, kernels = [], []
        for i, f in enumerate(feats):
            s = self.num_grids[i]
            kf = F.interpolate(coords(f), size=(s, s), mode="bilinear",
                               align_corners=False)
            kernels.append(self.kernel_pred(self.kernel_tower(kf)))
            cates.append(self.cate_pred(self.cate_tower(kf[:, :-2])))
        return cates, kernels


class SOLOv2(nn.Module):
    """The network of the configuration file's ``config`` dict."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        bb, sv = cfg["backbone"], cfg["solov2"]
        self.frozen_stages = bb["frozen_stages"]
        self.backbone = Backbone(bb["layers"], bb["dcn_layers"],
                                 bb["dcn_interval"])
        nf = cfg["fpn"]["num_features"]
        self.fpn = FPN((256, 512, 1024, 2048), nf)
        self.inst_head = SOLOv2Head(sv, cfg["num_classes"], nf)
        self.mask_head = MaskHead(sv, nf)
        for m in self.frozen():
            m.requires_grad_(False)

    def frozen(self) -> List[nn.Module]:
        b = self.backbone
        return [b.conv1, b.bn1, *b.layers[:self.frozen_stages]]

    def train(self, mode: bool = True) -> "SOLOv2":
        """Train mode with every BatchNorm on its running statistics."""
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self

    def dcn_layers(self) -> List[DeformableConv2d]:
        return [m for m in self.modules() if isinstance(m, DeformableConv2d)]

    def backbone_forward(self, x):
        b = self.backbone
        with torch.no_grad():
            x = b.maxpool(F.relu(b.bn1(b.conv1(x))))
        outs = []
        for s, stage in enumerate(b.layers):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and s >= self.frozen_stages):
                x = stage(x)
            outs.append(x)
        return outs

    def forward(self, x: torch.Tensor) -> Dict:
        feats = self.backbone_forward(x.permute(0, 3, 1, 2))
        p = self.fpn(feats)
        ins = [F.interpolate(p[0], scale_factor=0.5, mode="bilinear",
                             align_corners=False), p[1], p[2], p[3],
               F.interpolate(p[4], size=p[3].shape[-2:], mode="bilinear",
                             align_corners=False)]
        cates, kernels = self.inst_head(ins)
        mask = self.mask_head(p[:len(self.cfg["solov2"]["masks_in_features"])])

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {"cate_preds": [nhwc(t) for t in cates],
                "kernel_preds": [nhwc(t) for t in kernels],
                "mask_pred": nhwc(mask)}


def named_shapes(cfg: Dict) -> Sequence:
    """(name, shape, kind) of every parameter and buffer, built on the
    meta device (``benchmark/weights.py``'s plan reads it)."""
    with torch.device("meta"):
        net = SOLOv2(cfg)
    out = [(n, tuple(p.shape), "param") for n, p in net.named_parameters()]
    out += [(n, tuple(b.shape), "buffer") for n, b in net.named_buffers()]
    return out


def _cell(v: torch.Tensor, size: int, g: int) -> torch.Tensor:
    return torch.floor((v / size) * g).long()


def targets(cfg: Dict, batch: Dict) -> Dict:
    """SOLOv2's targets of a dense batch: per level, the (B, S*S) labels
    (background = ``num_classes``) and positive cells, and per image the
    (cell, instance) positives in order; the masks at 1/4 scale. Boxes
    xyxy in input pixels, ``classes`` (B, N), ``gt_valid`` (B, N),
    ``masks`` (B, N, H, W)."""
    sv = cfg["solov2"]
    masks, valid = batch["masks"].float(), batch["gt_valid"].bool()
    b, n, h, w = masks.shape
    sums = masks.sum((2, 3))
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    m00 = sums.clamp(min=1e-6)
    cx = (masks * xs).sum((2, 3)) / m00
    cy = (masks * ys[:, None]).sum((2, 3)) / m00
    t4 = torch.floor(resize(masks.reshape(b * n, 1, h, w), (h // 4, w // 4))
                     + 0.5).reshape(b, n, h // 4, w // 4)
    boxes = batch["boxes"].float()
    bw, bh = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    area = torch.sqrt((bw * bh).clamp(min=0.0))
    sigma = sv["sigma"]
    out = {"labels": [], "cells": [], "pairs": [], "masks4": t4}
    for lv in range(NUM_LEVELS):
        g = sv["num_grids"][lv]
        lo, hi = sv["fpn_scale_ranges"][lv]
        ch, cw = _cell(cy, h, g), _cell(cx, w, g)
        box = torch.stack([
            torch.maximum(_cell(cy - 0.5 * bh * sigma, h, g).clamp(min=0),
                          ch - 1),
            torch.minimum(_cell(cy + 0.5 * bh * sigma, h, g).clamp(
                max=g - 1), ch + 1),
            torch.maximum(_cell(cx - 0.5 * bw * sigma, w, g).clamp(min=0),
                          cw - 1),
            torch.minimum(_cell(cx + 0.5 * bw * sigma, w, g).clamp(
                max=g - 1), cw + 1)], -1).cpu()
        hit = (valid & (area >= lo) & (area <= hi) & (sums > 0)).cpu()
        classes = batch["classes"].long().cpu()
        label = torch.full((b, g, g), cfg["num_classes"], dtype=torch.long)
        pos = torch.zeros((b, g, g), dtype=torch.bool)
        pairs = []
        for i in range(b):
            mine = []
            for j in range(n):
                if not hit[i, j]:
                    continue
                top, down, left, right = (int(v) for v in box[i, j])
                label[i, top:down + 1, left:right + 1] = classes[i, j]
                pos[i, top:down + 1, left:right + 1] = True
                mine += [(r * g + c, j) for r in range(top, down + 1)
                         for c in range(left, right + 1)]
            pairs.append(mine)
        out["labels"].append(label.reshape(b, g * g).to(masks.device))
        out["cells"].append(pos.reshape(b, g * g).to(masks.device))
        out["pairs"].append(pairs)
    return out


def counts(tg: Dict) -> Dict[str, float]:
    """The normalisers of the whole batch: positives and positive cells."""
    return {"positives": float(sum(len(p) for lv in tg["pairs"]
                                   for p in lv)),
            "cells": float(sum(c.sum() for c in tg["cells"]))}


def losses(cfg: Dict, preds: Dict, tg: Dict, norm: Dict[str, float],
           rows: slice) -> Dict[str, torch.Tensor]:
    """The weighted dice and focal terms of the images ``rows`` of the
    batch whose targets are ``tg``, over the whole batch's normalisers
    ``norm`` (``counts``): the terms of all blocks add up to the batch's."""
    nc = cfg["num_classes"]
    mask = preds["mask_pred"].float()                   # (b, Hm, Wm, K)
    b = mask.shape[0]
    feat = mask.reshape(b, -1, mask.shape[-1])
    t4 = tg["masks4"][rows].reshape(b, tg["masks4"].shape[1], -1)
    dice = mask.new_zeros(())
    for lv in range(NUM_LEVELS):
        kp = preds["kernel_preds"][lv].float().reshape(b, -1, feat.shape[-1])
        for i, pairs in enumerate(tg["pairs"][lv][rows]):
            if not pairs:
                continue
            cells = torch.tensor([c for c, _ in pairs], device=mask.device)
            inst = torch.tensor([j for _, j in pairs], device=mask.device)
            p = torch.sigmoid(kp[i, cells] @ feat[i].t())      # (P, HW)
            t = t4[i, inst]
            a = (p * t).sum(1)
            d = 1.0 - 2 * a / (((p * p).sum(1) + 0.001)
                               + ((t * t).sum(1) + 0.001))
            dice = dice + d.sum()
    logits = torch.cat([cp.float().reshape(b, -1, nc)
                        for cp in preds["cate_preds"]], 1).reshape(-1, nc)
    labels = torch.cat([lab[rows] for lab in tg["labels"]], 1).reshape(-1)
    t = F.one_hot(labels, nc + 1)[:, :nc].float()
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    pt = p * t + (1 - p) * (1 - t)
    al = cfg["focal_alpha"]
    focal = (al * t + (1 - al) * (1 - t)) * (1 - pt) ** cfg["focal_gamma"] \
        * ce
    return {"ins": cfg["dice_weight"] * dice / max(norm["positives"], 1.0),
            "cat": cfg["focal_weight"] * focal.sum() / (norm["cells"] + 1.0)}


class Trainer:
    """The network, its SGD state and ``step``."""

    def __init__(self, cfg: Dict, state: Dict[str, torch.Tensor], device,
                 block: int = 2):
        self.cfg, self.block = cfg, block
        with torch.device("meta"):
            net = SOLOv2(cfg)
        net = net.to_empty(device=device)
        net.load_state_dict(state)
        self.net = net.train()
        self.names = [n for n, p in net.named_parameters() if p.requires_grad]
        self.params = [p for p in net.parameters() if p.requires_grad]
        self.buf: List[torch.Tensor] = []
        self.updates = 0

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """One step on a dense batch (``image`` u8 BGR); returns the losses
        with ``total`` and the gradients before clipping."""
        cfg = self.cfg
        for p in self.params:
            p.grad = None
        tg = targets(cfg, batch)
        norm = counts(tg)
        total = {"ins": 0.0, "cat": 0.0}
        n = batch["image"].shape[0]
        for i in range(0, n, self.block):
            rows = slice(i, min(n, i + self.block))
            preds = self.net(normalise(batch["image"][rows]))
            out = losses(cfg, preds, tg, norm, rows)
            sum(out.values()).backward()
            for k, v in out.items():
                total[k] = total[k] + v.detach()
            del preds, out
        grads = [p.grad.detach().clone() for p in self.params]
        norm2 = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        coef = min(1.0, cfg["clip_grad_norm"] / (float(norm2) + 1e-6))
        lr = learning_rate(cfg, self.updates)
        wd, mu = cfg["weight_decay"], cfg["momentum"]
        with torch.no_grad():
            for k, (p, g) in enumerate(zip(self.params, grads)):
                # d = clipped gradient + decay; the first step's buffer is d
                d = g * coef + wd * p
                if self.updates == 0:
                    self.buf.append(d.clone())
                else:
                    self.buf[k].mul_(mu).add_(d)
                p.sub_(lr * self.buf[k])
        self.updates += 1
        total["total"] = total["ins"] + total["cat"]
        return {"losses": total, "grads": dict(zip(self.names, grads)),
                "grad_norm": float(norm2), "clip": coef,
                "positives": max(len(p) for lv in tg["pairs"] for p in lv),
                "positives_total": norm["positives"]}


def flops_per_image(cfg: Dict, h: int, w: int, positives: float) -> float:
    """A training step's operations an image: the network's forward and
    backward (the frozen stages' backward is not run, so not counted),
    by ``torch.utils.flop_counter`` on the meta device, and the dice
    products (the logits and the backward's two) of ``positives``, the
    positives an image holds over all levels (the slots that pad them to
    ``max_positives`` are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = SOLOv2(cfg).train()
    x = torch.empty(1, h, w, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        out = net(x)
        total = sum(t.sum() for v in out.values()
                    for t in (v if isinstance(v, list) else [v]))
        total.backward()
    hw = (h // 4) * (w // 4)
    dice = 3 * 2 * positives * hw * cfg["solov2"]["num_kernels"]
    return float(counter.get_total_flops()) + dice


def dcn_shapes(cfg: Dict, batch: int, h: int, w: int) -> List[Dict]:
    """(b, c, h, w, ho, wo) of every deformable convolution's call in a
    forward, backbone and towers at each level, on the meta device."""
    with torch.device("meta"):
        net = SOLOv2(cfg)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(dict(
            b=inp[0].shape[0], c=inp[0].shape[1], h=inp[0].shape[2],
            w=inp[0].shape[3], ho=out.shape[2], wo=out.shape[3])))
        for m in net.dcn_layers()]
    with torch.no_grad():
        net(torch.empty(batch, h, w, 3, device="meta"))
    for hk in hooks:
        hk.remove()
    return shapes
