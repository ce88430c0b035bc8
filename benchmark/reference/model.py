"""PlaneRecNet's forward in plain PyTorch: the benchmark's yardstick.

A frozen, independent statement of the network that
``planerecnet_tpu_torch/models`` implements (the upstream EryiXie/PlaneRecNet
``planerecnet.py`` with its ResNet-DCNv2 backbone, the reference FPN, the
SOLOv2 heads and the depth decoder with the cross-task mask injection),
written from the published architecture and the port's documented layouts
and nothing else. It imports nothing of the program. Module names give the
same state-dict keys as the program's, so that one seeded weight set loads
into both.

Departures from the program, each deliberate:
* The modulated deformable convolution gathers its four bilinear corners
  with plain indexing (a corner outside the map weighs 0, as in DCNv2)
  and multiplies with ``torch.matmul``; no custom kernel.
* Resizes are ``F.interpolate`` (bilinear, ``align_corners=False``, no
  antialiasing; nearest with the floor rule), whose sample positions are
  computed in f32 where the program computes them in f64: a difference of
  a few 1e-6 px.
* ``remat=True`` recomputes each backbone bottleneck in the backward
  (``torch.utils.checkpoint``) and puts its BatchNorm buffers back after
  the recompute, so that they are updated once a step, as the forward
  updates them. It only saves memory.

Layouts: ``forward`` takes normalised (B, H, W, 3) RGB images and returns
``cate_preds`` / ``kernel_preds`` (lists of (B, S, S, C)), ``mask_pred``
(B, H/4, W/4, K) and ``depth_pred`` (B, H/2, W/2, 1), as the program does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

NUM_INSTANCE_LEVELS = 4


def resize(x: torch.Tensor, size, mode: str = "bilinear") -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def deform_conv(x, offset, modulator, weight, bias, stride, padding):
    """Modulated deformable 3x3 convolution, NCHW. ``offset`` (B, 2K, Ho,
    Wo) holds (dy, dx) per tap k = 3i + j; ``modulator`` (B, K, Ho, Wo).
    Each sample is the bilinear blend of its four corners, a corner outside
    the map counting 0; the corners are ``floor`` of the sample position,
    a constant to the gradient (so at an integer position the derivative
    is the right-hand one, as DCNv2's is). Computed in f32, or in f64 for f64
    ``x`` (a witness for the f32 rounding)."""
    b, c, h, w = x.shape
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    ho, wo = offset.shape[-2:]
    ks = weight.shape[-1]
    k = ks * ks
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * stride - padding).to(dt)
    base_x = (torch.arange(wo, device=dev) * stride - padding).to(dt)
    taps = torch.arange(ks, device=dev, dtype=dt)
    ty = taps.repeat_interleave(ks)            # tap k = (k // 3, k % 3)
    tx = taps.repeat(ks)
    off = offset.to(dt).reshape(b, k, 2, ho, wo).permute(0, 3, 4, 1, 2)
    sy = base_y[None, :, None, None] + ty + off[..., 0]      # (B, Ho, Wo, K)
    sx = base_x[None, None, :, None] + tx + off[..., 1]
    y0, x0 = torch.floor(sy).detach(), torch.floor(sx).detach()
    fy, fx = sy - y0, sx - x0
    flat = x.to(dt).permute(0, 2, 3, 1).reshape(b, h * w, c)
    rows = torch.arange(b, device=dev)[:, None]
    sampled = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        weight_c = ((fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
                    * inside)
        at = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        sampled = sampled + flat[rows, at.reshape(b, -1)] * weight_c.reshape(
            b, -1, 1)
    mod = modulator.to(dt).permute(0, 2, 3, 1).reshape(b, -1, 1)
    cols = (sampled * mod).reshape(b, ho * wo, k * c)       # (tap, channel)
    wmat = weight.to(dt).permute(0, 2, 3, 1).reshape(weight.shape[0], k * c)
    out = torch.matmul(cols, wmat.t())
    if bias is not None:
        out = out + bias.to(dt)
    return out.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


class DeformableConv2d(nn.Module):
    def __init__(self, cin, cout, stride=1, padding=1, use_bias=True):
        super().__init__()
        self.offset_conv = nn.Conv2d(cin, 18, 3, stride, padding)
        self.modulator_conv = nn.Conv2d(cin, 9, 3, stride, padding)
        self.regular_conv = nn.Conv2d(cin, cout, 3, stride, padding,
                                      bias=use_bias)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        h, w = x.shape[-2:]
        offset = self.offset_conv(x)
        modulator = 2.0 * torch.sigmoid(self.modulator_conv(x))
        m = max(h, w) / 4.0
        offset = offset.clamp(-m, m)
        return deform_conv(x, offset, modulator, self.regular_conv.weight,
                           self.regular_conv.bias, self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dilation=1, use_dcn=False):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = (DeformableConv2d(planes, planes, stride, dilation)
                      if use_dcn else
                      nn.Conv2d(planes, planes, 3, stride, dilation,
                                dilation=dilation, bias=False))
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            nn.BatchNorm2d(out)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


@contextlib.contextmanager
def _buffers_kept(module):
    bufs = [b for m in module.modules() if isinstance(m, nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]
    kept = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, k in zip(bufs, kept):
                b.copy_(k)


class Backbone(nn.Module):
    """ResNet stem and bottleneck stages; a block carries a deformable
    conv2 where ``dcn_layers`` and ``dcn_interval`` say (the upstream
    rule: the last ``dcn_layers[s]`` blocks of stage s, every
    ``dcn_interval``-th of them after the first)."""

    def __init__(self, layers, dcn_layers, dcn_interval, extra_stages=0):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layers = nn.ModuleList()
        inplanes = 64
        for s, blocks in enumerate(layers):
            planes, stride = (64, 128, 256, 512)[s], (1, 2, 2, 2)[s]
            dcn = dcn_layers[s] if s < len(dcn_layers) else 0
            stage = []
            for i in range(blocks):
                use = (dcn >= blocks if i == 0 else
                       (i + dcn) >= blocks and i % dcn_interval == 0)
                stage.append(Bottleneck(
                    inplanes, planes, stride if i == 0 else 1,
                    i == 0 and (stride != 1 or inplanes != planes * 4),
                    use_dcn=use))
                inplanes = planes * 4
            self.layers.append(nn.Sequential(*stage))
        self.base_stages = len(layers)
        for _ in range(extra_stages):
            self.layers.append(nn.Sequential(
                Bottleneck(inplanes, 256, 2, True)))
            inplanes = 1024

    def forward(self, x, remat=False):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for s, stage in enumerate(self.layers):
            for block in stage:
                if remat and s < self.base_stages and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(
                        block, x, use_reentrant=False,
                        preserve_rng_state=False,
                        context_fn=lambda b=block: (
                            contextlib.nullcontext(), _buffers_kept(b)))
                else:
                    x = block(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """The upstream FPN: a running sum resized down to each next level."""

    def __init__(self, in_channels, num_features, start_level,
                 interpolation_mode, high_level_mode, relu_pred_layers):
        super().__init__()
        used = list(in_channels)[start_level:]
        self.start_level = start_level
        self.mode = interpolation_mode
        self.high_level_mode = high_level_mode
        self.relu = relu_pred_layers
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, num_features, 1)
                                           for c in used)
        self.fpn_convs = nn.ModuleList(
            nn.Conv2d(num_features, num_features, 3, padding=1) for _ in used)

    def forward(self, inputs):
        x, lats = None, []
        for conv, feat in zip(self.lateral_convs, inputs[self.start_level:]):
            lat = conv(feat)
            x = lat if x is None else lat + resize(x, feat.shape[-2:],
                                                    self.mode)
            lats.append(x)
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, lats)]
        outs = [F.relu(o) if self.relu else o for o in outs]
        if self.high_level_mode == "original":
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs


def coords(x):
    b, _, h, w = x.shape
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return torch.cat([x, grid.to(x.dtype)[None].expand(b, 2, h, w)], 1)


def gn(c):
    return nn.GroupNorm(32, c, eps=1e-5)


class InsHead(nn.Module):
    def __init__(self, sv, num_classes, cin):
        super().__init__()
        c = sv["instance_channels"]
        self.num_grids = sv["num_grids"]
        for name, first in (("kernel", cin + 2), ("cate", cin)):
            layers = []
            for i in range(sv["num_instance_convs"]):
                layers += [nn.Conv2d(first if i == 0 else c, c, 3, padding=1,
                                     bias=False), gn(c), nn.ReLU()]
            setattr(self, f"{name}_tower", nn.Sequential(*layers))
        self.cate_pred = nn.Conv2d(c, num_classes, 3, padding=1)
        self.kernel_pred = nn.Conv2d(c, sv["num_kernels"], 3, padding=1)

    def forward(self, feats):
        cates, kernels = [], []
        for i, f in enumerate(feats):
            s = self.num_grids[i]
            kf = resize(coords(f), (s, s))
            kernels.append(self.kernel_pred(self.kernel_tower(kf)))
            cates.append(self.cate_pred(self.cate_tower(kf[:, :-2])))
        return cates, kernels


class MaskHead(nn.Module):
    def __init__(self, sv, cin):
        super().__init__()
        mc = sv["masks_channels"]
        n = len(sv["masks_in_features"])

        def block(c):
            return nn.Sequential(nn.Conv2d(c, mc, 3, padding=1, bias=False),
                                 gn(mc), nn.ReLU())

        self.convs_all_levels = nn.ModuleList(
            nn.ModuleDict({f"conv{j}": block((cin + (2 if i == 3 else 0))
                                             if j == 0 else mc)
                           for j in range(max(i, 1))}) for i in range(n))
        self.conv_pred = nn.Sequential(
            nn.Conv2d(mc, sv["num_masks"], 1, bias=False),
            gn(sv["num_masks"]), nn.ReLU())

    def forward(self, feats):
        out = self.convs_all_levels[0]["conv0"](feats[0])
        for i in range(1, len(self.convs_all_levels)):
            x = coords(feats[i]) if i == 3 else feats[i]
            for j in range(i):
                x = self.convs_all_levels[i][f"conv{j}"](x)
                x = resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))
            out = out + x
        return self.conv_pred(out)


def conv_bn_relu(cin, cout, upsample=False):
    """[nearest 2x] + reflection pad 1 + 3x3 conv + BN(eps 1e-3, momentum
    0.01) + ReLU; Sequential indices as the program's."""
    pre = [nn.Upsample(scale_factor=2, mode="nearest")] if upsample else []
    return nn.Sequential(*pre, nn.ReflectionPad2d(1), nn.Conv2d(cin, cout, 3),
                         nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                         nn.ReLU())


class DepthDecoder(nn.Module):
    def __init__(self, in_channels, num_cells, f):
        super().__init__()
        f2, f4 = f // 2, f // 4
        c5, c4, c3, c2 = reversed(list(in_channels))
        self.conv1x1 = nn.Sequential(nn.Conv2d(num_cells, f, 1))
        self.latlayer1 = nn.Conv2d(c5, f, 1)
        self.conv1 = conv_bn_relu(f, f)
        self.deconv1 = conv_bn_relu(f, f, True)
        self.refine_conv = conv_bn_relu(2 * f, f2)
        self.latlayer2 = nn.Conv2d(c4, f, 1)
        self.conv2 = conv_bn_relu(f, f2)
        self.deconv2 = conv_bn_relu(2 * f2, f2, True)
        self.latlayer3 = nn.Conv2d(c3, f, 1)
        self.conv3 = conv_bn_relu(f, f2)
        self.deconv3 = conv_bn_relu(2 * f2, f2, True)
        self.latlayer4 = nn.Conv2d(c2, f, 1)
        self.conv4 = conv_bn_relu(f, f2)
        self.deconv4 = conv_bn_relu(2 * f2, f4, True)
        self.depth_pred = nn.Sequential(nn.ReflectionPad2d(1),
                                        nn.Conv2d(f4, 1, 3))

    def forward(self, feats, seg, kernel_preds):
        b, k, h, w = seg.shape
        kern = torch.cat([kp.permute(0, 2, 3, 1).reshape(b, -1, k)
                          for kp in kernel_preds], 1).detach()
        masks = torch.sigmoid(kern @ seg.detach().reshape(b, k, h * w))
        masks = self.conv1x1(masks.reshape(b, -1, h, w))
        masks = resize(masks, (h // 4, w // 4))
        c5, c4, c3, c2 = reversed(list(feats))
        x = self.deconv1(self.conv1(self.latlayer1(c5)))
        x = self.refine_conv(torch.cat([x, x * masks], 1))
        x = self.deconv2(torch.cat([self.conv2(self.latlayer2(c4)), x], 1))
        x = self.deconv3(torch.cat([self.conv3(self.latlayer3(c3)), x], 1))
        x = self.deconv4(torch.cat([self.conv4(self.latlayer4(c2)), x], 1))
        return F.softplus(self.depth_pred(x))


class PlaneRecNet(nn.Module):
    """The network of a configuration file's ``config`` dict."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        bb, sv = cfg["backbone"], cfg["solov2"]
        sel = bb["selected_layers"]
        extra = max(0, max(sel) + 1 - len(bb["layers"]))
        self.backbone = Backbone(bb["layers"], bb["dcn_layers"],
                                 bb["dcn_interval"], extra)
        chans = ((256, 512, 1024, 2048)[:len(bb["layers"])]
                 + (1024,) * extra)
        fc = cfg["fpn"]
        self.fpn = FPN([chans[i] for i in fc["selected_layers"]],
                       fc["num_features"], fc["start_level"] or 0,
                       fc["interpolation_mode"], fc["high_level_mode"],
                       fc["relu_pred_layers"])
        self.inst_head = InsHead(sv, cfg["num_classes"], fc["num_features"])
        self.mask_head = MaskHead(sv, fc["num_features"])
        cells = sum(s * s for s in sv["num_grids"][:NUM_INSTANCE_LEVELS])
        self.depth_decoder = DepthDecoder(
            [chans[i] for i in cfg["depth"]["selected_layers"]], cells,
            cfg["depth"]["num_features"])

    def dcn_layers(self) -> List[DeformableConv2d]:
        return [m for m in self.modules() if isinstance(m, DeformableConv2d)]

    def forward(self, x: torch.Tensor, remat: bool = False) -> Dict:
        cfg = self.cfg
        feats = self.backbone(x.permute(0, 3, 1, 2), remat)
        pyr = self.fpn([feats[i] for i in cfg["fpn"]["selected_layers"]])
        p2 = pyr[0]
        ins = [resize(p2, (p2.shape[-2] // 2, p2.shape[-1] // 2)),
               *pyr[1:NUM_INSTANCE_LEVELS]]
        cates, kernels = self.inst_head(ins)
        mask = self.mask_head(pyr[:len(cfg["solov2"]["masks_in_features"])])
        depth = self.depth_decoder(
            [feats[i] for i in cfg["depth"]["selected_layers"]], mask, kernels)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {"cate_preds": [nhwc(t) for t in cates],
                "kernel_preds": [nhwc(t) for t in kernels],
                "mask_pred": nhwc(mask), "depth_pred": nhwc(depth)}


MEANS = (103.94, 116.78, 123.68)
STD = (57.38, 57.12, 58.40)


def normalise(images_bgr: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR pixels in [0, 255] -> normalised RGB, f32."""
    mean = torch.tensor(MEANS, device=images_bgr.device)
    std = torch.tensor(STD, device=images_bgr.device)
    return ((images_bgr.float() - mean) / std).flip(-1)


def prior_bias(pi: float) -> float:
    return -math.log((1 - pi) / pi)


def named_shapes(cfg: Dict) -> Sequence:
    """(name, shape, kind) of every parameter and buffer of the network,
    built on the meta device (no memory, no init)."""
    with torch.device("meta"):
        net = PlaneRecNet(cfg)
    out = [(n, tuple(p.shape), "param") for n, p in net.named_parameters()]
    out += [(n, tuple(b.shape), "buffer") for n, b in net.named_buffers()]
    return out
