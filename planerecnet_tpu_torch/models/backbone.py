"""ResNet-50/101 backbone with DCNv2 blocks, returning C2..C5 (NCHW).

Counterpart of ``planerecnet_tpu/models/backbone.py``. Module names follow
the reference's torch state_dict (``backbone.layers.{stage}.{block}...``).
A block's deformable conv2 replaces the 3x3 conv, chosen per block by
``_stage_plan``:
  * first block of a stage: ``use_dcn = dcn_layers[s] >= blocks``
  * block i >= 1: ``use_dcn = (i + dcn_layers[s]) >= blocks and
    i % dcn_interval == 0``
Every forward takes an optional spatial context ``rows``
(``parallel/halo.py::Rows``): with it, each layer runs on this rank's rows
of its map through the row-window ops of ``models/layers.py``.

``ResNetBackbone.forward(x, rows, remat=True)`` recomputes each stage
bottleneck's activations in the backward instead of storing them, as the
JAX package's ``nn.remat(Bottleneck)`` does: a block keeps only its input,
and the backward runs its forward again (``torch.utils.checkpoint``,
non-reentrant). The recompute normalises with the batch's statistics as
the forward did, and the BatchNorm running statistics are put back as the
forward left them (``_running_stats_kept``), so that they are updated
once a step, from the forward, as flax's ``batch_stats`` are. The stem
and the extra stages are not recomputed, as in JAX.

Where ``selected_layers`` reaches past the ResNet's stages, stride-2
bottleneck stages of 256 planes (1024 channels) are appended, as the JAX
package's ``extra{e}_0`` blocks (``backbone.layers.{4 + e}.0`` here, as
the reference appends them to ``layers``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from planerecnet_tpu_torch.config import BackboneConfig
from planerecnet_tpu_torch.models.layers import (BatchNorm2d, batch_norm,
                                                 conv2d, max_pool2d)
from planerecnet_tpu_torch.ops.dcn import deform_conv2d
from planerecnet_tpu_torch.utils.timer import span


class DeformableConv2d(nn.Module):
    """DCNv2 block: ``offset_conv`` predicts 2K offsets (always in f32),
    ``modulator_conv`` K modulators (``2*sigmoid``); offsets are clamped to
    ±max(H, W)/4 of this block's input, then the deformable sampling and the
    product with ``regular_conv``'s weight run as ``ops.dcn.deform_conv2d``.
    Takes and returns NCHW. ``deterministic`` (set by
    ``PlaneRecNet.set_deterministic``) selects the backward that sums in a
    fixed order on the card.

    Under a spatial context the offset and modulator convs are row-window
    convs, the clamp is the whole map's, and the sampling reads the whole
    input (``Rows.whole``: offsets are unbounded, so a sample may land on
    any row) for this rank's output rows (``deform_conv2d(row0=)``). Its
    backward scatters dx into the whole height; the gather's backward sums
    it over the spatial ranks onto the rows each owns.
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

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        h, w = x.shape[-2:]
        src, row0 = x, 0
        if rows is not None:
            h = rows.rows_of(x)
            src = rows.whole(x)
            if not rows.splits((h + 2 * self.padding - self.kernel_size)
                               // self.stride + 1):
                x, rows = src, None     # a whole output: the plain layer
        # Sub-pixel sampling positions lose too much precision in bf16.
        with torch.autocast(x.device.type, enabled=False):
            offset = conv2d(self.offset_conv, x.float(), rows)
        modulator = 2.0 * torch.sigmoid(conv2d(self.modulator_conv, x, rows))
        if rows is not None:
            row0 = rows.window(rows.rows_of(offset))[0]
        max_offset = max(h, w) / 4.0
        offset = offset.clamp(-max_offset, max_offset)

        dtype = self.dtype or x.dtype
        weight = self.regular_conv.weight.permute(2, 3, 1, 0)   # HWIO
        out = deform_conv2d(
            src.to(dtype).permute(0, 2, 3, 1).contiguous(),
            offset.permute(0, 2, 3, 1).contiguous(),
            modulator.float().permute(0, 2, 3, 1).contiguous(),
            weight.to(dtype), self.regular_conv.bias,
            stride=self.stride, padding=self.padding,
            kernel_size=self.kernel_size, deterministic=self.deterministic,
            row0=row0)
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

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        out = self.relu(batch_norm(self.bn1, self.conv1(x), rows))
        out = (self.conv2(out, rows)
               if isinstance(self.conv2, DeformableConv2d)
               else conv2d(self.conv2, out, rows))
        out = self.relu(batch_norm(self.bn2, out, rows))
        out = batch_norm(self.bn3, self.conv3(out), rows)
        residual = x if self.downsample is None else batch_norm(
            self.downsample[1], conv2d(self.downsample[0], x, rows), rows)
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


@contextlib.contextmanager
def _running_stats_kept(module: nn.Module):
    """The BatchNorm running statistics and ``num_batches_tracked`` under
    ``module`` as they were when it opened, put back when it closes. The
    recompute runs the block's norms as the forward ran them, so that it
    saves the same tensors (the batch's statistics normalise, the
    all-reduces of ``SyncBatchNorm2d`` run again on every rank alike), and
    each buffer keeps the forward's one update of the step."""
    bufs = [buf for m in module.modules() if isinstance(m, nn.BatchNorm2d)
            for buf in (m.running_mean, m.running_var,
                        m.num_batches_tracked)]
    kept = [buf.clone() for buf in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, old in zip(bufs, kept):
                buf.copy_(old)


@contextlib.contextmanager
def _recompute(module: nn.Module):
    """The checkpoint's second run of ``module``, in the backward: a
    ``backbone.recompute`` span, with the BatchNorm statistics kept."""
    with span("backbone.recompute"), _running_stats_kept(module):
        yield


def _remat(block: nn.Module, x: torch.Tensor, rows) -> torch.Tensor:
    """``block(x, rows)`` with its activations recomputed in the backward.
    No op of a bottleneck draws random numbers, so the RNG state is not
    kept; autocast is restored for the recompute by the checkpoint."""
    return torch.utils.checkpoint.checkpoint(
        block, x, rows, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(block)))


class ResNetBackbone(nn.Module):
    """ResNet stem + bottleneck stages (+ ``extra_layers`` stride-2
    stages); ``forward`` returns C2..C5 (and the extra stages' maps)."""

    def __init__(self, layers: Tuple[int, ...],
                 dcn_layers: Tuple[int, ...] = (0, 0, 0, 0),
                 dcn_interval: int = 1, atrous_layers: Tuple[int, ...] = (),
                 extra_layers: int = 0,
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
        self.base_stages = len(layers)
        for _ in range(extra_layers):
            self.layers.append(nn.Sequential(Bottleneck(
                inplanes, 256, stride=2, has_downsample=True, dtype=dtype)))
            inplanes = 256 * Bottleneck.expansion

    @property
    def channels(self) -> Tuple[int, ...]:
        extra = len(self.layers) - self.base_stages
        return (256, 512, 1024, 2048)[:self.base_stages] + (1024,) * extra

    def forward(self, x: torch.Tensor, rows=None, remat: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        x = self.relu(batch_norm(self.bn1, conv2d(self.conv1, x, rows), rows))
        x = max_pool2d(self.maxpool, x, rows)
        remat = remat and torch.is_grad_enabled()
        outs = []
        for s, stage in enumerate(self.layers):
            for block in stage:
                x = (_remat(block, x, rows) if remat and s < self.base_stages
                     else block(x, rows))
            outs.append(x)
        return tuple(outs)


def construct_backbone(cfg: BackboneConfig,
                       dtype: Optional[torch.dtype] = None) -> ResNetBackbone:
    """The backbone of ``cfg``, with a stride-2 stage appended for each
    selected layer past the ResNet's stages."""
    return ResNetBackbone(layers=tuple(cfg.layers),
                          dcn_layers=tuple(cfg.dcn_layers),
                          dcn_interval=cfg.dcn_interval,
                          atrous_layers=tuple(cfg.atrous_layers),
                          extra_layers=max(0, max(cfg.selected_layers) + 1
                                           - len(cfg.layers)),
                          dtype=dtype)
