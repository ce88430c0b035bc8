"""Shared building blocks (counterpart of ``planerecnet_tpu/models/layers.py``).

The JAX package's ``TorchBatchNorm`` is torch's ``nn.BatchNorm2d``. In eval
mode both compute ``(x - mean) * rsqrt(var + eps) * weight + bias`` with the
running statistics. In train mode both normalise with the batch's biased
variance and update the running variance with the Bessel-corrected one;
torch's ``momentum`` is one minus flax's (0.1 in the backbone, 0.01 in the
depth decoder).

In the bf16 mode the convolutions run in bf16 under ``torch.autocast``,
and the norms, as the JAX package's, in f32: ``TorchBatchNorm`` returns
f32 and flax's ``GroupNorm`` takes the f32 of its parameters, so the
residual sums and the ReLUs after them stay f32. ``BatchNorm2d`` and
``GroupNorm`` below are torch's with their input in f32 (the same module
in f32 mode); torch's autocast would keep a bf16 BatchNorm in bf16, and a
GroupNorm in bf16 on the CPU and f32 on the card.

The row-window ops (``conv2d``, ``max_pool2d``, ``batch_norm``,
``group_norm``, ``run_rows``) take a spatial context ``rows``
(``parallel/halo.py::Rows``) or None. With None each is the module's own
call. Under a context a row-sharded map reads its neighbours' rows where
a window crosses into them and does the unsplit op's own edge handling
only at the image's top and bottom; a map whose output height does not
split is made whole first, and a whole map whose output splits is cut to
this rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from planerecnet_tpu_torch.ops.image import ReflectPad2d, reflect_pad
from planerecnet_tpu_torch.parallel.spmd import SyncBatchNorm2d


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` in f32 whatever its input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in f32 whatever its input's type. A group of one
    value (a 1x1 map with one channel a group) is flax's: ``_group_norm``
    gives its bias, where torch's kernel normalises the rounding noise of
    ``x - mean`` (and its functional check refuses a batch of one)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x[0].numel() == self.num_groups:
            return _group_norm(self, x)
        return super().forward(x)


def _group_norm(m: nn.GroupNorm, x: torch.Tensor, rows=None
                ) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` in f32 with its statistics computed here:
    the mean, then the variance about it, each over the (image, group)'s
    count, summed over the spatial ranks of ``rows`` where it is given."""
    x = x.float()
    b, c = x.shape[:2]
    xg = x.reshape(b, m.num_groups, -1)
    total = (lambda t: t) if rows is None else rows.sum
    n = xg.shape[-1] * (1 if rows is None else rows.n)
    mean = total(xg.sum(-1)) / n
    d = xg - mean[..., None]
    var = total((d * d).sum(-1)) / n
    y = (d * torch.rsqrt(var + m.eps)[..., None]).reshape(x.shape)
    return y * m.weight.view(1, c, 1, 1) + m.bias.view(1, c, 1, 1)


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
                         BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                         nn.ReLU())

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        return run_rows(self, x, rows)


def _window(m, x, rows, edge, op):
    """``op(x')`` for a (k, s, p) window op ``m`` under ``rows``: on this
    rank's rows with the halo the window reads (``edge`` at the image's
    top and bottom, no row padding left to ``op``), or on the whole map,
    cut to the output's layout."""
    k, s, p, d = (_pair(v)[0] for v in (m.kernel_size, m.stride, m.padding,
                                        m.dilation))
    span = d * (k - 1) + 1
    g = rows.rows_of(x)
    above, below = p, max(span - p - s, 0)
    if not (rows.sharded(x) and rows.splits((g + 2 * p - span) // s + 1)) \
            or max(above, below) > x.shape[-2]:
        return rows.local(m(rows.whole(x)))
    return op(rows.halo(x, above, below, edge) if above or below else x)


def conv2d(m: nn.Conv2d, x: torch.Tensor, rows=None) -> torch.Tensor:
    """``m(x)``; under ``rows``, zero rows at the image's edges only."""
    if rows is None:
        return m(x)
    return _window(m, x, rows, "zeros", lambda e: F.conv2d(
        e, m.weight, m.bias, m.stride, (0, m.padding[1]), m.dilation,
        m.groups))


def max_pool2d(m: nn.MaxPool2d, x: torch.Tensor, rows=None) -> torch.Tensor:
    """``m(x)``; under ``rows``, -inf rows at the image's edges only."""
    if rows is None:
        return m(x)
    return _window(m, x, rows, "-inf", lambda e: F.max_pool2d(
        e, m.kernel_size, m.stride, (0, m.padding), m.dilation))


def batch_norm(m: nn.BatchNorm2d, x: torch.Tensor, rows=None
               ) -> torch.Tensor:
    """``m(x)``; under ``rows`` a training ``SyncBatchNorm2d`` takes its
    statistics over the ranks that hold disjoint parts of ``x``'s images
    (``Rows.norm_group``). A training BatchNorm that does not sync would
    normalise each shard alone, so it is refused."""
    if rows is None or not m.training:
        return m(x)
    if not isinstance(m, SyncBatchNorm2d):
        raise ValueError("a training BatchNorm under the spatial axis must "
                         "be a SyncBatchNorm2d (create_train_state(mesh=))")
    return m(x, group=rows.norm_group(x))


def group_norm(m: nn.GroupNorm, x: torch.Tensor, rows=None) -> torch.Tensor:
    """``m(x)``; under ``rows`` a row-sharded map's per-(image, group)
    statistics are summed over the spatial ranks (``sum_rows``): the mean,
    then the variance about it, each over the whole map's count, in f32."""
    if rows is None or not rows.sharded(x):
        return m(x)
    return _group_norm(m, x, rows)


def run_rows(seq: nn.Sequential, x: torch.Tensor, rows=None) -> torch.Tensor:
    """A Sequential of [nearest upsample], ``ReflectPad2d``, a conv without
    padding, [BatchNorm], [ReLU] (the depth decoder's blocks and head):
    ``seq(x)``, or under ``rows`` with the pad across the shards."""
    if rows is None:
        return nn.Sequential.forward(seq, x)
    for m in seq:
        if isinstance(m, nn.Upsample):
            x = rows.local(m(x))
        elif isinstance(m, ReflectPad2d):
            x = reflect_pad(x, m.pad, rows)
        elif isinstance(m, nn.BatchNorm2d):
            x = batch_norm(m, x, rows)
        else:
            x = m(x)
    return x
