"""Image ops of the inference path: resize, pad, normalise, coord grids.

Counterpart of ``planerecnet_tpu/ops/image.py``. The model runs NCHW inside,
so the resize and pad ops here take NCHW tensors; ``fast_base_transform``
keeps the public (B, H, W, 3) layout and ``point_sample_grid`` returns
(h, w, 2) as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from planerecnet_tpu_torch.config import MEANS, STD


@functools.lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int, device: torch.device):
    """Per output index: the two source indices and their weights.

    Half-pixel source position clamped to [0, in-1], computed in float64
    and rounded to f32 once, as the JAX package builds its resize matrix
    (``F.interpolate`` computes the position in f32, which at a source
    index near 60 is off by up to 4e-6).
    """
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
        in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    same = lo == hi   # clamped to the last row: one tap of weight 1
    w_lo = np.where(same, 1.0, 1.0 - frac).astype(np.float32)
    w_hi = np.where(same, 0.0, frac).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (lo, hi, w_lo, w_hi))


def _resize_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    lo, hi, w_lo, w_hi = _resize_taps(in_size, out_size, x.device)
    view = [1] * x.dim()
    view[dim] = out_size
    return (x.index_select(dim, lo) * w_lo.to(x.dtype).view(view)
            + x.index_select(dim, hi) * w_hi.to(x.dtype).view(view))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size=(H, W)``, rows then columns.

    Half-pixel convention with the source clamped to [0, in-1] and no
    antialiasing: the function of ``F.interpolate(align_corners=False)``,
    with the JAX package's float64 sample positions.
    """
    if not x.is_floating_point():
        x = x.float()
    return _resize_axis(_resize_axis(x, -2, size[0]), -1, size[1])


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW ``x``, floor convention
    ``src = floor(dst * in / out)``, with the indices computed in float64
    exactly as the JAX package does."""
    h, w = x.shape[-2:]
    oh, ow = size
    rows = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
    rows = torch.from_numpy(rows).to(x.device)
    cols = torch.from_numpy(cols).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NCHW ``x``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection padding of the two spatial dims of NCHW ``x``."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def fast_base_transform(images_bgr: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR pixels in [0, 255] -> (B, H, W, 3) normalised RGB."""
    mean = torch.tensor(MEANS, dtype=torch.float32, device=images_bgr.device)
    std = torch.tensor(STD, dtype=torch.float32, device=images_bgr.device)
    x = (images_bgr.float() - mean) / std
    return x.flip(-1)


def point_sample_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Coord-conv channels in [-1, 1]: (h, w, 2), channel 0 = x, 1 = y."""
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)
