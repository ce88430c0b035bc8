"""Image ops: resize (and its matrix), pad, normalise, coord grids.

Counterpart of ``planerecnet_tpu/ops/image.py``. The model runs NCHW inside,
so the resize and pad ops here take NCHW tensors; ``fast_base_transform``
keeps the public (B, H, W, 3) layout and ``point_sample_grid`` returns
(h, w, 2) as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from planerecnet_tpu_torch.config import MEANS, STD


def _source_taps(in_size: int, out_size: int):
    """Per output index: the two source indices and, in float64, the
    fraction of the second. Half-pixel source position clamped to
    [0, in-1], as the JAX package builds its resize matrix."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
        in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, src - lo


@functools.lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int, device: torch.device):
    """Per output index: the two source indices and their weights.

    The positions are computed in float64 and rounded to f32 once
    (``F.interpolate`` computes the position in f32, which at a source
    index near 60 is off by up to 4e-6).
    """
    lo, hi, frac = _source_taps(in_size, out_size)
    same = lo == hi   # clamped to the last row: one tap of weight 1
    w_lo = np.where(same, 1.0, 1.0 - frac).astype(np.float32)
    w_hi = np.where(same, 0.0, frac).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (lo, hi, w_lo, w_hi))


@functools.lru_cache(maxsize=256)
def _resize_weights(in_size: int, out_size: int,
                    device=None) -> torch.Tensor:
    """Dense (in, out) f32 bilinear interpolation matrix of the resize from
    ``in_size`` to ``out_size``: column j holds output j's two taps (the
    identity when the sizes are equal). Counterpart of the JAX package's
    ``ops/image.py::_resize_weights``, from the same float64 positions.
    Cached per (sizes, device), as ``_resize_taps`` is: callers must not
    write into it."""
    if in_size == out_size:
        return torch.eye(in_size, device=device)
    lo, hi, frac = _source_taps(in_size, out_size)
    w = np.zeros((in_size, out_size), np.float64)
    cols = np.arange(out_size)
    np.add.at(w, (lo, cols), 1.0 - frac)
    np.add.at(w, (hi, cols), frac)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def _resize_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    lo, hi, w_lo, w_hi = _resize_taps(in_size, out_size, x.device)
    view = [1] * x.dim()
    view[dim] = out_size
    return (x.index_select(dim, lo) * w_lo.to(x.dtype).view(view)
            + x.index_select(dim, hi) * w_hi.to(x.dtype).view(view))


def _nearest_sources(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output of a nearest resize."""
    return np.minimum((np.arange(out_size) * (in_size / out_size)).astype(
        np.int64), in_size - 1)


@functools.lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """``_nearest_sources`` on ``device``, cached per device as
    ``_resize_taps`` is: callers must not write into it."""
    return torch.from_numpy(_nearest_sources(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=256)
def _window_taps(in_size: int, out_size: int, n: int, index: int,
                 nearest: bool, device):
    """Rank ``index`` of ``n`` row-sharded ranks' part of a resize of the
    rows from ``in_size`` to ``out_size``: (above, below), the most rows
    beyond its own shard that any rank's output rows read (every rank
    exchanges as many), and its output rows' taps into its rows with that
    halo, (lo, hi, w_lo, w_hi) on ``device`` (a nearest resize: lo
    alone), the whole resize's. Cached per device, as ``_resize_taps``:
    callers must not write into them."""
    if nearest:
        lo = hi = _nearest_sources(in_size, out_size)
    else:
        lo, hi, _ = _source_taps(in_size, out_size)
    h, c = in_size // n, out_size // n
    above = max(max(s * h - int(lo[s * c:(s + 1) * c].min()) for s in
                    range(n)), 0)
    below = max(max(int(hi[s * c:(s + 1) * c].max()) - ((s + 1) * h - 1)
                    for s in range(n)), 0)
    mine, x0 = slice(index * c, (index + 1) * c), index * h - above
    taps = [torch.from_numpy(t[mine] - x0).to(device) for t in (lo, hi)]
    if nearest:
        return above, below, taps[0]
    _, _, w_lo, w_hi = _resize_taps(in_size, out_size, device)
    return above, below, *taps, w_lo[mine], w_hi[mine]


def _resize_rows(x: torch.Tensor, out_h: int, rows, nearest: bool
                 ) -> torch.Tensor:
    """The row pass of a resize under a spatial context ``rows``
    (``parallel/halo.py::Rows``): in the layout its rule gives the output.
    A sharded map to a sharded output reads its neighbours' rows that its
    output rows' taps reach (``halo_rows``), and computes its output rows
    as the whole resize computes them; otherwise the map is made whole,
    resized, and cut."""
    g = rows.rows_of(x)
    if g == out_h:
        return x
    first, count = rows.window(out_h)
    window = None
    if rows.sharded(x) and rows.splits(out_h):
        window = _window_taps(g, out_h, rows.n, rows.mesh.spatial_index,
                              nearest, x.device)
    if window is None or max(window[:2]) > x.shape[-2]:
        whole = rows.whole(x)
        y = (whole.index_select(-2, torch.from_numpy(_nearest_sources(
            g, out_h)).to(x.device)) if nearest
            else _resize_axis(whole, -2, out_h))
        return y[..., first:first + count, :] if rows.splits(out_h) else y
    above, below, *taps = window
    ext = rows.halo(x, above, below) if above or below else x
    if nearest:
        return ext.index_select(-2, taps[0])
    lo, hi, w_lo, w_hi = taps
    view = [1] * x.dim()
    view[-2] = count
    return (ext.index_select(-2, lo) * w_lo.to(x.dtype).view(view)
            + ext.index_select(-2, hi) * w_hi.to(x.dtype).view(view))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    rows=None) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size=(H, W)``, rows then columns.

    Half-pixel convention with the source clamped to [0, in-1] and no
    antialiasing: the function of ``F.interpolate(align_corners=False)``,
    with the JAX package's float64 sample positions. Under a spatial
    context ``rows`` (``parallel/halo.py::Rows``), ``size`` is global and
    ``x`` and the result are in the layout its rule gives them.
    """
    if not x.is_floating_point():
        x = x.float()
    if rows is None:
        return _resize_axis(_resize_axis(x, -2, size[0]), -1, size[1])
    return _resize_axis(_resize_rows(x, size[0], rows, False), -1, size[1])


def resize_nearest(x: torch.Tensor, size: Tuple[int, int],
                   rows=None) -> torch.Tensor:
    """Nearest resize of NCHW ``x``, floor convention
    ``src = floor(dst * in / out)``, with the indices computed in float64
    exactly as the JAX package does; ``rows`` as ``resize_bilinear``."""
    w = x.shape[-1]
    oh, ow = size
    cols = _nearest_index(w, ow, x.device)
    if rows is None:
        x = x.index_select(-2, _nearest_index(x.shape[-2], oh, x.device))
    else:
        x = _resize_rows(x, oh, rows, True)
    return x.index_select(-1, cols)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NCHW ``x``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _reflect_sources(n: int, pad: int) -> np.ndarray:
    """The input index that each of the n + 2 pad outputs copies; an axis
    of one repeats it, as ``np.pad(mode="reflect")`` does."""
    if n == 1:
        return np.zeros(1 + 2 * pad, np.int64)
    o = np.abs(np.arange(-pad, n + pad))
    return np.where(o > n - 1, 2 * (n - 1) - o, o)


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """``_reflect_sources`` on ``device``, cached per device: callers must
    not write into it."""
    return torch.from_numpy(_reflect_sources(n, pad)).to(device)


@functools.lru_cache(maxsize=None)
def _reflect_frame(h: int, w: int, pad: int, device) -> List[Tuple]:
    """The strips of an h x w input that more than one output copies:
    [(dim, runs, n, idx, valid)], the rows (dim -2) and the columns (-1),
    each a list of slices of n rows or columns in all; ``idx[s, q]`` the
    flat index of the s-th output, in row-major order of the output, that
    copies the q-th pixel of those strips (row-major), where ``valid[s,
    q]``."""
    def copies(n):
        src = _reflect_sources(n, pad)
        outs = [np.flatnonzero(src == i) for i in range(n)]
        m = max(len(o) for o in outs)
        idx = np.zeros((m, n), np.int64)
        valid = np.zeros((m, n), bool)
        for i, o in enumerate(outs):
            idx[:len(o), i] = o
            valid[:len(o), i] = True
        return idx, valid

    (ir, vr), (ic, vc) = copies(h), copies(w)
    groups = []
    for dim, valid in ((-2, vr), (-1, vc)):
        runs = []
        for i in np.flatnonzero(valid.sum(0) > 1):
            if runs and runs[-1][1] == i:
                runs[-1][1] = i + 1
            else:
                runs.append([i, i + 1])
        if not runs:
            continue
        sel = np.concatenate([np.arange(a, b) for a, b in runs])
        if dim == -2:
            ii, jj = np.repeat(sel, w), np.tile(np.arange(w), len(sel))
        else:
            ii, jj = np.repeat(np.arange(h), len(sel)), np.tile(sel, h)
        s = [(a, b) for a in range(len(ir)) for b in range(len(ic))]
        idx = np.stack([ir[a, ii] * (w + 2 * pad) + ic[b, jj] for a, b in s])
        ok = np.stack([vr[a, ii] & vc[b, jj] for a, b in s])
        groups.append((dim, [slice(int(a), int(b)) for a, b in runs],
                       len(sel), torch.from_numpy(idx).to(device),
                       torch.from_numpy(ok).to(device)))
    return groups


class _ReflectPad(torch.autograd.Function):
    """``F.pad(mode="reflect")`` with a backward that sums in a fixed order
    on every device: each input pixel adds the gradients of the output
    pixels that copy it in row-major order of the output, the order (and
    so the rounding) of ``F.pad``'s CPU backward. Its CUDA backward adds
    with atomics, and PyTorch's deterministic mode refuses it. Most pixels
    have one such output, a copy; only the strips beside the border add
    more, the rows' and the columns' each gathered in one index_select and
    written by slices. An axis of length 1, which ``F.pad`` refuses, is
    repeated: its pad rows or columns copy it."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad, ctx.hw = pad, tuple(x.shape[-2:])
        # F.pad keeps a channels-last input's layout (in its output and its
        # gradient), and the convolutions around it take other paths, with
        # other roundings, on the two layouts.
        ctx.layout = (torch.channels_last if x.dim() == 4
                      and not x.is_contiguous()
                      and x.is_contiguous(memory_format=torch.channels_last)
                      else torch.contiguous_format)
        h, w = ctx.hw
        if min(h, w) > 1:
            return F.pad(x, (pad,) * 4, mode="reflect")
        for dim, n in ((-2, h), (-1, w)):
            x = x.index_select(dim, _reflect_index(n, pad, x.device))
        return x.contiguous(memory_format=ctx.layout)

    @staticmethod
    def backward(ctx, g):
        p, (h, w) = ctx.pad, ctx.hw
        dx = torch.empty((*g.shape[:-2], h, w), dtype=g.dtype,
                         device=g.device, memory_format=ctx.layout)
        # zero + the one output that copies each pixel, as F.pad starts
        torch.add(g[..., p:p + h, p:p + w], 0.0, out=dx)
        for dim, runs, n, idx, valid in _reflect_frame(h, w, p, g.device):
            v = torch.where(valid, g.flatten(-2).index_select(
                -1, idx.flatten()).unflatten(-1, tuple(idx.shape)), 0.0)
            acc = 0.0
            for s in range(idx.shape[0]):
                acc = acc + v[..., s, :]
            acc = acc.unflatten(-1, (n, w) if dim == -2 else (h, n))
            k = 0
            for r in runs:
                m = r.stop - r.start
                if dim == -2:
                    dx[..., r, :] = acc[..., k:k + m, :]
                else:
                    dx[..., :, r] = acc[..., :, k:k + m]
                k += m
        return dx, None


def reflect_pad(x: torch.Tensor, pad: int = 1, rows=None) -> torch.Tensor:
    """Reflection padding of the two spatial dims of NCHW ``x``: the
    values and gradients of ``F.pad(mode="reflect")``, with a backward
    that is deterministic on the card too (``_ReflectPad``). Under a
    spatial context ``rows`` (``parallel/halo.py::Rows``) a row-sharded
    ``x`` takes its neighbours' rows inside the image and reflects at the
    image's top and bottom only (``halo_rows``); the columns are
    reflected as before."""
    if rows is None or not rows.sharded(x):
        return _ReflectPad.apply(x, pad)
    ext = rows.halo(x, pad, pad, "reflect")
    return _ReflectPad.apply(ext, pad)[..., pad:-pad, :]


class ReflectPad2d(torch.nn.Module):
    """``nn.ReflectionPad2d`` through ``reflect_pad``; no parameters, so
    it takes a ``Sequential`` index without moving the state-dict keys."""

    def __init__(self, pad: int = 1):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.pad)


def pad_to_multiple(x: np.ndarray, divisor: int = 32) -> np.ndarray:
    """Zero-pad an HWC image at the bottom and right so that H and W
    divide ``divisor`` (host side)."""
    h, w = x.shape[:2]
    ext_h, ext_w = (-h) % divisor, (-w) % divisor
    if ext_h == 0 and ext_w == 0:
        return x
    pads = [(0, ext_h), (0, ext_w)] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pads, mode="constant")


def calc_size_preserve_ar(img_w: int, img_h: int, max_size: int
                          ) -> Tuple[int, int]:
    """(w, h) with the long side ``max_size`` and the aspect kept."""
    if img_w > img_h:
        w, h = max_size, img_h / img_w * max_size
    else:
        h, w = max_size, img_w / img_h * max_size
    return int(w), int(h)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``MEANS`` and ``STD`` as f32 tensors on ``device``, copied there
    once; callers must not write into them."""
    return (torch.tensor(MEANS, dtype=torch.float32, device=device),
            torch.tensor(STD, dtype=torch.float32, device=device))


def fast_base_transform(images_bgr: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR pixels in [0, 255] -> (B, H, W, 3) normalised RGB."""
    mean, std = _mean_std(images_bgr.device)
    x = (images_bgr.float() - mean) / std
    return x.flip(-1)


def point_sample_grid(h: int, w: int, device=None,
                      window: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Coord-conv channels in [-1, 1]: (h, w, 2), channel 0 = x, 1 = y;
    with ``window=(first, rows)`` only those rows of the h-row grid."""
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    if window is not None:
        ys = ys[window[0]:window[0] + window[1]]
        h = window[1]
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)
