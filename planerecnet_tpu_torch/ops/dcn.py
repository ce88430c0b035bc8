"""Modulated deformable convolution (DCNv2), NHWC.

Counterpart of ``planerecnet_tpu/ops/dcn.py::deform_conv2d`` with the same
contract: NHWC ``x``; ``offset`` (B, Ho, Wo, 2K) with channel ``2k`` the y and
``2k+1`` the x offset of tap ``k``; ``mask`` (B, Ho, Wo, K); HWIO ``weight``.

The op is a deformable im2col followed by one matmul. The im2col is a CUDA
kernel (``csrc/dcn_im2col.cu``, see the note there), built with ``nvcc`` at
first use into ``_build/`` and called through ``ctypes``. One launch covers
a whole batch. ``deform_im2col`` sends a CUDA tensor to the kernel and a CPU
tensor to ``deform_im2col_plain``, the plain PyTorch version beside it; the
product is ``torch.matmul`` either way.

``deform_conv2d`` is a ``torch.autograd.Function`` on both devices (the
ctypes launch leaves its output outside autograd's graph). Its backward is
the JAX package's hand-written ``_dcn_bwd``: the im2col again with a unit
mask for the samples, matmuls for dcols and dweight, plain torch gathers
for dmask and doffset, and the scatter kernel (``ops/dcn_scatter.py``) for
dx, or its deterministic variant when ``deform_conv2d`` is called with
``deterministic=True``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from planerecnet_tpu_torch.ops import cuda_build
from planerecnet_tpu_torch.ops.dcn_scatter import CORNERS, dcn_input_grad

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernel indexes with 32-bit ints.
_MAX_ELEMS = 2 ** 30


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("dcn_im2col")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"prn_dcn_im2col_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_args(x, offset, mask, kernel_size, stride, padding, row0):
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError("x, offset and mask must be 4-D (NHWC)")
    b, h, _, _ = x.shape
    k = kernel_size * kernel_size
    ob, ho, wo, oc = offset.shape
    if ob != b or oc != 2 * k:
        raise ValueError(f"offset {tuple(offset.shape)} does not match "
                         f"batch {b} and {k} taps")
    if tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, ho, wo, k)}")
    rows = (h + 2 * padding - kernel_size) // stride + 1
    if row0 < 0 or row0 + ho > rows:
        raise ValueError(f"output rows {row0}..{row0 + ho - 1} outside the "
                         f"{rows} rows of a {h}-row input")


def _sample_positions(offset: torch.Tensor, stride: int, padding: int,
                      kernel_size: int, row0: int = 0):
    """Float sample coordinates (sy, sx), each (B, Ho*Wo*K) f32, row
    (p, k) for output pixel p and tap k; the offset's rows are the output
    rows ``row0..row0+Ho-1`` (the integer part is exact, so a window's
    positions are the whole map's)."""
    b, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    dev = offset.device
    oy = ((row0 + torch.arange(ho, device=dev)) * stride - padding).float()
    ox = (torch.arange(wo, device=dev) * stride - padding).float()
    taps = torch.arange(kernel_size, device=dev, dtype=torch.float32)
    ty, tx = torch.meshgrid(taps, taps, indexing="ij")
    off = offset.float().reshape(b, ho, wo, k, 2)
    sy = (oy[None, :, None, None] + ty.reshape(1, 1, 1, k)) + off[..., 0]
    sx = (ox[None, None, :, None] + tx.reshape(1, 1, 1, k)) + off[..., 1]
    return sy.reshape(b, -1), sx.reshape(b, -1)


def _corners(sy: torch.Tensor, sx: torch.Tensor, h: int, w: int):
    """The bilinear corners of each sample, in the order (00, 01, 10, 11):
    (y0, x0, fy, fx, [(valid, weight, flat_id)] * 4). ``floor`` is a
    constant of the sample position, as it is to JAX's autodiff; a corner
    outside the map has weight 0 and a clamped id."""
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    out = []
    for dy, dx in CORNERS:
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        wy = fy if dy else 1.0 - fy
        wx = fx if dx else 1.0 - fx
        flat = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        out.append((valid, torch.where(valid, wy * wx, 0.0), flat))
    return y0, x0, fy, fx, out


def _gather_rows(x_flat: torch.Tensor, flat_id: torch.Tensor) -> torch.Tensor:
    """x_flat (B, H*W, C) at flat_id (B, R) -> (B, R, C)."""
    rows = torch.arange(x_flat.shape[0], device=x_flat.device)[:, None]
    return x_flat[rows, flat_id]


def deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, *, stride: int = 1,
                        padding: int = 1, kernel_size: int = 3,
                        row0: int = 0) -> torch.Tensor:
    """Plain PyTorch deformable im2col: (B, Ho*Wo, K*Cin) in ``x.dtype``,
    for the output rows ``row0..row0+Ho-1`` (Ho the offset's rows).

    The arithmetic of the JAX package's ``_forward_chunk``: f32 sample
    positions, four validity-weighted corner gathers in the order
    (00, 01, 10, 11), their sum, then the modulation.
    """
    _check_args(x, offset, mask, kernel_size, stride, padding, row0)
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    sy, sx = _sample_positions(offset, stride, padding, kernel_size, row0)
    _, _, _, _, corners = _corners(sy, sx, h, w)
    x_flat = x.reshape(b, h * w, cin)
    gathered = torch.stack([_gather_rows(x_flat, flat)
                            for _, _, flat in corners], dim=2)  # (B, R, 4, C)
    wts = torch.stack([wt for _, wt, _ in corners],
                      dim=-1)[..., None].to(x.dtype)            # (B, R, 4, 1)
    sampled = (gathered * wts).sum(dim=2).reshape(b, ho * wo, k, cin)
    sampled = sampled * mask.reshape(b, ho * wo, k, 1).to(x.dtype)
    return sampled.reshape(b, ho * wo, k * cin)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  *, stride: int = 1, padding: int = 1,
                  kernel_size: int = 3, row0: int = 0) -> torch.Tensor:
    """Deformable im2col, (B, Ho*Wo, K*Cin) in ``x.dtype``, for the output
    rows ``row0..row0+Ho-1`` (a spatial rank's window).

    A CPU ``x`` goes to ``deform_im2col_plain``. A CUDA ``x`` goes to the
    kernel, which takes contiguous f32 or bf16 ``x`` with contiguous f32
    ``offset`` and ``mask`` on the same card, and raises on anything else.
    ``deform_im2col.launches`` counts the kernel's launches,
    ``deform_im2col.bf16_launches`` those of them on bf16 ``x``.
    """
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offset, mask, stride=stride,
                                   padding=padding, kernel_size=kernel_size,
                                   row0=row0)
    if x.device.type != "cuda":
        raise ValueError(f"deform_im2col: unsupported device {x.device}")
    _check_args(x, offset, mask, kernel_size, stride, padding, row0)
    if x.dtype not in _DTYPES:
        raise TypeError(f"deform_im2col: x must be f32 or bf16, not {x.dtype}")
    if offset.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("deform_im2col: offset and mask must be f32")
    for name, t in (("x", x), ("offset", offset), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"deform_im2col: {name} on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"deform_im2col: {name} is not contiguous")
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    cols = torch.empty((b, ho * wo, k * cin), dtype=x.dtype, device=x.device)
    if max(cols.numel(), x.numel()) >= _MAX_ELEMS:
        raise ValueError("deform_im2col: tensor too large for 32-bit indexing")
    fn = getattr(_library(), f"prn_dcn_im2col_{_DTYPES[x.dtype]}")
    # The launch is asynchronous. Inputs the caller frees after return are
    # safe: the caching allocator hands their memory only to work queued
    # later on this stream.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 cols.data_ptr(), b, h, w, cin, ho, wo, kernel_size, stride,
                 padding, row0, stream)
    cuda_build.check_launch(err, "dcn_im2col")
    deform_im2col.launches += 1
    deform_im2col.bf16_launches += x.dtype == torch.bfloat16
    return cols


deform_im2col.launches = 0
deform_im2col.bf16_launches = 0


def _dcn_backward(x, offset, mask, weight, has_bias, dout, stride, padding,
                  kernel_size, deterministic=False, row0=0):
    """The analytic backward of ``deform_conv2d``, term by term the JAX
    package's ``_dcn_bwd``, in f32: (dx, doffset, dmask, dweight, dbias);
    dx over the whole of ``x`` from the output rows of the window."""
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    p = ho * wo
    cout = weight.shape[-1]
    dflat = dout.float().reshape(b, p, cout)
    dcols = torch.matmul(dflat, weight.float().reshape(k * cin, cout).t())
    dcols_r = dcols.reshape(b, p * k, cin)                    # (B, R, Cin)

    # The unmodulated samples, recomputed by the im2col with a unit mask
    # rather than saved (9x the input at every layer).
    x32 = x.float().contiguous()
    geom = dict(stride=stride, padding=padding, kernel_size=kernel_size)
    samples = deform_im2col(x32, offset, torch.ones_like(mask), row0=row0,
                            **geom)
    maskf = mask.float()
    cols = samples.reshape(b, p, k, cin) * maskf.reshape(b, p, k, 1)
    dweight = torch.matmul(cols.reshape(b * p, k * cin).t(),
                           dflat.reshape(b * p, cout)).reshape(weight.shape)
    dbias = dout.float().sum(dim=(0, 1, 2)) if has_bias else None
    dmask = (samples.reshape(b, p * k, cin) * dcols_r).sum(-1)
    dmask = dmask.reshape(b, ho, wo, k)

    # doffset: the bilinear weights' derivatives against the corner dots,
    # gated on in-bounds corners, not on weight > 0: at an integer sample
    # position a corner has weight 0 but a non-zero derivative.
    sy, sx = _sample_positions(offset, stride, padding, kernel_size, row0)
    y0, x0, fy, fx, corners = _corners(sy, sx, h, w)
    x_flat = x32.reshape(b, h * w, cin)
    d00, d01, d10, d11 = [
        torch.where(valid, (_gather_rows(x_flat, flat) * dcols_r).sum(-1), 0.0)
        for valid, _, flat in corners]
    vm = maskf.reshape(b, p * k)
    dsy = (-(1.0 - fx) * d00 - fx * d01 + (1.0 - fx) * d10 + fx * d11) * vm
    dsx = (-(1.0 - fy) * d00 + (1.0 - fy) * d01 - fy * d10 + fy * d11) * vm
    doffset = torch.stack([dsy.reshape(b, ho, wo, k),
                           dsx.reshape(b, ho, wo, k)], dim=-1)
    doffset = doffset.reshape(b, ho, wo, 2 * k)

    # dx: the modulated corner weights scatter dcols into the input map.
    corner_idx, contrib_w = _scatter_args(y0, x0, corners, vm, h, w)
    dx = dcn_input_grad(corner_idx, contrib_w, dcols_r, h, w,
                        deterministic=deterministic)
    return dx, doffset, dmask, dweight, dbias


def _scatter_args(y0, x0, corners, vm, h, w):
    """``dcn_input_grad``'s corner_idx (top-left corner in coordinates
    padded by one pixel, clamped) and its modulated corner weights."""
    contrib_w = torch.stack([wt for _, wt, _ in corners], dim=-1) * vm[..., None]
    corner_idx = torch.stack([(y0 + 1).clamp(0, h), (x0 + 1).clamp(0, w)],
                             dim=-1).to(torch.int32)
    return corner_idx, contrib_w.contiguous()


def scatter_inputs(offset: torch.Tensor, mask: torch.Tensor, h: int, w: int,
                   *, stride: int = 1, padding: int = 1,
                   kernel_size: int = 3, row0: int = 0):
    """(corner_idx, corner_w) that the backward of ``deform_conv2d`` hands
    ``dcn_input_grad`` for these offsets and modulation on an HxW input
    (output rows from ``row0``)."""
    b = offset.shape[0]
    sy, sx = _sample_positions(offset, stride, padding, kernel_size, row0)
    y0, x0, _, _, corners = _corners(sy, sx, h, w)
    return _scatter_args(y0, x0, corners, mask.float().reshape(b, -1), h, w)


class _DeformConv2d(torch.autograd.Function):
    """im2col + matmul forward; ``_dcn_backward`` backward. The same
    Function runs on both devices: the im2col and the scatter take their
    kernels on the card and their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding,
                kernel_size, deterministic, row0):
        b, _, _, cin = x.shape
        _, ho, wo, _ = offset.shape
        k = kernel_size * kernel_size
        cols = deform_im2col(x, offset, mask, stride=stride, padding=padding,
                             kernel_size=kernel_size, row0=row0)
        out = torch.matmul(cols, weight.reshape(k * cin, -1).to(x.dtype))
        if bias is not None:
            out = out + bias.to(out.dtype)
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.geometry = (stride, padding, kernel_size, deterministic, row0)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out.reshape(b, ho, wo, -1)

    @staticmethod
    def backward(ctx, dout):
        x, offset, mask, weight = ctx.saved_tensors
        dx, doffset, dmask, dweight, dbias = _dcn_backward(
            x, offset, mask, weight, ctx.bias_dtype is not None, dout,
            *ctx.geometry)
        return (dx.to(x.dtype), doffset.to(offset.dtype), dmask.to(mask.dtype),
                dweight.to(weight.dtype),
                None if dbias is None else dbias.to(ctx.bias_dtype),
                None, None, None, None, None)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  *, stride: int = 1, padding: int = 1,
                  kernel_size: int = 3, deterministic: bool = False,
                  row0: int = 0) -> torch.Tensor:
    """Modulated deformable convolution, NHWC in and out, differentiable in
    every tensor argument; with ``deterministic`` its backward sums dx in
    a fixed order on the card.

    x (B, H, W, Cin); offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K);
    weight (kh, kw, Cin, Cout) HWIO; bias (Cout,) or None.
    Returns (B, Ho, Wo, Cout) in ``x.dtype``: the output rows
    ``row0..row0+Ho-1`` of the convolution of the whole ``x`` (a spatial
    rank's window: its samples may land on any row of ``x``, and dx
    covers all of them).
    """
    cin = x.shape[-1]
    if tuple(weight.shape[:3]) != (kernel_size, kernel_size, cin):
        raise ValueError(f"weight {tuple(weight.shape)} is not HWIO for "
                         f"{kernel_size}x{kernel_size}x{cin}")
    return _DeformConv2d.apply(x, offset, mask, weight, bias, stride, padding,
                               kernel_size, deterministic, row0)
