"""Input gradient of the deformable convolution: a scatter-add.

Counterpart of ``planerecnet_tpu/ops/pallas/dcn_scatter.py`` with the same
contract. Every contribution row ``r`` of image ``b`` adds
``corner_w[b, r, i] * dcols[b, r, :]`` at the four corners of its 2x2 patch,
whose top-left corner ``corner_idx[b, r]`` is given in coordinates padded by
one pixel; what lands in the margin is dropped.

``dcn_input_grad`` sends a CPU tensor to ``dcn_input_grad_plain`` (four
``index_add_`` on the flat padded map, the JAX package's
``dcn_input_grad_xla``) and a CUDA tensor to the kernel
``csrc/dcn_scatter.cu`` (f32 atomics; see the note there on ordering).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from planerecnet_tpu_torch.ops import cuda_build

# The four corners of the 2x2 patch, in the order of ``corner_w``.
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _check_args(corner_idx, corner_w, dcols):
    if dcols.dim() != 3:
        raise ValueError(f"dcols must be (B, R, C), not {tuple(dcols.shape)}")
    b, r, _ = dcols.shape
    if tuple(corner_idx.shape) != (b, r, 2):
        raise ValueError(f"corner_idx {tuple(corner_idx.shape)} != {(b, r, 2)}")
    if tuple(corner_w.shape) != (b, r, 4):
        raise ValueError(f"corner_w {tuple(corner_w.shape)} != {(b, r, 4)}")


def dcn_input_grad_plain(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                         dcols: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch scatter-add: (B, H, W, C) f32."""
    _check_args(corner_idx, corner_w, dcols)
    b, r, c = dcols.shape
    hp, wp = h + 2, w + 2
    flat = torch.zeros((b * hp * wp, c), dtype=torch.float32,
                       device=dcols.device)
    base = torch.arange(b, device=dcols.device)[:, None] * (hp * wp)
    cy = corner_idx[..., 0].long()
    cx = corner_idx[..., 1].long()
    rows = dcols.float().reshape(b * r, c)
    for i, (dy, dx) in enumerate(CORNERS):
        idx = (base + (cy + dy) * wp + (cx + dx)).reshape(-1)
        flat.index_add_(0, idx, corner_w[..., i].float().reshape(-1, 1) * rows)
    return flat.reshape(b, hp, wp, c)[:, 1:h + 1, 1:w + 1, :]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("dcn_scatter")
    lib.prn_dcn_scatter_f32.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
    lib.prn_dcn_scatter_f32.restype = ctypes.c_int
    return lib


def dcn_input_grad(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                   dcols: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Accumulate the deformable-sampling gradient into the input map.

    corner_idx: (B, R, 2) int32, the top-left corner (y0 + 1, x0 + 1) of
      each row's patch in padded coordinates, clamped to [0, H] x [0, W];
    corner_w: (B, R, 4) f32 weights of the corners (00, 01, 10, 11), zero
      where a corner lies outside the map;
    dcols: (B, R, C) f32 upstream gradient rows.
    Returns dx (B, H, W, C) f32. ``dcn_input_grad.launches`` counts the
    kernel's launches.
    """
    if dcols.device.type == "cpu":
        return dcn_input_grad_plain(corner_idx, corner_w, dcols, h, w)
    if dcols.device.type != "cuda":
        raise ValueError(f"dcn_input_grad: unsupported device {dcols.device}")
    _check_args(corner_idx, corner_w, dcols)
    for name, t, dtype in (("corner_idx", corner_idx, torch.int32),
                           ("corner_w", corner_w, torch.float32),
                           ("dcols", dcols, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"dcn_input_grad: {name} must be {dtype}, "
                            f"not {t.dtype}")
        if t.device != dcols.device:
            raise ValueError(f"dcn_input_grad: {name} on {t.device}, "
                             f"dcols on {dcols.device}")
        if not t.is_contiguous():
            raise ValueError(f"dcn_input_grad: {name} is not contiguous")
    b, r, c = dcols.shape
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dcols.device)
    with torch.cuda.device(dcols.device):
        stream = torch.cuda.current_stream(dcols.device).cuda_stream
        err = _library().prn_dcn_scatter_f32(
            corner_idx.data_ptr(), corner_w.data_ptr(), dcols.data_ptr(),
            dx.data_ptr(), b, r, h, w, c, stream)
    cuda_build.check_launch(err, "dcn_scatter")
    dcn_input_grad.launches += 1
    return dx


dcn_input_grad.launches = 0
