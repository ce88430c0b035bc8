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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
KERNEL_SOURCE = _PKG_DIR / "csrc" / "dcn_im2col.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernel indexes with 32-bit ints.
_MAX_ELEMS = 2 ** 30


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def build_kernel() -> dict:
    """Compile ``csrc/dcn_im2col.cu`` for sm_90a into ``_build/``, keyed by
    a hash of the source; a second call finds the library and returns at
    once. Returns {"path", "seconds", "log"} (``log`` holds ptxas's
    register and spill report of a fresh build)."""
    src = KERNEL_SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"dcn_im2col_{digest[:16]}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(KERNEL_SOURCE)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_kernel()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"prn_dcn_im2col_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_args(x, offset, mask, kernel_size):
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError("x, offset and mask must be 4-D (NHWC)")
    b, _, _, _ = x.shape
    k = kernel_size * kernel_size
    ob, ho, wo, oc = offset.shape
    if ob != b or oc != 2 * k:
        raise ValueError(f"offset {tuple(offset.shape)} does not match "
                         f"batch {b} and {k} taps")
    if tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, ho, wo, k)}")


def deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, *, stride: int = 1,
                        padding: int = 1, kernel_size: int = 3
                        ) -> torch.Tensor:
    """Plain PyTorch deformable im2col: (B, Ho*Wo, K*Cin) in ``x.dtype``.

    The arithmetic of the JAX package's ``_forward_chunk``: f32 sample
    positions, four validity-weighted corner gathers in the order
    (00, 01, 10, 11), their sum, then the modulation.
    """
    _check_args(x, offset, mask, kernel_size)
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    dev = x.device
    oy = (torch.arange(ho, device=dev) * stride - padding).float()
    ox = (torch.arange(wo, device=dev) * stride - padding).float()
    taps = torch.arange(kernel_size, device=dev, dtype=torch.float32)
    ty, tx = torch.meshgrid(taps, taps, indexing="ij")
    off = offset.float().reshape(b, ho, wo, k, 2)
    sy = (oy[None, :, None, None] + ty.reshape(1, 1, 1, k)) + off[..., 0]
    sx = (ox[None, None, :, None] + tx.reshape(1, 1, 1, k)) + off[..., 1]
    sy = sy.reshape(b, -1)
    sx = sx.reshape(b, -1)

    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    x_flat = x.reshape(b, h * w, cin)
    rows = torch.arange(b, device=dev)[:, None]
    corners, weights = [], []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yy = y0 + dy
            xx = x0 + dx
            valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            yi = yy.clamp(0, h - 1).long()
            xi = xx.clamp(0, w - 1).long()
            weights.append(torch.where(valid, wy * wx, 0.0))
            corners.append(x_flat[rows, yi * w + xi])          # (B, R, Cin)
    corners = torch.stack(corners, dim=2)                      # (B, R, 4, Cin)
    wts = torch.stack(weights, dim=-1)[..., None].to(x.dtype)  # (B, R, 4, 1)
    sampled = (corners * wts).sum(dim=2).reshape(b, ho * wo, k, cin)
    sampled = sampled * mask.reshape(b, ho * wo, k, 1).to(x.dtype)
    return sampled.reshape(b, ho * wo, k * cin)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  *, stride: int = 1, padding: int = 1,
                  kernel_size: int = 3) -> torch.Tensor:
    """Deformable im2col, (B, Ho*Wo, K*Cin) in ``x.dtype``.

    A CPU ``x`` goes to ``deform_im2col_plain``. A CUDA ``x`` goes to the
    kernel, which takes contiguous f32 or bf16 ``x`` with contiguous f32
    ``offset`` and ``mask`` on the same card, and raises on anything else.
    ``deform_im2col.launches`` counts the kernel's launches.
    """
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offset, mask, stride=stride,
                                   padding=padding, kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"deform_im2col: unsupported device {x.device}")
    _check_args(x, offset, mask, kernel_size)
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
                 padding, stream)
    if err != 0:
        raise RuntimeError(f"dcn_im2col launch failed: cudaError {err}")
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  *, stride: int = 1, padding: int = 1,
                  kernel_size: int = 3) -> torch.Tensor:
    """Modulated deformable convolution, NHWC in and out.

    x (B, H, W, Cin); offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K);
    weight (kh, kw, Cin, Cout) HWIO; bias (Cout,) or None.
    Returns (B, Ho, Wo, Cout) in ``x.dtype``.
    """
    b, _, _, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kernel_size * kernel_size
    if tuple(weight.shape[:3]) != (kernel_size, kernel_size, cin):
        raise ValueError(f"weight {tuple(weight.shape)} is not HWIO for "
                         f"{kernel_size}x{kernel_size}x{cin}")
    cols = deform_im2col(x, offset, mask, stride=stride, padding=padding,
                         kernel_size=kernel_size)
    out = torch.matmul(cols, weight.reshape(k * cin, -1).to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, ho, wo, -1)
