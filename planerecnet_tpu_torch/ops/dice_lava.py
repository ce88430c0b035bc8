"""Fused dynamic-conv + sigmoid + dice/lava loss reductions.

Counterpart of ``planerecnet_tpu/ops/pallas/dice_lava.py`` with the same
contract. Per positive slot ``p`` of image ``b``, over the mask pixels ``q``
(s the sigmoid of the slot's dynamic 1x1 conv, t its target row, g the lava
gradient map pulled back to mask resolution):

    a[b, p]    = sum_q s[p, q] * t[p, q]        (dice numerator)
    b[b, p]    = sum_q s[p, q] ** 2             (dice denominator)
    lava[b, p] = sum_q s[p, q] * g[q]           (lava dot)

``fused_dice_lava`` is a ``torch.autograd.Function``: its forward is
``dice_lava_fwd`` and its backward ``dice_lava_bwd``, which recomputes s
instead of saving the (B, P, HW) probabilities. Each sends a CPU tensor to
its plain PyTorch version (``fused_dice_lava_plain``,
``fused_dice_lava_bwd_plain``) and a CUDA tensor to its kernel in
``csrc/dice_lava.cu``: with ``deterministic=True`` to the kernel's variant
that sums its blocks' partials in a fixed order instead of with float
atomics, so that a run can be reproduced bit for bit (the plain versions
are deterministic already). Like the JAX package's, the backward gives
gradients to the kernels and the mask features only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from planerecnet_tpu_torch.ops import cuda_build

# What the kernels take (see csrc/dice_lava.cu): the K of the presets and
# up to 128 slots; any number of instances (one launch per 63).
_KERNEL_K = (32, 128, 256)
_MAX_P = 128


def _logits_targets(kernels, mask_feat, onehot, targets):
    logits = torch.einsum("bpk,bqk->bpq", kernels.float(), mask_feat.float())
    tgt = torch.einsum("bpn,bnq->bpq", onehot.float(), targets.float())
    return torch.sigmoid(logits), tgt


def fused_dice_lava_plain(kernels, mask_feat, onehot, targets, grad_low
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain forward (the JAX package's ``fused_dice_lava_xla``)."""
    sig, tgt = _logits_targets(kernels, mask_feat, onehot, targets)
    a = (sig * tgt).sum(2)
    b = (sig * sig).sum(2)
    lava = torch.einsum("bpq,bq->bp", sig, grad_low.float())
    return a, b, lava


def fused_dice_lava_bwd_plain(kernels, mask_feat, onehot, targets, grad_low,
                              ga, gb, gl) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: the formulas of the JAX package's ``_bwd_kernel``.
    Returns (dk (B, P, K), dm (B, HW, K)), f32."""
    sig, tgt = _logits_targets(kernels, mask_feat, onehot, targets)
    dsig = (ga[..., None] * tgt + 2.0 * gb[..., None] * sig
            + gl[..., None] * grad_low.float()[:, None, :])
    dlogits = dsig * sig * (1.0 - sig)                    # (B, P, HW)
    dk = torch.matmul(dlogits, mask_feat.float())
    dm = torch.matmul(dlogits.transpose(1, 2), kernels.float())
    return dk, dm


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("dice_lava")
    lib.prn_dice_lava_fwd.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.prn_dice_lava_bwd.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.prn_dice_lava_fwd_det.argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_longlong]
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.prn_dice_lava_bwd_det.argtypes = ([ctypes.c_void_p] * 11
                                          + [ctypes.c_longlong]
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.prn_dice_lava_launches.argtypes = [ctypes.c_int]
    lib.prn_dice_lava_det_workspace.argtypes = [ctypes.c_int] * 7
    lib.prn_dice_lava_det_workspace.restype = ctypes.c_longlong
    for fn in (lib.prn_dice_lava_fwd, lib.prn_dice_lava_bwd,
               lib.prn_dice_lava_fwd_det, lib.prn_dice_lava_bwd_det,
               lib.prn_dice_lava_launches):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _det_workspace_floats(b, p, k, n, hw, grid_x, backward) -> int:
    """Floats of the partials of a deterministic launch at this shape."""
    need = _library().prn_dice_lava_det_workspace(b, p, k, n, hw, grid_x,
                                                  int(backward))
    cuda_build.check_launch(int(-need) if need < 0 else 0,
                            "dice_lava workspace query")
    return int(need)


def _workspace(shape, grid_x, backward, device) -> torch.Tensor:
    return torch.empty(max(_det_workspace_floats(*shape, grid_x, backward),
                           4), dtype=torch.float32, device=device)


def _check_args(kernels, mask_feat, onehot, targets, grad_low):
    b, p, k = kernels.shape
    hw = mask_feat.shape[1]
    n = onehot.shape[2]
    want = {"mask_feat": (b, hw, k), "onehot": (b, p, n),
            "targets": (b, n, hw), "grad_low": (b, hw)}
    got = {"mask_feat": mask_feat, "onehot": onehot, "targets": targets,
           "grad_low": grad_low}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} {tuple(got[name].shape)} != {shape}")
    return b, p, k, n, hw


def _check_cuda(name, tensors):
    """The kernels' conditions on CUDA inputs; raises on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be f32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: an input is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: an input is not 16-byte aligned")


def _launch_geometry(name, p, k, device):
    """The card's SM count: the kernels' grid is persistent over (image,
    pixel tile), as many blocks as fit on the SMs at once."""
    if k not in _KERNEL_K or p > _MAX_P:
        raise ValueError(f"{name}: the kernel takes K in {_KERNEL_K} and "
                         f"P <= {_MAX_P}, not K={k}, P={p}")
    return torch.cuda.get_device_properties(device).multi_processor_count


def dice_lava_fwd(kernels, mask_feat, onehot, targets, grad_low,
                  deterministic=False):
    """(a, b, lava), each (B, P) f32. ``dice_lava_fwd.launches`` counts the
    kernel's launches, ``dice_lava_fwd.det_launches`` those of its
    deterministic variant."""
    shape = _check_args(kernels, mask_feat, onehot, targets, grad_low)
    if kernels.device.type == "cpu":
        return fused_dice_lava_plain(kernels, mask_feat, onehot, targets,
                                     grad_low)
    if kernels.device.type != "cuda":
        raise ValueError(f"dice_lava_fwd: unsupported device {kernels.device}")
    ins = (kernels, mask_feat, onehot, targets, grad_low)
    _check_cuda("dice_lava_fwd", ins)
    b, p, k, n, hw = shape
    grid_x = _launch_geometry("dice_lava_fwd", p, k, kernels.device)
    out = torch.zeros((3, b, p), dtype=torch.float32, device=kernels.device)
    outs = (out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    with torch.cuda.device(kernels.device):
        stream = torch.cuda.current_stream(kernels.device).cuda_stream
        if deterministic:
            ws = _workspace(shape, grid_x, False, kernels.device)
            err = _library().prn_dice_lava_fwd_det(
                *(t.data_ptr() for t in ins), *outs, ws.data_ptr(),
                ws.numel(), b, p, k, n, hw, grid_x, stream)
        else:
            err = _library().prn_dice_lava_fwd(
                *(t.data_ptr() for t in ins), *outs, b, p, k, n, hw, grid_x,
                stream)
    cuda_build.check_launch(err, "dice_lava_fwd")
    if deterministic:
        dice_lava_fwd.det_launches += _library().prn_dice_lava_launches(n)
    else:
        dice_lava_fwd.launches += _library().prn_dice_lava_launches(n)
    return out[0], out[1], out[2]


def dice_lava_bwd(kernels, mask_feat, onehot, targets, grad_low, ga, gb, gl,
                  deterministic=False):
    """(dk (B, P, K), dm (B, HW, K)) f32 for the output gradients ga, gb, gl
    (B, P). ``dice_lava_bwd.launches`` counts the kernel's launches,
    ``dice_lava_bwd.det_launches`` those of its deterministic variant."""
    shape = _check_args(kernels, mask_feat, onehot, targets, grad_low)
    if kernels.device.type == "cpu":
        return fused_dice_lava_bwd_plain(kernels, mask_feat, onehot, targets,
                                         grad_low, ga, gb, gl)
    if kernels.device.type != "cuda":
        raise ValueError(f"dice_lava_bwd: unsupported device {kernels.device}")
    b, p, k, n, hw = shape
    for g in (ga, gb, gl):
        if tuple(g.shape) != (b, p):
            raise ValueError(f"output gradient {tuple(g.shape)} != {(b, p)}")
    ins = (kernels, mask_feat, onehot, targets, grad_low, ga, gb, gl)
    _check_cuda("dice_lava_bwd", ins)
    grid_x = _launch_geometry("dice_lava_bwd", p, k, kernels.device)
    dk = torch.zeros((b, p, k), dtype=torch.float32, device=kernels.device)
    dm = torch.empty((b, hw, k), dtype=torch.float32, device=kernels.device)
    with torch.cuda.device(kernels.device):
        stream = torch.cuda.current_stream(kernels.device).cuda_stream
        if deterministic:
            ws = _workspace(shape, grid_x, True, kernels.device)
            err = _library().prn_dice_lava_bwd_det(
                *(t.data_ptr() for t in ins), dk.data_ptr(), dm.data_ptr(),
                ws.data_ptr(), ws.numel(), b, p, k, n, hw, grid_x, stream)
        else:
            err = _library().prn_dice_lava_bwd(
                *(t.data_ptr() for t in ins), dk.data_ptr(), dm.data_ptr(),
                b, p, k, n, hw, grid_x, stream)
    cuda_build.check_launch(err, "dice_lava_bwd")
    if deterministic:
        dice_lava_bwd.det_launches += _library().prn_dice_lava_launches(n)
    else:
        dice_lava_bwd.launches += _library().prn_dice_lava_launches(n)
    return dk, dm


dice_lava_fwd.launches = dice_lava_fwd.det_launches = 0
dice_lava_bwd.launches = dice_lava_bwd.det_launches = 0


class _FusedDiceLava(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernels, mask_feat, onehot, targets, grad_low,
                deterministic):
        ins = tuple(t.float().contiguous()
                    for t in (kernels, mask_feat, onehot, targets, grad_low))
        ctx.save_for_backward(*ins)
        ctx.dtypes = (kernels.dtype, mask_feat.dtype)
        ctx.deterministic = deterministic
        return dice_lava_fwd(*ins, deterministic=deterministic)

    @staticmethod
    def backward(ctx, ga, gb, gl):
        dk, dm = dice_lava_bwd(*ctx.saved_tensors, ga.contiguous(),
                               gb.contiguous(), gl.contiguous(),
                               deterministic=ctx.deterministic)
        return (dk.to(ctx.dtypes[0]), dm.to(ctx.dtypes[1]), None, None, None,
                None)


def fused_dice_lava(kernels: torch.Tensor, mask_feat: torch.Tensor,
                    onehot: torch.Tensor, targets: torch.Tensor,
                    grad_low: torch.Tensor, deterministic: bool = False):
    """Per-slot dice/lava reductions without materialising the probabilities.

    kernels (B, P, K) the selected kernel predictions per positive slot;
    mask_feat (B, HW, K) flattened mask features; onehot (B, P, N)
    slot -> instance one-hot (zero rows for invalid slots); targets
    (B, N, HW) rescaled GT instance masks; grad_low (B, HW) the lava
    gradient map at mask resolution. Returns (a, b, lava), each (B, P) f32,
    differentiable in ``kernels`` and ``mask_feat``. ``deterministic``
    sends CUDA tensors to the kernels' variants that sum in a fixed order.
    """
    return _FusedDiceLava.apply(kernels, mask_feat, onehot, targets, grad_low,
                                deterministic)
