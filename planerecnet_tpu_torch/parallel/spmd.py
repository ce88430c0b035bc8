"""Process-group start-up and the global-batch BatchNorm.

Counterpart of ``planerecnet_tpu/parallel/spmd.py`` on the data axis: in
JAX a sharded ``jit`` computes every BatchNorm statistic over the global
batch by itself; here ``SyncBatchNorm2d`` all-reduces them. The
``spatial`` axis (image height sharded across cards, with halo exchanges
around every conv and resize) is not ported.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from planerecnet_tpu_torch.parallel.mesh import Mesh, make_mesh

# The backend per device type; PRN_BACKEND (or ``backend=``) names
# another, e.g. gloo for several ranks on one card, which NCCL refuses.
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(device="cuda", **kwargs) -> Mesh:
    """Join the data-parallel process group; returns this rank's ``Mesh``.

    The wiring comes from the launcher's variables
    (``tools/run_multihost.py``), as the JAX package's does:
    ``PRN_COORDINATOR_ADDRESS`` (host:port of rank 0's TCP store),
    ``PRN_NUM_PROCESSES`` and ``PRN_PROCESS_ID``; ``PRN_PLATFORM=cpu``
    runs on the CPU over gloo whatever ``device`` says, and
    ``PRN_BACKEND`` names the backend. The keyword arguments
    ``coordinator_address``, ``num_processes``, ``process_id`` and
    ``backend`` win over the variables. On ``cuda`` each rank takes the
    card ``rank % device_count`` (its local rank where hosts are numbered
    one after another with equal cards) before the group starts.
    """
    env = (("PRN_COORDINATOR_ADDRESS", "coordinator_address", str),
           ("PRN_NUM_PROCESSES", "num_processes", int),
           ("PRN_PROCESS_ID", "process_id", int),
           ("PRN_BACKEND", "backend", str))
    for var, key, cast in env:
        if var in os.environ and key not in kwargs:
            kwargs[key] = cast(os.environ[var])
    missing = [var for var, key, _ in env[:3] if key not in kwargs]
    if missing:
        raise ValueError(f"{', '.join(missing)} not set: launch the ranks "
                         f"with planerecnet_tpu_torch.tools.run_multihost")
    device = torch.device(os.environ.get("PRN_PLATFORM") or device)
    rank = kwargs["process_id"]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; PRN_PLATFORM=cpu runs "
                               "the ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        kwargs.get("backend") or _BACKENDS[device.type],
        init_method=f"tcp://{kwargs['coordinator_address']}",
        world_size=kwargs["num_processes"], rank=rank)
    return make_mesh(device)


def _all_sum(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch. Every per-channel sum,
    forward (the mean, then the variance about it) and backward (of dy and
    of dy * xhat), is taken in f64 and summed over the ranks in f64, so
    that the statistics do not depend on how the batch is split: summed in
    f32, their rounding is amplified where a channel's mean is large
    against its spread, through every layer. The elementwise work is
    f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims, view = (0, 2, 3), (1, c, 1, 1)
        n = x.numel() // c * dist.get_world_size()
        ctx.dtype, x = x.dtype, x.float()
        mean = (_all_sum(x.sum(dims, dtype=torch.float64)) / n).float()
        d = x - mean.view(view)
        var = (_all_sum((d * d).sum(dims, dtype=torch.float64)) / n).float()
        invstd = torch.rsqrt(var + eps)
        xhat = d * invstd.view(view)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight.view(view) + bias.view(view), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        dims, view = (0, 2, 3), (1, c, 1, 1)
        dy = dy.float()
        local = torch.stack([dy.sum(dims, dtype=torch.float64),
                             (dy * xhat).sum(dims, dtype=torch.float64)])
        g_dy, g_dyx = (_all_sum(local.clone()) / ctx.n).float().unbind()
        dx = (weight * invstd).view(view) * (
            dy - g_dy.view(view) - xhat * g_dyx.view(view))
        # The parameters' gradients are this rank's share (DDP sums them).
        return dx.to(ctx.dtype), local[1].float(), local[0].float(), None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """A BatchNorm2d whose train-mode statistics are the global batch's
    (``_SyncBatchNormFn``), in f32 out, as ``models.layers.BatchNorm2d``.
    Eval mode is BatchNorm2d's. Replaces a BatchNorm2d in place through
    ``convert_sync_batchnorm``, sharing its parameters and buffers, so
    state-dict keys and the optimizer's parameters stay as they were."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float())
        y, mean, var = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                              self.eps)
        n = x.numel() // x.shape[1] * dist.get_world_size()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """Swap every BatchNorm2d under ``module`` for a ``SyncBatchNorm2d``
    holding the same parameters and buffers; returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, nn.BatchNorm2d) and \
                not isinstance(child, SyncBatchNorm2d):
            sync = SyncBatchNorm2d(child.num_features, child.eps,
                                   child.momentum)
            sync.weight, sync.bias = child.weight, child.bias
            sync.running_mean = child.running_mean
            sync.running_var = child.running_var
            sync.num_batches_tracked = child.num_batches_tracked
            sync.train(child.training)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child)
    return module
