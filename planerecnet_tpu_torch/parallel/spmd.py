"""Process-group start-up, the global-batch BatchNorm and the sharded
serving forward.

Counterpart of ``planerecnet_tpu/parallel/spmd.py``. In JAX a sharded
``jit`` computes every BatchNorm statistic over the global batch by
itself; here ``SyncBatchNorm2d`` all-reduces them. ``jit_forward(cfg,
mesh, spatial=True)`` shards the batch over the data axis and the image
height over the ``spatial`` axis: the forward runs on each rank's rows,
with the halo exchanges that XLA SPMD inserts in JAX written out by hand
(``parallel/halo.py``), and returns the outputs whole on every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from planerecnet_tpu_torch.parallel.halo import Rows
from planerecnet_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

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


def _all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch: over the ranks of
    ``group`` (None: the world), which hold disjoint parts of it. Every
    per-channel sum, forward (the mean, then the variance about it) and
    backward (of dy and of dy * xhat), is taken in f64 and summed over the
    ranks in f64, so that the statistics do not depend on how the batch
    is split: summed in f32, their rounding is amplified where a channel's
    mean is large against its spread, through every layer. The count is
    summed with the first sums, so shards of any size count alike. The
    elementwise work is f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims, view = (0, 2, 3), (1, c, 1, 1)
        ctx.dtype, x = x.dtype, x.float()
        sums = _all_sum(torch.cat([
            x.sum(dims, dtype=torch.float64),
            x.new_full((1,), x.numel() // c, dtype=torch.float64)]), group)
        n = sums[-1]    # a tensor: no wait for the device
        mean = (sums[:-1] / n).float()
        d = x - mean.view(view)
        var = (_all_sum((d * d).sum(dims, dtype=torch.float64), group)
               / n).float()
        invstd = torch.rsqrt(var + eps)
        xhat = d * invstd.view(view)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var, n)
        return xhat * weight.view(view) + bias.view(view), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        dims, view = (0, 2, 3), (1, c, 1, 1)
        dy = dy.float()
        local = torch.stack([dy.sum(dims, dtype=torch.float64),
                             (dy * xhat).sum(dims, dtype=torch.float64)])
        g_dy, g_dyx = (_all_sum(local.clone(), ctx.group) / ctx.n
                       ).float().unbind()
        dx = (weight * invstd).view(view) * (
            dy - g_dy.view(view) - xhat * g_dyx.view(view))
        # The parameters' gradients are this rank's share (DDP sums them).
        return (dx.to(ctx.dtype), local[1].float(), local[0].float(), None,
                None)


class SyncBatchNorm2d(nn.BatchNorm2d):
    """A BatchNorm2d whose train-mode statistics are the global batch's
    (``_SyncBatchNormFn``), in f32 out, as ``models.layers.BatchNorm2d``.
    Eval mode is BatchNorm2d's. Replaces a BatchNorm2d in place through
    ``convert_sync_batchnorm``, sharing its parameters and buffers, so
    state-dict keys and the optimizer's parameters stay as they were.
    ``group`` names the ranks that hold disjoint parts of the batch: the
    world (None) for data-parallel ranks and for row-sharded maps, the
    data axis for a map that every spatial rank holds whole."""

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float())
        y, mean, var, n = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                                 self.eps, group)
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


def _gather_images(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data axis's images of ``t`` (images first), on every rank."""
    if mesh.n_data == 1:
        return t
    out = [torch.empty_like(t) for _ in range(mesh.n_data)]
    dist.all_gather(out, t.contiguous(), group=mesh.group)
    return torch.cat(out)


def jit_forward(cfg, mesh: Mesh, spatial: bool = False):
    """The sharded serving forward, the counterpart of the JAX package's
    ``jit_forward(cfg, mesh, spatial)`` (the name kept, though nothing is
    compiled). Returns ``fn(model, images) -> preds``: every rank passes
    the same eval-mode ``PlaneRecNet`` of ``cfg`` and the whole normalised
    NHWC batch; each keeps its data index's images and, with ``spatial``,
    its spatial index's rows (``parallel/halo.py``), and every rank gets
    the raw-pred dict of the whole batch, as JAX's replicated
    ``out_shardings`` give it."""
    del cfg     # the model holds it; kept for the JAX package's signature

    def fn(model, images):
        b = shard_batch(mesh, images.shape[0])
        x = images[mesh.data_index * b:(mesh.data_index + 1) * b]
        rows = None
        if spatial and mesh.n_spatial > 1:
            rows = Rows(mesh, images.shape[1], images.shape[2])
            first, count = rows.window(images.shape[1])
            x = x[:, first:first + count]
        with torch.no_grad():
            preds = model(x, spatial=rows)
        return {k: ([_gather_images(t, mesh) for t in v]
                    if isinstance(v, list) else _gather_images(v, mesh))
                for k, v in preds.items()}

    return fn
