"""The data axis of a process group: the counterpart of
``planerecnet_tpu/parallel/mesh.py`` on the data axis only.

A ``Mesh`` is this process's place in the data-parallel group: its rank,
the group's size and its device. Each rank holds the rows
``[rank * b, (rank + 1) * b)`` of every global batch of ``size * b``
(``data/datasets.py::BatchIterator`` loads them), and the train step
(``trainer.py``) computes the global batch's step from them: the model is
``replicated`` on every rank, the gradients are summed over the ranks,
and every mean, count and BatchNorm statistic is taken over the global
batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Mesh:
    size: int
    rank: int
    device: torch.device

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (a new tensor, no gradient)."""
        t = t.detach().clone()
        if self.size > 1:
            dist.all_reduce(t)
        return t

    def all_max(self, value: float) -> float:
        """The largest of the ranks' ``value``."""
        t = torch.tensor([value], dtype=torch.float32, device=self.device)
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)


def make_mesh(device, n_data=None) -> Mesh:
    """The data axis over the initialised process group (a single rank
    where there is none). ``n_data``, where given, must be its size."""
    size, rank = ((dist.get_world_size(), dist.get_rank())
                  if dist.is_initialized() else (1, 0))
    if n_data is not None and n_data != size:
        raise ValueError(
            f"{n_data} data-parallel ranks asked for, but the process group "
            f"has {size}: launch the ranks with "
            f"planerecnet_tpu_torch.tools.run_multihost")
    return Mesh(size, rank, torch.device(device))


def shard_batch(mesh: Mesh, batch_size: int) -> int:
    """The rows of a global batch of ``batch_size`` that each rank holds;
    raises unless the batch divides by the ranks."""
    if batch_size % mesh.size:
        raise ValueError(f"global batch size {batch_size} not divisible by "
                         f"{mesh.size} ranks")
    return batch_size // mesh.size


def _sum_hook(state, bucket):
    """DDP communication hook: the gradients' sum over the ranks, where
    DDP's own hook takes their mean. Each rank's loss is its share of the
    global batch's loss (its sums over the global counts), so the sum of
    the ranks' gradients is the global batch's gradient."""
    work = dist.all_reduce(bucket.buffer(), async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def replicated(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` under ``DistributedDataParallel``, its gradients summed
    over the ranks. The buffers are not broadcast: the BatchNorm running
    statistics are the same on every rank by construction (global
    statistics, or frozen). Checkpoints read ``model`` itself, so their
    keys have no ``module.`` prefix."""
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    ddp = nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False)
    ddp.register_comm_hook(None, _sum_hook)
    return ddp
