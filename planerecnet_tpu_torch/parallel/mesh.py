"""The ("data", "spatial") mesh of a process group: the counterpart of
``planerecnet_tpu/parallel/mesh.py``.

A ``Mesh`` is this process's place in the group. World rank r sits at
data index ``r // n_spatial`` and spatial index ``r % n_spatial``, as the
JAX package's device grid ``reshape(n_data, n_spatial)`` places devices.

* The data axis: each data index holds the images ``[d * b, (d + 1) * b)``
  of every global batch of ``n_data * b`` (``data/datasets.py::
  BatchIterator`` loads them), and the train step (``trainer.py``)
  computes the global batch's step from them: the model is
  ``replicated`` on every rank, the gradients are summed over the ranks,
  and every mean, count and BatchNorm statistic is taken over the global
  batch.
* The spatial axis (``n_spatial > 1``): the ranks of one data index hold
  the rows of its images, ``local_rows`` cuts them, and the forward
  exchanges rows between them (``parallel/halo.py``).

With ``n_spatial == 1`` the mesh is the data axis alone, its group the
world, as before the spatial axis existed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

# Batch keys with an image-height axis, and that axis: the JAX package's
# ``trainer._SPATIAL_AXES`` (the wire keys keep the rows on the same axis:
# masks pack along the width, depth is quantised).
SPATIAL_AXES = {"image": 1, "depth": 1, "masks": 2, "depth_q": 1,
                "masks_packed": 2}
# The stem's 7x7 convolution reads 3 rows of its neighbour's shard of the
# image: the widest halo of the network.
IMAGE_MIN_ROWS = 3


@dataclass(frozen=True)
class Mesh:
    size: int                  # ranks in the world
    rank: int                  # this rank in the world
    device: torch.device
    n_spatial: int = 1
    group: Any = None          # the data axis's group (None: the world)
    spatial_group: Any = None  # the spatial axis's group (n_spatial > 1)

    @property
    def n_data(self) -> int:
        return self.size // self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    def data_axis(self) -> "Mesh":
        """The data axis alone: its size, this rank's index on it, sums
        over its group (this mesh where there is no spatial axis)."""
        if self.n_spatial == 1:
            return self
        return Mesh(self.n_data, self.data_index, self.device,
                    group=self.group)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis (a new tensor, no gradient)."""
        t = t.detach().clone()
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_max(self, value: float) -> float:
        """The largest of the data axis's ``value``."""
        t = torch.tensor([value], dtype=torch.float32, device=self.device)
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t)


def make_mesh(device, n_data=None, n_spatial: int = 1) -> Mesh:
    """The (data, spatial) mesh over the initialised process group (a
    single rank where there is none). ``n_data`` defaults to the world
    size over ``n_spatial``; raises unless ``n_data * n_spatial`` is the
    world size. With ``n_spatial > 1`` every rank creates every group of
    both axes (``dist.new_group`` must be called by all ranks alike) and
    keeps its own two."""
    size, rank = ((dist.get_world_size(), dist.get_rank())
                  if dist.is_initialized() else (1, 0))
    if n_data is None and size % n_spatial == 0:
        n_data = size // n_spatial
    if n_data is None or n_data * n_spatial != size:
        raise ValueError(
            f"a {n_data} x {n_spatial} (data x spatial) mesh asked for, but "
            f"the process group has {size}: launch the ranks with "
            f"planerecnet_tpu_torch.tools.run_multihost")
    if n_spatial == 1:
        return Mesh(size, rank, torch.device(device))
    spatial = data = None
    for d in range(n_data):
        g = dist.new_group(list(range(d * n_spatial, (d + 1) * n_spatial)))
        if d == rank // n_spatial:
            spatial = g
    for s in range(n_spatial):
        g = dist.new_group(list(range(s, size, n_spatial)))
        if s == rank % n_spatial:
            data = g
    return Mesh(size, rank, torch.device(device), n_spatial, data, spatial)


def shard_batch(mesh: Mesh, batch_size: int) -> int:
    """The images of a global batch of ``batch_size`` that each data index
    holds; raises unless the batch divides by the data axis."""
    if batch_size % mesh.n_data:
        raise ValueError(f"global batch size {batch_size} not divisible by "
                         f"{mesh.n_data} ranks")
    return batch_size // mesh.n_data


def check_height(mesh: Mesh, height: int) -> int:
    """The rows of an image of ``height`` that each spatial rank holds;
    raises unless the height divides by the spatial axis into shards of
    at least ``IMAGE_MIN_ROWS`` rows."""
    rows, rest = divmod(height, mesh.n_spatial)
    if rest or rows < IMAGE_MIN_ROWS:
        raise ValueError(
            f"image height {height} does not split over {mesh.n_spatial} "
            f"spatial ranks into equal shards of at least {IMAGE_MIN_ROWS} "
            f"rows")
    return rows


def local_rows(mesh: Mesh, batch: Mapping) -> Dict:
    """This rank's piece of a global batch (numpy arrays or tensors): its
    data index's images, and of every key in ``SPATIAL_AXES`` its spatial
    index's rows (the counterpart of the JAX package's ``shard_batch``
    with the spatial axis). The sparse mask wire has no image axis:
    densify it first (``trainer.densify_sparse_masks``)."""
    if "masks_sparse" in batch:
        raise ValueError("local_rows: densify the sparse mask wire first")
    b = shard_batch(mesh, len(batch["image"]))
    rows = check_height(mesh, batch["image"].shape[1])
    d, s = mesh.data_index, mesh.spatial_index
    out = {}
    for key, value in batch.items():
        value = value[d * b:(d + 1) * b]
        axis = SPATIAL_AXES.get(key)
        if axis is not None and mesh.n_spatial > 1:
            cut = [slice(None)] * value.ndim
            cut[axis] = slice(s * rows, (s + 1) * rows)
            value = value[tuple(cut)]
        out[key] = value
    return out


def _sum_hook(state, bucket):
    """DDP communication hook: the gradients' sum over the ranks, where
    DDP's own hook takes their mean. Each rank's loss is its share of the
    global batch's loss (its sums over the global counts, over the
    spatial ranks too), so the sum of the ranks' gradients is the global
    batch's gradient."""
    work = dist.all_reduce(bucket.buffer(), async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def replicated(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` under ``DistributedDataParallel``, its gradients summed
    over all the ranks of the world. The buffers are not broadcast: the
    BatchNorm running statistics are the same on every rank by
    construction (global statistics, or frozen). Checkpoints read
    ``model`` itself, so their keys have no ``module.`` prefix."""
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    ddp = nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False)
    ddp.register_comm_hook(None, _sum_hook)
    return ddp
