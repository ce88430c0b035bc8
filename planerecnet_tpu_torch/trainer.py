"""Training state, optimizer, learning-rate schedule and the train step.

Counterpart of ``planerecnet_tpu/trainer.py``. One step is: unpack the wire
batch onto the device, forward in train mode, the joint loss
(``losses.compute_losses``), backward, and Adam, skipped when the total
loss is not finite. Runs on ``cuda`` unless ``device="cpu"`` is passed.

Two things follow the JAX package exactly:
* The learning rate follows the count of APPLIED updates (optax's own
  count, which a skipped step does not advance), while ``state.step``
  counts every step and seeds the step's random numbers.
* A skipped step leaves the parameters, Adam's moments and the BatchNorm
  running statistics as they were. torch updates the running statistics
  during the forward, so they are saved before it and put back.

The optimizer is Adam (0.9, 0.999, eps 1e-8) without weight decay (the JAX
optimizer ignores ``cfg.decay``); ``per_module_lr`` gives the backbone 5x
and the depth decoder 2x the learning rate.

``create_train_state(deterministic=True)`` sends the step's DCN scatter
and dice/lava kernels to their variants that sum in a fixed order, so
that a step on the same state and batch gives the same bits (with
PyTorch's own deterministic mode, which the train CLI sets).

``create_train_state(mesh=...)`` (``parallel/``) makes ``train_step``
the data-parallel step, the
counterpart of the JAX package's ``jit_train_step(cfg, mesh)``: each rank
steps its rows of the global batch, and the step is the global batch's.
The model runs under ``DistributedDataParallel`` with the gradients
summed over the ranks, each rank's losses are its share of the global
losses (``compute_losses(mesh=...)``), BatchNorm trains on the global
batch's statistics (``parallel.spmd.SyncBatchNorm2d``) unless frozen,
and the losses returned, hence the non-finite skip, are the global ones.

A mesh with a spatial axis (``make_mesh(n_spatial=...)``) makes it the
2-D data x spatial step, the counterpart of ``jit_train_step(cfg, mesh,
spatial=True)``: each rank takes its data index's images and its spatial
index's rows of them (``parallel.mesh.local_rows``), the forward runs on
the rows with the halo exchanges of ``parallel/halo.py``, and the
predictions and the targets are gathered whole on every spatial rank for
the losses, which every rank computes alike (the dice/lava kernels on the
whole mask features, VNL on the whole depth). Each rank's loss is scaled
by ``1 / n_spatial`` before the backward: the parts of the network that
run whole then give each spatial rank a ``1 / n_spatial`` share of their
gradient, and the row-sharded parts each rank's rows' share (the
gathers' backward sums over the spatial ranks), so that the sum over all
ranks that DDP takes is the global batch's gradient. Counts and the
losses returned are summed over the data axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.losses import compute_losses
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.ops.image import fast_base_transform
from planerecnet_tpu_torch.parallel.halo import Rows, gather_rows
from planerecnet_tpu_torch.parallel.mesh import Mesh, replicated
from planerecnet_tpu_torch.parallel.spmd import convert_sync_batchnorm
from planerecnet_tpu_torch.runner import resolve_device
from planerecnet_tpu_torch.utils.timer import span
from planerecnet_tpu_torch.utils.weights import (flatten_variables,
                                                 from_jax_variables)

# Learning-rate multipliers of ``per_module_lr`` by top-level module.
MODULE_LR = {"backbone": 5.0, "depth_decoder": 2.0}


def lr_schedule(cfg: PlaneRecNetConfig) -> Callable[[int], float]:
    """Linear warm-up, then step decay, as a function of the update count."""
    lr = cfg.lr

    def schedule(it: int) -> float:
        if cfg.lr_warmup_until > 0 and it <= cfg.lr_warmup_until:
            return ((lr - cfg.lr_warmup_init) * (it / cfg.lr_warmup_until)
                    + cfg.lr_warmup_init)
        return lr * cfg.gamma ** sum(it >= s for s in cfg.lr_steps)

    return schedule


def make_optimizer(model: nn.Module, per_module_lr: bool = False
                   ) -> torch.optim.Adam:
    """Adam over the model's parameters, one group per lr multiplier; each
    group's ``lr_mult`` scales the scheduled learning rate."""
    groups: Dict[float, List[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        mult = MODULE_LR.get(name.split(".", 1)[0], 1.0) if per_module_lr \
            else 1.0
        groups.setdefault(mult, []).append(p)
    return torch.optim.Adam(
        [{"params": ps, "lr_mult": m} for m, ps in groups.items()],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


@dataclass
class TrainState:
    cfg: PlaneRecNetConfig
    model: PlaneRecNet
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    seed: int = 0
    step: int = 0        # every step taken
    updates: int = 0     # the steps whose update was applied
    deterministic: bool = False   # the kernels' fixed-order variants
    mesh: Optional[Mesh] = None   # the data (x spatial) ranks
    replica: Optional[nn.Module] = None   # ``model`` under DDP, with mesh

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def generator(self) -> torch.Generator:
        """This step's random numbers (the VNL sampler's)."""
        return torch.Generator(self.device).manual_seed(
            self.seed * 1_000_003 + self.step)


def create_train_state(cfg: PlaneRecNetConfig,
                       variables: Optional[Mapping] = None, seed: int = 0,
                       device="cuda", per_module_lr: bool = False,
                       deterministic: bool = False,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A model in train mode (fresh weights from ``seed``, or the JAX
    package's ``variables``, nested or flat), its optimizer and schedule.
    ``deterministic`` selects the kernels' fixed-order variants. A
    ``mesh`` makes the state data-parallel, or data x spatial, on
    ``mesh.device`` (module docstring), one rank included."""
    device = resolve_device(device if mesh is None else mesh.device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = PlaneRecNet(cfg)
    if variables is not None:
        model.load_state_dict(
            from_jax_variables(flatten_variables(variables), model))
    if mesh is not None and not cfg.freeze_bn:
        convert_sync_batchnorm(model)
    model = model.to(device).train().set_deterministic(deterministic)
    replica = None if mesh is None else replicated(model, mesh)
    return TrainState(cfg, model, make_optimizer(model, per_module_lr),
                      lr_schedule(cfg), seed=seed, deterministic=deterministic,
                      mesh=mesh, replica=replica)


def densify_sparse_masks(cfg: PlaneRecNetConfig, batch: Dict) -> Dict:
    """Expand the valid-slot mask wire (``masks_sparse`` (M, H, W/8) rows
    and ``mask_slots`` (M,) flat (image, slot) ids; padding rows carry an
    out-of-range id) into ``masks_packed`` (B, max_instances, H, W/8)."""
    if "masks_sparse" not in batch:
        return batch
    batch = dict(batch)
    sparse = batch.pop("masks_sparse")
    slots = batch.pop("mask_slots").long()
    b = batch["image"].shape[0]
    n_cap = cfg.max_instances
    dense = torch.zeros((b * n_cap,) + tuple(sparse.shape[1:]),
                        dtype=sparse.dtype, device=sparse.device)
    keep = slots < b * n_cap
    dense[slots[keep]] = sparse[keep]
    batch["masks_packed"] = dense.reshape(b, n_cap, *sparse.shape[1:])
    return batch


def widen_u16(x: torch.Tensor) -> torch.Tensor:
    """A uint16 tensor as int32 of the same values, through int16's bits
    (CUDA has few uint16 kernels); any other tensor as it is."""
    if x.dtype != torch.uint16:
        return x
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def unpack_wire_batch(cfg: PlaneRecNetConfig, batch: Mapping,
                      device) -> Dict[str, torch.Tensor]:
    """The JAX package's wire batch (numpy or tensors) -> the dense batch of
    ``compute_losses`` on ``device``: masks unpacked from bits (sparse or
    dense wire), ``depth_q`` scaled by ``depth_resolution``, u8 BGR images
    normalised (every preset's transform: ImageNet statistics, to RGB). A
    dense batch passes through."""
    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}
    batch = densify_sparse_masks(cfg, batch)
    if "masks_packed" in batch:
        packed = batch.pop("masks_packed")                # (B, N, H, W/8)
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=device)
        bits = (packed[..., None] >> shifts) & 1
        w = batch["image"].shape[2]
        batch["masks"] = bits.reshape(*packed.shape[:-1],
                                      packed.shape[-1] * 8)[..., :w]
    if "depth_q" in batch:
        res = cfg.dataset.depth_resolution or 1e-3
        batch["depth"] = widen_u16(batch.pop("depth_q")).float() * res
    if batch["image"].dtype == torch.uint8:
        batch["image"] = fast_base_transform(batch["image"])
    return batch


def _bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [buf for m in model.modules() if isinstance(m, nn.BatchNorm2d)
            for buf in (m.running_mean, m.running_var, m.num_batches_tracked)]


def grad_step(state: TrainState, batch: Mapping,
              vnl_indices: Optional[Dict[str, torch.Tensor]] = None):
    """Forward, joint loss and backward; the gradients are left in the
    parameters' ``.grad``. Returns (the detached losses with ``total``, the
    BatchNorm running statistics as they were before the forward). With
    a mesh the gradients and the losses are the global batch's; with a
    spatial axis ``batch`` holds this rank's rows (``local_rows``)."""
    with span("trainer.upload"):
        batch = unpack_wire_batch(state.cfg, batch, state.device)
    mesh, rows = state.mesh, None
    if mesh is not None and mesh.n_spatial > 1:
        image = batch["image"]
        rows = Rows(mesh, image.shape[1] * mesh.n_spatial, image.shape[2])
        with torch.no_grad():
            for key, dim in (("depth", 1), ("masks", 2)):
                batch[key] = gather_rows(batch[key], mesh, dim)
    saved = [buf.clone() for buf in _bn_buffers(state.model)]
    state.optimizer.zero_grad(set_to_none=True)
    net = state.model if state.replica is None else state.replica
    with span("trainer.forward"):
        preds = (net(batch["image"]) if rows is None
                 else net(batch["image"], spatial=rows))
    with span("trainer.loss"):
        losses = compute_losses(
            state.cfg, preds, batch, vnl_indices=vnl_indices,
            generator=state.generator(), deterministic=state.deterministic,
            mesh=None if mesh is None else mesh.data_axis())
        total = sum(losses.values())
    with span("trainer.backward"):
        (total if rows is None else total / mesh.n_spatial).backward()
    losses = dict(losses, total=total)
    if state.mesh is not None:
        summed = state.mesh.all_sum(torch.stack(list(losses.values())))
        return dict(zip(losses, summed.unbind())), saved
    return {k: v.detach() for k, v in losses.items()}, saved


def apply_grads(state: TrainState, total: torch.Tensor,
                saved_bn: List[torch.Tensor]) -> bool:
    """Adam's update, or, when ``total`` is not finite, no update and the
    BatchNorm running statistics put back. Returns whether it applied."""
    with span("trainer.apply_grads"):
        with span("trainer.finite_read"):
            finite = bool(torch.isfinite(total))
        if finite:
            lr = state.schedule(state.updates)
            for group in state.optimizer.param_groups:
                group["lr"] = lr * group["lr_mult"]
            state.optimizer.step()
            state.updates += 1
        else:
            with torch.no_grad():
                for buf, old in zip(_bn_buffers(state.model), saved_bn):
                    buf.copy_(old)
    state.step += 1
    return finite


def train_step(state: TrainState, batch: Mapping,
               vnl_indices: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step; returns the losses with ``total``."""
    with span("trainer.step"):
        losses, saved = grad_step(state, batch, vnl_indices)
        apply_grads(state, losses["total"], saved)
    return losses
