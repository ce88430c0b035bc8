"""The ranks' side of ``tests/test_torch_port_spatial.py``.

Spawned ranks import this module, which imports torch and the port only
(the test module imports JAX too, which would add seconds to every
rank's start). Each rank computes its part and saves it; the test
process holds the parts against the unsplit and JAX references.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.models.backbone import DeformableConv2d
from planerecnet_tpu_torch.models.layers import (GroupNorm, batch_norm,
                                                 conv2d, group_norm,
                                                 max_pool2d)
from planerecnet_tpu_torch.ops.image import reflect_pad, resize_bilinear
from planerecnet_tpu_torch.parallel import halo
from planerecnet_tpu_torch.parallel import mesh as pmesh
from planerecnet_tpu_torch.parallel import spmd
from planerecnet_tpu_torch.parallel.halo import Rows
from planerecnet_tpu_torch.utils import checkpoint

# The (n_data, n_spatial) meshes of the 4-rank training steps.
MESHES = ((4, 1), (2, 2), (1, 4))


def _conv(cin, cout, k, s=1, p=0):
    return lambda: nn.Conv2d(cin, cout, k, stride=s, padding=p)


def _affine(make):
    def build():
        m = make()
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
        return m
    return build


def _dcn(stride):
    def build():
        m = DeformableConv2d(4, 5, 3, stride=stride, padding=1)
        with torch.no_grad():
            m.offset_conv.weight.normal_(0, 0.02)
            m.offset_conv.bias.uniform_(-8, 8)   # clamped at 32/4 = 8 px
            m.modulator_conv.weight.normal_(0, 0.1)
        return m
    return build


def _padded_conv(m, x, rows):
    return m(reflect_pad(x, 1, rows))


# name: (input NCHW shape, build() -> module or None, f(module, x, rows)),
# rows None the unsplit op; every output is the input scaled on both axes.
OP_CASES = {
    "conv3x3": ((2, 3, 16, 12), _conv(3, 4, 3, 1, 1), conv2d),
    "conv3x3_1row_shards": ((2, 3, 4, 6), _conv(3, 4, 3, 1, 1), conv2d),
    "conv3x3_s2": ((2, 3, 16, 12), _conv(3, 4, 3, 2, 1), conv2d),
    "stem7x7_s2": ((2, 3, 16, 12), _conv(3, 4, 7, 2, 3), conv2d),
    "max_pool": ((2, 3, 16, 12), lambda: nn.MaxPool2d(3, 2, 1), max_pool2d),
    "reflect_pad": ((2, 3, 16, 12), _conv(3, 4, 3), _padded_conv),
    "reflect_pad_1row_shards": ((2, 3, 4, 6), _conv(3, 4, 3), _padded_conv),
    "resize_x2": ((2, 3, 8, 6), lambda: None,
                  lambda m, x, rows: resize_bilinear(x, (16, 12), rows)),
    "resize_half": ((2, 3, 16, 12), lambda: None,
                    lambda m, x, rows: resize_bilinear(x, (8, 6), rows)),
    "resize_3_8": ((2, 3, 16, 16), lambda: None,
                   lambda m, x, rows: resize_bilinear(x, (6, 6), rows)),
    "resize_to_whole": ((2, 3, 16, 16), lambda: None,
                        lambda m, x, rows: resize_bilinear(x, (5, 5), rows)),
    "group_norm": ((2, 4, 16, 12), _affine(lambda: GroupNorm(2, 4)),
                   group_norm),
    # A training BatchNorm: a SyncBatchNorm2d on the ranks (``op``), on a
    # row-sharded map (over the world) and on a whole one, 5 rows that
    # split over neither 2 nor 4 ranks (over the data axis alone).
    "sync_batchnorm": ((2, 3, 16, 12), _affine(
        lambda: nn.BatchNorm2d(3, momentum=0.3)), batch_norm),
    "sync_batchnorm_whole": ((2, 3, 5, 6), _affine(
        lambda: nn.BatchNorm2d(3, momentum=0.3)), batch_norm),
    "dcn": ((2, 4, 32, 24), _dcn(1), lambda m, x, rows: m(x, rows)),
    "dcn_s2": ((2, 4, 32, 24), _dcn(2), lambda m, x, rows: m(x, rows)),
}


def _seed(name):
    return sum(map(ord, name))


def op(name, x, rows):
    """(module, output) of case ``name`` on ``x``."""
    _, build, f = OP_CASES[name]
    torch.manual_seed(_seed(name))
    m = build()
    if rows is not None and isinstance(m, nn.BatchNorm2d):
        m = spmd.convert_sync_batchnorm(nn.Sequential(m))[0]
    return m, f(m, x, rows)


def op_input(name):
    rng = np.random.RandomState(_seed(name))
    return torch.tensor(rng.randn(*OP_CASES[name][0]).astype(np.float32))


def cotangent(name, shape):
    rng = np.random.RandomState(_seed(name) + 1)
    return torch.tensor(rng.randn(*shape).astype(np.float32))


def op_results(mesh):
    """Every case on this rank's rows (or the whole input, where its
    height does not split), for the objective: the sum over the ranks of
    <output, cotangent>. A row-sharded output takes its rows of the whole
    cotangent, a whole one the cotangent over the ranks' count (the 2-D
    train step's loss scaling)."""
    results = {}
    for name, (shape, _, _) in OP_CASES.items():
        # The maps at a quarter of the image's scale: the image's shards
        # hold the stem's halo, the maps' may hold one row.
        rows = Rows(mesh, 4 * shape[2], 4 * shape[3])
        x = rows.local(op_input(name)).clone()
        x_sharded = rows.sharded(x)
        x.requires_grad_(True)
        m, y = op(name, x, rows)
        sharded = rows.sharded(y)
        g = rows.rows_of(y)
        cot = cotangent(name, (*y.shape[:-2], g, y.shape[-1]))
        if sharded:
            first, count = rows.window(g)
            cot = cot[..., first:first + count, :]
        else:
            cot = cot / rows.n
        (y * cot).sum().backward()
        results[name] = dict(
            y=y.detach(), sharded=sharded, x_sharded=x_sharded, dx=x.grad,
            params={} if m is None else {
                k: p.grad for k, p in m.named_parameters()},
            stats={} if not isinstance(m, nn.BatchNorm2d) else {
                "mean": m.running_mean, "var": m.running_var})
    return results


def forward_results(mesh, cfg, flat, images):
    """The whole raw-pred dict (numpy, f32) of ``jit_forward(spatial=True)`` on
    ``mesh`` for weights ``flat`` on ``images``, and the bytes the
    forward's exchanges handed this rank and their number
    (``received_bytes``, ``exchanges``)."""
    model = trainer.create_train_state(cfg, variables=flat,
                                       device="cpu").model.eval()
    halo.reset_traffic()
    preds = spmd.jit_forward(cfg, mesh, spatial=True)(
        model, torch.from_numpy(images))
    out = {k: ([t.float().numpy() for t in v] if isinstance(v, list) else
               v.float().numpy()) for k, v in preds.items()}
    out["received_bytes"], out["exchanges"] = halo.traffic()
    return out


def step(state, batch, vnl):
    """One step: (losses, gradients, state dict after the update)."""
    losses, saved = trainer.grad_step(state, batch, vnl)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    trainer.apply_grads(state, losses["total"], saved)
    return ({k: float(v) for k, v in losses.items()}, grads,
            {k: v.clone() for k, v in state.model.state_dict().items()})


def step_results(n_data, n_spatial, cfgs, flat, batch, vnl, save_to=None):
    """{freeze_bn: one step on a (n_data, n_spatial) mesh} from this
    rank's piece of the global batch and its data rows of the VNL
    triplets; ``cfgs`` maps freeze_bn to the config. With ``save_to`` the
    BatchNorm-training state is saved there (``"checkpoint"``)."""
    mesh = pmesh.make_mesh("cpu", n_data, n_spatial)
    b = pmesh.shard_batch(mesh, len(batch["image"]))
    d = mesh.data_index
    out = {}
    for freeze, cfg in cfgs.items():
        state = trainer.create_train_state(cfg, variables=flat, mesh=mesh)
        out[freeze] = step(state, pmesh.local_rows(mesh, batch),
                           {k: v[d * b:(d + 1) * b] for k, v in vnl.items()})
        if save_to and not freeze:
            out["checkpoint"] = checkpoint.save_train_state(save_to, state)
    return out


def rank_main(rank, n, port, out_dir, fwd, steps, small=None, bf16=None):
    """One rank of an n-rank spawn: the op cases on the n-rank spatial
    axis, the forward on a (1, n) mesh (``fwd``: cfg, weights, images),
    and, given ``steps`` (cfgs, weights, batch, VNL triplets), the
    forward on a (2, n / 2) mesh and the steps of ``MESHES``; given
    ``small`` ((fwd, steps) at another size), both forwards and the
    steps again at that size (``"small"``); given ``bf16`` ((n_data,
    n_spatial), fwd with a bf16 config), the forward on that mesh
    (``"forward_bf16"`` on a (1, n) mesh, else ``"forward_2d_bf16"``);
    saves ``rank{rank}.pt`` in ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = pmesh.make_mesh("cpu", n_spatial=n)
        out = {"ops": op_results(mesh), "forward": forward_results(mesh,
                                                                   *fwd)}
        if steps:
            out["forward_2d"] = forward_results(
                pmesh.make_mesh("cpu", 2, n // 2), *fwd)
        if bf16:
            grid, fwd_bf16 = bf16
            key = "forward_bf16" if grid[0] == 1 else "forward_2d_bf16"
            out[key] = forward_results(pmesh.make_mesh("cpu", *grid),
                                       *fwd_bf16)
        for grid in (MESHES if steps else ()):
            save = (os.path.join(out_dir, "ckpt_2x2")
                    if grid == (2, 2) and rank == 0 else None)
            out[grid] = step_results(*grid, *steps, save_to=save)
        if small:
            fwd_s, steps_s = small
            out["small"] = {
                "forward": forward_results(mesh, *fwd_s),
                "forward_2d": forward_results(
                    pmesh.make_mesh("cpu", 2, n // 2), *fwd_s),
                **{grid: step_results(*grid, *steps_s) for grid in MESHES}}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
