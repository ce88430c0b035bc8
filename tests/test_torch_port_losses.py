"""The port's loss stack against the JAX package on the CPU.

The same numpy inputs go through ``planerecnet_tpu.losses`` and
``planerecnet_tpu_torch.losses``. The two packages draw different random
numbers, so the VNL loss of the port is fed the triplet indices that JAX's
sampler draws from the same key (``jax_vnl_indices``).

Tolerances: the GT preparation is integer work and must be equal; masks4
is exact (sums of 0/1 values times multiples of 1/4). Float results: rtol
and atol 1e-5 (2e-5 for gradients), f32 on both sides reduced in other
orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from planerecnet_tpu import losses as jl
from planerecnet_tpu.config import PlaneRecNet_50_config
from planerecnet_tpu.losses.vnl import _sample_mask_indices
from planerecnet_tpu_torch import losses as tl
from test_losses import _tiny_batch
from test_torch_port_model import port_cfg

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
B, H, W = 2, 64, 64


def _cfg(**kw):
    return PlaneRecNet_50_config.copy(dict(
        max_instances=4, max_positives=16, vnl_samples=32, **kw))


def _batch(seed=7, edge_strip=True):
    """``test_losses._tiny_batch`` with a second instance per image; with
    ``edge_strip``, image 0's is the thin strip on the bottom edge whose
    mass centre lies in the last grid row of every level and that coarser
    levels gate out (``test_losses.py::
    test_edge_centred_gated_instance_grads_finite``)."""
    batch = {k: np.array(v) for k, v in _tiny_batch(
        _cfg(), np.random.RandomState(seed), b=B, h=H, w=W, n=4).items()}
    masks, boxes, valid = batch["masks"], batch["boxes"], batch["gt_valid"]
    masks[1, 1, 20:60, 30:50] = 1
    boxes[1, 1] = [30, 20, 50, 60]
    valid[1, 1] = True
    if edge_strip:
        masks[0, 1, 62:64, 40:64] = 1
        boxes[0, 1] = [40, 62, 64, 64]
        valid[0, 1] = True
    planes = batch["plane_paras"]
    planes[:, 1, :3] = [0.6, 0.0, 0.8]
    # Depth: two slanted planes, so that triplets have real normals.
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    batch["depth"] = (1.5 + 0.01 * xx + 0.02 * yy
                      + 0.3 * (xx > 32))[None, :, :, None].repeat(B, 0)
    return batch


def _preds(cfg, seed=8):
    rng = np.random.RandomState(seed)
    sv = cfg.solov2
    return {
        "cate_preds": [rng.randn(B, g, g, cfg.num_classes).astype(np.float32)
                       for g in sv.num_grids[:4]],
        "kernel_preds": [(rng.randn(B, g, g, sv.num_kernels) * 0.1).astype(
            np.float32) for g in sv.num_grids[:4]],
        "mask_pred": (rng.randn(B, H // 4, W // 4, sv.num_kernels) * 0.1
                      ).astype(np.float32),
        "depth_pred": (rng.rand(B, H // 2, W // 2, 1) + 0.5).astype(
            np.float32),
    }


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def jax_vnl_indices(cfg, batch, rng):
    """The triplet ids JAX's ``compute_losses`` draws from ``rng``, in the
    layout of ``planerecnet_tpu_torch.losses.sample_vnl_indices``."""
    masks = np.asarray(batch["masks"]).astype(bool)
    valid = np.asarray(batch["gt_valid"])
    b, n, h, w = masks.shape
    vp = min(cfg.vnl_max_planes, n)
    m = cfg.vnl_samples
    order = np.argsort(~valid, axis=1, kind="stable")[:, :vp]
    vnl_masks = np.take_along_axis(masks, order[:, :, None, None], axis=1)
    full_np = ~np.any(masks & valid[:, :, None, None], axis=1).reshape(b, -1)
    out = {"plane_idx": [], "plane_ok": [], "np_idx": [], "np_ok": []}
    for i, key in enumerate(jax.random.split(rng, b)):
        keys = jax.random.split(key, vp + 1)
        pairs = [_sample_mask_indices(keys[j],
                                      jnp.asarray(vnl_masks[i, j].reshape(-1)),
                                      (3, m), (h, w)) for j in range(vp)]
        out["plane_idx"].append(np.stack([np.asarray(p[0]) for p in pairs]))
        out["plane_ok"].append(np.stack([np.asarray(p[1]) for p in pairs]))
        idx, ok = _sample_mask_indices(keys[vp], jnp.asarray(full_np[i]),
                                       (3, m), (h, w))
        out["np_idx"].append(np.asarray(idx))
        out["np_ok"].append(np.asarray(ok))
    return {k: torch.from_numpy(np.stack(v).astype(
        np.int64 if k.endswith("idx") else bool)) for k, v in out.items()}


def test_prepare_ground_truth_matches_jax():
    cfg = _cfg()
    batch = _batch()
    want = jl.prepare_ground_truth(
        cfg, *(jnp.asarray(batch[k]) for k in ("boxes", "classes",
                                               "gt_valid", "masks")), 4)
    got = tl.prepare_ground_truth(
        port_cfg(cfg), *(torch.from_numpy(batch[k])
                         for k in ("boxes", "classes", "gt_valid", "masks")),
        4)
    np.testing.assert_array_equal(got["masks4"].numpy(),
                                  np.asarray(want["masks4"]))
    for key in ("cate_labels", "ins_inds", "pos_cells", "pos_insts",
                "pos_valids"):
        for lvl in range(4):
            np.testing.assert_array_equal(
                got[key][lvl].numpy(), np.asarray(want[key][lvl]),
                err_msg=f"{key}[{lvl}]")
    assert any(got["pos_valids"][lvl].any() for lvl in range(4))


def test_adjoint_resize_and_gradient_map_match_jax():
    rng = np.random.RandomState(3)
    g = rng.rand(2, 48, 64).astype(np.float32)
    want = np.stack([np.asarray(jl.adjoint_resize(jnp.asarray(x), (12, 16)))
                     for x in g])
    got = tl.adjoint_resize(torch.from_numpy(g), (12, 16))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    d = (rng.rand(2, 8, 9, 1) + 0.5).astype(np.float32)
    vm = (rng.rand(2, 8, 9, 1) > 0.3).astype(np.float32)
    for mask in (None, vm):
        want = np.asarray(jl.compute_gradient_map(
            jnp.asarray(d), None if mask is None else jnp.asarray(mask)))
        got = tl.compute_gradient_map(
            torch.from_numpy(d), None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_elementary_losses_match_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(5, 40).astype(np.float32)
    t = (rng.rand(5, 40) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tl.dice_loss(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(jl.dice_loss(jnp.asarray(x), jnp.asarray(t))), **TOL)
    logits = (rng.randn(30, 2) * 3).astype(np.float32)
    tgt = (rng.rand(30, 2) > 0.8).astype(np.float32)
    np.testing.assert_allclose(
        tl.sigmoid_focal_loss(torch.from_numpy(logits),
                              torch.from_numpy(tgt)).numpy(),
        np.asarray(jl.sigmoid_focal_loss(jnp.asarray(logits),
                                         jnp.asarray(tgt))), **TOL)
    pred = (rng.rand(2, 6, 8, 1) + 0.1).astype(np.float32)
    gt = (rng.rand(2, 6, 8, 1) + 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tl.rmse_log_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                         torch.from_numpy(gt > 0.3)).numpy(),
        np.asarray(jl.rmse_log_loss(jnp.asarray(pred), jnp.asarray(gt),
                                    jnp.asarray(gt > 0.3))), **TOL)


def test_vnl_loss_with_injected_indices_matches_jax():
    """One image's VNL loss and its gradient in the predicted depth, the
    port fed the indices JAX's sampler draws."""
    cfg = _cfg()
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    masks = batch["masks"][:1].astype(bool)
    valid = batch["gt_valid"][:1]
    pred = (batch["depth"][:1, :, :, 0]
            * (1 + 0.05 * np.random.RandomState(2).randn(1, H, W))
            ).astype(np.float32)
    full_np = ~np.any(masks & valid[:, :, None, None], axis=1).reshape(1, -1)
    args = (masks[0], batch["plane_paras"][0, :, :3], valid[0],
            batch["depth"][0, :, :, 0], batch["k_matrix"][0])

    def jax_loss(p):
        return jl.vnl_loss_single(
            jax.random.split(rng, 1)[0], p, *(jnp.asarray(a) for a in args),
            jnp.asarray(full_np[0]), num_samples=cfg.vnl_samples)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred[0]))
    idx = jax_vnl_indices(cfg.copy(dict(vnl_max_planes=4)),
                          {"masks": masks, "gt_valid": valid}, rng)
    assert idx["plane_ok"].any() and idx["np_ok"].all()
    p = torch.tensor(pred, requires_grad=True)
    got = tl.vnl_loss_from_indices(
        p, torch.from_numpy(batch["depth"][:1, :, :, 0]),
        torch.from_numpy(batch["k_matrix"][:1]),
        torch.from_numpy(batch["plane_paras"][:1, :, :3]),
        torch.from_numpy(valid), idx)
    got.sum().backward()
    assert float(want) > 0
    np.testing.assert_allclose(got.detach().numpy()[0], float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy()[0], np.asarray(want_grad),
                               **GRAD_TOL)


def test_vnl_sampler_is_uniform_over_the_mask():
    """The port's exact inverse-CDF sampler draws only mask pixels, and an
    empty mask reports not ok."""
    mask = torch.zeros(2, 1, 8, 8, dtype=torch.bool)
    mask[0, 0, 2:4, 5:7] = True
    g = torch.Generator().manual_seed(0)
    out = tl.sample_vnl_indices(g, mask, mask.reshape(2, -1), 500)
    ids = out["plane_idx"][0, 0].reshape(-1)
    assert set(ids.tolist()) == {21, 22, 29, 30}
    counts = np.bincount(ids.numpy(), minlength=64)[[21, 22, 29, 30]]
    assert counts.min() > 300
    assert out["plane_ok"].tolist() == [[True], [False]]
    assert out["np_ok"].tolist() == [True, False]


@pytest.mark.parametrize("fused", ["off", "on"])
def test_compute_losses_matches_jax(fused):
    """Key by key against JAX's loss, its dice/lava through the XLA
    composition ("off") or the Pallas kernels in interpret mode ("on"),
    and the gradients in the predictions; the edge-centred gated instance
    is in the batch, and every gradient is finite."""
    cfg = _cfg(fused_loss_kernel=fused)
    batch = _batch()
    preds = _preds(cfg)
    rng = jax.random.PRNGKey(11)

    def jax_total(p):
        ls = jl.compute_losses(cfg, p, _tree(jnp.asarray, batch), rng)
        return sum(ls.values()), ls

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grads = jax.value_and_grad(jax_total, has_aux=True)(
            _tree(jnp.asarray, preds))
    tpreds = _tree(lambda a: torch.tensor(a, requires_grad=True), preds)
    got = tl.compute_losses(port_cfg(cfg), tpreds,
                            _tree(torch.from_numpy, batch),
                            vnl_indices=jax_vnl_indices(cfg, batch, rng))
    assert list(got) == ["ins", "cat", "dpt", "pln", "lav"]
    assert set(got) == set(want)
    for key in want:
        assert float(want[key]) > 0, key
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   err_msg=key, **TOL)
    sum(got.values()).backward()
    for key in ("mask_pred", "depth_pred"):
        g = tpreds[key].grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(want_grads[key]),
                                   err_msg=key, **GRAD_TOL)
    for key in ("cate_preds", "kernel_preds"):
        for lvl in range(4):
            g = tpreds[key][lvl].grad.numpy()
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, np.asarray(want_grads[key][lvl]),
                                       err_msg=f"{key}[{lvl}]", **GRAD_TOL)


@pytest.mark.parametrize("name", ["ScanNet", "Stanford 2D3DS"])
def test_lava_valid_mask_branches_match_jax(name):
    """The lava loss's two valid-region branches, which no preset's
    dataset name reaches: the 20-pixel ScanNet crop and the dilated
    invalid-depth mask."""
    base = _cfg(use_plane_loss=False)
    cfg = base.copy(dict(dataset=base.dataset.copy(dict(name=name))))
    batch = _batch(edge_strip=False)
    batch["depth"][0, 10:30, 40:50] = 0.0       # invalid depth
    preds = _preds(cfg, seed=9)
    want = jl.compute_losses(cfg, _tree(jnp.asarray, preds),
                             _tree(jnp.asarray, batch), jax.random.PRNGKey(0))
    got = tl.compute_losses(port_cfg(cfg), _tree(torch.from_numpy, preds),
                            _tree(torch.from_numpy, batch))
    assert float(want["lav"]) > 0
    np.testing.assert_allclose(got["lav"].item(), float(want["lav"]), **TOL)
    unmasked = tl.compute_losses(port_cfg(base), _tree(torch.from_numpy, preds),
                                 _tree(torch.from_numpy, batch))
    assert abs(unmasked["lav"].item() - got["lav"].item()) > 1e-4
