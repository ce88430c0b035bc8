"""Three capabilities of the JAX package that the port gained beside
``remat_backbone`` (``tests/test_torch_port_remat.py``), on the CPU:

* ``fused_loss_kernel``: "off" takes the dice/lava loss's plain PyTorch
  composition, never the kernels' wrapper; the tiny preset's step with it
  against the JAX package's "off" step (the XLA composition): losses
  within ``LOSS_TOL``, every gradient, BatchNorm frozen, within
  ``LEAF_TOL`` of its leaf's scale (``tests/test_torch_port_trainer.py``).
  An unknown value raises.
* Extra backbone stages: the tiny preset with ``selected_layers``
  reaching one stage past the ResNet's four builds ``extra0_0`` (a
  stride-2 bottleneck of 256 planes) in both packages; the backbone's five
  maps and the raw predictions against the JAX package's at 1e-4
  (``tests/test_torch_port_model.py``'s tolerance), the weights there and
  back through the JAX layout, and the extra stage outside remat.
* ``vnl_loss_ori``: fed the triplet ids that the JAX package's
  ``jax.random.randint`` draws inside its ``vnl_loss_ori``, at three
  shapes, with and without ``select``: the loss within ``LOSS_TOL`` and
  its gradient in the predicted depth within 1e-4 of its scale, at every
  pixel whose predicted depth is not exactly 0 (test comment); the
  port's own sampler draws each image's triplets over the whole image.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu import trainer as jtrainer
from planerecnet_tpu.config import PlaneRecNet_tiny_config as JaxTiny
from planerecnet_tpu.losses.vnl import vnl_loss_ori as jax_vnl_loss_ori
from planerecnet_tpu.models.planerecnet import PlaneRecNet as JaxPlaneRecNet
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.losses import (compute_losses,
                                          sample_vnl_ori_indices,
                                          vnl_loss_ori,
                                          vnl_loss_ori_from_indices)
from planerecnet_tpu_torch.losses import losses as tlosses
from planerecnet_tpu_torch.models import backbone
from planerecnet_tpu_torch.utils.weights import (from_jax_variables,
                                                 to_jax_variables)
from test_torch_port_model import (TOL, images, jax_variables, nest,
                                   port_cfg, port_model, variable_shapes)
from test_torch_port_trainer import (LOSS_TOL, _assert_leaves_close, _batch,
                                     _cfg, _flatten, _jax_state, _port_state,
                                     _step_indices)

torch.set_num_threads(2)
VNL_GRAD_TOL = 1e-4       # of the gradient's scale


# --- fused_loss_kernel ---------------------------------------------------


def test_fused_loss_off_step_matches_jax(monkeypatch):
    """BatchNorm frozen: the losses and every gradient of one step."""
    cfg = _cfg(freeze_bn=True, fused_loss_kernel="off")
    flat = jax_variables(_cfg(freeze_bn=True))
    batch = _batch(seed=2)
    jstate = _jax_state(cfg, flat)
    grads, _, want = jax.jit(functools.partial(
        jtrainer.grad_step, cfg=cfg))(jstate, dict(batch))

    def refused(*args, **kwargs):
        raise AssertionError("the kernels' wrapper with fused_loss 'off'")

    monkeypatch.setattr(tlosses, "fused_dice_lava", refused)
    state = _port_state(cfg, flat)
    assert state.cfg.fused_loss_kernel == "off"
    got, _ = trainer.grad_step(state, batch, _step_indices(cfg, jstate, batch))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **LOSS_TOL)
    _assert_leaves_close(
        to_jax_variables({n: p.grad for n, p in
                          state.model.named_parameters()}),
        _flatten(grads, "params"), "grads")


def test_fused_loss_kernel_values():
    """"auto" and "on" give the same losses on the CPU (the kernels'
    plain version), "off" the same within 1e-5; another value raises."""
    base = port_cfg(_cfg())
    state = trainer.create_train_state(base, device="cpu")
    batch = trainer.unpack_wire_batch(base, _batch(seed=2), "cpu")
    with torch.no_grad():
        preds = state.model(batch["image"])

    def losses(value):
        return compute_losses(base.copy(dict(fused_loss_kernel=value)),
                              preds, batch,
                              generator=torch.Generator().manual_seed(0))

    auto, on, off = losses("auto"), losses("on"), losses("off")
    for key in auto:
        assert float(on[key]) == float(auto[key]), key
        np.testing.assert_allclose(float(off[key]), float(auto[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="fused_loss_kernel"):
        losses("pallas")


# --- extra backbone stages -----------------------------------------------

EXTRA_CFG = JaxTiny.copy(dict(max_size=64, backbone=JaxTiny.backbone.copy(
    dict(selected_layers=(2, 3, 4)))))


@functools.lru_cache(maxsize=None)
def _jax_extra_forward():
    """(input, backbone maps, raw preds) of one JAX apply, numpy."""
    x = images(seed=3)
    preds, state = JaxPlaneRecNet(EXTRA_CFG).apply(
        nest(jax_variables(EXTRA_CFG)), jnp.asarray(x), train=False,
        capture_intermediates=lambda mdl, method: (mdl.name == "backbone"
                                                   and method == "__call__"),
        mutable=["intermediates"])
    feats = state["intermediates"]["backbone"]["__call__"][0]
    return (x, [np.asarray(f) for f in feats],
            jax.tree_util.tree_map(np.asarray, preds))


def test_extra_stage_forward_matches_jax():
    x, want_feats, want = _jax_extra_forward()
    assert len(want_feats) == 5
    model = port_model(EXTRA_CFG, jax_variables(EXTRA_CFG))
    assert model.backbone.channels == (256, 512, 1024, 2048, 1024)
    with torch.no_grad():
        feats = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = model(torch.from_numpy(x))
    assert len(feats) == 5
    for i, (g, w) in enumerate(zip(feats, want_feats)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   err_msg=f"stage {i}", **TOL)
    for key in ("cate_preds", "kernel_preds"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"{key}[{i}]",
                                       **TOL)
    for key in ("mask_pred", "depth_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key,
                                   **TOL)


def test_extra_stage_weights_round_trip_and_stay_out_of_remat(monkeypatch):
    """The JAX leaves of ``extra0_0`` land on ``backbone.layers.4.0`` and
    come back to the same keys and values; under remat only the four
    ResNet blocks are recomputed."""
    flat = jax_variables(EXTRA_CFG)
    extra = {k for k in flat if "/extra0_0/" in k}
    assert "params/backbone/extra0_0/downsample_conv/kernel" in extra
    model = port_model(EXTRA_CFG, flat)
    back = to_jax_variables(model.state_dict())
    assert {k: v.shape for k, v in back.items()} == variable_shapes(EXTRA_CFG)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    again = from_jax_variables(back, model)
    assert all(torch.equal(again[k], v) for k, v in
               model.state_dict().items())
    assert model.state_dict()["backbone.layers.4.0.conv2.weight"].shape == (
        256, 256, 3, 3)

    calls = []
    remat = backbone._remat
    monkeypatch.setattr(backbone, "_remat", lambda block, x, rows: (
        calls.append(block), remat(block, x, rows))[1])
    state = trainer.create_train_state(
        port_cfg(EXTRA_CFG.copy(dict(remat_backbone=True))), variables=flat,
        device="cpu")
    losses, _ = trainer.grad_step(state, _batch(seed=2))
    assert torch.isfinite(losses["total"])
    extra_block = state.model.backbone.layers[4][0]
    assert len(calls) == 4 and all(b is not extra_block for b in calls)


# --- vnl_loss_ori --------------------------------------------------------


def _depths(b, h, w, seed):
    """A GT depth of slanted planes with a few zero (invalid) pixels, and
    a prediction near it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gt = np.stack([1.5 + rng.rand() * 0.02 * xx + rng.rand() * 0.03 * yy
                   + 0.4 * (xx > w // 2) for _ in range(b)])
    gt[rng.rand(b, h, w) < 0.05] = 0.0
    pred = gt * (1.0 + 0.05 * rng.randn(b, h, w)) + 0.01
    pred[rng.rand(b, h, w) < 0.02] = 0.0
    return gt.astype(np.float32), pred.astype(np.float32)


@pytest.mark.parametrize("select", [True, False], ids=["select", "all"])
@pytest.mark.parametrize("b,h,w,m", [(2, 32, 48, 256), (1, 40, 40, 512),
                                     (3, 24, 32, 128)])
def test_vnl_loss_ori_matches_jax(b, h, w, m, select):
    gt, pred = _depths(b, h, w, seed=h + w)
    fx, fy = 0.8 * w, 0.9 * h
    key = jax.random.PRNGKey(b * 100 + m)
    idx = jax.vmap(lambda k: jax.random.randint(k, (3, m), 0, h * w))(
        jax.random.split(key, b))
    want, want_grad = jax.value_and_grad(
        lambda p: jax_vnl_loss_ori(key, jnp.asarray(gt), p, fx, fy,
                                   num_samples=m, select=select))(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = vnl_loss_ori_from_indices(
        torch.from_numpy(gt), p, fx, fy, torch.tensor(np.asarray(idx)).long(),
        select=select)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    # Where the predicted depth is exactly 0 (the z clamp's case) the
    # packages take different subgradients of |d| (torch's abs 0, JAX's
    # +-1); the model's softplus depth is never 0. Elsewhere every pixel.
    off_zero = pred != 0
    assert (~off_zero).any()
    want_grad = np.asarray(want_grad)[off_zero]
    scale = float(np.abs(want_grad).max())
    assert scale > 0
    assert float(np.abs(p.grad.numpy()[off_zero] - want_grad).max()) <= (
        VNL_GRAD_TOL * scale)


def test_vnl_loss_ori_sampler():
    """Each image draws its own ids over the whole image; the loss is a
    finite scalar, the same for the same generator seed."""
    idx = sample_vnl_ori_indices(torch.Generator().manual_seed(0), 3, 20, 30,
                                 400)
    assert idx.shape == (3, 3, 400) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 600
    assert int(idx.max()) > 550 and int(idx.min()) < 50
    assert not torch.equal(idx[0], idx[1])
    gt, pred = (torch.from_numpy(a) for a in _depths(2, 32, 32, seed=1))
    runs = [vnl_loss_ori(torch.Generator().manual_seed(5), gt, pred, 25.0,
                         25.0, num_samples=256) for _ in range(2)]
    assert runs[0].dim() == 0 and torch.isfinite(runs[0])
    assert float(runs[0]) == float(runs[1]) > 0
