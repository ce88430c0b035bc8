"""The port's trainer against the JAX package's on the CPU.

Both packages start from the same seeded variables
(``test_torch_port_model.seeded_variables``) of the tiny PlaneRecNet-50 at
64x64, take the same batch, and the port's VNL loss gets the triplet ids
JAX's sampler draws from the step's key (``jax_vnl_indices``). Losses and
gradients (read in the JAX layout through ``to_jax_variables``) are then
compared, and the parameters over a few steps.

Tolerances: losses rtol 2e-4 (the VNL loss's triplet filter and
hardest-75% selection are discontinuous in the predicted depth, which the
packages round differently); gradients and BatchNorm statistics within
2e-4 of each leaf's largest magnitude (measured: 1.6e-5).

Gradients are compared with ``freeze_bn`` (BatchNorm on its running
statistics, the reference's setting for small per-device batches) and on
an input whose ReLUs all sit clear of their kinks. In train-mode BatchNorm
at this size (8 values per channel at C5) the f32 gradient is itself
ill-conditioned: the port's f32 gradient lies a median 7e-3 (at most 9e-2)
of each leaf's scale from the port's own float64 evaluation, and JAX's
one-pass variance (E[x^2] - E[x]^2) loses more (2.4e-3 at a mean 30 times
the spread, where torch's two-pass stays at 4e-7). One ReLU input within
rounding of 0 moves a leaf's gradient by a few percent in either package.
Train mode is therefore held by its losses and running statistics, and the
BatchNorm layer by ``test_batchnorm_train_mode_matches_jax``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu import trainer as jtrainer
from planerecnet_tpu.config import PlaneRecNet_tiny_config
from planerecnet_tpu.data.datasets import collate_batch
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.utils import checkpoint
from planerecnet_tpu_torch.utils.weights import to_jax_variables
from test_torch_port_losses import jax_vnl_indices
from test_torch_port_model import (jax_variables, nest, port_cfg,
                                   variable_shapes)
from test_trainer import _tiny_batch

torch.set_num_threads(2)
SIZE = 64
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
LEAF_TOL = 2e-4
# After a few Adam steps: Adam divides each gradient by its own running
# magnitude, so a leaf whose gradient is near zero (a conv bias in front of
# a BatchNorm) takes +-lr steps from rounding noise in either package.
TRAJECTORY_TOL = dict(rtol=1e-3, atol=1e-6)


def _cfg(size=SIZE, **kw):
    """The tiny preset with a schedule that moves the weights: no warm-up,
    lr 1e-3."""
    return PlaneRecNet_tiny_config.copy(dict(
        max_size=size, lr=1e-3, lr_warmup_until=0, **kw))


def _batch(seed=0, size=SIZE):
    batch = _tiny_batch(2, size, size)
    x0, y0, x1, y1 = (np.array([10, 30, 50, 60]) * size) // SIZE
    batch["masks"][1, 1, y0:y1, x0:x1] = 1
    batch["boxes"][1, 1] = [x0, y0, x1, y1]
    batch["gt_valid"][1, 1] = True
    batch["image"] = np.random.RandomState(seed).randn(
        2, size, size, 3).astype(np.float32)
    return batch


def _jax_state(cfg, flat, per_module_lr=False):
    state = jtrainer.create_train_state(cfg, jax.random.PRNGKey(0),
                                        input_shape=(cfg.max_size,) * 2,
                                        per_module_lr=per_module_lr)
    tree = nest(flat)
    return state.replace(params=tree["params"],
                         batch_stats=tree["batch_stats"],
                         opt_state=state.tx.init(tree["params"]))


def _port_state(cfg, flat, **kw):
    return trainer.create_train_state(port_cfg(cfg), variables=flat,
                                      device="cpu", **kw)


def _step_indices(cfg, jstate, batch):
    key = jax.random.fold_in(jstate.rng, jstate.step)
    return jax_vnl_indices(cfg, batch, key)


def _assert_leaves_close(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(got[key] - w).max())
        assert err <= LEAF_TOL * scale, (what, key, err, scale)


def _flatten(tree, prefix=""):
    """A nested JAX tree -> flat "/"-keyed numpy leaves under ``prefix``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def test_lr_schedule_matches_jax():
    cfg = PlaneRecNet_tiny_config
    want = jtrainer.lr_schedule(cfg)
    got = trainer.lr_schedule(port_cfg(cfg))
    for it in [0, 1, 1000, 2000, 2001, 50000, 62500, 99999, 100000, 124999]:
        assert got(it) == pytest.approx(float(want(it)), rel=1e-6), it


def test_per_module_lr_groups():
    """5x for the backbone, 2x for the depth decoder, 1x elsewhere; one
    group without ``per_module_lr``; no weight decay."""
    cfg = port_cfg(_cfg())
    state = trainer.create_train_state(cfg, device="cpu", per_module_lr=True)
    mult = {}
    for group in state.optimizer.param_groups:
        assert group["weight_decay"] == 0.0
        assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
        for p in group["params"]:
            mult[id(p)] = group["lr_mult"]
    for name, p in state.model.named_parameters():
        top = name.split(".", 1)[0]
        assert mult[id(p)] == {"backbone": 5.0,
                               "depth_decoder": 2.0}.get(top, 1.0), name
    plain = trainer.create_train_state(cfg, device="cpu")
    assert len(plain.optimizer.param_groups) == 1


@pytest.mark.parametrize("sparse", [True, False])
def test_unpack_wire_batch_matches_jax(sparse):
    """A wire batch from the JAX package's ``collate_batch`` (bit-packed
    masks, sparse or dense; u16 depth; u8 BGR image)."""
    cfg = _cfg()
    rng = np.random.RandomState(1)
    samples = []
    for n in (2, 0, 3):
        masks = (rng.rand(n, 16, 20) > 0.5).astype(np.uint8)
        samples.append((
            rng.randint(0, 256, (16, 20, 3)).astype(np.uint8),
            {"masks": masks, "boxes": rng.rand(n, 4).astype(np.float32) * 16,
             "classes": np.ones(n, np.int32),
             "plane_paras": rng.rand(n, 4).astype(np.float32),
             "k_matrix": np.eye(3, dtype=np.float32)},
            (rng.rand(16, 20) * 4).astype(np.float32)))
    wire = collate_batch(cfg, samples, sparse_masks=sparse)
    assert ("masks_sparse" in wire) == sparse
    want = jtrainer.unpack_wire_batch(cfg, dict(wire))
    got = trainer.unpack_wire_batch(port_cfg(cfg), wire, "cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["masks"].numpy(),
                                  np.asarray(want["masks"]))
    for key in ("image", "depth", "boxes", "plane_paras", "k_matrix"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for key in ("classes", "gt_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("freeze_bn,size", [
    pytest.param(True, SIZE, id="True"), pytest.param(False, SIZE, id="False"),
    # C5 is 1x1 at 32^2 (the reflection pad's and GroupNorm's one-value
    # cases, forward and backward).
    pytest.param(True, 32, id="True-32x32")])
def test_train_step_losses_and_grads_match_jax(freeze_bn, size):
    """One step of the tiny model on the same weights and batch: every
    loss and the BatchNorm running statistics after the step; with
    ``freeze_bn``, every gradient (in the JAX layout)."""
    cfg = _cfg(size, freeze_bn=freeze_bn)
    flat = jax_variables(cfg)
    batch = _batch(seed=2, size=size)
    jstate = _jax_state(cfg, flat)
    grads, new_bs, want = jax.jit(functools.partial(
        jtrainer.grad_step, cfg=cfg))(jstate, dict(batch))
    state = _port_state(cfg, flat)
    got, _ = trainer.grad_step(state, batch, _step_indices(cfg, jstate, batch))
    assert set(got) == set(want) == {"ins", "cat", "dpt", "pln", "lav",
                                     "total"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **LOSS_TOL)
    stats = {k: v for k, v in to_jax_variables(
        state.model.state_dict()).items() if k.startswith("batch_stats/")}
    _assert_leaves_close(stats, _flatten(new_bs, "batch_stats"), "batch_stats")
    if freeze_bn:
        port_grads = to_jax_variables({n: p.grad for n, p in
                                       state.model.named_parameters()})
        _assert_leaves_close(port_grads, _flatten(grads, "params"), "grads")


def test_batchnorm_train_mode_matches_jax():
    """``nn.BatchNorm2d`` in train mode is JAX's ``TorchBatchNorm``: the
    output, the input gradient and the running statistics (biased variance
    to normalise, Bessel-corrected running variance; torch momentum 0.1 =
    flax 0.9)."""
    from planerecnet_tpu.models.layers import TorchBatchNorm
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 8) * 0.5 + rng.randn(8) * 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    mod = TorchBatchNorm(use_running_average=False, momentum=0.9)
    scale, bias = 1 + rng.randn(8) * 0.1, rng.randn(8) * 0.1
    mean, var = rng.randn(8) * 0.5, rng.rand(8) + 0.5
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       variables)

    def f(xx):
        y, upd = mod.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), want_dx = jax.value_and_grad(
        f, has_aux=True)(jnp.asarray(x))
    bn = torch.nn.BatchNorm2d(8).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.tensor(v, dtype=torch.float32))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_dx), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want_stats["var"]), **tol)


def test_three_step_trajectory_matches_jax():
    """Three steps with the per-module learning rates: every loss at every
    step, the counters, and the parameters' updates."""
    cfg = _cfg(freeze_bn=True)
    flat = jax_variables(cfg)
    batch = _batch(seed=2)
    jstate = _jax_state(cfg, flat, per_module_lr=True)
    state = _port_state(cfg, flat, per_module_lr=True)
    step = jax.jit(lambda s, b: jtrainer.train_step(s, b, cfg))
    for i in range(3):
        idx = _step_indices(cfg, jstate, batch)
        jstate, want = step(jstate, dict(batch))
        got = trainer.train_step(state, batch, idx)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       err_msg=f"{key}, step {i}",
                                       **(LOSS_TOL if i == 0
                                          else TRAJECTORY_TOL))
    assert state.step == state.updates == int(jstate.step) == 3
    params = {k: v for k, v in to_jax_variables(
        state.model.state_dict()).items() if k.startswith("params/")}
    want = _flatten(jstate.params, "params")
    dp = np.concatenate([(params[k] - flat[k]).ravel() for k in want])
    dj = np.concatenate([(np.asarray(want[k]) - flat[k]).ravel() for k in want])
    diff = np.abs(dp - dj)
    # Adam's early updates are about lr * sign(gradient) per element, so an
    # element whose gradient is at rounding level flips; measured: mean
    # difference 4.7e-4 of the mean update, 98.6% of the elements within
    # 1e-2 of their own update.
    assert diff.mean() <= 2e-3 * np.abs(dj).mean()
    assert (diff <= 1e-2 * np.abs(dj)).mean() >= 0.95
    moved = max(float(np.abs(params[k] - flat[k]).max()) for k in params)
    assert moved > 1e-3


def test_nonfinite_step_is_skipped():
    """A NaN depth poisons the loss: parameters, Adam's state and the
    BatchNorm running statistics stay as they were, ``step`` advances and
    the update count does not."""
    cfg = port_cfg(_cfg())
    state = trainer.create_train_state(cfg, device="cpu", seed=2)
    batch = _batch()
    trainer.train_step(state, batch)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    adam = {id(p): {k: v.clone() for k, v in st.items()}
            for p, st in state.optimizer.state.items()}
    bad = dict(batch, depth=batch["depth"] * np.nan)
    losses = trainer.train_step(state, bad)
    assert not torch.isfinite(losses["total"])
    assert (state.step, state.updates) == (2, 1)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            torch.testing.assert_close(v, adam[id(p)][k], rtol=0, atol=0)
    trainer.train_step(state, batch)
    assert (state.step, state.updates) == (3, 2)


def test_freeze_bn_keeps_running_stats():
    cfg = port_cfg(_cfg(freeze_bn=True))
    state = trainer.create_train_state(cfg, device="cpu")
    stats = [b.clone() for b in trainer._bn_buffers(state.model)]
    trainer.train_step(state, _batch())
    assert state.model.training and state.updates == 1
    for old, new in zip(stats, trainer._bn_buffers(state.model)):
        torch.testing.assert_close(new, old, rtol=0, atol=0)


def test_checkpoint_save_load_resume(tmp_path):
    """A saved train state resumes to the same next step; its weights are
    the JAX package's layout and load into the JAX runner."""
    cfg = port_cfg(_cfg())
    batch = _batch()
    state = trainer.create_train_state(cfg, device="cpu", seed=3)
    trainer.train_step(state, batch)
    path = checkpoint.save_train_state(str(tmp_path / "state"), state)
    assert path.endswith(".npz") and len(list(tmp_path.iterdir())) == 1
    resumed = trainer.create_train_state(cfg, device="cpu", seed=4)
    checkpoint.load_train_state(path, resumed)
    assert (resumed.step, resumed.updates) == (1, 1)
    a = trainer.train_step(state, batch)
    b = trainer.train_step(resumed, batch)
    assert float(a["total"]) == float(b["total"])
    for (k, v), w in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        if not k.endswith("num_batches_tracked"):   # unused: fixed momentum
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)

    from planerecnet_tpu.runner import PlaneRecNetRunner as JaxRunner
    jcfg = _cfg()
    runner = JaxRunner(jcfg, variables=nest(jax_variables(jcfg)))
    runner.load_weights(path)
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files
                 if k.split("/", 1)[0] in ("params", "batch_stats")}
    loaded = _flatten(runner.variables)
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_to_jax_variables_round_trip():
    """Port weights -> JAX layout -> port weights, and the JAX layout has
    exactly the JAX model's keys and shapes."""
    cfg = _cfg()
    state = trainer.create_train_state(port_cfg(cfg), device="cpu", seed=5)
    flat = to_jax_variables(state.model.state_dict())
    shapes = variable_shapes(cfg)
    assert {k: v.shape for k, v in flat.items()} == shapes
    fresh = trainer.create_train_state(port_cfg(cfg), variables=flat,
                                       device="cpu", seed=6)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)


def test_default_device_is_cuda():
    cfg = port_cfg(_cfg())
    if torch.cuda.is_available():
        assert trainer.create_train_state(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.create_train_state(cfg)
