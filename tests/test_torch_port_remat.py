"""Backbone rematerialisation (``remat_backbone``) in the port's training
step, against the JAX package's ``nn.remat`` step on the CPU.

The port recomputes each stage bottleneck in the backward through a
non-reentrant ``torch.utils.checkpoint``; the recompute runs the block's
BatchNorms as the forward did and puts their running statistics back, so
that they are updated once a step (``models/backbone.py``). Held here:

* The tiny preset's step with ``remat_backbone=True`` against the JAX
  package's step with it, at 2x64x64 (BatchNorm frozen and training) and
  2x32x32 (frozen): every loss within ``LOSS_TOL``, the running statistics
  and, with BatchNorm frozen, every gradient within ``LEAF_TOL`` of each
  leaf's scale (``tests/test_torch_port_trainer.py``'s tolerances; its
  docstring says why train-mode gradients are held by the statistics).
* The port with remat against the port without, from the same weights
  and batch: the losses equal, every gradient within 1e-6 of its leaf's
  scale, and ``running_mean``, ``running_var`` and
  ``num_batches_tracked`` of every norm equal in every bit (a second
  update in the recompute moves them by a factor of 0.9); in f32 and in
  bf16 (the recompute under the forward's autocast).
* A non-finite step under remat leaves every buffer as it was.
* ``resolve_remat`` as a pure function, and "auto" on the CPU.
* The (1, 2) and (2, 2) data x spatial meshes over gloo with remat (the
  recomputed halo exchanges and ``SyncBatchNorm2d`` all-reduces inside
  DDP's backward) against the JAX package's unsplit remat step, at
  ``tests/test_torch_port_spatial.py``'s tolerances: losses and the
  parameters after the update; with BatchNorm frozen, every gradient
  (DDP's sum over the ranks), and with it training, the running
  statistics, against the port's one-process remat step.
"""

import functools
import os

import numpy as np
import jax
import pytest
import torch
import torch.multiprocessing as mp

from planerecnet_tpu import trainer as jtrainer
from planerecnet_tpu.models.planerecnet import PlaneRecNet as JaxPlaneRecNet
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.models import backbone
from planerecnet_tpu_torch.models.planerecnet import (REMAT_FIT_BYTES,
                                                      REMAT_FIT_CARD_BYTES,
                                                      resolve_remat)
from planerecnet_tpu_torch.tools.run_multihost import _free_port
from planerecnet_tpu_torch.utils.weights import to_jax_variables
from test_torch_port_model import jax_variables, nest, port_cfg
from test_torch_port_spatial import (LAUNCH_TIMEOUT, PARAM_TOL, STEP_CFG,
                                     _params, _step_batch, _vnl)
from test_torch_port_spatial import LEAF_TOL as SPATIAL_LEAF_TOL
from test_torch_port_spatial import LOSS_TOL as SPATIAL_LOSS_TOL
from test_torch_port_trainer import (LOSS_TOL, SIZE, _assert_leaves_close,
                                     _batch, _cfg, _flatten, _jax_state,
                                     _port_state, _step_indices)
from torch_spatial_ranks import remat_rank_main
from torch_spatial_ranks import step as port_step

torch.set_num_threads(2)
SAME_TOL = 1e-6           # of each leaf's scale: remat against no remat
TINY_BLOCKS = 4           # the tiny preset's stage bottlenecks
REMAT_STEP_CFG = STEP_CFG.copy(dict(remat_backbone=True))
GRIDS = {2: (1, 2), 4: (2, 2)}        # ranks -> (n_data, n_spatial)


@pytest.fixture
def remat_calls(monkeypatch):
    """The blocks run under remat, one entry a call of ``_remat``."""
    calls = []
    remat = backbone._remat

    def counted(block, x, rows):
        calls.append(block)
        return remat(block, x, rows)

    monkeypatch.setattr(backbone, "_remat", counted)
    return calls


def _bits_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("freeze_bn,size", [
    pytest.param(True, SIZE, id="True"), pytest.param(False, SIZE, id="False"),
    pytest.param(True, 32, id="True-32x32")])
def test_remat_step_matches_jax_remat_step(freeze_bn, size, remat_calls):
    """One step of the tiny model with ``remat_backbone=True`` in both
    packages: every loss and the running statistics after it; with
    ``freeze_bn``, every gradient."""
    cfg = _cfg(size, freeze_bn=freeze_bn, remat_backbone=True)
    flat = jax_variables(_cfg(size, freeze_bn=freeze_bn))
    batch = _batch(seed=2, size=size)
    jstate = _jax_state(cfg, flat)
    grads, new_bs, want = jax.jit(functools.partial(
        jtrainer.grad_step, cfg=cfg))(jstate, dict(batch))
    state = _port_state(cfg, flat)
    got, _ = trainer.grad_step(state, batch, _step_indices(cfg, jstate, batch))
    assert len(remat_calls) == TINY_BLOCKS
    assert set(got) == set(want)
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


def _port_grad_step(cfg, flat, batch):
    """The port's ``grad_step``: (losses, gradients, BatchNorm buffers)."""
    state = trainer.create_train_state(port_cfg(cfg), variables=flat,
                                       device="cpu")
    losses, _ = trainer.grad_step(state, batch)
    return (losses, {n: p.grad.clone()
                     for n, p in state.model.named_parameters()},
            [b.clone() for b in trainer._bn_buffers(state.model)])


@pytest.mark.parametrize("freeze_bn,dtype", [
    (False, "float32"), (True, "float32"), (False, "bfloat16")])
def test_remat_step_equals_the_step_without(freeze_bn, dtype, remat_calls):
    """The same weights and batch with and without remat: the same
    losses, the gradients within ``SAME_TOL`` of each leaf's scale, and
    every BatchNorm buffer equal in every bit, updated once
    (``num_batches_tracked`` 1 where BatchNorm trains)."""
    cfg = _cfg(freeze_bn=freeze_bn, compute_dtype=dtype)
    flat = jax_variables(_cfg(freeze_bn=freeze_bn))
    batch = _batch(seed=2)
    want = _port_grad_step(cfg, flat, batch)
    assert not remat_calls
    got = _port_grad_step(cfg.copy(dict(remat_backbone=True)), flat, batch)
    assert len(remat_calls) == TINY_BLOCKS
    for key, value in want[0].items():
        _bits_equal(got[0][key], value, key)
    for key, value in want[1].items():
        scale = max(float(value.abs().max()), 1e-12)
        err = float((got[1][key] - value).abs().max())
        assert err <= SAME_TOL * scale, (key, err, scale)
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        _bits_equal(g, w, f"buffer {i}")
    counts = {int(b) for b in want[2][2::3]}
    assert counts == ({0} if freeze_bn else {1})


def test_nonfinite_remat_step_is_skipped(remat_calls):
    """A NaN depth under remat: the step is skipped and every parameter
    and buffer, the running statistics and their counts among them, stays
    as it was."""
    cfg = port_cfg(_cfg(remat_backbone=True))
    state = trainer.create_train_state(cfg, device="cpu", seed=2)
    batch = _batch()
    trainer.train_step(state, batch)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bad = dict(batch, depth=batch["depth"] * np.nan)
    losses = trainer.train_step(state, bad)
    assert not torch.isfinite(losses["total"])
    assert (state.step, state.updates) == (2, 1)
    assert len(remat_calls) == 2 * TINY_BLOCKS
    for k, v in state.model.state_dict().items():
        _bits_equal(v, before[k], k)
    trainer.train_step(state, batch)
    assert (state.step, state.updates) == (3, 2)
    assert {int(b) for b in trainer._bn_buffers(state.model)[2::3]} == {2}


def test_resolve_remat():
    """True and False force it; "auto" remats only with gradients, on a
    card, past the card's fitting point, which scales with its memory;
    PRN-50's default 8x640x640 f32 step stays without remat on the card
    that measured the point."""
    fit, card = REMAT_FIT_BYTES, REMAT_FIT_CARD_BYTES
    assert fit > 0 and card > 0
    for setting in (True, False):
        for grad, memory in ((True, card), (False, card), (True, None)):
            assert resolve_remat(setting, grad, 1, memory) is setting
    assert not resolve_remat("auto", False, 10 * fit, card)
    assert not resolve_remat("auto", True, 10 * fit, None)
    assert not resolve_remat("auto", True, fit, card)
    assert resolve_remat("auto", True, fit + 1, card)
    assert resolve_remat("auto", True, fit // 2 + 1, card // 2)
    assert not resolve_remat("auto", True, fit, 2 * card)
    assert not resolve_remat("auto", True, 8 * 640 * 640 * 4, card)
    with pytest.raises(ValueError, match="remat_backbone"):
        resolve_remat("on", True, 1, card)


def test_auto_does_not_remat_on_the_cpu(remat_calls):
    """The tiny preset with ``remat_backbone="auto"`` takes a step on the
    CPU without remat, and a forward under ``no_grad`` with
    ``remat_backbone=True`` runs no checkpoint."""
    cfg = port_cfg(_cfg(remat_backbone="auto"))
    state = trainer.create_train_state(cfg, device="cpu")
    trainer.train_step(state, _batch())
    forced = trainer.create_train_state(port_cfg(_cfg(remat_backbone=True)),
                                        device="cpu")
    with torch.no_grad():
        forced.model(torch.zeros(1, SIZE, SIZE, 3))
    assert not remat_calls


# --- the data x spatial meshes over gloo --------------------------------


def _remat_cfgs():
    return {f: port_cfg(REMAT_STEP_CFG.copy(dict(freeze_bn=f)))
            for f in (False, True)}


@functools.lru_cache(maxsize=None)
def _jax_remat_step():
    """The JAX package's unsharded remat step at 4x64x64: (losses,
    params)."""
    tree = nest(jax_variables(STEP_CFG))
    state = jtrainer.TrainState.create(
        apply_fn=JaxPlaneRecNet(REMAT_STEP_CFG).apply, params=tree["params"],
        tx=jtrainer.make_optimizer(REMAT_STEP_CFG, None, False),
        batch_stats=tree["batch_stats"],
        rng=jax.random.split(jax.random.PRNGKey(0))[1])
    grads, new_bs, losses = jax.jit(functools.partial(
        jtrainer.grad_step, cfg=REMAT_STEP_CFG))(state, _step_batch())
    state = jax.jit(jtrainer.apply_grads)(state, grads, new_bs,
                                          losses["total"])
    return ({k: float(v) for k, v in losses.items()},
            {f"params/{k}": v for k, v in _flatten(state.params).items()})


@functools.lru_cache(maxsize=None)
def _one_process_remat_step(freeze_bn):
    state = trainer.create_train_state(
        _remat_cfgs()[freeze_bn], variables=jax_variables(STEP_CFG),
        device="cpu")
    return port_step(state, _step_batch(), _vnl())


@pytest.fixture(scope="module")
def remat_ranks(tmp_path_factory):
    """n -> each rank's results of the remat steps on ``GRIDS[n]``; both
    spawns start at the first request, and the JAX step is computed while
    they run."""
    steps = (_remat_cfgs(), jax_variables(STEP_CFG), _step_batch(), _vnl())
    ctx = mp.get_context("spawn")
    spawns = {}
    for n, grid in GRIDS.items():
        out_dir = str(tmp_path_factory.mktemp(f"remat{n}"))
        port = _free_port()
        procs = [ctx.Process(target=remat_rank_main,
                             args=(r, n, port, out_dir, grid, steps))
                 for r in range(n)]
        for p in procs:
            p.start()
        spawns[n] = (procs, out_dir)
    try:
        _jax_remat_step()
    finally:
        results = {}
        for n, (procs, out_dir) in spawns.items():
            for p in procs:
                p.join(timeout=LAUNCH_TIMEOUT)
                if p.is_alive():
                    p.kill()
                    p.join()
            results[n] = ([p.exitcode for p in procs], out_dir)

    def get(n):
        codes, out_dir = results[n]
        assert codes == [0] * n, codes
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    return functools.lru_cache(maxsize=None)(get)


@pytest.mark.parametrize("n", list(GRIDS), ids=["1x2", "2x2"])
def test_spatial_remat_step_matches_jax(remat_ranks, n):
    """BatchNorm training (synced): every rank's losses against the JAX
    package's unsplit remat step, and the parameters after the update."""
    want_losses, want_params = _jax_remat_step()
    for got in remat_ranks(n):
        assert got["remat_blocks"] == [True] * (2 * TINY_BLOCKS)
        losses, _, state = got[False]
        assert set(losses) == set(want_losses)
        for key, want in want_losses.items():
            assert losses[key] == pytest.approx(want, **SPATIAL_LOSS_TOL), key
        params = _params(state)
        assert set(params) == set(want_params)
        worst = max(float(np.abs(params[k] - np.asarray(want_params[k])).max())
                    for k in params)
        assert worst < PARAM_TOL


@pytest.mark.parametrize("n", list(GRIDS), ids=["1x2", "2x2"])
def test_spatial_remat_step_matches_one_process(remat_ranks, n):
    """BatchNorm frozen: every gradient leaf on every rank (DDP's sum over
    the ranks); with BatchNorm training, the running statistics (updated
    once) and their counts; against the port's remat step in one
    process."""
    frozen, training = (_one_process_remat_step(True),
                        _one_process_remat_step(False))
    ranks = remat_ranks(n)
    for r in ranks:
        for k, want in frozen[1].items():
            scale = max(float(want.abs().max()), 1e-6)
            err = float((r[True][1][k] - want).abs().max())
            assert err <= SPATIAL_LEAF_TOL * scale, (k, err, scale)
        stats = r[False][2]
        for k, want in training[2].items():
            if k.endswith("num_batches_tracked"):
                _bits_equal(stats[k], want, k)
            elif "running" in k:
                scale = max(float(want.abs().max()), 1e-6)
                err = float((stats[k] - want).abs().max())
                assert err <= SPATIAL_LEAF_TOL * scale, (k, err, scale)
