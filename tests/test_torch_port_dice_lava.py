"""The port's fused dice/lava reductions against the JAX package on the CPU.

On a CPU tensor the port's Function takes its plain forward and its plain
backward (the formulas of JAX's ``_bwd_kernel``, not torch's autograd of
the plain forward), so these tests hold what the card's kernels compute
against ``fused_dice_lava`` (the Pallas kernels in interpret mode, with
``jax.grad`` through its custom VJP) and against ``fused_dice_lava_xla``.

Besides the one-hot rows the training step gives, the forward and backward
tests take the general contract: a fractional ``onehot`` with several
non-zero entries per row and fractional ``targets``. The card's kernels
form a[p] as sum_n onehot[p, n] (sum_q s t_n), which holds for any onehot
only if the plain versions they are checked against do too.

Tolerance: rtol 1e-5, atol 1e-4 for the per-slot sums (f32 sums of up to a
few thousand terms of O(1), reduced in other orders); rtol and atol 1e-5
for the gradients.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from planerecnet_tpu.ops.pallas.dice_lava import (
    fused_dice_lava as jax_fused, fused_dice_lava_xla)
from planerecnet_tpu_torch.ops import dice_lava

torch.set_num_threads(2)
SUM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHTS = (0.7, -0.3, 1.3)     # the loss sum(0.7 a - 0.3 b + 1.3 lava)


def _inputs(b=2, p=16, k=32, n=4, hw=300, seed=0, kind="onehot"):
    """"onehot": some slots invalid (all-zero one-hot rows), binary targets.
    "fractional": rows with several fractional entries (and some all-zero
    rows), fractional targets."""
    rng = np.random.RandomState(seed)
    kernels = rng.randn(b, p, k).astype(np.float32) * 0.2
    feat = rng.randn(b, hw, k).astype(np.float32) * 0.2
    if kind == "onehot":
        onehot = np.zeros((b, p, n), np.float32)
        for bi in range(b):
            for pi in range(p):
                if rng.rand() > 0.25:
                    onehot[bi, pi, rng.randint(n)] = 1.0
        targets = (rng.rand(b, n, hw) > 0.5).astype(np.float32)
    else:
        onehot = (rng.rand(b, p, n) * (rng.rand(b, p, n) > 0.4)).astype(
            np.float32)
        onehot[:, ::5] = 0.0
        assert ((onehot > 0).sum(-1) > 1).any()
        targets = rng.rand(b, n, hw).astype(np.float32)
    assert (onehot.sum(-1) == 0).any()
    grad = rng.rand(b, hw).astype(np.float32)
    return kernels, feat, onehot, targets, grad


def _jax_fused(args, interpret):
    return (jax_fused if interpret else fused_dice_lava_xla)(*args)


def _interpret(oracle):
    """Pallas interpret mode around the whole JAX call, backward included."""
    if oracle == "pallas_interpret":
        return pltpu.force_tpu_interpret_mode()
    return contextlib.nullcontext()


# hw=2381: not a multiple of the Pallas chunk (1024) nor of the CUDA tiles.
CASES = [pytest.param(300, "onehot", id="300"),
         pytest.param(2381, "onehot", id="2381"),
         pytest.param(300, "fractional", id="300-fractional"),
         pytest.param(2381, "fractional", id="2381-fractional")]


@pytest.mark.parametrize("hw,kind", CASES)
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_forward_matches_jax(hw, kind, oracle):
    args = _inputs(hw=hw, seed=hw, kind=kind)
    with _interpret(oracle):
        want = _jax_fused([jnp.asarray(a) for a in args],
                          oracle == "pallas_interpret")
    got = dice_lava.fused_dice_lava(*(torch.from_numpy(a) for a in args))
    for name, g, w in zip(("a", "b", "lava"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **SUM_TOL)


@pytest.mark.parametrize("hw,kind", CASES)
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_backward_matches_jax(hw, kind, oracle):
    args = _inputs(hw=hw, seed=hw + 1, kind=kind)

    def loss(kernels, feat):
        a, b, lava = _jax_fused([kernels, feat] + [jnp.asarray(x)
                                                   for x in args[2:]],
                                oracle == "pallas_interpret")
        return jnp.sum(WEIGHTS[0] * a + WEIGHTS[1] * b + WEIGHTS[2] * lava)

    with _interpret(oracle):
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(args[0]),
                                              jnp.asarray(args[1]))
    kernels = torch.tensor(args[0], requires_grad=True)
    feat = torch.tensor(args[1], requires_grad=True)
    a, b, lava = dice_lava.fused_dice_lava(
        kernels, feat, *(torch.from_numpy(x) for x in args[2:]))
    (WEIGHTS[0] * a + WEIGHTS[1] * b + WEIGHTS[2] * lava).sum().backward()
    for name, g, w in (("dk", kernels.grad, want[0]), ("dm", feat.grad,
                                                       want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_backward_plain_is_the_formula_not_autograd():
    """The Function's CPU backward is ``fused_dice_lava_bwd_plain``; it
    agrees with torch's autograd of the plain forward."""
    args = [torch.from_numpy(a) for a in _inputs(seed=3)]
    k = args[0].clone().requires_grad_(True)
    m = args[1].clone().requires_grad_(True)
    a, b, lava = dice_lava.fused_dice_lava_plain(k, m, *args[2:])
    (WEIGHTS[0] * a + WEIGHTS[1] * b + WEIGHTS[2] * lava).sum().backward()
    gs = [torch.full_like(a, w) for w in WEIGHTS]
    dk, dm = dice_lava.fused_dice_lava_bwd_plain(*args, *gs)
    torch.testing.assert_close(dk, k.grad, **GRAD_TOL)
    torch.testing.assert_close(dm, m.grad, **GRAD_TOL)


def test_cpu_dispatch_and_checks():
    args = [torch.from_numpy(a) for a in _inputs(seed=4)]
    before = (dice_lava.dice_lava_fwd.launches,
              dice_lava.dice_lava_bwd.launches)
    dice_lava.dice_lava_fwd(*args)
    dice_lava.dice_lava_bwd(*args, *[torch.ones(2, 16)] * 3)
    assert (dice_lava.dice_lava_fwd.launches,
            dice_lava.dice_lava_bwd.launches) == before
    with pytest.raises(ValueError):
        dice_lava.dice_lava_fwd(args[0], args[1][:, :-1], *args[2:])
    with pytest.raises(ValueError):
        dice_lava.dice_lava_fwd(*(a.to("meta") for a in args))
    # What the kernels take, checked before anything touches a card.
    for p, k in ((129, 128), (128, 64)):
        with pytest.raises(ValueError):
            dice_lava._launch_geometry("dice_lava_fwd", p, k, "cuda")
