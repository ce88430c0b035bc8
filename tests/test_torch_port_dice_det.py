"""The deterministic dice/lava variants' host plan and order, on the CPU.

``csrc/dice_lava.cu``'s deterministic variants cut each image's pixel
tiles into units (``ops/dice_lava.py::det_plan``), store each unit's
partial to its own slot, and after one grid barrier sum every output
element over its image's units in unit order. The card is not here, so:
the plan must cover every tile of every image exactly once, whatever the
shape; the blocks of the kernel's persistent grid (``unit_items`` in the
source) must take whole units, each once, on a card of 132 SMs and of 114
(so the sums, which follow from the units alone, are the same on both);
``kernel_order`` below sums in the kernel's order in plain PyTorch and
must agree with the JAX package's XLA oracle; and ``deterministic=True``
on a CPU tensor still takes the plain versions, which agree with the JAX
package at the tolerances of ``tests/test_torch_port_dice_lava.py``.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu.ops.pallas.dice_lava import fused_dice_lava_xla
from planerecnet_tpu_torch.ops import dice_lava
from test_torch_port_dice_lava import (CASES, GRAD_TOL, SUM_TOL, WEIGHTS,
                                       _inputs, _interpret, _jax_fused)

torch.set_num_threads(2)
SOURCE = (Path(dice_lava.__file__).resolve().parent.parent / "csrc"
          / "dice_lava.cu").read_text()
DK_TILES = int(re.search(r"constexpr int kDkTiles = (\d+);",
                         SOURCE).group(1))
DET_DK_TILES = int(re.search(r"constexpr int kDetDkTiles = (\d+);",
                             SOURCE).group(1))
# (B, K, HW): the presets' training shapes (640x640 masks at 160x160), the
# card's check cases, one image, and batches past the unit budget.
PLAN_SHAPES = [(8, 128, 25600), (8, 256, 25600), (8, 32, 25600),
               (2, 32, 2381), (2, 128, 2381), (2, 256, 1000),
               (2, 256, 25600), (3, 128, 333), (2, 256, 555), (1, 128, 25600),
               (16, 128, 6400), (200, 32, 100), (4, 128, 1)]


def test_constants_mirror_the_kernel():
    """The plan's tile widths and slot sizes are the kernel's."""
    m = re.search(r"return K >= 256 \? (\d+) : \(backward \? (\d+) : "
                  r"(\d+)\);", SOURCE)
    wide, bwd, fwd = map(int, m.groups())
    for k in (32, 128, 256):
        assert dice_lava.tile_width(k, True) == (wide if k >= 256 else bwd)
        assert dice_lava.tile_width(k, False) == (wide if k >= 256 else fwd)
    assert int(re.search(r"constexpr int kMaxP = (\d+);",
                         SOURCE).group(1)) == dice_lava._MAX_P
    assert ("backward ? (long long)kMaxP * (K > 128 ? K : 128)\n"
            "                                  : 3LL * kMaxP") in SOURCE
    assert "det_reduce" not in SOURCE    # one launch a chunk
    assert ("constexpr int every = DET && K < 256 ? kDetDkTiles : "
            "kDkTiles;") in SOURCE


@pytest.mark.parametrize("backward", [True, False], ids=["bwd", "fwd"])
@pytest.mark.parametrize("b,k,hw", PLAN_SHAPES)
def test_det_plan_covers_every_tile_once(b, k, hw, backward):
    plan = dice_lava.det_plan(b, k, hw, backward)
    assert plan.tile == dice_lava.tile_width(k, backward)
    assert plan.tiles == -(-hw // plan.tile)
    seen = [t for u in range(plan.units) for t in plan.unit_tiles(u)]
    assert seen == list(range(plan.tiles))
    assert all(len(plan.unit_tiles(u)) >= 1 for u in range(plan.units))
    # About DET_UNITS units a batch, never more than a tile a unit.
    assert plan.units <= plan.tiles
    assert b * plan.units <= max(dice_lava.DET_UNITS + b, b)
    slot = plan.slot_floats(k, backward)
    assert plan.workspace_floats(b, k, backward) == b * plan.units * slot


def unit_items(plan, b, grid):
    """Per block, its items (image x tiles + tile): ``unit_items`` in the
    source, for a persistent grid of ``grid`` blocks."""
    units = b * plan.units

    def start(u):
        return (u // plan.units) * plan.tiles + (u % plan.units) * (
            plan.tiles_per_unit)

    return [range(start(units * x // grid), start(units * (x + 1) // grid))
            for x in range(grid)]


@pytest.mark.parametrize("b,k,hw", PLAN_SHAPES)
def test_blocks_take_whole_units_whatever_the_card(b, k, hw):
    """On 132 and on 114 SMs (one block an SM, as at the training shapes)
    every item is one block's, and a block starts and ends on unit
    boundaries, so each unit's partial is formed by one block from its
    tiles alone, and the sums do not depend on the card."""
    plan = dice_lava.det_plan(b, k, hw, True)
    bounds = {i * plan.tiles + t for i in range(b)
              for t in range(0, plan.tiles, plan.tiles_per_unit)}
    bounds.add(b * plan.tiles)
    for sms in (132, 114):
        grid = min(sms, b * plan.units)
        blocks = unit_items(plan, b, grid)
        items = [it for r in blocks for it in r]
        assert items == list(range(b * plan.tiles))
        for r in blocks:
            assert len(r) > 0
            assert r.start in bounds and r.stop in bounds


def test_workspace_is_a_slot_a_unit():
    """At PRN-50's training shape: 16 units an image of 50 backward (25
    forward) tiles, 8.4 MB of backward slots (the variant it replaces held
    two images' P x K for each of 132 blocks, 17.3 MB)."""
    bwd = dice_lava.det_plan(8, 128, 25600, True)
    fwd = dice_lava.det_plan(8, 128, 25600, False)
    assert (bwd.units, bwd.tiles_per_unit) == (16, 50)
    assert (fwd.units, fwd.tiles_per_unit) == (16, 25)
    assert 4 * bwd.workspace_floats(8, 128, True) == 8388608
    assert 4 * fwd.workspace_floats(8, 128, False) == 196608


def kernel_order(kernels, feat, onehot, targets, grad, ga, gb, gl):
    """The deterministic variants' sums in plain PyTorch: each unit's
    partial over its tiles (dk flushed from its accumulator every
    kDetDkTiles tiles below K = 256, kDkTiles at it, and added to the
    slot), then each output the sum of
    its image's units in unit order. Returns (a, b, lava, dk)."""
    b, p, k = kernels.shape
    hw = feat.shape[1]
    sig, tgt = dice_lava._logits_targets(kernels, feat, onehot, targets)
    dl = (ga[..., None] * tgt + 2.0 * gb[..., None] * sig
          + gl[..., None] * grad[:, None, :]) * sig * (1.0 - sig)
    out = []
    for backward in (False, True):
        plan = dice_lava.det_plan(b, k, hw, backward)
        slots = []
        for u in range(b * plan.units):
            i, tiles = u // plan.units, plan.unit_tiles(u % plan.units)
            q = slice(tiles.start * plan.tile,
                      min(tiles.stop * plan.tile, hw))
            if not backward:
                slots.append(torch.stack([(sig[i, :, q] * tgt[i, :, q]).sum(1),
                                          (sig[i, :, q] ** 2).sum(1),
                                          sig[i, :, q] @ grad[i, q]]))
                continue
            slot = None
            every = DET_DK_TILES if k < 256 else DK_TILES
            for t0 in range(tiles.start, tiles.stop, every):
                r = slice(t0 * plan.tile,
                          min((t0 + every) * plan.tile, hw, q.stop))
                part = dl[i, :, r] @ feat[i, r]
                slot = part if slot is None else slot + part
            slots.append(slot)
        per_image = []
        for i in range(b):
            s = slots[i * plan.units]
            for u in range(1, plan.units):
                s = s + slots[i * plan.units + u]
            per_image.append(s)
        out.append(torch.stack(per_image))
    a, bb, lava = out[0].unbind(1)
    return a, bb, lava, out[1]


@pytest.mark.parametrize("hw,kind", CASES)
def test_kernel_order_matches_jax(hw, kind):
    args = _inputs(hw=hw, seed=hw + 7, kind=kind)
    gs = np.random.RandomState(hw).randn(3, 2, 16).astype(np.float32)
    targs = [torch.from_numpy(x) for x in args]
    a, b, lava, dk = kernel_order(*targs, *torch.from_numpy(gs))
    want = fused_dice_lava_xla(*(jnp.asarray(x) for x in args))
    for name, g, w in zip(("a", "b", "lava"), (a, b, lava), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **SUM_TOL)

    def loss(kernels):
        outs = fused_dice_lava_xla(kernels, *(jnp.asarray(x)
                                              for x in args[1:]))
        return sum(jnp.sum(jnp.asarray(g) * o) for g, o in zip(gs, outs))

    want_dk = jax.grad(loss)(jnp.asarray(args[0]))
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), **GRAD_TOL)


@pytest.mark.parametrize("hw,kind", CASES)
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_deterministic_matches_jax(hw, kind, oracle):
    """``deterministic=True`` on the CPU: the plain forward and backward,
    against the JAX package, as the atomic path's tests hold them."""
    args = _inputs(hw=hw, seed=hw + 2, kind=kind)

    def loss(kernels, feat):
        a, b, lava = _jax_fused([kernels, feat] + [jnp.asarray(x)
                                                   for x in args[2:]],
                                oracle == "pallas_interpret")
        return jnp.sum(WEIGHTS[0] * a + WEIGHTS[1] * b + WEIGHTS[2] * lava)

    with _interpret(oracle):
        want = _jax_fused([jnp.asarray(a) for a in args],
                          oracle == "pallas_interpret")
        want_grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(args[0]),
                                                    jnp.asarray(args[1]))
    kernels = torch.tensor(args[0], requires_grad=True)
    feat = torch.tensor(args[1], requires_grad=True)
    got = dice_lava.fused_dice_lava(
        kernels, feat, *(torch.from_numpy(x) for x in args[2:]),
        deterministic=True)
    for name, g, w in zip(("a", "b", "lava"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **SUM_TOL)
    (WEIGHTS[0] * got[0] + WEIGHTS[1] * got[1]
     + WEIGHTS[2] * got[2]).sum().backward()
    for name, g, w in (("dk", kernels.grad, want_grads[0]),
                       ("dm", feat.grad, want_grads[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_deterministic_dispatch_and_checks():
    """A CPU tensor takes the plain versions (no launch counted); a bad
    shape or device raises before anything touches a card."""
    args = [torch.from_numpy(a) for a in _inputs(seed=5)]
    gs = [torch.ones(2, 16)] * 3
    before = (dice_lava.dice_lava_fwd.det_launches,
              dice_lava.dice_lava_bwd.det_launches)
    got = dice_lava.dice_lava_fwd(*args, deterministic=True)
    got_b = dice_lava.dice_lava_bwd(*args, *gs, deterministic=True)
    assert (dice_lava.dice_lava_fwd.det_launches,
            dice_lava.dice_lava_bwd.det_launches) == before
    for g, w in zip((*got, *got_b),
                    (*dice_lava.fused_dice_lava_plain(*args),
                     *dice_lava.fused_dice_lava_bwd_plain(*args, *gs))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        dice_lava.dice_lava_fwd(args[0], args[1][:, :-1], *args[2:],
                                deterministic=True)
    with pytest.raises(ValueError):
        dice_lava.dice_lava_bwd(*args[:2], args[2][:, :-1], *args[3:], *gs,
                                deterministic=True)
    with pytest.raises(ValueError):
        dice_lava.dice_lava_bwd(*(a.to("meta") for a in args),
                                *(g.to("meta") for g in gs),
                                deterministic=True)
