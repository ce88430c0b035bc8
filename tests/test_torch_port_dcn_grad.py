"""The port's deformable-conv backward against the JAX package on the CPU.

``deform_conv2d`` is an autograd Function with the JAX package's analytic
backward (``_dcn_bwd``); on the CPU its im2col and its input-gradient
scatter take their plain versions, so these tests hold the same formulas
that the card runs against ``jax.grad`` of JAX's plain-autodiff
``deform_conv2d_reference``. The scatter's plain version is held against
the Pallas kernel in interpret mode and against its XLA oracle.

Tolerance 1e-5 relative and absolute (1e-4 for doffset, whose corner dots
sum Cin products against dcols of O(1) and then difference them): f32 on
both sides, reduced in different orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from planerecnet_tpu.ops.dcn import deform_conv2d_reference
from planerecnet_tpu.ops.pallas.dcn_scatter import (dcn_input_grad_pallas,
                                                    dcn_input_grad_xla)
from planerecnet_tpu_torch.ops import dcn
from planerecnet_tpu_torch.ops.dcn_scatter import (dcn_input_grad,
                                                   dcn_input_grad_plain)
from test_torch_port_dcn import _inputs

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x", "offset", "mask", "weight", "bias")


def _jax_grads(x, off, mask, weight, bias, cot, stride):
    def loss(*args):
        out = deform_conv2d_reference(*args, stride=stride, padding=1,
                                      kernel_size=3)
        return jnp.sum(out * cot)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, off, mask, weight, bias)))]


def _port_grads(x, off, mask, weight, bias, cot, stride):
    args = [torch.tensor(a, requires_grad=True)
            for a in (x, off, mask, weight, bias)]
    out = dcn.deform_conv2d(*args, stride=stride, padding=1, kernel_size=3)
    (out * torch.from_numpy(cot)).sum().backward()
    return [a.grad.numpy() for a in args]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("offsets", ["integer", "fractional",
                                     "out_of_bounds"])
def test_dcn_grads_match_jax(stride, offsets):
    """dx, doffset, dmask, dweight and dbias against ``jax.grad``, at
    integer sample positions (corners of weight 0 with a non-zero offset
    derivative), fractional ones, and offsets crossing the border."""
    x, off, mask, weight, bias = _inputs(offsets, stride, seed=4)
    ho, wo = off.shape[1:3]
    cot = np.random.RandomState(9).randn(
        x.shape[0], ho, wo, weight.shape[-1]).astype(np.float32)
    want = _jax_grads(x, off, mask, weight, bias, cot, stride)
    got = _port_grads(x, off, mask, weight, bias, cot, stride)
    for name, g, w in zip(NAMES, got, want):
        assert np.abs(w).max() > 0, name
        tol = dict(rtol=1e-4, atol=1e-4) if name == "offset" else TOL
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_dcn_grads_reach_module_inputs():
    """Through the module: the offset and modulator convs and the input
    all get gradients (the kernel path's output used to have no grad_fn)."""
    from planerecnet_tpu_torch.models.backbone import DeformableConv2d
    torch.manual_seed(0)
    mod = DeformableConv2d(8, 8, 3, stride=1, padding=1)
    with torch.no_grad():
        for conv in (mod.offset_conv, mod.modulator_conv):
            conv.weight.normal_(0, 0.1)
    x = torch.randn(2, 8, 6, 7, requires_grad=True)
    mod(x).square().sum().backward()
    for name, p in mod.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    assert x.grad.abs().max() > 0


def _scatter_inputs(seed, b=2, r=100, c=8, h=7, w=9):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.randint(0, h + 1, (b, r)),
                    rng.randint(0, w + 1, (b, r))], axis=-1).astype(np.int32)
    cw = rng.rand(b, r, 4).astype(np.float32)
    dcols = rng.randn(b, r, c).astype(np.float32)
    return idx, cw, dcols, h, w


def _conv_scatter_inputs(seed, spread, stride, b=2, c=8, h=13, w=11):
    """The rows a DCN backward hands the scatter: pixel-major, tap-minor,
    with offsets of +-``spread`` px. Under a pixel the rows of neighbouring
    pixels cluster on a few dx pixels (the kernel's window path); at 8 px
    they spread over the map and past its edges."""
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = rng.uniform(-spread, spread, (b, ho, wo, 18)).astype(np.float32)
    mask = rng.uniform(0.0, 2.0, (b, ho, wo, 9)).astype(np.float32)
    idx, cw = dcn.scatter_inputs(torch.from_numpy(off),
                                 torch.from_numpy(mask), h, w, stride=stride)
    dcols = rng.randn(b, idx.shape[1], c).astype(np.float32)
    return idx.numpy(), cw.numpy(), dcols, h, w


# (oracle, corners): the first two keep their earlier ids.
SCATTER_CASES = [(o, corners) for corners in ("random", "clustered_s1",
                                              "clustered_s2", "spread")
                 for o in ("pallas_interpret", "xla")]


@pytest.mark.parametrize(
    "oracle,corners", SCATTER_CASES,
    ids=[o if corners == "random" else f"{o}-{corners}"
         for o, corners in SCATTER_CASES])
def test_scatter_plain_matches_jax(oracle, corners):
    """Random corners across the whole padded map, margins included, with
    non-zero weights there (what lands in the margin is dropped); and the
    rows of a DCN backward with corners clustered (offsets under a pixel,
    stride 1 and 2) and spread (+-8 px)."""
    if corners == "random":
        idx, cw, dcols, h, w = _scatter_inputs(seed=5)
    elif corners == "spread":
        idx, cw, dcols, h, w = _conv_scatter_inputs(7, 8.0, 1)
    else:
        idx, cw, dcols, h, w = _conv_scatter_inputs(6, 0.5,
                                                    int(corners[-1]))
    args = (jnp.asarray(idx), jnp.asarray(cw), jnp.asarray(dcols), h, w)
    if oracle == "xla":
        want = np.asarray(dcn_input_grad_xla(*args))
    else:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(dcn_input_grad_pallas(*args))
    got = dcn_input_grad_plain(torch.from_numpy(idx), torch.from_numpy(cw),
                               torch.from_numpy(dcols), h, w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scatter_cpu_dispatch_and_checks():
    """A CPU tensor takes the plain version and launches nothing; wrong
    shapes and devices raise."""
    idx, cw, dcols, h, w = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in _scatter_inputs(seed=6))
    before = dcn_input_grad.launches
    got = dcn_input_grad(idx, cw, dcols, h, w)
    assert dcn_input_grad.launches == before
    torch.testing.assert_close(got, dcn_input_grad_plain(idx, cw, dcols, h, w))
    with pytest.raises(ValueError):
        dcn_input_grad(idx[:, :-1], cw, dcols, h, w)
    with pytest.raises(ValueError):
        dcn_input_grad(idx.to("meta"), cw.to("meta"), dcols.to("meta"), h, w)
