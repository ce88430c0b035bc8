"""The port's image ops against ``planerecnet_tpu.ops.image`` on the CPU.

Same numpy inputs through both; the port's resize/pad ops are NCHW, the JAX
ones NHWC. Tolerance 1e-6: the two packages compute the bilinear weights in
different precisions (float64 rounded to f32 against f32).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu.ops import image as jimage
from planerecnet_tpu_torch.ops import image as timage

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _nhwc(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(fn, x_nhwc, *args):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    return fn(x, *args).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("src,dst", [
    ((60, 80), (36, 36)),     # the S x S grid resize at non-integer ratios
    ((60, 80), (40, 40)),
    ((30, 40), (24, 24)),
    ((15, 20), (16, 16)),     # upsampling, non-integer
    ((16, 16), (32, 32)),     # the mask head's 2x
    ((60, 80), (30, 40)),     # the p2 halving
    ((32, 32), (8, 8)),       # the depth decoder's x0.25
    ((10, 10), (64, 64)),     # post-processing's soft-mask resize
    ((17, 23), (17, 23)),     # identity
])
def test_resize_bilinear(src, dst):
    x = _nhwc((2, *src, 5))
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), dst))
    got = _port(timage.resize_bilinear, x, dst)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("src,dst", [
    ((60, 80), (36, 36)), ((15, 20), (30, 40)), ((7, 9), (5, 4)),
])
def test_resize_nearest(src, dst):
    x = _nhwc((2, *src, 3))
    want = np.asarray(jimage.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(_port(timage.resize_nearest, x, dst), want)


def test_upsample2x_nearest():
    x = _nhwc((2, 7, 5, 4))
    want = np.asarray(jimage.upsample2x_nearest(jnp.asarray(x)))
    np.testing.assert_array_equal(_port(timage.upsample2x_nearest, x), want)


@pytest.mark.parametrize("pad", [1, 2])
def test_reflect_pad(pad):
    x = _nhwc((2, 6, 5, 3))
    want = np.asarray(jimage.reflect_pad(jnp.asarray(x), pad))
    np.testing.assert_array_equal(_port(timage.reflect_pad, x, pad), want)


def test_fast_base_transform():
    x = np.random.RandomState(1).uniform(0, 255, (2, 9, 7, 3)).astype(
        np.float32)
    want = np.asarray(jimage.fast_base_transform(jnp.asarray(x)))
    got = timage.fast_base_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w", [(40, 40), (15, 20), (1, 3)])
def test_point_sample_grid(h, w):
    want = np.asarray(jimage.point_sample_grid(h, w))
    got = timage.point_sample_grid(h, w).numpy()
    np.testing.assert_allclose(got, want, **TOL)
