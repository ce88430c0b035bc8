"""The port's deformable convolution against the JAX package on the CPU.

On a CPU tensor ``deform_im2col`` takes the plain PyTorch version, which is
what these tests hold against ``planerecnet_tpu.ops.dcn.deform_conv2d``; the
CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``. Tolerance 1e-5: the corner sums and the matmul are
reduced in different orders by XLA and by PyTorch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu.models.backbone import DeformableConv2d as JaxDCN
from planerecnet_tpu.ops.dcn import deform_conv2d as jax_deform_conv2d
from planerecnet_tpu_torch.models.backbone import DeformableConv2d
from planerecnet_tpu_torch.ops import dcn

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(offsets, stride, seed=0, b=2, h=9, w=11, cin=8, cout=6, ks=3):
    rng = np.random.RandomState(seed)
    ho = (h + 2 - ks) // stride + 1
    wo = (w + 2 - ks) // stride + 1
    k = ks * ks
    x = rng.randn(b, h, w, cin).astype(np.float32)
    if offsets == "integer":
        off = rng.randint(-2, 3, (b, ho, wo, 2 * k)).astype(np.float32)
    elif offsets == "fractional":
        off = rng.uniform(-1.5, 1.5, (b, ho, wo, 2 * k)).astype(np.float32)
    else:  # many samples, and some whole 2x2 patches, out of bounds
        off = rng.uniform(-8.0, 8.0, (b, ho, wo, 2 * k)).astype(np.float32)
    mask = rng.uniform(0.0, 2.0, (b, ho, wo, k)).astype(np.float32)
    weight = rng.randn(ks, ks, cin, cout).astype(np.float32) * 0.2
    bias = rng.randn(cout).astype(np.float32)
    return x, off, mask, weight, bias


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("offsets", ["integer", "fractional",
                                     "out_of_bounds"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_deform_conv2d_matches_jax(stride, offsets, with_bias):
    x, off, mask, weight, bias = _inputs(offsets, stride)
    bias = bias if with_bias else None
    want = np.asarray(jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
        jnp.asarray(weight), None if bias is None else jnp.asarray(bias),
        stride=stride, padding=1, kernel_size=3))
    got = dcn.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
        torch.from_numpy(weight),
        None if bias is None else torch.from_numpy(bias),
        stride=stride, padding=1, kernel_size=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_im2col_layout_and_cpu_dispatch():
    """cols[b, p, k*Cin + c] is tap k of output pixel p; zero offsets at
    stride 1 sample the zero-padded input on the integer grid. A CPU tensor
    takes the plain version and launches nothing."""
    b, h, w, cin = 1, 4, 5, 3
    x = torch.arange(b * h * w * cin, dtype=torch.float32).reshape(
        b, h, w, cin)
    off = torch.zeros(b, h, w, 18)
    mask = torch.ones(b, h, w, 9)
    before = dcn.deform_im2col.launches
    cols = dcn.deform_im2col(x, off, mask, stride=1, padding=1,
                             kernel_size=3)
    assert dcn.deform_im2col.launches == before
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for oy in range(h):
        for ox in range(w):
            for k in range(9):
                ky, kx = divmod(k, 3)
                torch.testing.assert_close(
                    cols[0, oy * w + ox, k * cin:(k + 1) * cin],
                    xp[0, oy + ky, ox + kx], rtol=0, atol=0)


def test_im2col_rejects_bad_shapes():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        dcn.deform_im2col(x, torch.zeros(1, 4, 4, 17), torch.zeros(1, 4, 4, 9))
    with pytest.raises(ValueError):
        dcn.deform_im2col(x, torch.zeros(1, 4, 4, 18), torch.zeros(1, 4, 3, 9))
    with pytest.raises(ValueError):
        dcn.deform_im2col(x.to("meta"), torch.zeros(1, 4, 4, 18),
                          torch.zeros(1, 4, 4, 9))


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel).transpose(3, 2, 0, 1)))


def _port_dcn_from_jax(params, cin, cout, stride):
    port = DeformableConv2d(cin, cout, 3, stride=stride, padding=1)
    sd = {"regular_conv.weight": _oihw(params["regular_conv_kernel"]),
          "regular_conv.bias": torch.from_numpy(params["regular_conv_bias"])}
    for conv in ("offset_conv", "modulator_conv"):
        sd[f"{conv}.weight"] = _oihw(params[conv]["kernel"])
        sd[f"{conv}.bias"] = torch.from_numpy(params[conv]["bias"])
    port.load_state_dict(sd)
    return port


@pytest.mark.parametrize("stride", [1, 2])
def test_deformable_conv_module_matches_jax(stride):
    """The module with offsets large enough that the ±max(H, W)/4 clamp
    bites, and the 2*sigmoid modulator."""
    rng = np.random.RandomState(3)
    b, h, w, cin, cout = 2, 8, 8, 16, 8
    x = rng.randn(b, h, w, cin).astype(np.float32)
    mod = JaxDCN(cout, kernel_size=3, stride=stride, padding=1)
    params = jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for conv in ("offset_conv", "modulator_conv"):
        for leaf in ("kernel", "bias"):
            params[conv][leaf] = (rng.randn(*params[conv][leaf].shape)
                                  * 0.1).astype(np.float32)
    params["regular_conv_bias"] = rng.randn(cout).astype(np.float32)

    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    raw_off = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(params["offset_conv"]["kernel"]),
        (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert np.abs(raw_off).max() > max(h, w) / 4.0, "clamp not exercised"

    port = _port_dcn_from_jax(params, cin, cout, stride)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
