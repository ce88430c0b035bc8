"""The port's model against the JAX package's on the CPU.

JAX variables are made with numpy from a seed for the shapes of the JAX
model (``seeded_variables``: the DCN offset/modulator convs get N(0, 0.1)
weights, BatchNorm running means N(0, 0.5) and variances U(0.5, 2.0), or
the DCN would sample on the integer grid and BN would be the identity) and
carried into the port with ``from_jax_variables``. Then the same input goes
through both.

Tolerance 1e-4: flax's GroupNorm takes the variance in one pass
(E[x^2] - E[x]^2), torch's in two, and the difference grows through the
heads' towers; convolutions also sum in other orders.

The kernels are N(0, 1/fan_in), not the JAX init's: with its he-uniform
DCN kernels and the perturbed offset convs, PRN-50's float32 forward is so
ill-conditioned that JAX and the port each land ~1e-4 of scale from a
float64 evaluation at C4/C5, and no float32 tolerance separates a port
fault from rounding.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu import config as jconfig
from planerecnet_tpu.models import backbone as jbackbone
from planerecnet_tpu.models.planerecnet import PlaneRecNet as JaxPlaneRecNet
from planerecnet_tpu_torch import config as tconfig
from planerecnet_tpu_torch.models import backbone as tbackbone
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.utils.weights import (flatten_variables,
                                                 from_jax_variables)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-4)
PRESETS = ["PlaneRecNet_tiny_config", "PlaneRecNet_50_config",
           "PlaneRecNet_101_config", "PlaneRecNet_base_config"]


def port_cfg(jcfg, tcls=tconfig.PlaneRecNetConfig):
    """The port's config with the values of a JAX config (the fields both
    have; the port's own fields, which the JAX package lacks, at their
    defaults, which reproduce its behaviour)."""
    kw = {}
    for f in dataclasses.fields(tcls):
        if not hasattr(jcfg, f.name):
            continue
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = port_cfg(v, type(getattr(tcls(), f.name)))
        kw[f.name] = v
    return tcls(**kw)


def seeded_variables(shapes, seed=0):
    """Numpy values for every JAX leaf: conv kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), biases N(0, 0.1), and, as
    ``tests/reference_torch.py:153-165`` perturbs them, the DCN
    offset/modulator convs N(0, 0.1) (zero at init: the DCN would sample
    the integer grid), BatchNorm means N(0, 0.5) and variances U(0.5, 2)
    (0 and 1 at init: BN would be the identity)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        leaf = key.rsplit("/", 1)[-1]
        if "/offset_conv/" in key or "/modulator_conv/" in key:
            v = rng.randn(*shape) * 0.1
        elif key.startswith("batch_stats/"):
            v = (rng.randn(*shape) * 0.5 if leaf == "mean"
                 else 0.5 + rng.rand(*shape) * 1.5)
        elif leaf in ("kernel", "regular_conv_kernel"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) * 0.1
        out[key] = np.asarray(v, np.float32)
    return out


def variable_shapes(jcfg, size=64):
    """Flat "/"-keyed leaf shapes of ``jcfg``'s JAX model, without an
    init (``jax.eval_shape``)."""
    model = JaxPlaneRecNet(jcfg)
    tree = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))
    return {key: tuple(v.shape) for key, v in flatten_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               tree)).items()}


def nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@functools.lru_cache(maxsize=None)
def jax_variables(jcfg, seed=0):
    """Seeded JAX variables (flat, numpy) of ``jcfg``'s model."""
    return seeded_variables(variable_shapes(jcfg), seed)


@functools.lru_cache(maxsize=None)
def jax_forward(name, seed=1, size=64):
    """One JAX apply at size^2 of preset ``name``: (input, backbone C2..C5,
    raw-pred dict), numpy."""
    jcfg = jconfig.get_cfg(name).copy(dict(max_size=size))
    x = images(size=size, seed=seed)
    preds, state = JaxPlaneRecNet(jcfg).apply(
        nest(jax_variables(jcfg)), jnp.asarray(x), train=False,
        capture_intermediates=lambda mdl, method: (mdl.name == "backbone"
                                                   and method == "__call__"),
        mutable=["intermediates"])
    feats = state["intermediates"]["backbone"]["__call__"][0]
    return (x, [np.asarray(f) for f in feats],
            jax.tree_util.tree_map(np.asarray, preds))


def port_model(jcfg, flat):
    model = PlaneRecNet(port_cfg(jcfg))
    model.load_state_dict(from_jax_variables(flat, model))
    return model.eval()


def images(b=2, size=64, seed=0):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("name", PRESETS)
def test_config_presets_match_jax(name):
    assert tconfig.get_cfg(name) == port_cfg(jconfig.get_cfg(name))


@pytest.mark.parametrize("name", PRESETS)
def test_stage_plan_matches_jax(name):
    bb = jconfig.get_cfg(name).backbone
    args = (bb.layers, bb.dcn_layers, bb.dcn_interval, bb.atrous_layers)
    assert tbackbone._stage_plan(*args) == jbackbone._stage_plan(*args)


def test_dcn_layer_counts():
    def count(name):
        model = PlaneRecNet(tconfig.get_cfg(name))
        return sum(isinstance(m, tbackbone.DeformableConv2d)
                   for m in model.modules())
    assert count("PlaneRecNet_50_config") == 13
    assert count("PlaneRecNet_101_config") == 11


@pytest.mark.parametrize("name", PRESETS)
def test_from_jax_variables_is_complete(name):
    """Every JAX leaf lands on one port parameter or buffer of the same
    shape, and every port parameter and buffer is filled."""
    jcfg = jconfig.get_cfg(name)
    flat = {key: np.zeros(shape, np.float32)
            for key, shape in variable_shapes(jcfg).items()}
    port = PlaneRecNet(port_cfg(jcfg))
    sd = from_jax_variables(flat, port)
    assert set(sd) == set(port.state_dict())
    n_port = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert n_port == len(flat)


def test_from_jax_variables_raises_on_mismatch():
    jcfg = jconfig.PlaneRecNet_tiny_config
    flat = jax_variables(jcfg)
    port = PlaneRecNet(port_cfg(jcfg))
    with pytest.raises(KeyError, match="no port key"):
        from_jax_variables({**flat, "params/backbone/extra/kernel":
                            np.zeros((1,))}, port)
    missing = dict(flat)
    missing.pop("batch_stats/backbone/bn1/var")
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_variables(missing, port)
    bad = dict(flat)
    bad["params/backbone/bn1/scale"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_variables(bad, port)


@pytest.mark.parametrize("name", ["PlaneRecNet_tiny_config",
                                  "PlaneRecNet_50_config"])
def test_backbone_matches_jax(name):
    """C2..C5, taken from the same JAX apply as the raw predictions."""
    jcfg = jconfig.get_cfg(name).copy(dict(max_size=64))
    x, want, _ = jax_forward(name)
    port = port_model(jcfg, jax_variables(jcfg))
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   err_msg=f"C{i + 2}", **TOL)


@pytest.mark.parametrize("name,size", [
    pytest.param("PlaneRecNet_tiny_config", 64, id="PlaneRecNet_tiny_config"),
    pytest.param("PlaneRecNet_50_config", 64, id="PlaneRecNet_50_config"),
    # C5 is 1x1 at 32^2: the depth decoder's reflection pad repeats its one
    # row and column, and a GroupNorm of one value gives its bias.
    pytest.param("PlaneRecNet_tiny_config", 32,
                 id="PlaneRecNet_tiny_config-32x32")])
def test_raw_preds_match_jax(name, size):
    jcfg = jconfig.get_cfg(name).copy(dict(max_size=size))
    x, _, want = jax_forward(name, size=size)
    port = port_model(jcfg, jax_variables(jcfg))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in ("cate_preds", "kernel_preds"):
        assert len(got[key]) == len(want[key]) == 4
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"{key}[{i}]",
                                       **TOL)
    for key in ("mask_pred", "depth_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key,
                                   **TOL)


def test_dcn_instance_towers_match_jax():
    """``use_dcn_in_instance`` (off in every preset): the instance towers
    are DeformableConv2d blocks without bias, in both packages."""
    base = jconfig.PlaneRecNet_tiny_config
    jcfg = base.copy(dict(max_size=64, solov2=base.solov2.copy(dict(
        use_dcn_in_instance=True))))
    flat = jax_variables(jcfg)
    assert any("/kernel_tower0_conv/offset_conv/" in k for k in flat)
    x = images(seed=2)
    want = JaxPlaneRecNet(jcfg).apply(nest(flat), jnp.asarray(x),
                                      train=False)
    with torch.no_grad():
        got = port_model(jcfg, flat)(torch.from_numpy(x))
    for key in ("cate_preds", "kernel_preds"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{key}[{i}]", **TOL)
