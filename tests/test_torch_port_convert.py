"""The port's ``.pth`` converter (``planerecnet_tpu_torch/utils/torch_convert.py``)
against the JAX package's (``planerecnet_tpu/utils/torch_convert.py``).

No released checkpoint is in the repository, so the upstream-layout state
dicts are synthetic, built from the JAX converter's key map as
``tests/test_checkpoint.py`` builds them. The JAX route (``convert_state_dict``
then ``utils/weights.py::from_jax_variables``) and the port's converter
must give exactly equal tensors; the runners on the same ``.pth`` agree
within ``test_torch_port_runner``'s tolerances.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from planerecnet_tpu.runner import PlaneRecNetRunner as JaxRunner
from planerecnet_tpu.utils.torch_convert import (
    convert_backbone_imagenet as jax_convert_backbone_imagenet,
    convert_state_dict as jax_convert_state_dict, flax_path_to_torch_key)
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from planerecnet_tpu_torch.utils.torch_convert import (
    convert_backbone_imagenet, convert_state_dict, load_pth)
from planerecnet_tpu_torch.utils.weights import (flatten_variables,
                                                 from_jax_variables)
from test_torch_port_model import jax_variables, nest, port_cfg
from test_torch_port_runner import (SIZE, _compare, _normalise, _soft_masks,
                                    _tiny_cfg)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    """The JAX config and a variable tree of its model at the runner
    tests' size (seeded numpy leaves: the converters read only the tree's
    paths and shapes)."""
    cfg = _tiny_cfg()
    return cfg, nest(jax_variables(cfg))


def upstream_state_dict(variables, seed=0):
    """A reference-layout state dict covering every JAX leaf (conv OIHW),
    with the values of ``tests/test_checkpoint.py::_synthetic_torch_sd``'s
    recipe, and the BatchNorm counters the reference saves."""
    rng = np.random.RandomState(seed)
    sd = {}
    for coll, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            p = tuple(x.key for x in path)
            key = flax_path_to_torch_key(p)
            arr = np.asarray(leaf)
            shape = ((arr.shape[3], arr.shape[2], arr.shape[0], arr.shape[1])
                     if p[-1] in ("kernel", "regular_conv_kernel")
                     else arr.shape)
            w = rng.randn(*shape).astype(np.float32) * 0.05
            if key.endswith("running_var"):
                w = np.abs(w) + 0.5
            sd[key] = w
            if key.endswith("running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    np.asarray(7, np.int64)
    return sd


def test_state_dict_matches_jax_route(tiny):
    cfg, variables = tiny
    sd = upstream_state_dict(variables)
    model = PlaneRecNet(port_cfg(cfg))
    want = from_jax_variables(
        flatten_variables(jax_convert_state_dict(sd, variables)), model)
    got = convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                             model)
    assert set(got) == set(model.state_dict())
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        if key.endswith("num_batches_tracked"):
            # The JAX variables have no counter; the port keeps the
            # checkpoint's, as torch's load_state_dict does.
            assert int(got[key]) == 7, key
            continue
        assert torch.equal(got[key], value), key
    # The checkpoint's values landed (not the model's fresh ones).
    assert torch.equal(got["backbone.conv1.weight"],
                       torch.from_numpy(sd["backbone.conv1.weight"]))


@pytest.mark.parametrize("drop", ["backbone.conv1.weight",
                                  "depth_decoder.depth_pred.1.bias"])
def test_missing_key_raises(tiny, drop):
    cfg, variables = tiny
    sd = upstream_state_dict(variables)
    sd.pop(drop)
    model = PlaneRecNet(port_cfg(cfg))
    with pytest.raises(KeyError):
        jax_convert_state_dict(sd, variables)
    with pytest.raises(KeyError):
        convert_state_dict(sd, model)


def test_unused_key_raises(tiny):
    cfg, variables = tiny
    sd = upstream_state_dict(variables)
    sd["fpn.extra_conv.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError):
        convert_state_dict(sd, PlaneRecNet(port_cfg(cfg)))


def test_wrong_shape_raises(tiny):
    cfg, variables = tiny
    sd = upstream_state_dict(variables)
    sd["backbone.conv1.weight"] = sd["backbone.conv1.weight"][:, :2]
    with pytest.raises(ValueError):
        convert_state_dict(sd, PlaneRecNet(port_cfg(cfg)))


def imagenet_state_dict(sd):
    """A torchvision ImageNet ResNet's layout: the backbone's keys with
    ``layers.{i}`` as ``layer{i+1}``, and the classifier."""
    out = {}
    for key, value in sd.items():
        if not key.startswith("backbone."):
            continue
        key = key[len("backbone."):]
        m = re.match(r"layers\.(\d)\.(.*)", key)
        if m:
            key = f"layer{int(m.group(1)) + 1}.{m.group(2)}"
        out[key] = value
    out["fc.weight"] = np.ones((1000, 2048), np.float32)
    out["fc.bias"] = np.zeros((1000,), np.float32)
    return out


def test_imagenet_remap_matches_jax(tiny):
    cfg, variables = tiny
    inet = imagenet_state_dict(upstream_state_dict(variables, seed=1))
    # A DCN block's conv2 in torchvision's layout: no such key here.
    inet["layer2.0.conv2.weight"] = np.ones((128, 128, 3, 3), np.float32)
    model = PlaneRecNet(port_cfg(cfg))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    got = convert_backbone_imagenet(inet, model)
    jax_flat = flatten_variables(
        jax_convert_backbone_imagenet(inet, variables))
    want = from_jax_variables(jax_flat, model)
    remapped = 0
    for key in fresh:
        src = re.sub(r"^backbone\.layers\.(\d)\.",
                     lambda m: f"layer{int(m.group(1)) + 1}.", key)
        src = re.sub(r"^backbone\.", "", src)
        if key.startswith("backbone.") and src in inet:
            # Both converters took it from the checkpoint (the JAX
            # variables have no BatchNorm counter to take).
            assert torch.equal(got[key], torch.from_numpy(inet[src])), key
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(got[key], want[key]), key
            remapped += 1
        else:
            # Both keep their model's fresh value.
            assert torch.equal(got[key], fresh[key]), key
    assert remapped > 50


def test_runner_loads_pth_like_jax(tiny, tmp_path):
    cfg, variables = tiny
    sd = upstream_state_dict(variables, seed=2)
    path = str(tmp_path / "upstream.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    assert set(load_pth(path)) == set(sd)
    frames = np.random.RandomState(5).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    jax_runner = JaxRunner(cfg)
    jax_runner.load_weights(path)
    want = jax_runner.infer(frames)
    port = PlaneRecNetRunner(port_cfg(cfg), device="cpu")
    port.load_weights(path)
    got = port.infer(frames)
    raw = jax_runner.forward_raw(jax.numpy.asarray(_normalise(frames)))
    _compare(got, want, cfg, _soft_masks(cfg, raw), tol=1e-4)


def test_runner_save_weights_round_trip(tiny, tmp_path):
    cfg, variables = tiny
    a = PlaneRecNetRunner(port_cfg(cfg), seed=4, device="cpu")
    path = a.save_weights(str(tmp_path / "w"))
    assert path.endswith(".npz") and os.path.exists(path)
    b = PlaneRecNetRunner(port_cfg(cfg), seed=5, device="cpu")
    b.load_weights(path)
    for key, value in a.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(b.model.state_dict()[key], value), key
    # And the JAX runner reads the port's file.
    JaxRunner(cfg).load_weights(path)


def test_train_cli_starts_from_backbone_pth(tmp_path, monkeypatch):
    """The train CLI takes a torchvision ImageNet ``.pth`` from
    ``--backbone_folder``: with lr 0 and no warm-up (and frozen BatchNorm
    at batch 2) its checkpoint holds the ``.pth``'s backbone."""
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.tools import synth_scenes
    from planerecnet_tpu_torch.utils.weights import load_npz, to_jax_variables

    synth_scenes.generate_dataset(str(tmp_path), 2, 0, 0, h=64, w=64,
                                  progress=False)
    cfg = set_cfg("PlaneRecNet_tiny_config")
    model = PlaneRecNet(cfg)
    inet = imagenet_state_dict({k: v.numpy() * 0 + 0.01 * (i % 7 + 1)
                                for i, (k, v) in enumerate(
                                    model.state_dict().items())
                                if v.is_floating_point()})
    folder = tmp_path / "backbones"
    folder.mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in inet.items()},
               str(folder / cfg.backbone.path))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main([
        "--config", "PlaneRecNet_tiny_config", "--device", "cpu",
        "--batch_size", "2", "--no_autoscale", "--no_tensorboard",
        "--lr", "0", "--validation_epoch", "0",
        "--backbone_folder", str(folder), "--save_folder", "weights/",
        "--cfg_overrides",
        '{"max_size": 64, "max_iter": 1, "lr_warmup_until": 0}'])
    saved = from_jax_variables(load_npz(out["checkpoint"]), model)
    want = convert_backbone_imagenet(inet, model)
    checked = 0
    for key, value in want.items():
        if key.startswith("backbone.") and "conv2.weight" not in key \
                and value.is_floating_point():
            assert torch.equal(saved[key], value), key
            checked += 1
    assert checked > 20
    assert to_jax_variables(saved)  # a complete, loadable state
