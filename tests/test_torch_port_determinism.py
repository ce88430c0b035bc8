"""``--reproductablity`` in the port: the switches, the reflect pad whose
backward is deterministic, and runs that repeat bit for bit on the CPU.

On the card the flag also sends the DCN scatter and the dice/lava loss to
their kernels' fixed-order variants; ``chip_smoke.py`` holds those against
their plain versions and requires two launches, and two train-CLI runs,
to be bit-identical. Here every kernel runs its plain version, which is
deterministic: a step with ``deterministic=True`` must equal the default
step exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from planerecnet_tpu_torch import train as train_cli
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config
from planerecnet_tpu_torch.models.layers import ReflectConvBNReLU
from planerecnet_tpu_torch.ops.image import ReflectPad2d, reflect_pad
from planerecnet_tpu_torch.tools import synth_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 2, 2), (1, 1, 3, 3),
                                   (2, 4, 16, 9), (1, 8, 40, 40)])
def test_reflect_pad_equals_f_pad_exactly(shape, channels_last):
    """Values, gradients and, for a channels-last input, the layout of
    both (the convolutions beside the pad round by layout)."""
    rng = np.random.RandomState(sum(shape))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(
        memory_format=fmt)
    g = torch.from_numpy(rng.randn(shape[0], shape[1], shape[2] + 2,
                                   shape[3] + 2).astype(np.float32))
    a = x.clone(memory_format=torch.preserve_format).requires_grad_()
    b = x.clone(memory_format=torch.preserve_format).requires_grad_()
    ya, yb = reflect_pad(a), F.pad(b, (1, 1, 1, 1), mode="reflect")
    np.testing.assert_array_equal(bits(ya), bits(yb))
    assert ya.stride() == yb.stride()
    ya.backward(g)
    yb.backward(g)
    np.testing.assert_array_equal(bits(a.grad), bits(b.grad))
    assert a.grad.stride() == b.grad.stride()


@pytest.mark.parametrize("pad", [2, 3])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 4, 4), (1, 4, 9, 12)])
def test_reflect_pad_wider_equals_f_pad_exactly(shape, pad):
    """Wider pads: more outputs copy each pixel near the border, and on
    small maps the strips beside the two borders meet."""
    rng = np.random.RandomState(pad + sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rng.randn(shape[0], shape[1], shape[2] + 2 * pad,
                                   shape[3] + 2 * pad).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = reflect_pad(a, pad), F.pad(b, (pad,) * 4, mode="reflect")
    np.testing.assert_array_equal(bits(ya), bits(yb))
    ya.backward(g)
    yb.backward(g)
    np.testing.assert_array_equal(bits(a.grad), bits(b.grad))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 8, 40, 40),
                                   # an axis of one, which F.pad refuses
                                   (2, 3, 1, 1), (1, 2, 1, 6), (1, 2, 5, 1)])
def test_reflect_pad_matches_jnp_pad(shape):
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[0], shape[1], shape[2] + 2,
                  shape[3] + 2).astype(np.float32)
    pad = ((0, 0), (0, 0), (1, 1), (1, 1))
    want, vjp = jax.vjp(lambda v: jnp.pad(v, pad, mode="reflect"),
                        jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    got = reflect_pad(t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(g))
    # A border pixel adds up to four gradients; the two sum them in their
    # own orders, so f32 rounding of those sums.
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def test_reflect_pad_keeps_state_dict_keys():
    block = ReflectConvBNReLU(4, 8, upsample=True)
    assert isinstance(block[1], ReflectPad2d)
    assert sorted(block.state_dict()) == sorted(
        ["2.weight", "2.bias", "3.weight", "3.bias", "3.running_mean",
         "3.running_var", "3.num_batches_tracked"])


PROBE = r"""
import json, os, sys, torch
sys.path.insert(0, sys.argv[1])
from planerecnet_tpu_torch import train, trainer
from planerecnet_tpu_torch.tools import synth_scenes


class Stop(Exception):
    pass


def switches():
    return {"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "warn_only": torch.is_deterministic_algorithms_warn_only_enabled()}


seen = {}


def probe(*args, **kwargs):
    seen.update(switches(), deterministic=kwargs.get("deterministic"))
    raise Stop


trainer.create_train_state = probe
synth_scenes.generate_dataset(sys.argv[2], 2, 0, 0, h=64, w=64, progress=False)
os.chdir(sys.argv[2])
out = {}
for flag in (True, False):
    seen.clear()
    try:
        train.main(["--config", "PlaneRecNet_tiny_config", "--device", "cpu",
                    "--batch_size", "2", "--no_tensorboard",
                    "--cfg_overrides", '{"max_size": 64, "max_iter": 1}']
                   + (["--reproductablity"] if flag else []))
    except Stop:
        pass
    out[str(flag)] = {"during": dict(seen), "after": switches()}
print(json.dumps(out))
"""


def test_reproductablity_sets_the_switches(tmp_path):
    """In a fresh interpreter, so that the process-wide mode cannot leak
    into other tests: the four switches are set when the train state is
    made (before any CUDA call), the state is asked for the deterministic
    kernels, and every switch is put back when the CLI returns."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUBLAS_WORKSPACE_CONFIG")}
    out = subprocess.run([sys.executable, "-c", PROBE, REPO, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["True"]["during"] == {
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "cudnn.deterministic": True,
        "cudnn.benchmark": False, "deterministic_algorithms": True,
        "warn_only": False, "deterministic": True}
    default = {"CUBLAS_WORKSPACE_CONFIG": None, "cudnn.deterministic": False,
               "cudnn.benchmark": False, "deterministic_algorithms": False,
               "warn_only": False}
    assert got["False"]["during"] == dict(default, deterministic=False)
    assert got["True"]["after"] == default
    assert got["False"]["after"] == default


def test_deterministic_step_equals_default_step_on_cpu():
    cfg = PlaneRecNet_tiny_config.copy(dict(freeze_bn=True))
    batch = chip_smoke.synthetic_batch(2, 64, cfg.max_instances, seed=5)
    out = []
    for deterministic in (False, True):
        state = trainer.create_train_state(cfg, seed=7, device="cpu",
                                           deterministic=deterministic)
        chip_smoke.perturb_(state.model, seed=8, offset_std=0.1)
        losses = trainer.train_step(state, batch)
        out.append((losses, state.model.state_dict()))
    (la, sa), (lb, sb) = out
    assert set(la) == set(lb)
    for key in la:
        np.testing.assert_array_equal(bits(la[key]), bits(lb[key]))
    for key, value in sa.items():
        assert torch.equal(value, sb[key]), key


def test_two_reproducible_cli_runs_are_bit_identical(tmp_path, monkeypatch):
    synth_scenes.generate_dataset(str(tmp_path), 4, 0, 0, h=64, w=64,
                                  progress=False)
    monkeypatch.chdir(tmp_path)
    ckpts = []
    for run in ("a", "b"):
        res = train_cli.main([
            "--config", "PlaneRecNet_tiny_config", "--device", "cpu",
            "--batch_size", "2", "--no_autoscale", "--no_tensorboard",
            "--reproductablity", "--validation_epoch", "0",
            "--save_folder", f"weights_{run}/",
            "--cfg_overrides", '{"max_size": 64, "max_iter": 3}'])
        ckpts.append(res["checkpoint"])
    assert torch.are_deterministic_algorithms_enabled() is False
    with np.load(ckpts[0]) as a, np.load(ckpts[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("adam/") for k in a.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key


def test_model_gradients_equal_those_with_nn_reflection_pad():
    """The depth decoder with ``ReflectPad2d`` gives, on the CPU, the bits
    of the same model with ``nn.ReflectionPad2d`` (some pads take
    channels-last inputs there)."""
    import copy
    from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
    torch.manual_seed(0)
    ours = PlaneRecNet(PlaneRecNet_tiny_config.copy(dict(freeze_bn=True)))
    ref = copy.deepcopy(ours)
    swapped = 0
    for mod in ref.modules():
        if isinstance(mod, torch.nn.Sequential):
            for i, sub in enumerate(mod):
                if isinstance(sub, ReflectPad2d):
                    mod[i] = torch.nn.ReflectionPad2d(1)
                    swapped += 1
    assert swapped == 10   # the 9 blocks and depth_pred
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3)
                         .astype(np.float32))
    grads = []
    for model in (ours.train(), ref.train()):
        preds = model(x)
        ((preds["depth_pred"] ** 2).sum()
         + (preds["mask_pred"] ** 2).sum()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        np.testing.assert_array_equal(bits(g), bits(grads[1][name]),
                                      err_msg=name)
