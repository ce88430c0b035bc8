"""The port's post-processing and runner against the JAX package on the CPU,
and the port's isolation from JAX.

Post-processing gets the SAME raw predictions in both packages. Slots,
classes and the overflow flag must be equal; scores, boxes and depth
within 1e-5; a binary mask may differ only at pixels whose soft value lies
within 1e-5 of ``mask_thr`` (the two packages round the mask logits
differently in the last bit).

End to end, the two runners share seeded variables (see
``test_torch_port_model``); there the raw predictions already differ by up
to 1e-4, so scores and depth are held to 1e-4 and the mask band is 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu.config import PlaneRecNet_50_config
from planerecnet_tpu.ops.image import fast_base_transform
from planerecnet_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from planerecnet_tpu.ops.postprocess import (
    flatten_level_preds as jax_flatten_level_preds,
    postprocess_batch as jax_postprocess_batch)
from planerecnet_tpu.runner import PlaneRecNetRunner as JaxRunner
from planerecnet_tpu_torch.ops.image import (
    fast_base_transform as port_fast_base_transform)
from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from test_torch_port_model import jax_variables, nest, port_cfg

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


def _tiny_cfg(**solov2):
    """PlaneRecNet-50 cut to a 64x64 smoke size (as ``test_cli`` does)."""
    cfg = PlaneRecNet_50_config
    return cfg.copy(dict(
        max_size=SIZE, max_instances=4, max_positives=16, vnl_samples=32,
        solov2=cfg.solov2.copy(dict(num_grids=(10, 9, 6, 4),
                                    max_candidates=32, nms_pre=32, top_k=8,
                                    **solov2))))


def _raw_preds(cfg, b, seed, cate_shift):
    """Random raw predictions in the model's layouts for a SIZE^2 input."""
    rng = np.random.RandomState(seed)
    sv = cfg.solov2
    k = sv.num_kernels
    return {
        "cate_preds": [(rng.randn(b, s, s, cfg.num_classes) * 2 + cate_shift
                        ).astype(np.float32) for s in sv.num_grids],
        "kernel_preds": [(rng.randn(b, s, s, k) * 3 / np.sqrt(k)
                          ).astype(np.float32) for s in sv.num_grids],
        "mask_pred": rng.randn(b, SIZE // 4, SIZE // 4, k).astype(np.float32),
        "depth_pred": rng.uniform(0.5, 5.0, (b, SIZE // 2, SIZE // 2, 1)
                                  ).astype(np.float32),
    }


def _soft_masks(cfg, raw):
    """(B, N_cells, H, W): every grid cell's soft mask at the output size,
    computed by the JAX package's ops."""
    _, kernels = jax_flatten_level_preds(
        [jnp.asarray(c) for c in raw["cate_preds"]],
        [jnp.asarray(k) for k in raw["kernel_preds"]],
        cfg.num_classes, cfg.solov2.num_kernels)
    feat = jnp.asarray(raw["mask_pred"])
    b, hm, wm, k = feat.shape
    logits = jnp.einsum("bnk,bpk->bnp", kernels, feat.reshape(b, -1, k))
    soft = 1.0 / (1.0 + jnp.exp(-logits))
    n = soft.shape[1]
    soft = jax_resize_bilinear(
        soft.reshape(b * n, hm, wm, 1), (SIZE, SIZE))
    return np.asarray(soft).reshape(b, n, SIZE, SIZE)


def _normalise(frames):
    return np.asarray(fast_base_transform(jnp.asarray(frames)))


def _compare(got, want, cfg, soft, tol):
    got = {key: v.numpy() for key, v in got.items()}
    want = {key: np.asarray(v) for key, v in want.items()}
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    np.testing.assert_array_equal(got["pred_valid"], want["pred_valid"])
    np.testing.assert_array_equal(got["candidates_clipped"],
                                  want["candidates_clipped"])
    valid = want["pred_valid"]
    # pred_classes is not masked by pred_valid: compare valid slots only.
    np.testing.assert_array_equal(got["pred_classes"][valid],
                                  want["pred_classes"][valid])
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got["pred_depth"], want["pred_depth"],
                               rtol=tol, atol=tol)
    thr = cfg.solov2.mask_thr
    for b, i in zip(*np.nonzero(valid)):
        w_mask = want["pred_masks"][b, i]
        # The grid cell whose soft mask binarises to this slot's mask.
        cell = np.argmin(((soft[b] > thr) != w_mask).sum(axis=(1, 2)))
        band = np.abs(soft[b, cell] - thr) < tol
        assert not np.any(((soft[b, cell] > thr) != w_mask) & ~band)
        diff = got["pred_masks"][b, i] != w_mask
        assert not np.any(diff & ~band), (b, i, int(diff.sum()))
        if not diff.any():
            np.testing.assert_array_equal(got["pred_boxes"][b, i],
                                          want["pred_boxes"][b, i])
    np.testing.assert_array_equal(got["pred_masks"][~valid], False)
    np.testing.assert_array_equal(got["pred_boxes"][~valid], 0.0)


@pytest.mark.parametrize("case,cate_shift,clipped", [
    ("sparse", -6.0, False),   # fewer candidates than the capacity
    ("dense", 0.0, True),      # overflow: candidates_clipped is set
])
def test_postprocess_matches_jax(case, cate_shift, clipped):
    cfg = _tiny_cfg()
    raw = _raw_preds(cfg, b=2, seed=len(case), cate_shift=cate_shift)
    want = jax_postprocess_batch(
        {key: ([jnp.asarray(a) for a in v] if isinstance(v, list)
               else jnp.asarray(v)) for key, v in raw.items()},
        cfg, (SIZE, SIZE))
    got = postprocess_batch(
        {key: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
               else torch.from_numpy(v)) for key, v in raw.items()},
        port_cfg(cfg), (SIZE, SIZE))
    assert bool(np.asarray(want["candidates_clipped"]).all()) == clipped
    assert np.asarray(want["pred_valid"]).any(axis=1).all()
    _compare(got, want, cfg, _soft_masks(cfg, raw), tol=1e-5)


def test_infer_matches_jax_runner():
    """Raw BGR frames through both runners with the same seeded
    variables (``test_torch_port_model.seeded_variables``)."""
    cfg = _tiny_cfg()
    flat = jax_variables(cfg)
    frames = np.random.RandomState(5).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    jax_runner = JaxRunner(cfg, variables=nest(flat))
    want = jax_runner.infer(frames)
    port = PlaneRecNetRunner(port_cfg(cfg), variables=flat, device="cpu")
    got = port.infer(frames)
    assert np.asarray(want["pred_valid"]).sum() >= 1
    raw = jax_runner.forward_raw(jnp.asarray(_normalise(frames)))
    _compare(got, want, cfg, _soft_masks(cfg, raw), tol=1e-4)


def test_runner_forward_raw_and_normalized_agree():
    """``infer`` is ``fast_base_transform`` + ``infer_normalized``, and
    ``forward_raw`` returns the JAX layouts."""
    cfg = port_cfg(_tiny_cfg(score_thr=0.003, update_thr=0.003))
    port = PlaneRecNetRunner(cfg, seed=1, device="cpu")
    frames = np.random.RandomState(6).uniform(
        0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    normalised = port_fast_base_transform(torch.from_numpy(frames))
    a = port.infer(frames)
    b = port.infer_normalized(normalised)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())
    raw = port.forward_raw(normalised)
    sv = cfg.solov2
    assert [tuple(t.shape) for t in raw["cate_preds"]] == [
        (1, s, s, cfg.num_classes) for s in sv.num_grids]
    assert tuple(raw["mask_pred"].shape) == (1, SIZE // 4, SIZE // 4,
                                             sv.num_masks)
    assert tuple(raw["depth_pred"].shape) == (1, SIZE // 2, SIZE // 2, 1)


def test_load_weights_keeps_model_collections(tmp_path):
    """``load_weights`` reads the JAX package's flat ``.npz``; of a train
    state it keeps ``params`` and ``batch_stats`` only."""
    cfg = _tiny_cfg()
    flat = jax_variables(cfg)
    path = str(tmp_path / "state.npz")
    np.savez(path, **flat, **{"opt_state/0/mu": np.zeros(3, np.float32),
                              "step": np.asarray(7)})
    port = PlaneRecNetRunner(port_cfg(cfg), seed=3, device="cpu")
    port.load_weights(path)
    ref = PlaneRecNetRunner(port_cfg(cfg), variables=flat, device="cpu")
    for key, value in ref.model.state_dict().items():
        torch.testing.assert_close(port.model.state_dict()[key], value,
                                   rtol=0, atol=0)


def test_default_device_is_cuda():
    """No device asked for: the runner takes the card, or raises where
    there is none; it never carries on quietly on the CPU."""
    cfg = port_cfg(_tiny_cfg())
    if torch.cuda.is_available():
        assert PlaneRecNetRunner(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PlaneRecNetRunner(cfg)


def test_port_imports_nothing_of_jax():
    """Import the port and every one of its modules in a fresh interpreter
    (this one has JAX loaded by the test configuration)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import planerecnet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'planerecnet_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=False)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
