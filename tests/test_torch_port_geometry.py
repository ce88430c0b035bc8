"""The port's ``ops/geometry.py`` against ``planerecnet_tpu.ops.geometry``
on the CPU, the properties that ``tests/test_geometry.py`` checks of the
JAX functions, and the port's ``tools/check_dataset.py`` over a synthetic
ScanNet tree, whose first line is the JAX tool's.

Same numpy inputs through both packages. Tolerances: back-projection and
the point-to-plane error 1e-6 relative (one f32 product and sum each);
normals 1e-4 (a 3x3 solve per pixel in f32 by two LAPACK paths); the PCA
normal up to its sign, which each SVD chooses for itself.
"""

import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planerecnet_tpu.ops import geometry as jgeo
from planerecnet_tpu_torch.config import set_cfg
from planerecnet_tpu_torch.data import SSDAugmentation, build_dataset
from planerecnet_tpu_torch.ops import geometry as tgeo
from planerecnet_tpu_torch.tools import check_dataset, synth_scenes

torch.set_num_threads(2)
K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])


def _plane_depth(h, w, k, normal, d):
    """Depth map of the plane n . p = d under intrinsics k."""
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    rays = np.einsum("ij,jhw->ihw", np.linalg.inv(k),
                     np.stack([u, v, np.ones_like(u)]))
    return d / np.einsum("i,ihw->hw", normal, rays)


def _seeded(seed, b=2, h=12, w=20):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.5, 4.0, (b, h, w, 1)).astype(np.float32)
    k = np.stack([[[rng.uniform(20, 40), 0, w / 2], [0, rng.uniform(20, 40),
                                                      h / 2], [0, 0, 1]]
                  for _ in range(b)])
    return depth, np.linalg.inv(k).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_points_coordinate_matches_jax(seed):
    depth, k_inv = _seeded(seed)
    want = np.asarray(jgeo.get_points_coordinate(jnp.asarray(depth),
                                                 jnp.asarray(k_inv)))
    got = tgeo.get_points_coordinate(_t(depth), _t(k_inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_unfold_matches_jax(seed):
    x = np.random.RandomState(seed).randn(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo._unfold_5x5_dilated2(_t(x)).numpy(),
        np.asarray(jgeo._unfold_5x5_dilated2(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1])
def test_surface_normal_matches_jax(seed):
    """Random depths with a ragged valid region: singular and regular
    systems both occur."""
    depth, k_inv = _seeded(seed)
    valid = (np.random.RandomState(seed + 10).rand(*depth.shape) > 0.3
             ).astype(np.float32)
    pts = np.asarray(jgeo.get_points_coordinate(jnp.asarray(depth),
                                                jnp.asarray(k_inv)))
    want = np.asarray(jgeo.get_surface_normal(jnp.asarray(pts),
                                              jnp.asarray(valid)))
    got = tgeo.get_surface_normal(_t(pts), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pca_svd_matches_jax(seed):
    pts = np.random.RandomState(seed).randn(50, 3).astype(np.float32)
    pts[:, 2] *= 0.1
    jc, jn = jgeo.pca_svd(jnp.asarray(pts))
    tc, tn = tgeo.pca_svd(_t(pts))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    sign = np.sign(np.dot(tn.numpy(), np.asarray(jn)))
    np.testing.assert_allclose(sign * tn.numpy(), np.asarray(jn), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_to_plane_error_matches_jax(seed):
    depth, k_inv = _seeded(seed, b=1)
    rng = np.random.RandomState(seed + 20)
    pts = np.array(jgeo.get_points_coordinate(jnp.asarray(depth),
                                              jnp.asarray(k_inv)))[0]
    pts[0, 0, 2] = -1.0                      # a point behind the camera
    mask = rng.rand(*pts.shape[:2]) > 0.5
    normal = rng.randn(3).astype(np.float32)
    normal /= np.linalg.norm(normal)
    want = float(jgeo.point_to_plane_error(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normal),
        jnp.asarray(1.5, jnp.float32)))
    got = float(tgeo.point_to_plane_error(_t(pts), _t(mask), _t(normal),
                                          1.5))
    assert got == pytest.approx(want, rel=1e-6)


def test_backprojection_inverts_projection():
    h, w = 24, 32
    normal = np.array([0.1, -0.2, 0.97])
    normal /= np.linalg.norm(normal)
    depth = _plane_depth(h, w, K, normal, 2.0)
    pts = tgeo.get_points_coordinate(
        torch.tensor(depth[None, :, :, None], dtype=torch.float32),
        torch.tensor(np.linalg.inv(K)[None], dtype=torch.float32))[0]
    err = tgeo.point_to_plane_error(pts, torch.ones((h, w), dtype=bool),
                                    torch.tensor(normal, dtype=torch.float32),
                                    2.0)
    assert float(err) < 1e-3


def test_surface_normal_on_plane():
    h, w = 24, 32
    depth = _plane_depth(h, w, K, np.array([0.0, 0.0, 1.0]), 2.0)
    pts = tgeo.get_points_coordinate(
        torch.tensor(depth[None, :, :, None], dtype=torch.float32),
        torch.tensor(np.linalg.inv(K)[None], dtype=torch.float32))
    normals = tgeo.get_surface_normal(pts, torch.ones((1, h, w, 1))).numpy()
    assert np.abs(normals[0, 8:-8, 8:-8, 2]).min() > 0.99


def test_pca_plane_fit():
    rng = np.random.RandomState(0)
    normal = np.array([0.3, 0.4, np.sqrt(1 - 0.25)])
    basis = np.linalg.svd(normal[None])[2][1:]
    pts = rng.randn(200, 2) @ basis + 2.0 * normal
    center, n_fit = tgeo.pca_svd(torch.tensor(pts, dtype=torch.float32))
    assert abs(float(np.dot(n_fit.numpy(), normal))) > 0.999
    np.testing.assert_allclose(center.numpy(), 2.0 * normal, atol=0.2)


def test_check_dataset_over_a_synthetic_tree(tmp_path, monkeypatch):
    """The CLI on the CPU: one finite error per frame, each equal to the
    JAX geometry's on the same augmented sample (the tiny preset resizes
    the 48x64 frames to its 640x640 square without touching the
    intrinsics, as the JAX tool does, so the errors are not small)."""
    synth_scenes.generate_dataset(str(tmp_path), 0, 3, 0, h=48, w=64, seed=2,
                                  min_area=30, progress=False)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "PlaneRecNet_tiny_config", "--device", "cpu",
            "--max_images", "3"]
    with redirect_stdout(io.StringIO()):
        errors = check_dataset.main(argv)
    assert len(errors) == 3 and np.isfinite(errors).all()

    cfg = set_cfg("PlaneRecNet_tiny_config")
    dataset = build_dataset(cfg, "valid", transform=SSDAugmentation(
        cfg, rng=np.random.RandomState(0)))
    for idx, got in enumerate(errors):
        _, inst, depth = dataset[idx]
        pts = jgeo.get_points_coordinate(
            jnp.asarray(depth[None]),
            jnp.asarray(np.linalg.inv(inst["k_matrix"])[None]))[0]
        planes = inst["plane_paras"]
        want = sum(float(jgeo.point_to_plane_error(
            pts, jnp.asarray(m.astype(bool)), jnp.asarray(p[:3]),
            jnp.asarray(p[3]))) for m, p in zip(inst["masks"], planes))
        assert got == pytest.approx(want / len(planes), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("config", ["PlaneRecNet_50_config",
                                    "PlaneRecNet_101_config"])
def test_check_dataset_prints_what_the_jax_tool_prints(tmp_path, monkeypatch,
                                                       config):
    """The port's first line (the backbone's name and weights file) is the
    JAX tool's (``tools/check_dataset.py``), run on the same tree; the
    port, like it, takes no ``--seed``."""
    synth_scenes.generate_dataset(str(tmp_path), 0, 1, 0, h=48, w=64, seed=2,
                                  min_area=30, progress=False)
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "jax_check_dataset",
        Path(__file__).resolve().parent.parent / "tools" / "check_dataset.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["check_dataset.py", "--config", config,
                                      "--max_images", "1"])
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        jax_tool.main()
    with redirect_stdout(got):
        check_dataset.main(["--config", config, "--device", "cpu",
                            "--max_images", "1"])
    first = want.getvalue().splitlines()[0]
    assert got.getvalue().splitlines()[0] == first
    assert first.split()[0].startswith("ResNet")
    with pytest.raises(SystemExit), redirect_stdout(io.StringIO()):
        check_dataset.main(["--config", config, "--device", "cpu",
                            "--seed", "1"])
