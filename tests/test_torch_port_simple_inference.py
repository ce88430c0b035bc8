"""The port's ``simple_inference`` against the JAX package's (which draws
with OpenCV, importable here).

``display_on_frame``: on the same result the blend, the contours and the
boxes are equal pixel for pixel; the label boxes are left out of the
comparison, because the port draws its labels in its own bitmap font and
cv2 in its Hershey font, so the boxes have other sizes. ``save_depth``:
the same PNG pixels, colour and 16-bit. The single-image mode end to end
on a PNG, both CLIs on the same weights (``--no_text``, gray 16-bit
depth): the runners' outputs agree within ``test_torch_port_runner``'s
tolerances, and the frames they write are equal wherever the two runners'
masks agree; the depth PNGs within one count of 1/512 m (the runners'
depths agree to 1e-4, and the PNG truncates depth x 512).
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
import scipy.io  # noqa: E402

import simple_inference as jax_si  # noqa: E402
from planerecnet_tpu.runner import PlaneRecNetRunner as JaxRunner  # noqa
from planerecnet_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from planerecnet_tpu_torch import simple_inference as si  # noqa: E402
from planerecnet_tpu_torch.data.image_io import imread, imwrite  # noqa
from planerecnet_tpu_torch.runner import PlaneRecNetRunner  # noqa: E402
from test_torch_port_model import jax_variables, nest, port_cfg  # noqa
from test_torch_port_runner import (SIZE, _compare, _normalise,  # noqa
                                    _soft_masks, _tiny_cfg)

torch.set_num_threads(2)


def blob_result(h=120, w=200, seed=0):
    """Valid detections of one image, as ``_valid_result`` gives them:
    masks with holes, a mask on the image's edge, thin strokes and single
    pixels; boxes partly outside the frame."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    masks = [((yy - 20) ** 2 + (xx - 25) ** 2 < 150)
             & ((yy - 20) ** 2 + (xx - 25) ** 2 > 20),
             (yy < 10) & (xx > 40),
             rng.rand(h, w) > 0.8,
             (np.abs(yy - xx) < 2) & (yy > 25),
             np.zeros((h, w), bool)]
    masks[4][30, 5] = masks[4][31, 6] = True
    boxes = np.array([[13, 8, 37, 32], [40, -3, 70, 9], [0, 0, 63, 47],
                      [26, 26, 47, 47], [5.7, 30.2, 6.9, 31.9]], np.float32)
    n = len(masks)
    return {"pred_masks": np.stack(masks),
            "pred_boxes": boxes,
            "pred_classes": np.zeros(n, np.int32),
            "pred_scores": np.linspace(0.9, 0.3, n).astype(np.float32),
            "pred_depth": rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)}


def label_boxes(result, cfg, h, w):
    """Where either package draws a label: its filled box, by cv2's text
    size and by the port font's."""
    out = np.zeros((h, w), bool)
    for j, box in enumerate(result["pred_boxes"]):
        x1, y1 = box.astype(int)[:2]
        text = "%s: %.2f" % (cfg.dataset.class_names[0],
                             float(result["pred_scores"][j]))
        sizes = [cv2.getTextSize(text, cv2.FONT_HERSHEY_DUPLEX, 0.6, 1)[0],
                 si.text_size(text)]
        for tw, th in sizes:
            out[max(y1, 0):max(y1 + th + 5, 0), max(x1, 0):max(x1 + tw + 1,
                                                              0)] = True
    return out


@pytest.mark.parametrize("no_text,no_box", [(True, False), (False, False),
                                            (False, True), (True, True)])
def test_display_on_frame_matches_jax(no_text, no_box):
    cfg = _tiny_cfg()
    result = blob_result()
    frame = (np.random.RandomState(1).rand(120, 200, 3) * 255).astype(
        np.float32)
    want, want_depth = jax_si.display_on_frame(result, frame, cfg,
                                               no_text=no_text, no_box=no_box)
    got, got_depth = si.display_on_frame(result, frame, port_cfg(cfg),
                                         no_text=no_text, no_box=no_box)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got_depth, want_depth)
    keep = ~label_boxes(result, cfg, 120, 200) if not no_text else \
        np.ones((120, 200), bool)
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(got[keep], want[keep])
    if not no_text:
        # The port's labels are drawn: white text in the label boxes.
        assert (got[~keep] == 255).all(axis=-1).any()


def test_display_on_frame_without_detections():
    cfg = _tiny_cfg()
    frame = np.full((8, 8, 3), 7.0, np.float32)
    result = {"pred_masks": None, "pred_boxes": None, "pred_classes": None,
              "pred_scores": None, "pred_depth": np.ones((8, 8), np.float32)}
    want = jax_si.display_on_frame(result, frame, cfg)
    got = si.display_on_frame(result, frame, port_cfg(cfg))
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("mode", ["colored", "gray"])
def test_save_depth_matches_jax(tmp_path, mode):
    depth = np.random.RandomState(2).uniform(0.3, 6.0, (40, 56)).astype(
        np.float32)
    jax_si.save_depth(depth, str(tmp_path / "jax.png"), mode, 512.0)
    si.save_depth(depth, str(tmp_path / "port.png"), mode, 512.0)
    want = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == (np.uint8 if mode == "colored"
                                       else np.uint16)
    np.testing.assert_array_equal(got, want)


def test_viridis_table_is_opencvs():
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(
        si.VIRIDIS_BGR, cv2.applyColorMap(levels, cv2.COLORMAP_VIRIDIS)[:, 0])


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """The tiny config as the CLIs remap it for ``--score_threshold
    0.05``, its seeded variables in a ``.npz`` both packages load, and the
    two runners on them."""
    cfg = _tiny_cfg(score_thr=0.05)
    cfg = cfg.copy(dict(solov2=cfg.solov2.copy(dict(
        nms_type="matrix", mask_thr=0.05, update_thr=0.05, top_k=100))))
    flat = jax_variables(cfg)
    path = str(tmp_path_factory.mktemp("w") / "seeded.npz")
    jax_ckpt.save_weights(path, nest(flat))
    jax_runner = JaxRunner(cfg)
    jax_runner.load_weights(path)
    port = PlaneRecNetRunner(port_cfg(cfg), device="cpu")
    port.load_weights(path)
    return cfg, path, jax_runner, port


def test_single_image_mode_matches_jax_cli(tmp_path, monkeypatch,
                                           same_weights):
    cfg, path, jax_runner, port = same_weights
    rng = np.random.RandomState(3)
    png = str(tmp_path / "in.png")
    imwrite(png, (rng.rand(40, 52, 3) * 255).astype(np.uint8))
    args = ["--image", "", "--trained_model", path, "--config",
            "PlaneRecNet_50_config", "--score_threshold", "0.05",
            "--no_text", "--depth_mode", "gray"]
    monkeypatch.setattr(jax_si, "set_cfg", lambda name: cfg)
    monkeypatch.setattr(si, "set_cfg", lambda name: port_cfg(cfg))
    args[1] = f"{png}:{tmp_path / 'jax.png'}"
    jax_si.main(args)
    args[1] = f"{png}:{tmp_path / 'port.png'}"
    si.main(args + ["--device", "cpu"])

    # What both CLIs feed their runner: the frame resized to max_size on
    # its long side and padded to a multiple of 32.
    frame = cv2.resize(cv2.imread(png), (SIZE, 49),
                       interpolation=cv2.INTER_LINEAR)
    frame = jax_si.pad_to_multiple(frame.astype(np.float32), 32)
    want = jax_runner.infer(frame[None])
    got = port.infer(frame[None])
    raw = jax_runner.forward_raw(_normalise(frame[None]))
    _compare(got, want, cfg, _soft_masks(cfg, raw), tol=1e-4)
    valid = np.asarray(want["pred_valid"][0])
    assert valid.sum() >= 1
    differ = (got["pred_masks"][0].numpy()
              != np.asarray(want["pred_masks"][0]))[valid]
    seg_want = cv2.imread(str(tmp_path / "jax.png"))
    seg_got = imread(str(tmp_path / "port.png"))
    assert seg_got.shape == seg_want.shape == (SIZE, SIZE, 3)
    if not differ.any():
        np.testing.assert_array_equal(seg_got, seg_want)
    else:
        # Only where a mask pixel flipped near mask_thr (and the contour
        # beside it) may the frames differ.
        near = cv2.dilate(differ.any(0).astype(np.uint8), np.ones((3, 3)))
        np.testing.assert_array_equal(seg_got[near == 0],
                                      seg_want[near == 0])
    dep_want = cv2.imread(str(tmp_path / "jax_dep.png"), cv2.IMREAD_UNCHANGED)
    dep_got = imread(str(tmp_path / "port_dep.png"), color=False)
    assert dep_got.dtype == dep_want.dtype == np.uint16
    assert np.abs(dep_got.astype(int) - dep_want.astype(int)).max() <= 1


def test_ibims1_on_a_mat_file(tmp_path, same_weights):
    cfg, _, jax_runner, port = same_weights
    in_dir, out_dir, pd_dir = (tmp_path / d for d in ("in", "out", "pd"))
    in_dir.mkdir()
    rgb = (np.random.RandomState(4).rand(SIZE, SIZE, 3) * 255).astype(
        np.uint8)
    calib = np.array([[50.0, 0, 0], [0, 50.0, 0], [32.0, 32.0, 1.0]])
    data = np.zeros((1, 1), dtype=[("rgb", "O"), ("calib", "O")])
    data["rgb"][0, 0] = rgb
    data["calib"][0, 0] = calib
    scipy.io.savemat(str(in_dir / "scene1.mat"), {"data": data})

    si.ibims1(port, str(in_dir), str(out_dir))
    assert (out_dir / "scene1_results.png").exists()
    got = scipy.io.loadmat(str(out_dir / "scene1_results.mat"))["pred_depths"]
    want = port.infer(rgb.astype(np.float32)[None])["pred_depth"][0].numpy()
    # The same frame through the same runner; oneDNN's CPU convolutions
    # may pick other vector paths for other buffers (1e-6 apart measured).
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jax_si.ibims1(jax_runner, str(in_dir), str(tmp_path / "jax"))
    np.testing.assert_allclose(
        got, scipy.io.loadmat(str(tmp_path / "jax" / "scene1_results.mat"))[
            "pred_depths"], rtol=1e-4, atol=1e-4)

    si.ibims1_pd(port, str(in_dir), str(pd_dir))
    pd = scipy.io.loadmat(str(pd_dir / "scene1_results.mat"))["pred_depths"]
    assert pd.shape == (SIZE, SIZE)
    assert (pd_dir / "scene1_results.png").exists()


def test_train_and_eval_image_panels(tmp_path, monkeypatch):
    """The train CLI's TensorBoard panels and the eval CLI's ``--autopsy``
    write their images (TensorBoard is installed here)."""
    pytest.importorskip("torch.utils.tensorboard")
    from torch.utils.tensorboard import SummaryWriter
    from planerecnet_tpu_torch import eval as eval_cli
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch.tools import synth_scenes
    from planerecnet_tpu_torch.config import set_cfg
    cfg = set_cfg("PlaneRecNet_tiny_config").copy(dict(max_size=SIZE))
    synth_scenes.generate_dataset(str(tmp_path), 0, 2, 2, h=SIZE, w=SIZE,
                                  progress=False)
    monkeypatch.chdir(tmp_path)
    state = trainer_state(cfg)
    writer = SummaryWriter(str(tmp_path / "tb"))
    train_cli.log_visual_example(cfg, state, writer, 5000)
    writer.close()
    assert state.model.training
    assert os.listdir(tmp_path / "tb")
    path = PlaneRecNetRunner(cfg, device="cpu").save_weights(
        str(tmp_path / "w.npz"))
    eval_cli.main(["--trained_model", path, "--config",
                   "PlaneRecNet_tiny_config", "--max_images", "2",
                   "--device", "cpu", "--no_bar", "--autopsy",
                   "--log_folder", str(tmp_path / "logs"),
                   "--cfg_overrides", '{"max_size": 64}'])
    runs = os.listdir(tmp_path / "logs")
    assert len(runs) == 1 and runs[0].startswith("autopsy_")
    assert os.listdir(tmp_path / "logs" / runs[0])


def trainer_state(cfg):
    from planerecnet_tpu_torch import trainer
    return trainer.create_train_state(cfg, seed=0, device="cpu")
