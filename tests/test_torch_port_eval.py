"""The port's evaluation stack against the JAX package on the CPU.

* ``evaluation.py`` (IoUs, depth metrics, the AP accumulator, greedy
  matching, the mAP table) and ``utils`` (``MovingAverage``,
  ``ProgressBar``, ``SavePath``, the timer under one patched clock) on
  seeded inputs: exactly equal.
* ``runner.infer_normalized_with_gt_iou`` at a 64x64 cut of PRN-50 with
  seeded variables (``test_torch_port_model.seeded_variables``) against
  the JAX runner: slots, classes and the overflow flag equal; scores,
  boxes and depth within 1e-4 as in ``test_torch_port_runner``; the IoU
  matrix exactly the host IoU of the port's own masks (binary masks sum
  to integers in f32), and within 1e-4 of JAX's wherever the two
  packages' masks agree. A mask may differ between the packages only at
  pixels whose soft value lies within 1e-4 of ``mask_thr``
  (``test_torch_port_runner``), and the IoU of such a slot moves by the
  flipped pixels over its union, which the test bounds.
* ``eval.evaluate`` of both packages on the same ``.npz`` weights and the
  same tree, thresholds lowered so that the seeded weights detect: depth
  metrics within 1e-4 relative, AP tables within 1e-3 (points).
"""

import io
import json
import os
import random
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from planerecnet_tpu import evaluation as jev
from planerecnet_tpu.config import PlaneRecNet_50_config
from planerecnet_tpu.data import BaseTransform as JBaseTransform
from planerecnet_tpu.data import build_dataset as jbuild
from planerecnet_tpu.runner import PlaneRecNetRunner as JaxRunner
from planerecnet_tpu.utils import checkpoint as jckpt
from planerecnet_tpu.utils import timer as jtimer
from planerecnet_tpu.utils import utils as jutils
from planerecnet_tpu_torch import eval as teval
from planerecnet_tpu_torch import evaluation as tev
from planerecnet_tpu_torch.data import BaseTransform, build_dataset
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from planerecnet_tpu_torch.tools import synth_scenes
from planerecnet_tpu_torch.utils import timer as ttimer
from planerecnet_tpu_torch.utils import utils as tutils
from test_torch_port_model import jax_variables, nest, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import eval as jeval  # noqa: E402

torch.set_num_threads(2)
SIZE = 64


def _tiny_cfg(**solov2):
    """PlaneRecNet-50 cut to a 64x64 smoke size (as ``test_cli`` does)."""
    cfg = PlaneRecNet_50_config
    return cfg.copy(dict(
        max_size=SIZE, max_instances=4, max_positives=16, vnl_samples=32,
        solov2=cfg.solov2.copy(dict(num_grids=(10, 9, 6, 4),
                                    max_candidates=32, nms_pre=32, top_k=8,
                                    **solov2))))


# --------------------------------------------------------- metrics


def _boxes(rng, n):
    xy = rng.rand(n, 2) * 50
    return np.concatenate([xy, xy + 2 + rng.rand(n, 2) * 30], 1)


def test_ious_and_depth_metrics_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 4)
    np.testing.assert_array_equal(tev.bbox_iou(a, b), jev.bbox_iou(a, b))
    ma, mb = rng.rand(6, 20, 30) > 0.5, rng.rand(3, 20, 30) > 0.7
    np.testing.assert_array_equal(tev.mask_iou(ma, mb), jev.mask_iou(ma, mb))
    jcfg = PlaneRecNet_50_config
    for seed in range(3):
        r = np.random.RandomState(seed)
        pred = r.uniform(0.2, 8, (24, 32)).astype(np.float32)
        gt = r.uniform(0.2, 8, (24, 32)).astype(np.float32)
        for median in (True, False):
            np.testing.assert_array_equal(
                tev.compute_depth_metrics(pred, gt, port_cfg(jcfg), median),
                jev.compute_depth_metrics(pred, gt, jcfg, median))


def test_ap_accumulation_and_map_table_match_jax():
    rng = np.random.RandomState(1)
    j_ap, t_ap = jev.make_ap_data(), tev.make_ap_data()
    for _ in range(5):
        n_pred, n_gt = rng.randint(0, 6), rng.randint(0, 4)
        gt_boxes, pred_boxes = _boxes(rng, n_gt), _boxes(rng, n_pred)
        gt_masks = rng.rand(n_gt, 16, 16) > 0.5
        pred_masks = rng.rand(n_pred, 16, 16) > 0.5
        classes = np.zeros(n_pred, np.int64)
        scores = rng.rand(n_pred)
        args = (gt_masks, gt_boxes, np.zeros(n_gt, np.int64), pred_masks,
                pred_boxes, classes, scores)
        jev.compute_segmentation_metrics(j_ap, *args)
        tev.compute_segmentation_metrics(t_ap, *args)
    for kind in ("box", "mask"):
        for jo, to in zip(j_ap[kind], t_ap[kind]):
            assert to.data_points == jo.data_points
            assert to.num_gt_positives == jo.num_gt_positives
            assert to.get_ap() == jo.get_ap()
    out_j, out_t = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        want = jev.calc_map(j_ap)
    with redirect_stdout(out_t):
        got = tev.calc_map(t_ap)
    assert got == want
    assert out_t.getvalue() == out_j.getvalue()


# ----------------------------------------------------------- utils


def test_moving_average_and_progress_bar_match_jax():
    values = [1.5, 2.25, float("nan"), -3.0, 1e9, float("inf"), 0.125]
    ja, ta = jutils.MovingAverage(4), tutils.MovingAverage(4)
    with redirect_stdout(io.StringIO()):
        for v in values:
            ja.add(v)
            ta.add(v)
            assert ta.get_avg() == ja.get_avg() and len(ta) == len(ja)
    jb, tb = jutils.ProgressBar(30, 7), tutils.ProgressBar(30, 7)
    for v in (-1, 0, 3, 7, 9):
        jb.set_val(v)
        tb.set_val(v)
        assert repr(tb) == repr(jb) and tb.is_finished() == jb.is_finished()


def test_save_path_matches_jax(tmp_path):
    names = ["PlaneRecNet_50_3_1200.npz", "PlaneRecNet_50_4_1500.npz",
             "PlaneRecNet_50_4_1501_interrupt.npz", "PlaneRecNet_101_9_9.npz",
             "PlaneRecNet_50_1_7.pth", "notes.txt"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    folder = str(tmp_path) + "/"
    for n in names[:5]:
        j, t = jutils.SavePath.from_str(n), tutils.SavePath.from_str(n)
        assert (t.model_name, t.epoch, t.iteration) == (
            j.model_name, j.epoch, j.iteration)
        assert t.get_path(folder) == j.get_path(folder)
    for config in ("PlaneRecNet_50", "PlaneRecNet_101", "nothing"):
        assert tutils.SavePath.get_latest(folder, config) == \
            jutils.SavePath.get_latest(folder, config)
    assert tutils.SavePath.get_interrupt(folder) == \
        jutils.SavePath.get_interrupt(folder)
    tutils.SavePath.remove_interrupt(folder)
    assert tutils.SavePath.get_interrupt(folder) is None


def _drive_timer(timer):
    timer.reset()
    timer.start("a")
    timer.start("b")
    timer.stop("b")
    with timer.env("c"):
        with timer.env("d", sync=torch.ones(2)):
            pass
    timer.stop("a")
    timer.start("e", use_stack=False)
    timer.stop("e", use_stack=False)
    return dict(timer._total_times), timer.total_time()


def test_timer_matches_jax(monkeypatch):
    """The same scopes under one patched clock accumulate the same
    totals; a CPU tensor as the sync payload waits for nothing."""
    for module in (jtimer, ttimer):
        clock = iter(np.arange(100.0) ** 1.5)
        monkeypatch.setattr(module, "_now",
                            lambda clock=clock: float(next(clock)))
    want = _drive_timer(jtimer)
    got = _drive_timer(ttimer)
    assert got == want
    with redirect_stdout(io.StringIO()) as out_t:
        ttimer.print_stats()
    with redirect_stdout(io.StringIO()) as out_j:
        jtimer.print_stats()
    assert out_t.getvalue() == out_j.getvalue()


# ------------------------------------------------- device IoU, runner


def _host_iou(masks, gt):
    """(B, K, H, W) x (B, N, H, W) -> (B, K, N), the host formula."""
    return np.stack([tev.mask_iou(m, g) for m, g in zip(masks, gt)])


def test_infer_normalized_with_gt_iou_matches_jax():
    cfg = _tiny_cfg()
    flat = jax_variables(cfg)
    rng = np.random.RandomState(9)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    gt = (rng.rand(2, 3, SIZE, SIZE) > 0.6).astype(np.float32)
    gt[0, 2] = 0                              # an empty padding slot
    jr = JaxRunner(cfg, variables=nest(flat))
    tr = PlaneRecNetRunner(port_cfg(cfg), variables=flat, device="cpu")
    want = {k: np.asarray(v) for k, v in
            jr.infer_normalized_with_gt_iou(x, gt).items()}
    got = {k: v.numpy() for k, v in
           tr.infer_normalized_with_gt_iou(x, gt).items()}
    assert set(got) == set(want) and "pred_masks" not in got
    want_masks = np.asarray(jr.infer_normalized(x)["pred_masks"])
    got_masks = tr.infer_normalized(x)["pred_masks"].numpy()
    valid = want["pred_valid"]
    assert valid.sum() >= 1
    np.testing.assert_array_equal(got["pred_valid"], valid)
    np.testing.assert_array_equal(got["candidates_clipped"],
                                  want["candidates_clipped"])
    np.testing.assert_array_equal(got["pred_classes"][valid],
                                  want["pred_classes"][valid])
    for k in ("pred_scores", "pred_depth"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    assert got["gt_mask_iou"].shape == want["gt_mask_iou"].shape == (
        2, cfg.solov2.top_k, 3)
    np.testing.assert_array_equal(got["gt_mask_iou"],
                                  _host_iou(got_masks, gt).astype(np.float32))
    same = (got_masks == want_masks).all(axis=(2, 3))
    np.testing.assert_allclose(got["gt_mask_iou"][same],
                               want["gt_mask_iou"][same], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["pred_boxes"][same & valid],
                                  want["pred_boxes"][same & valid])
    # A slot whose mask differs (near-threshold pixels only, see the
    # module docstring): its IoU moves by at most the flips over the
    # smaller union.
    flips = (got_masks != want_masks).sum(axis=(2, 3))
    union = np.minimum(
        got_masks.sum(axis=(2, 3))[..., None] + gt.sum(axis=(2, 3))[:, None],
        want_masks.sum(axis=(2, 3))[..., None] + gt.sum(axis=(2, 3))[:, None])
    bound = flips[..., None] / np.maximum(union - flips[..., None], 1)
    assert (np.abs(got["gt_mask_iou"] - want["gt_mask_iou"])
            <= bound + 1e-4).all()
    assert same[valid].mean() >= 0.5


# ------------------------------------------------------- evaluate


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic ScanNet tree (48x80 PNG frames, so that the 64x64
    transform resizes both sides) and JAX ``.npz`` weights of the cut
    PRN-50."""
    out = str(tmp_path_factory.mktemp("eval"))
    root = synth_scenes.generate_dataset(out, 0, 0, 5, h=48, w=80, seed=2,
                                         min_area=30, progress=False)
    cfg = _tiny_cfg(score_thr=0.01, update_thr=0.01)
    cfg = cfg.copy(dict(dataset=cfg.dataset.copy(dict(
        eval_images=os.path.join(root, "scans") + "/",
        eval_info=os.path.join(root, "scannet_eval.json")))))
    weights = os.path.join(out, "PlaneRecNet_50_1_10.npz")
    jckpt.save_weights(weights, nest(jax_variables(_tiny_cfg())))
    return cfg, weights


def _evaluate(evaluate, runner, ds, **kw):
    random.seed(3)
    with redirect_stdout(io.StringIO()):
        return evaluate(runner, ds, eval_nums=5, no_bar=True, **kw)


def test_evaluate_matches_jax(tree):
    cfg, weights = tree
    jr = JaxRunner(cfg)
    jr.load_weights(weights)
    tr = PlaneRecNetRunner(port_cfg(cfg), device="cpu")
    tr.load_weights(weights)
    jds = jbuild(cfg, "eval", transform=JBaseTransform(cfg))
    tds = build_dataset(port_cfg(cfg), "eval",
                        transform=BaseTransform(port_cfg(cfg)))
    want_maps, want_depth = _evaluate(jeval.evaluate, jr, jds, batch_size=2)
    stats = {}
    got_maps, got_depth = _evaluate(teval.evaluate, tr, tds, batch_size=2,
                                    stats=stats)
    assert stats["detections"] > 0
    assert max(want_maps["mask"].values()) > 0
    np.testing.assert_allclose(got_depth, want_depth, rtol=1e-4, atol=0)
    for kind in ("box", "mask"):
        assert list(got_maps[kind]) == list(want_maps[kind])
        np.testing.assert_allclose(list(got_maps[kind].values()),
                                   list(want_maps[kind].values()),
                                   rtol=0, atol=1e-3)


def test_evaluate_device_metrics_equal_host_and_batch_one(tree):
    """The port's evaluate: device IoU and host IoU give the same tables
    and depth metrics, exactly; batch 2 gives batch 1's tables, and its
    depth metrics within 1e-5 (the CPU convolutions sum a batch of one
    in another order)."""
    cfg, weights = tree
    tcfg = port_cfg(cfg)
    tr = PlaneRecNetRunner(tcfg, device="cpu")
    tr.load_weights(weights)
    tds = build_dataset(tcfg, "eval", transform=BaseTransform(tcfg))
    dev, host, one = [_evaluate(teval.evaluate, tr, tds, batch_size=b,
                                device_metrics=d)
                      for b, d in ((2, True), (2, False), (1, True))]
    assert host[0] == dev[0]
    np.testing.assert_array_equal(host[1], dev[1])
    assert one[0] == dev[0]
    np.testing.assert_allclose(one[1], dev[1], rtol=1e-5, atol=1e-7)


def test_metrics_json_payload(tree, tmp_path):
    """``main`` writes and returns the mAP tables and depth metrics."""
    cfg, weights = tree
    path = str(tmp_path / "m.json")
    ov = {"max_size": SIZE, "max_instances": 4,
          "solov2": {"num_grids": [10, 9, 6, 4], "max_candidates": 32,
                     "nms_pre": 32, "top_k": 8},
          "dataset": {"eval_images": cfg.dataset.eval_images,
                      "eval_info": cfg.dataset.eval_info}}
    with redirect_stdout(io.StringIO()):
        res = teval.main(["--trained_model", weights, "--device", "cpu",
                          "--max_images", "3", "--batch_size", "2",
                          "--score_threshold", "0.01",
                          "--update_threshold", "0.01", "--no_bar",
                          "--seed", "1", "--metrics_json", path,
                          "--cfg_overrides", json.dumps(ov)])
    with open(path) as f:
        written = json.load(f)
    assert written["config"] == "PlaneRecNet_50_config"
    assert written["depth"] == res["depth"]
    assert {str(k): v for k, v in res["box"].items()} == written["box"]
    assert res["detections"] > 0 and res["ms_per_image"] > 0
