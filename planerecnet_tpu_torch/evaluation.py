"""Evaluation metrics: depth errors, greedy-matching AP, mAP tables.

Counterpart of ``planerecnet_tpu/evaluation.py``, host numpy as there (the
forward, post-processing and, on the eval CLI's default path, the mask
IoU run on the device). The JAX package's semantics are kept, quirks
included, because the published mAP numbers were produced with them:

* ``num_gt_for_class`` counts GT instances of the single plane class per
  image;
* every prediction pushes a false-positive data point even when it
  matched a GT, and matched GTs are not excluded from later matches;
* median scaling only reports the ratio, it does not rescale.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from planerecnet_tpu_torch.config import PlaneRecNetConfig

DEPTH_METRICS = ["abs_rel", "sq_rel", "rmse", "log10", "a1", "a2", "a3",
                 "ratio"]
IOU_THRESHOLDS = [x / 100 for x in range(50, 100, 5)]


def bbox_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise xyxy IoU. (N,4)x(M,4)->(N,M)."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    ix = np.maximum(
        np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0)
    iy = np.maximum(
        np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0)
    inter = ix * iy
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0])
              * (boxes_a[:, 3] - boxes_a[:, 1]))[:, None]
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0])
              * (boxes_b[:, 3] - boxes_b[:, 1]))[None, :]
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou(masks_a: np.ndarray, masks_b: np.ndarray) -> np.ndarray:
    """Pairwise mask IoU via matmul."""
    a = masks_a.reshape(masks_a.shape[0], -1).astype(np.float32)
    b = masks_b.reshape(masks_b.shape[0], -1).astype(np.float32)
    inter = a @ b.T
    area_a = a.sum(1)[:, None]
    area_b = b.sum(1)[None, :]
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_depth_metrics(pred_depth: np.ndarray, gt_depth: np.ndarray,
                          cfg: PlaneRecNetConfig,
                          median_scaling: bool = True) -> np.ndarray:
    """Eight depth error metrics over the 0.5m-validity mask. Inputs
    (H, W) metres."""
    pred = np.asarray(pred_depth, np.float64).reshape(-1)
    gt = np.asarray(gt_depth, np.float64).reshape(-1)
    valid = (gt > 0.5) & (pred > 0.5)
    p = pred[valid]
    g = gt[valid]
    if p.size == 0:
        return np.zeros(8)

    ratio = float(np.median(gt_depth) / np.median(p)) if median_scaling else 0.0
    p = np.clip(p, cfg.dataset.min_depth, cfg.dataset.max_depth)

    thresh = np.maximum(g / p, p / g)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((g - p) ** 2).mean()))
    log10 = float(np.abs(np.log10(g) - np.log10(p)).mean())
    abs_rel = float((np.abs(g - p) / g).mean())
    sq_rel = float((((g - p) ** 2) / g).mean())
    return np.asarray([abs_rel, sq_rel, rmse, log10, a1, a2, a3, ratio])


class APDataObject:
    """PR-curve accumulator with COCO-style 101-point interpolation."""

    def __init__(self):
        self.data_points: List[Tuple[float, bool]] = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool):
        self.data_points.append((score, is_true))

    def add_gt_positives(self, num_positives: int):
        self.num_gt_positives += num_positives

    def is_empty(self) -> bool:
        return len(self.data_points) == 0 and self.num_gt_positives == 0

    def get_ap(self) -> float:
        """COCO 101-point interpolated AP, fully vectorised.

        Detections sorted by descending score, running precision/recall,
        precision envelope right-to-left, then the mean of the envelope
        sampled at recalls 0.00:0.01:1.00 (samples past the last data point
        contribute 0).
        """
        if self.num_gt_positives == 0:
            return 0
        if not self.data_points:
            return 0
        pts = np.asarray(self.data_points, dtype=np.float64)
        order = np.argsort(-pts[:, 0], kind="stable")
        hits = pts[order, 1]

        tp = np.cumsum(hits)
        precisions = tp / np.arange(1, hits.size + 1)
        recalls = tp / self.num_gt_positives

        # Monotone precision envelope (suffix running max).
        envelope = np.maximum.accumulate(precisions[::-1])[::-1]

        sample_recalls = np.linspace(0.0, 1.0, 101)
        idx = np.searchsorted(recalls, sample_recalls, side="left")
        sampled = np.where(idx < envelope.size,
                           envelope[np.minimum(idx, envelope.size - 1)], 0.0)
        return float(sampled.mean())


def make_ap_data() -> Dict[str, List[APDataObject]]:
    return {"box": [APDataObject() for _ in IOU_THRESHOLDS],
            "mask": [APDataObject() for _ in IOU_THRESHOLDS]}


def compute_segmentation_metrics(ap_data, gt_masks, gt_boxes, gt_classes,
                                 pred_masks, pred_boxes, pred_classes,
                                 pred_scores, mask_iou_cache=None):
    """Greedy IoU matching into the AP accumulators (quirks kept, see the
    module docstring).

    ``mask_iou_cache`` may be computed on the device (exact: binary masks
    sum to integers in f32; ``runner.infer_normalized_with_gt_iou``), and
    then ``pred_masks`` and ``gt_masks`` may be None.
    """
    num_pred = len(pred_classes)
    num_gt = len(gt_classes)
    if num_pred == 0 and num_gt == 0:
        return

    if mask_iou_cache is None:
        mask_iou_cache = mask_iou(pred_masks, gt_masks) \
            if num_pred and num_gt else np.zeros((num_pred, num_gt))
    bbox_iou_cache = bbox_iou(np.asarray(pred_boxes, np.float64),
                              np.asarray(gt_boxes, np.float64)) \
        if num_pred and num_gt else np.zeros((num_pred, num_gt))

    indices = sorted(range(num_pred), key=lambda i: -pred_scores[i])
    iou_types = [("box", bbox_iou_cache), ("mask", mask_iou_cache)]
    num_gt_for_class = sum(1 for x in gt_classes if x == 0)

    for iou_idx, iou_threshold in enumerate(IOU_THRESHOLDS):
        for iou_type, iou_cache in iou_types:
            ap_obj = ap_data[iou_type][iou_idx]
            ap_obj.add_gt_positives(num_gt_for_class)
            for i in indices:
                max_iou_found = iou_threshold
                max_match_idx = -1
                for j in range(num_gt):
                    iou = float(iou_cache[i, j])
                    if iou > max_iou_found:
                        max_iou_found = iou
                        max_match_idx = j
                if max_match_idx >= 0:
                    ap_obj.push(float(pred_scores[i]), True)
                ap_obj.push(float(pred_scores[i]), False)


def calc_map(ap_data, print_table: bool = True) -> Dict[str, Dict]:
    """mAP table across IoU thresholds."""
    aps = [{"box": [], "mask": []} for _ in IOU_THRESHOLDS]
    for iou_idx in range(len(IOU_THRESHOLDS)):
        for iou_type in ("box", "mask"):
            ap_obj = ap_data[iou_type][iou_idx]
            if not ap_obj.is_empty():
                aps[iou_idx][iou_type].append(ap_obj.get_ap())

    all_maps = {"box": OrderedDict(), "mask": OrderedDict()}
    for iou_type in ("box", "mask"):
        all_maps[iou_type]["all"] = 0
        for i, threshold in enumerate(IOU_THRESHOLDS):
            m = (sum(aps[i][iou_type]) / len(aps[i][iou_type]) * 100
                 if len(aps[i][iou_type]) > 0 else 0)
            all_maps[iou_type][int(threshold * 100)] = m
        all_maps[iou_type]["all"] = (sum(all_maps[iou_type].values())
                                     / (len(all_maps[iou_type].values()) - 1))
    if print_table:
        print_maps(all_maps)
    return {k: {j: round(u, 2) for j, u in v.items()}
            for k, v in all_maps.items()}


def print_maps(all_maps):
    def make_row(vals):
        return (" %5s |" * len(vals)) % tuple(vals)

    def make_sep(n):
        return "-------+" * n

    print()
    print(make_row([""] + [(".%d " % x if isinstance(x, int) else x + " ")
                           for x in all_maps["box"].keys()]))
    print(make_sep(len(all_maps["box"]) + 1))
    for iou_type in ("box", "mask"):
        print(make_row([iou_type] + ["%.2f" % x if x < 100 else "%.1f" % x
                                     for x in all_maps[iou_type].values()]))
    print(make_sep(len(all_maps["box"]) + 1))
    print()
