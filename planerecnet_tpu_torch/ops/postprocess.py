"""Inference post-processing on a fixed candidate capacity.

Counterpart of ``planerecnet_tpu/ops/postprocess.py``: score threshold ->
dynamic-conv mask assembly -> area filter -> maskness rescore -> top
``nms_pre`` -> matrix/mask NMS -> ``update_thr`` -> top ``top_k`` -> resize ->
binarise -> boxes from masks, each stage over ``cfg.solov2.max_candidates``
slots with a validity mask. Inputs keep the JAX layouts (NHWC).

Ordering: ``jax.lax.top_k`` puts the lower index first among ties, which
``torch.topk`` does not promise, so every top-k here is a stable descending
sort.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.ops.image import resize_bilinear
from planerecnet_tpu_torch.ops.nms import mask_nms, matrix_nms, point_nms


def flat_strides(num_grids: Sequence[int],
                 strides: Sequence[int]) -> np.ndarray:
    """Per-grid-cell stride over all levels, row-major per level."""
    return np.concatenate([np.full(s * s, stride, dtype=np.float32)
                           for s, stride in zip(num_grids, strides)])


@functools.lru_cache(maxsize=None)
def stride_table(num_grids: Tuple[int, ...], strides: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """``flat_strides`` on ``device``, copied there once per grids and
    device (a CUDA graph cannot copy from pageable host memory); callers
    must not write into it."""
    return torch.from_numpy(flat_strides(num_grids, strides)).to(device)


def _masked_topk_desc(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Indices of the top-k validity-masked scores, descending, lower index
    first among ties; and whether each picked slot was valid."""
    masked = torch.where(valid, scores, float("-inf"))
    top, idx = torch.sort(masked, descending=True, stable=True)
    return idx[:k], torch.isfinite(top[:k])


def select_masks(cate_scores_flat: torch.Tensor, kernels_flat: torch.Tensor,
                 mask_feat: torch.Tensor, cfg: PlaneRecNetConfig,
                 num_levels: int | None = None):
    """The detections of one image before the resize: candidate extraction
    through the final top-k.

    cate_scores_flat (N_cells, num_classes) point-NMS'd scores; kernels_flat
    (N_cells, num_kernels); mask_feat (Hm, Wm, num_kernels). Returns, per
    top_k slot, scores, labels, the grid cell it came from, its soft mask
    (top_k, Hm*Wm) and whether it is valid; and whether candidates were
    clipped.
    """
    sv = cfg.solov2
    cap = sv.max_candidates
    dev = cate_scores_flat.device
    n_cells, n_cls = cate_scores_flat.shape
    n_k = mask_feat.shape[-1]

    # --- candidate extraction ---
    scores_all = cate_scores_flat.reshape(-1)
    cell_ids = torch.arange(n_cells, device=dev).repeat_interleave(n_cls)
    class_ids = torch.arange(n_cls, device=dev).repeat(n_cells)
    valid0 = scores_all > sv.score_thr
    # More candidates than the capacity: the overflow is dropped before
    # mask scoring, which the reference would not do. Reported, not hidden.
    clipped = valid0.sum() > cap

    idx, valid = _masked_topk_desc(scores_all, valid0, cap)
    scores = scores_all[idx]
    labels = class_ids[idx]
    cells = cell_ids[idx]
    nl = num_levels if num_levels is not None else len(sv.num_grids)
    strides = stride_table(tuple(sv.num_grids[:nl]),
                           tuple(sv.fpn_instance_strides[:nl]), dev)[cells]

    # --- dynamic-conv mask assembly: one (cap, K) @ (K, Hm*Wm) matmul ---
    kernels = kernels_flat[cells].float()
    seg_logits = kernels @ mask_feat.reshape(-1, n_k).float().T
    seg_sig = torch.sigmoid(seg_logits)
    seg_bin = seg_sig > sv.mask_thr
    sum_masks = seg_bin.sum(dim=1).float()

    # Stride-based minimum area.
    valid = valid & (sum_masks > strides)

    # Maskness rescoring.
    maskness = (seg_sig * seg_bin).sum(dim=1) / sum_masks.clamp(min=1.0)
    scores = scores * maskness

    # Sort by the rescored score, keep the top nms_pre.
    order, _ = _masked_topk_desc(scores, valid, cap)
    scores = scores[order]
    labels = labels[order]
    cells = cells[order]
    seg_sig = seg_sig[order]
    seg_bin = seg_bin[order]
    sum_masks = sum_masks[order]
    valid = valid[order]
    if sv.nms_pre < cap:
        valid = valid & (torch.arange(cap, device=dev) < sv.nms_pre)

    # --- NMS ---
    if sv.nms_type == "matrix":
        scores = matrix_nms(labels, seg_bin, sum_masks, scores, valid,
                            sigma=sv.nms_sigma, kernel=sv.nms_kernel)
        valid = valid & (scores >= sv.update_thr)
    elif sv.nms_type == "mask":
        valid = mask_nms(labels, seg_bin, sum_masks, scores, valid,
                         nms_thr=sv.mask_thr)
    else:
        raise NotImplementedError(sv.nms_type)

    # Final top-k; k cannot exceed the capacity.
    order, ok = _masked_topk_desc(scores, valid, min(sv.top_k, cap))
    return (scores[order], labels[order], cells[order], seg_sig[order],
            valid[order] & ok, clipped)


def postprocess_single(cate_scores_flat: torch.Tensor,
                       kernels_flat: torch.Tensor,
                       mask_feat: torch.Tensor,
                       depth_pred: torch.Tensor,
                       cfg: PlaneRecNetConfig,
                       ori_size: Tuple[int, int],
                       num_levels: int | None = None
                       ) -> Dict[str, torch.Tensor]:
    """Post-process one image.

    cate_scores_flat (N_cells, num_classes) point-NMS'd scores; kernels_flat
    (N_cells, num_kernels); mask_feat (Hm, Wm, num_kernels); depth_pred
    (Hd, Wd, 1), or None for a model without depth. Returns pred_masks
    (top_k, H, W) bool, pred_scores (top_k,), pred_classes (top_k,) int32,
    pred_boxes (top_k, 4) xyxy, pred_valid (top_k,) bool, pred_depth
    (H, W) (not without depth), candidates_clipped ().
    """
    sv = cfg.solov2
    dev = cate_scores_flat.device
    hm, wm, _ = mask_feat.shape
    depth = None if depth_pred is None else resize_bilinear(
        depth_pred.permute(2, 0, 1)[None].float(), ori_size)[0, 0]
    scores, labels, _, seg_sig, valid, clipped = select_masks(
        cate_scores_flat, kernels_flat, mask_feat, cfg, num_levels)

    # Resize the soft masks to the output size and binarise.
    masks = resize_bilinear(seg_sig.reshape(-1, 1, hm, wm), ori_size)[:, 0]
    masks = (masks > sv.mask_thr) & valid[:, None, None]

    # Boxes from mask extents, over row/column occupancy.
    h, w = ori_size
    any_x = masks.any(dim=1)                                # (K, W)
    any_y = masks.any(dim=2)                                # (K, H)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    big = 1e9
    x_min = torch.where(any_x, xs, big).min(dim=1).values
    y_min = torch.where(any_y, ys, big).min(dim=1).values
    x_max = torch.where(any_x, xs, -big).max(dim=1).values
    y_max = torch.where(any_y, ys, -big).max(dim=1).values
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    boxes = torch.where(valid[:, None], boxes, 0.0)

    out = {
        "pred_masks": masks,
        "pred_scores": torch.where(valid, scores, 0.0),
        "pred_classes": labels.to(torch.int32),
        "pred_boxes": boxes,
        "pred_valid": valid,
        "pred_depth": depth,
        "candidates_clipped": clipped,
    }
    if depth is None:
        del out["pred_depth"]
    return out


def flatten_level_preds(cate_preds: Sequence[torch.Tensor],
                        kernel_preds: Sequence[torch.Tensor],
                        num_classes: int, num_kernels: int):
    """Point-NMS per level, then flatten to (B, N_cells, C) / (B, N_cells, K)."""
    b = cate_preds[0].shape[0]
    cates, kernels = [], []
    for cp, kp in zip(cate_preds, kernel_preds):
        c = point_nms(torch.sigmoid(cp.float()), kernel=2)
        cates.append(c.reshape(b, -1, num_classes))
        kernels.append(kp.reshape(b, -1, num_kernels))
    return torch.cat(cates, dim=1), torch.cat(kernels, dim=1)


def postprocess_batch(preds: Dict, cfg: PlaneRecNetConfig,
                      ori_size: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Point-NMS and per-image post-processing of a raw-pred dict; every
    output gains a leading batch dimension."""
    sv = cfg.solov2
    num_levels = len(preds["cate_preds"])
    cates, kernels = flatten_level_preds(
        preds["cate_preds"], preds["kernel_preds"],
        cfg.num_classes, sv.num_kernels)
    depth = preds.get("depth_pred")
    outs = [postprocess_single(cates[i], kernels[i], preds["mask_pred"][i],
                               None if depth is None else depth[i], cfg,
                               tuple(ori_size),
                               num_levels=num_levels)
            for i in range(cates.shape[0])]
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
