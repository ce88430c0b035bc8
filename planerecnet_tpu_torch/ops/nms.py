"""Point / matrix / mask NMS on fixed-capacity candidate sets.

Counterpart of ``planerecnet_tpu/ops/nms.py``: candidates live in a fixed
number of slots with a validity mask, and the mask-IoU matrix is one matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def point_nms(heat: torch.Tensor, kernel: int = 2) -> torch.Tensor:
    """Local-peak gate on (B, S, S, C) sigmoid scores: a cell survives iff it
    equals the max of the 2x2 window over itself and its up/left
    neighbours (``max_pool2d(k=2, s=1, p=1)`` then ``[:-1, :-1]``)."""
    if kernel != 2:
        raise ValueError(f"point_nms supports kernel 2, not {kernel}")
    h = heat.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(h, 2, stride=1, padding=1)[:, :, :-1, :-1]
    keep = (hmax == h).to(heat.dtype)
    return (h * keep).permute(0, 2, 3, 1)


def _pair_stats(seg_masks, sum_masks, valid):
    m = seg_masks.float() * valid[:, None]
    inter = m @ m.T
    areas = torch.where(valid, sum_masks, 0.0)
    union = areas[None, :] + areas[:, None] - inter
    return inter, union


def matrix_nms(labels: torch.Tensor, seg_masks: torch.Tensor,
               sum_masks: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, sigma: float = 2.0,
               kernel: str = "gaussian") -> torch.Tensor:
    """SOLOv2 matrix (soft) NMS over N slots; returns the decayed scores,
    0 on invalid slots. seg_masks (N, P) binary, sum_masks/scores (N,),
    valid (N,) bool."""
    n = scores.shape[0]
    inter, union = _pair_stats(seg_masks, sum_masks, valid)
    iou = torch.where(union > 0, inter / union, 0.0)
    triu = torch.triu(torch.ones((n, n), device=scores.device), diagonal=1)
    iou = iou * triu

    label_match = (labels[None, :] == labels[:, None]).float() * triu
    label_match = label_match * (valid[None, :] & valid[:, None]).float()

    decay_iou = iou * label_match                    # (N, N), [i, j]
    # Per-candidate max overlap with any higher-scoring same-class mask.
    compensate = decay_iou.max(dim=0).values         # (N,)

    if kernel == "gaussian":
        decay_matrix = torch.exp(-sigma * decay_iou ** 2)
        compensate_matrix = torch.exp(-sigma * compensate[:, None] ** 2)
        coeff = (decay_matrix / compensate_matrix).min(dim=0).values
    elif kernel == "linear":
        coeff = ((1 - decay_iou) / (1 - compensate[:, None])).min(
            dim=0).values
    else:
        raise NotImplementedError(kernel)
    return torch.where(valid, scores * coeff, 0.0)


def mask_nms(labels: torch.Tensor, seg_masks: torch.Tensor,
             sum_masks: torch.Tensor, scores: torch.Tensor,
             valid: torch.Tensor, nms_thr: float = 0.5) -> torch.Tensor:
    """Greedy hard mask NMS over slots sorted by descending score; returns
    the bool keep mask."""
    n = scores.shape[0]
    inter, union = _pair_stats(seg_masks, sum_masks, valid)
    suppress_pair = torch.where(union > 0, inter / union > nms_thr,
                                torch.ones_like(valid[None, :]))
    suppress_pair = suppress_pair & (labels[None, :] == labels[:, None])
    col_ids = torch.arange(n, device=scores.device)
    keep = valid.clone()
    for i in range(n - 1):
        row = suppress_pair[i] & keep[i] & valid[i]
        keep = keep & ~(row & (col_ids > i))
    return keep
