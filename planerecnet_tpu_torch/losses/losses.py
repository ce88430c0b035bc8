"""PlaneRecNet's joint training loss.

Counterpart of ``planerecnet_tpu/losses/losses.py``: fixed-capacity GT
preparation (every GT instance claims at most the 3x3 window of grid cells
around its mass centre on each level, compacted to ``max_positives`` slots),
then dice (instance masks), sigmoid focal (categories), RMSE of log depth,
the VNL plane loss and the lava loss, weighted and returned as a dict.

The dice and lava terms always go through ``ops/dice_lava.py``'s fused
reductions (the kernels on the card, their plain versions on the CPU), so
the loss has one formulation everywhere. The lava loss uses the adjoint
identity sum(resize(m) * G) == sum(m * adjoint(G)): the gradient map is
pulled back to mask resolution once per image.

Batch layout (the JAX package's): ``image`` (B, H, W, 3), ``depth``
(B, H, W, 1), ``masks`` (B, N, H, W), ``boxes`` (B, N, 4) xyxy, ``classes``
(B, N), ``gt_valid`` (B, N), ``plane_paras`` (B, N, 4), ``k_matrix``
(B, 3, 3), with N = ``max_instances``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.losses.vnl import (sample_vnl_indices,
                                              vnl_loss_from_indices)
from planerecnet_tpu_torch.ops.dice_lava import fused_dice_lava
from planerecnet_tpu_torch.ops.image import (_resize_weights, reflect_pad,
                                             resize_bilinear)


def dice_loss(input_sig: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-instance dice loss over the last (pixel) axis."""
    a = (input_sig * target).sum(-1)
    b = (input_sig * input_sig).sum(-1) + 0.001
    c = (target * target).sum(-1) + 0.001
    return 1.0 - (2 * a) / (b + c)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Elementwise sigmoid focal loss, no reduction."""
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def rmse_log_loss(pred: torch.Tensor, target: torch.Tensor,
                  valid: torch.Tensor, clamp_val: float = 1e-9
                  ) -> torch.Tensor:
    """Per-image RMSE of log depth over the valid pixels, (B,)."""
    b = pred.shape[0]
    pred = pred.reshape(b, -1)
    target = target.reshape(b, -1)
    valid = valid.reshape(b, -1).to(pred.dtype)
    l1 = (torch.log(pred.clamp(min=clamp_val))
          - torch.log(target.clamp(min=clamp_val))).abs() * valid
    mean = (l1 ** 2).sum(1) / valid.sum(1).clamp(min=1.0)
    # +eps keeps the sqrt gradient finite when every pixel is invalid.
    return torch.sqrt(mean + 1e-12)


_SOBEL_X = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
_SOBEL_Y = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))


def compute_gradient_map(depth: torch.Tensor,
                         valid_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Squared Sobel gradient magnitude (kernels / 8) of (B, H, W, 1) depth
    maps with reflect padding, (B, H, W, 1). Written as nine shifted f32
    products rather than a convolution, which cuDNN would run in TF32."""
    b, h, w, _ = depth.shape
    padded = reflect_pad(depth.permute(0, 3, 1, 2))[:, 0]
    gx = torch.zeros((b, h, w), dtype=depth.dtype, device=depth.device)
    gy = torch.zeros_like(gx)
    for i in range(3):
        for j in range(3):
            win = padded[:, i:i + h, j:j + w]
            if _SOBEL_X[i][j]:
                gx = gx + win * (_SOBEL_X[i][j] / 8.0)
            if _SOBEL_Y[i][j]:
                gy = gy + win * (_SOBEL_Y[i][j] / 8.0)
    grads = (gx ** 2 + gy ** 2)[..., None]
    if valid_mask is not None:
        grads = grads * valid_mask.to(grads.dtype)
    return grads


def adjoint_resize(grad_map: torch.Tensor, out_size: Tuple[int, int]
                   ) -> torch.Tensor:
    """Exact adjoint of the bilinear resize from ``out_size`` up to the
    map's size: sum(resize(m) * G) == sum(m * adjoint_resize(G)).
    grad_map (..., H, W) -> (..., out_size[0], out_size[1])."""
    h, w = grad_map.shape[-2:]
    wh = _resize_weights(out_size[0], h, grad_map.device)   # (oh, h)
    ww = _resize_weights(out_size[1], w, grad_map.device)   # (ow, w)
    return wh @ grad_map @ ww.t()


def center_of_mass(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mass centres (cx, cy) of (..., H, W) float masks."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    m00 = masks.sum((-2, -1)).clamp(min=1e-6)
    m10 = (masks * xs).sum((-2, -1))
    m01 = (masks * ys[:, None]).sum((-2, -1))
    return m10 / m00, m01 / m00


def _prepare_level(boxes, labels, gt_valid, mask_sums, cx, cy, img_hw,
                   num_grid, scale_range, sigma, num_classes, max_positives):
    """One level's fixed-capacity GT assignment for a batch: the
    scale-range gate on sqrt(box area), the mass-centre cell, and the
    sigma-shrunk centre box clamped to the centre cell +-1.

    Returns cate_label (B, G*G) int64 (background = num_classes), ins_ind
    (B, G*G) bool, and per positive slot pos_cell, pos_inst (B, P) int64
    and pos_valid (B, P) bool.
    """
    h, w = img_hw
    bsz, n = boxes.shape[:2]
    lo, hi = scale_range
    g = num_grid
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    areas = torch.sqrt((bw * bh).clamp(min=0.0))
    hit = gt_valid & (areas >= lo) & (areas <= hi) & (mask_sums > 0)
    half_w = 0.5 * bw * sigma
    half_h = 0.5 * bh * sigma

    def cell(v, size):
        return torch.floor((v / size) * g).long()

    coord_w, coord_h = cell(cx, w), cell(cy, h)
    top = torch.maximum(cell(cy - half_h, h).clamp(min=0), coord_h - 1)
    down = torch.minimum(cell(cy + half_h, h).clamp(max=g - 1), coord_h + 1)
    left = torch.maximum(cell(cx - half_w, w).clamp(min=0), coord_w - 1)
    right = torch.minimum(cell(cx + half_w, w).clamp(max=g - 1), coord_w + 1)

    # Every candidate cell lies in the 3x3 window around the centre cell.
    d = torch.tensor([-1, 0, 1], device=boxes.device)
    ci = (coord_h[..., None, None] + d[:, None]).expand(bsz, n, 3, 3)
    cj = (coord_w[..., None, None] + d[None, :]).expand(bsz, n, 3, 3)

    def win(t):
        return t[..., None, None]

    ok = (win(hit) & (ci >= win(top)) & (ci <= win(down))
          & (cj >= win(left)) & (cj <= win(right)))
    cells = (ci * g + cj).reshape(bsz, n * 9)
    slot_valid = ok.reshape(bsz, n * 9)
    slot_inst = torch.arange(n, device=boxes.device).repeat_interleave(9)

    # A single foreground class: the order of duplicate writes is moot.
    dropped = torch.where(slot_valid, cells, g * g)
    cate_label = torch.full((bsz, g * g + 1), num_classes, dtype=torch.long,
                            device=boxes.device)
    cate_label.scatter_(1, dropped, labels.long().repeat_interleave(9, dim=1))
    ins_ind = torch.zeros((bsz, g * g + 1), dtype=torch.bool,
                          device=boxes.device)
    ins_ind.scatter_(1, dropped, True)

    # Compact the (N*9) slot table to max_positives slots, keeping instance
    # order (the scores are distinct, so the selection is stable).
    order_score = (slot_valid.long() * (2 * n * 9)
                   - torch.arange(n * 9, device=boxes.device))
    sel = torch.topk(order_score, max_positives, dim=1).indices
    pos_cell = torch.gather(cells, 1, sel)
    pos_inst = slot_inst[sel]
    pos_valid = torch.gather(slot_valid, 1, sel)
    # An invalid slot's window cell may lie off the grid (an edge-centred
    # instance gated out of this level); its gather in compute_losses would
    # then read outside the level, and although the slot is masked, a NaN
    # there poisons the whole backward. Sanitise it to cell 0.
    pos_cell = torch.where(pos_valid, pos_cell, 0)
    return (cate_label[:, :g * g], ins_ind[:, :g * g], pos_cell, pos_inst,
            pos_valid)


def prepare_ground_truth(cfg: PlaneRecNetConfig, boxes: torch.Tensor,
                         labels: torch.Tensor, gt_valid: torch.Tensor,
                         masks: torch.Tensor, num_levels: int) -> Dict:
    """Batched GT preparation over the instance levels.

    boxes (B, N, 4) xyxy in input pixels; labels (B, N); gt_valid (B, N)
    bool; masks (B, N, H, W) binary. Returns per-level lists
    ``cate_labels`` (B, S^2), ``ins_inds`` (B, S^2), ``pos_cells``,
    ``pos_insts``, ``pos_valids`` (B, P), and ``masks4`` (B, N, H/4, W/4),
    the masks rescaled as cv2's INTER_LINEAR does on uint8 (half up:
    floor(x + 0.5)).
    """
    sv = cfg.solov2
    b, n, h, w = masks.shape
    masksf = masks.float()
    mask_sums = masksf.sum((2, 3))
    cx, cy = center_of_mass(masksf)
    masks4 = resize_bilinear(masksf.reshape(b * n, 1, h, w), (h // 4, w // 4))
    masks4 = torch.floor(masks4 + 0.5).reshape(b, n, h // 4, w // 4)

    out = {"cate_labels": [], "ins_inds": [], "pos_cells": [],
           "pos_insts": [], "pos_valids": [], "masks4": masks4}
    for lvl in range(num_levels):
        level = _prepare_level(
            boxes.float(), labels, gt_valid.bool(), mask_sums, cx, cy, (h, w),
            sv.num_grids[lvl], tuple(sv.fpn_scale_ranges[lvl]), sv.sigma,
            cfg.num_classes, cfg.max_positives)
        for key, value in zip(("cate_labels", "ins_inds", "pos_cells",
                               "pos_insts", "pos_valids"), level):
            out[key].append(value)
    return out


def _lava_valid_mask(cfg: PlaneRecNetConfig, gt_depths: torch.Tensor):
    """The lava loss's valid region. The reference tests the names
    'ScanNet' and 'Stanford 2D3DS', which no dataset preset has
    ('ScanNetDataset', 'S2D3DSDataset'), so in its published runs, and
    here, neither branch fires."""
    if cfg.dataset.name == "ScanNet":
        vm = torch.zeros_like(gt_depths)
        vm[:, 20:-20, 20:-20, :] = 1.0
        return vm
    if cfg.dataset.name == "Stanford 2D3DS":
        invalid = (gt_depths <= 0).float().permute(0, 3, 1, 2)
        return 1.0 - F.max_pool2d(invalid, 5, stride=1,
                                  padding=2).permute(0, 2, 3, 1)
    return None


def compute_losses(cfg: PlaneRecNetConfig, preds: Dict, batch: Dict,
                   vnl_indices: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False,
                   mesh=None) -> Dict[str, torch.Tensor]:
    """Weighted loss dict: ins, cat, dpt [, pln] [, lav].

    ``preds`` is the model's raw-pred dict, ``batch`` the dense GT batch.
    The VNL loss samples its triplets with ``generator``, unless
    ``vnl_indices`` (as ``losses.vnl.sample_vnl_indices`` returns them, for
    the first ``vnl_max_planes`` valid planes) are given.
    ``deterministic`` sends the fused dice/lava loss to its kernels'
    fixed-order variants.

    With a ``mesh`` (``parallel/mesh.py``), ``batch`` is this rank's rows
    of the global batch, and each loss is this rank's
    share of the global batch's: its sums over the global normalisers
    (the dice and focal counts, the lava images, the batch size), so that
    the losses, and their gradients, summed over the ranks are the
    global batch's. The VNL triplets are drawn for the global batch and
    this rank's rows kept.
    """
    cate_preds: List[torch.Tensor] = preds["cate_preds"]
    kernel_preds: List[torch.Tensor] = preds["kernel_preds"]
    mask_pred = preds["mask_pred"].float()                  # (B, Hm, Wm, K)
    depth_pred = preds["depth_pred"].float()                # (B, H/2, W/2, 1)
    gt_masks = batch["masks"]
    gt_valid = batch["gt_valid"].bool()
    gt_depths = batch["depth"].float()

    num_levels = len(cate_preds)
    b, hm, wm, n_k = mask_pred.shape
    losses: Dict[str, torch.Tensor] = {}
    gt = prepare_ground_truth(cfg, batch["boxes"], batch["classes"], gt_valid,
                              gt_masks, num_levels)
    targets_flat = gt["masks4"].reshape(b, -1, hm * wm)     # (B, N, Hm*Wm)
    n_inst = targets_flat.shape[1]
    target_areas = targets_flat.sum(2)                      # sum t^2 = sum t

    need_lava = cfg.use_lava_loss
    if need_lava:
        grad = compute_gradient_map(gt_depths,
                                    _lava_valid_mask(cfg, gt_depths))
        depth_res = cfg.dataset.depth_resolution or 1e-3
        grad = grad / gt_depths.clamp(min=depth_res) ** 2
        grad = grad.clamp(max=1e-2)
        grad = torch.where(grad < 1e-4, 0.0, grad)[..., 0].detach()
        grad_low_flat = adjoint_resize(grad, (hm, wm)).reshape(b, hm * wm)
        grad_sum = grad.sum((1, 2))
    else:
        grad_low_flat = torch.zeros((b, hm * wm), device=mask_pred.device)

    dice_sum = dice_cnt = num_ins = 0.0
    lava_dot = torch.zeros(b, device=mask_pred.device)
    lava_cnt = torch.zeros(b, device=mask_pred.device)
    mask_flat = mask_pred.reshape(b, hm * wm, n_k)
    for lvl in range(num_levels):
        kp = kernel_preds[lvl].float().reshape(b, -1, n_k)
        cells = gt["pos_cells"][lvl]
        insts = gt["pos_insts"][lvl]
        pvalid = gt["pos_valids"][lvl].float()
        k_sel = torch.gather(kp, 1, cells[..., None].expand(-1, -1, n_k))
        onehot = F.one_hot(insts, n_inst).float() * pvalid[..., None]
        a, bb, dots = fused_dice_lava(k_sel, mask_flat, onehot, targets_flat,
                                      grad_low_flat, deterministic)
        c = torch.gather(target_areas, 1, insts)
        d = 1.0 - (2 * a) / ((bb + 0.001) + (c + 0.001))
        dice_sum = dice_sum + (d * pvalid).sum()
        dice_cnt = dice_cnt + pvalid.sum()
        if need_lava:
            lava_dot = lava_dot + (dots * pvalid).sum(1)
            lava_cnt = lava_cnt + pvalid.sum(1)
        num_ins = num_ins + gt["ins_inds"][lvl].float().sum()
    if need_lava:
        contrib = (lava_cnt > 0) & (grad_sum > 0)
        n_contrib = contrib.float().sum()
    world, first = (1, 0) if mesh is None else (mesh.size, mesh.rank * b)
    if world > 1:
        counts = mesh.all_sum(torch.stack(
            [dice_cnt, num_ins, n_contrib if need_lava else dice_cnt]))
        dice_cnt, num_ins, n_contrib = counts.unbind()
    losses["ins"] = cfg.dice_weight * dice_sum / dice_cnt.clamp(min=1.0)

    flat_logits = torch.cat([cp.float().reshape(b, -1, cfg.num_classes)
                             for cp in cate_preds], dim=1
                            ).reshape(-1, cfg.num_classes)
    flat_labels = torch.cat(gt["cate_labels"], dim=1).reshape(-1)
    pos = flat_labels != cfg.num_classes
    oh = (F.one_hot(torch.where(pos, flat_labels, 0), cfg.num_classes).float()
          * pos[:, None])
    focal = sigmoid_focal_loss(flat_logits, oh, alpha=cfg.focal_alpha,
                               gamma=cfg.focal_gamma)
    losses["cat"] = cfg.focal_weight * focal.sum() / (num_ins + 1.0)

    h, w = gt_depths.shape[1:3]
    depth_up = resize_bilinear(depth_pred.permute(0, 3, 1, 2), (h, w)
                               ).permute(0, 2, 3, 1)        # (B, H, W, 1)
    min_depth = cfg.dataset.min_depth or 1e-3
    losses["dpt"] = cfg.depth_weight * rmse_log_loss(
        depth_up, gt_depths, gt_depths > min_depth).sum() / (b * world)

    if cfg.use_plane_loss:
        # The first vnl_max_planes VALID planes; the non-planar region
        # comes from the full GT set, so capped planes are unsampled, not
        # non-planar.
        vp = min(cfg.vnl_max_planes, gt_masks.shape[1])
        order = torch.argsort((~gt_valid).int(), dim=1, stable=True)[:, :vp]
        masks_bool = gt_masks.bool()
        vnl_masks = masks_bool[torch.arange(b, device=order.device)[:, None],
                               order]
        vnl_normals = torch.gather(batch["plane_paras"][..., :3].float(), 1,
                                   order[..., None].expand(-1, -1, 3))
        vnl_valid = torch.gather(gt_valid, 1, order)
        if vnl_indices is None:
            full_np = ~(masks_bool & gt_valid[:, :, None, None]).any(1)
            vnl_indices = sample_vnl_indices(generator, vnl_masks,
                                             full_np.reshape(b, -1),
                                             cfg.vnl_samples,
                                             rows=(first, b * world))
        pln = vnl_loss_from_indices(depth_up[..., 0], gt_depths[..., 0],
                                    batch["k_matrix"].float(), vnl_normals,
                                    vnl_valid, vnl_indices)
        losses["pln"] = cfg.pln_weight * pln.sum() / (b * world)

    if need_lava:
        per_img = lava_dot / (grad_sum * lava_cnt).clamp(min=1e-12)
        lava = torch.where(contrib, per_img, 0.0).sum() / n_contrib.clamp(
            min=1.0)
        losses["lav"] = cfg.lava_weight * lava
    return losses
