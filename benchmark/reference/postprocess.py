"""SOLOv2 post-processing in plain PyTorch: the yardstick of a request.

The upstream ``PlaneRecNet`` inference after the network, in the
fixed-capacity form the program documents: point NMS (a cell survives iff
it is the maximum of the 2x2 window over itself and its up/left
neighbours), candidates above ``score_thr`` (at most ``max_candidates``,
by score, lower index first among ties), one matmul for their masks,
the stride area filter, maskness rescoring, the first ``nms_pre``, matrix
NMS (gaussian), ``update_thr``, the first ``top_k``, the soft masks resized
to the frame and thresholded at ``mask_thr``, boxes from the mask extents,
and the depth resized to the frame. Every sort is stable and descending.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.model import resize


def _top(scores, valid, k):
    s = torch.where(valid, scores, float("-inf"))
    top, idx = torch.sort(s, descending=True, stable=True)
    return idx[:k], torch.isfinite(top[:k])


def _matrix_nms(labels, seg, sums, scores, valid, sigma):
    n = scores.shape[0]
    m = seg.float() * valid[:, None]
    inter = m @ m.T
    areas = torch.where(valid, sums, 0.0)
    union = areas[None, :] + areas[:, None] - inter
    upper = torch.triu(torch.ones((n, n), device=scores.device), 1)
    iou = torch.where(union > 0, inter / union, 0.0) * upper
    same = ((labels[None, :] == labels[:, None]).float() * upper
            * (valid[None, :] & valid[:, None]).float())
    decay = iou * same
    comp = decay.max(0).values
    coeff = (torch.exp(-sigma * decay ** 2)
             / torch.exp(-sigma * comp[:, None] ** 2)).min(0).values
    return torch.where(valid, scores * coeff, 0.0)


def one_image(cate, kern, feat, depth, cfg: Dict, size, strides):
    sv = cfg["solov2"]
    cap = sv["max_candidates"]
    dev = cate.device
    cells, ncls = cate.shape
    hm, wm, nk = feat.shape
    flat = cate.reshape(-1)
    cell_id = torch.arange(cells, device=dev).repeat_interleave(ncls)
    cls_id = torch.arange(ncls, device=dev).repeat(cells)
    idx, valid = _top(flat, flat > sv["score_thr"], cap)
    scores, labels, cell = flat[idx], cls_id[idx], cell_id[idx]
    seg = torch.sigmoid(kern[cell].float() @ feat.reshape(-1, nk).float().T)
    binm = seg > sv["mask_thr"]
    sums = binm.sum(1).float()
    valid = valid & (sums > strides[cell])
    scores = scores * (seg * binm).sum(1) / sums.clamp(min=1.0)
    order, _ = _top(scores, valid, cap)
    scores, labels, seg, binm, sums, valid = (
        t[order] for t in (scores, labels, seg, binm, sums, valid))
    valid = valid & (torch.arange(cap, device=dev) < sv["nms_pre"])
    if sv["nms_type"] != "matrix" or sv["nms_kernel"] != "gaussian":
        raise NotImplementedError("the yardstick has gaussian matrix NMS")
    scores = _matrix_nms(labels, binm, sums, scores, valid, sv["nms_sigma"])
    valid = valid & (scores >= sv["update_thr"])
    order, ok = _top(scores, valid, min(sv["top_k"], cap))
    scores, labels, seg = scores[order], labels[order], seg[order]
    valid = valid[order] & ok
    h, w = size
    masks = resize(seg.reshape(-1, 1, hm, wm), (h, w))[:, 0]
    masks = (masks > sv["mask_thr"]) & valid[:, None, None]
    ax, ay = masks.any(1), masks.any(2)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None]
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None]
    boxes = torch.stack([torch.where(ax, xs, 1e9).min(1).values,
                         torch.where(ay, ys, 1e9).min(1).values,
                         torch.where(ax, xs, -1e9).max(1).values,
                         torch.where(ay, ys, -1e9).max(1).values], -1)
    return {"pred_masks": masks,
            "pred_scores": torch.where(valid, scores, 0.0),
            "pred_classes": labels.to(torch.int32),
            "pred_boxes": torch.where(valid[:, None], boxes, 0.0),
            "pred_valid": valid,
            "pred_depth": resize(depth.permute(2, 0, 1)[None].float(),
                                 (h, w))[0, 0]}


def postprocess(preds: Dict, cfg: Dict, size) -> Dict[str, torch.Tensor]:
    """Raw predictions (the network's layouts) -> per-frame outputs with a
    leading batch dimension."""
    sv = cfg["solov2"]
    cates, kerns = [], []
    levels = len(preds["cate_preds"])
    b = preds["cate_preds"][0].shape[0]
    for cp, kp in zip(preds["cate_preds"], preds["kernel_preds"]):
        h = torch.sigmoid(cp.float()).permute(0, 3, 1, 2)
        peak = F.max_pool2d(h, 2, stride=1, padding=1)[:, :, :-1, :-1]
        h = (h * (peak == h).float()).permute(0, 2, 3, 1)
        cates.append(h.reshape(b, -1, cfg["num_classes"]))
        kerns.append(kp.reshape(b, -1, sv["num_kernels"]))
    cate, kern = torch.cat(cates, 1), torch.cat(kerns, 1)
    strides = torch.cat([torch.full((s * s,), float(st))
                         for s, st in zip(sv["num_grids"][:levels],
                                          sv["fpn_instance_strides"][:levels])
                         ]).to(cate.device)
    outs = [one_image(cate[i], kern[i], preds["mask_pred"][i],
                      preds["depth_pred"][i], cfg, size, strides)
            for i in range(b)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
