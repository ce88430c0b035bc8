"""PlaneRecNet's joint training loss in plain PyTorch: the yardstick.

The upstream loss (SOLOv2's dice and sigmoid focal terms, RMSE of log
depth, the VNL plane loss and the lava loss) in the fixed-capacity form
that the program states in its documentation: every GT instance claims
the cells of its sigma-shrunk centre box within the 3x3 window around its
mass centre on each level, compacted to ``max_positives`` slots; the VNL
loss samples ``vnl_samples`` triplets over each of the first
``vnl_max_planes`` valid planes and over the non-planar region. Written
with plain tensor ops: the dice and lava sums are an einsum over every
pixel, differentiated by autograd; no custom kernel, nothing of the
program.

The VNL triplets are drawn from a ``torch.Generator`` that the caller
seeds as the program seeds its own (the same device, the same calls in
the same order give the same draws), so that both sides sample the same
pixels.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.model import resize

DELTA_Z = 1e-4
DELTA_COS = 0.985
DELTA_DIFF_PLANE = 0.005
DELTA_DIFF_NONPLANAR = 0.1
SOBEL_X = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
SOBEL_Y = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))


def gradient_map(depth):
    """Squared Sobel magnitude (kernels / 8) of (B, H, W) depth, reflect
    padded, as nine shifted f32 products."""
    b, h, w = depth.shape
    p = F.pad(depth[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    gx = torch.zeros_like(depth)
    gy = torch.zeros_like(depth)
    for i in range(3):
        for j in range(3):
            win = p[:, i:i + h, j:j + w]
            if SOBEL_X[i][j]:
                gx = gx + win * (SOBEL_X[i][j] / 8.0)
            if SOBEL_Y[i][j]:
                gy = gy + win * (SOBEL_Y[i][j] / 8.0)
    return gx ** 2 + gy ** 2


def prepare_level(boxes, labels, valid, mask_sums, cx, cy, hw, g, rng_, sigma,
                  num_classes, max_pos):
    h, w = hw
    b, n = boxes.shape[:2]
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    area = torch.sqrt((bw * bh).clamp(min=0.0))
    hit = valid & (area >= rng_[0]) & (area <= rng_[1]) & (mask_sums > 0)

    def cell(v, size):
        return torch.floor((v / size) * g).long()

    ch, cw = cell(cy, h), cell(cx, w)
    top = torch.maximum(cell(cy - 0.5 * bh * sigma, h).clamp(min=0), ch - 1)
    down = torch.minimum(cell(cy + 0.5 * bh * sigma, h).clamp(max=g - 1),
                         ch + 1)
    left = torch.maximum(cell(cx - 0.5 * bw * sigma, w).clamp(min=0), cw - 1)
    right = torch.minimum(cell(cx + 0.5 * bw * sigma, w).clamp(max=g - 1),
                          cw + 1)
    d = torch.tensor([-1, 0, 1], device=boxes.device)
    ci = (ch[..., None, None] + d[:, None]).expand(b, n, 3, 3)
    cj = (cw[..., None, None] + d[None, :]).expand(b, n, 3, 3)

    def e(t):
        return t[..., None, None]

    ok = (e(hit) & (ci >= e(top)) & (ci <= e(down)) & (cj >= e(left))
          & (cj <= e(right)))
    cells = (ci * g + cj).reshape(b, n * 9)
    slot_ok = ok.reshape(b, n * 9)
    slot_inst = torch.arange(n, device=boxes.device).repeat_interleave(9)
    dropped = torch.where(slot_ok, cells, g * g)
    label = torch.full((b, g * g + 1), num_classes, dtype=torch.long,
                       device=boxes.device)
    label.scatter_(1, dropped, labels.long().repeat_interleave(9, dim=1))
    ins = torch.zeros((b, g * g + 1), dtype=torch.bool, device=boxes.device)
    ins.scatter_(1, dropped, True)
    # The first max_pos valid slots, in slot order.
    key = slot_ok.long() * (2 * n * 9) - torch.arange(n * 9,
                                                      device=boxes.device)
    sel = torch.topk(key, max_pos, dim=1).indices
    pos_ok = torch.gather(slot_ok, 1, sel)
    pos_cell = torch.where(pos_ok, torch.gather(cells, 1, sel), 0)
    return label[:, :g * g], ins[:, :g * g], pos_cell, slot_inst[sel], pos_ok


def _sample(gen, masks_flat, num):
    cdf = torch.cumsum(masks_flat.long(), -1)
    total = cdf[..., -1:]
    r = torch.rand(masks_flat.shape[:-1] + (num,), generator=gen,
                   dtype=torch.float64, device=masks_flat.device)
    u = torch.minimum((r * total).floor().long() + 1, total.clamp(min=1))
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return idx.clamp(max=masks_flat.shape[-1] - 1), total[..., 0] > 0


def _points(depth_flat, idx, fx, fy, u0, v0, w):
    b = depth_flat.shape[0]
    d = torch.gather(depth_flat, 1, idx.reshape(b, -1)).reshape(idx.shape)
    view = (b,) + (1,) * (idx.dim() - 1)
    u = (idx % w).float() - u0
    v = torch.div(idx, w, rounding_mode="floor").float() - v0
    p = torch.stack([u * d.abs() / fx.view(view), v * d.abs() / fy.view(view),
                     d], -2)                        # (..., 3pts, 3xyz, M)
    return p.permute(*range(p.dim() - 3), -1, -2, -3)   # (..., M, xyz, pts)


def _valid_triplets(p, delta_diff):
    p = p.detach()
    diff = torch.stack([p[..., 1] - p[..., 0], p[..., 2] - p[..., 0],
                        p[..., 2] - p[..., 1]], -1)
    q = diff.transpose(-1, -2)
    qn = torch.linalg.vector_norm(q, dim=-1)
    cos = torch.einsum("...ik,...jk->...ij", q, q) / (
        qn[..., :, None] * qn[..., None, :] + 1e-8)
    collinear = ((cos > DELTA_COS) | (cos < -DELTA_COS)).sum((-2, -1)) > 3
    in_front = (p[..., 2, :] > DELTA_Z).sum(-1) == 3
    near = diff.abs() < delta_diff
    flat = near[..., 0, :].any(-1) & near[..., 1, :].any(-1) \
        & near[..., 2, :].any(-1)
    return in_front & ~(flat | collinear)


def _norm(x, keepdim=False):
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim) + 1e-12)


def _normal(p):
    n = torch.linalg.cross(p[..., 1] - p[..., 0], p[..., 2] - p[..., 0],
                           dim=-1)
    m = _norm(n, True)
    return n / (m + (m < 1e-5).float() * 0.01)


def _abs_cos(a, b):
    return ((a * b).sum(-1) / (_norm(a) * _norm(b)).clamp(min=1e-8)).abs()


def _hardest_75(loss, valid):
    n = valid.sum(-1)
    keep = n - torch.div(n, 4, rounding_mode="floor")
    key = torch.where(valid, loss, torch.full_like(loss, -1e30)).detach()
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    ranked = torch.gather(loss, -1, order)
    sel = torch.arange(loss.shape[-1], device=loss.device) < keep[..., None]
    return torch.where(keep > 0, (ranked * sel).sum(-1) / keep.clamp(min=1),
                       0.0)


def vnl_loss(pred, gt, k, normals, plane_valid, plane_masks, nonplanar, num,
             gen):
    b, h, w = pred.shape
    np_ = plane_masks.shape[1]
    idx, ok = _sample(gen, plane_masks.reshape(b, np_, -1), 3 * num)
    idx = idx.reshape(b, np_, 3, num)
    nidx, nok = _sample(gen, nonplanar, 3 * num)
    nidx = nidx.reshape(b, 3, num)
    fx, fy = k[:, 0, 0], k[:, 1, 1]
    u0, v0 = w // 2, h // 2
    pf, gf = pred.reshape(b, -1), gt.reshape(b, -1)
    pw = _points(pf, idx, fx, fy, u0, v0, w)
    ok = ok & plane_valid
    tv = _valid_triplets(pw, DELTA_DIFF_PLANE) & ok[..., None]
    per_plane = _hardest_75(1.0 - _abs_cos(_normal(pw), normals[:, :, None]),
                            tv)
    total = torch.where(ok, per_plane, 0.0).sum(-1)
    n_planes = ok.float().sum(-1)
    pg = _points(gf, nidx, fx, fy, u0, v0, w)
    tv = _valid_triplets(pg, DELTA_DIFF_NONPLANAR) & nok[:, None]
    pp = _points(pf, nidx, fx, fy, u0, v0, w)
    z = pp[..., 2, :]
    pp = torch.cat([pp[..., :2, :],
                    torch.where(z == 0, 1e-4, z)[..., None, :]], -2)
    np_loss = _hardest_75(1.0 - _abs_cos(_normal(pp), _normal(pg)), tv)
    has_np = nok & (tv.sum(-1) > 0)
    return torch.where(has_np, (total + np_loss) / (n_planes + 1.0),
                       total / n_planes.clamp(min=1.0))


def dice_lava_sums(kernels, feat, onehot, targets, grad_low):
    """(a, b, lava) per slot: sum sig*t, sum sig^2, sum sig*grad_low over
    every pixel, sig = sigmoid(kernels . feat), t the slot's target."""
    sig = torch.sigmoid(torch.einsum("bpk,bqk->bpq", kernels, feat))
    tgt = torch.einsum("bpn,bnq->bpq", onehot, targets)
    return ((sig * tgt).sum(2), (sig * sig).sum(2),
            torch.einsum("bpq,bq->bp", sig, grad_low))


def losses(cfg: Dict, preds: Dict, batch: Dict, gen: torch.Generator,
           checkpoint_sums: bool = False) -> Dict[str, torch.Tensor]:
    """Weighted losses {ins, cat, dpt[, pln][, lav]} of a dense batch:
    ``image`` (B, H, W, 3), ``depth`` (B, H, W) metres, ``masks`` (B, N,
    H, W) {0, 1}, ``boxes`` (B, N, 4) xyxy, ``classes``, ``gt_valid``,
    ``plane_paras`` (B, N, 4), ``k_matrix`` (B, 3, 3).
    ``checkpoint_sums`` recomputes the dice/lava sums in the backward
    (memory only)."""
    sv, ds = cfg["solov2"], cfg["dataset"]
    cates, kerns = preds["cate_preds"], preds["kernel_preds"]
    mask = preds["mask_pred"].float()
    depth_pred = preds["depth_pred"].float()
    masks, valid = batch["masks"], batch["gt_valid"].bool()
    depth = batch["depth"].float()
    levels = len(cates)
    b, hm, wm, nk = mask.shape
    n = masks.shape[1]
    h, w = masks.shape[-2:]
    mf = masks.float()
    sums = mf.sum((2, 3))
    ys = torch.arange(h, dtype=torch.float32, device=mf.device)
    xs = torch.arange(w, dtype=torch.float32, device=mf.device)
    m00 = sums.clamp(min=1e-6)
    cx = (mf * xs).sum((2, 3)) / m00
    cy = (mf * ys[:, None]).sum((2, 3)) / m00
    t4 = torch.floor(resize(mf.reshape(b * n, 1, h, w), (h // 4, w // 4))
                     + 0.5).reshape(b, n, hm * wm)
    areas = t4.sum(2)

    out = {}
    if cfg["use_lava_loss"]:
        res = ds["depth_resolution"] or 1e-3
        g = gradient_map(depth) / depth.clamp(min=res) ** 2
        g = g.clamp(max=1e-2)
        g = torch.where(g < 1e-4, 0.0, g)
        # sum(resize(m) * G) = sum(m * resize^T(G)): G pulled back by the
        # transpose of the bilinear resize from (hm, wm) up to (h, w).
        eye_h = torch.eye(hm, device=g.device)[None, None]
        eye_w = torch.eye(wm, device=g.device)[None, None]
        rh = resize(eye_h, (h, hm))[0, 0]          # (h, hm) up-rows
        rw = resize(eye_w, (wm, w))[0, 0]          # (wm, w)
        glow = (rh.t() @ g @ rw.t()).reshape(b, hm * wm)
        gsum = g.sum((1, 2))
    else:
        glow = torch.zeros((b, hm * wm), device=mask.device)
    feat = mask.reshape(b, hm * wm, nk)
    dsum = dcnt = nins = 0.0
    ldot = torch.zeros(b, device=mask.device)
    lcnt = torch.zeros(b, device=mask.device)
    for lv in range(levels):
        lab, ins, pcell, pinst, pok = prepare_level(
            batch["boxes"].float(), batch["classes"], valid, sums, cx, cy,
            (h, w), sv["num_grids"][lv], sv["fpn_scale_ranges"][lv],
            sv["sigma"], cfg["num_classes"], cfg["max_positives"])
        kp = kerns[lv].float().reshape(b, -1, nk)
        ksel = torch.gather(kp, 1, pcell[..., None].expand(-1, -1, nk))
        pv = pok.float()
        onehot = F.one_hot(pinst, n).float() * pv[..., None]
        if checkpoint_sums:
            a, bb, dots = torch.utils.checkpoint.checkpoint(
                dice_lava_sums, ksel, feat, onehot, t4, glow,
                use_reentrant=False)
        else:
            a, bb, dots = dice_lava_sums(ksel, feat, onehot, t4, glow)
        c = torch.gather(areas, 1, pinst)
        dl = 1.0 - 2 * a / ((bb + 0.001) + (c + 0.001))
        dsum = dsum + (dl * pv).sum()
        dcnt = dcnt + pv.sum()
        ldot = ldot + (dots * pv).sum(1)
        lcnt = lcnt + pv.sum(1)
        nins = nins + ins.float().sum()
        out.setdefault("_labels", []).append(lab)
    out["ins"] = cfg["dice_weight"] * dsum / dcnt.clamp(min=1.0)

    logits = torch.cat([cp.float().reshape(b, -1, cfg["num_classes"])
                        for cp in cates], 1).reshape(-1, cfg["num_classes"])
    labels = torch.cat(out.pop("_labels"), 1).reshape(-1)
    pos = labels != cfg["num_classes"]
    t = F.one_hot(torch.where(pos, labels, 0),
                  cfg["num_classes"]).float() * pos[:, None]
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * t
          + torch.log1p(torch.exp(-logits.abs())))
    pt = p * t + (1 - p) * (1 - t)
    al = cfg["focal_alpha"]
    focal = (al * t + (1 - al) * (1 - t)) * ce * (1 - pt) ** cfg["focal_gamma"]
    out["cat"] = cfg["focal_weight"] * focal.sum() / (nins + 1.0)

    up = resize(depth_pred.permute(0, 3, 1, 2), (h, w))[:, 0]   # (B, H, W)
    mind = ds["min_depth"] or 1e-3
    ok = (depth > mind).float().reshape(b, -1)
    l1 = (torch.log(up.clamp(min=1e-9)) - torch.log(depth.clamp(min=1e-9))
          ).abs().reshape(b, -1) * ok
    rmse = torch.sqrt((l1 ** 2).sum(1) / ok.sum(1).clamp(min=1.0) + 1e-12)
    out["dpt"] = cfg["depth_weight"] * rmse.sum() / b

    if cfg["use_plane_loss"]:
        vp = min(cfg["vnl_max_planes"], n)
        order = torch.argsort((~valid).int(), dim=1, stable=True)[:, :vp]
        mb = masks.bool()
        rows = torch.arange(b, device=order.device)[:, None]
        normals = torch.gather(batch["plane_paras"][..., :3].float(), 1,
                               order[..., None].expand(-1, -1, 3))
        nonplanar = ~(mb & valid[:, :, None, None]).any(1)
        pln = vnl_loss(up, depth, batch["k_matrix"].float(), normals,
                       torch.gather(valid, 1, order), mb[rows, order],
                       nonplanar.reshape(b, -1), cfg["vnl_samples"], gen)
        out["pln"] = cfg["pln_weight"] * pln.sum() / b

    if cfg["use_lava_loss"]:
        contrib = (lcnt > 0) & (gsum > 0)
        per = ldot / (gsum * lcnt).clamp(min=1e-12)
        out["lav"] = cfg["lava_weight"] * torch.where(contrib, per, 0.0).sum(
        ) / contrib.float().sum().clamp(min=1.0)
    return out
