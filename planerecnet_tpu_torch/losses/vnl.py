"""Plane-surface-normal (VNL) loss.

Counterpart of ``planerecnet_tpu/losses/vnl.py::vnl_loss_single``, batched
over images. Every plane of an image gets ``num_samples`` point triplets
drawn uniformly over its mask pixels, with replacement; the triplets'
normals in the predicted depth's point cloud are held against the plane's
normal (1 - |cos|), the easiest quarter of the valid triplets is dropped,
and the non-planar region adds one more term comparing the predicted and
the GT point clouds' normals.

The loss is split into a sampler, ``sample_vnl_indices`` (an exact inverse
CDF over the mask with a ``torch.Generator``: the ``u``-th set pixel for a
uniform integer ``u``), and an index-driven body, ``vnl_loss_from_indices``,
as the JAX package splits ``vnl_loss_ori`` at ``_vnl_ori_from_indices``. The
two packages' random streams differ, so the tests feed the port the
indices that JAX's sampler drew.

The JAX package's documented divergences from the reference hold here too:
a fixed sample count per plane; 0 (not NaN) for a plane with no valid
triplet; the intended z-clamp of predicted points at depth 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# Triplet filter thresholds of the reference (vnl.py:76-104).
DELTA_Z = 1e-4
DELTA_COS = 0.985
DELTA_DIFF_PLANE = 0.005
DELTA_DIFF_NONPLANAR = 0.1


def _sample_mask_indices(generator: Optional[torch.Generator],
                         masks_flat: torch.Tensor, num: int,
                         rows: Optional[Tuple[int, int]] = None):
    """Uniform flat pixel ids of each row's set pixels, with replacement.
    masks_flat (B, ..., HW) bool -> (ids (B, ..., num) int64, ok (B, ...)
    bool); ok is False for an empty mask (its ids are then HW - 1). With
    ``rows = (first, total)`` the B images are rows first..first+B-1 of a
    batch of ``total``: the draws are the whole batch's, and these rows'
    are kept, so that every split of a batch draws what the whole does."""
    cdf = torch.cumsum(masks_flat.long(), dim=-1)
    total = cdf[..., -1:]
    b = masks_flat.shape[0]
    first, n_rows = rows or (0, b)
    r = torch.rand((n_rows,) + masks_flat.shape[1:-1] + (num,),
                   generator=generator, dtype=torch.float64,
                   device=masks_flat.device)[first:first + b]
    u = torch.minimum((r * total).floor().long() + 1, total.clamp(min=1))
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    return idx.clamp(max=masks_flat.shape[-1] - 1), total[..., 0] > 0


def sample_vnl_indices(generator: Optional[torch.Generator],
                       plane_masks: torch.Tensor, nonplanar: torch.Tensor,
                       num_samples: int,
                       rows: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Triplet pixel ids for ``vnl_loss_from_indices``.

    plane_masks (B, NP, H, W) bool; nonplanar (B, H*W) bool. Returns
    ``plane_idx`` (B, NP, 3, M), ``plane_ok`` (B, NP), ``np_idx``
    (B, 3, M), ``np_ok`` (B,), M = num_samples. ``rows`` as
    ``_sample_mask_indices`` takes it (a data-parallel rank's rows).
    """
    b, n = plane_masks.shape[:2]
    idx, ok = _sample_mask_indices(generator, plane_masks.reshape(b, n, -1),
                                   3 * num_samples, rows)
    np_idx, np_ok = _sample_mask_indices(generator, nonplanar,
                                         3 * num_samples, rows)
    return {"plane_idx": idx.reshape(b, n, 3, num_samples), "plane_ok": ok,
            "np_idx": np_idx.reshape(b, 3, num_samples), "np_ok": np_ok}


def _form_triplets(depth_flat, idx, fx, fy, u0, v0, w):
    """Back-project the depths at flat ids ``idx`` (B, ..., 3, M):
    x = (u - u0)|d|/fx, y = (v - v0)|d|/fy, z = d.
    Returns (B, ..., M, 3xyz, 3pts)."""
    b = depth_flat.shape[0]
    d = torch.gather(depth_flat, 1, idx.reshape(b, -1)).reshape(idx.shape)
    view = (b,) + (1,) * (idx.dim() - 1)
    ad = d.abs()
    u = (idx % w).float() - u0
    v = torch.div(idx, w, rounding_mode="floor").float() - v0
    pw = torch.stack([u * ad / fx.view(view), v * ad / fy.view(view), d],
                     dim=-2)                          # (..., 3pts, 3xyz, M)
    return pw.permute(*range(pw.dim() - 3), -1, -2, -3)


def _filter_mask(pw, delta_z, delta_cos=DELTA_COS,
                 delta_diff=DELTA_DIFF_PLANE):
    """Triplet validity from detached (..., M, 3xyz, 3pts) points: no
    near-collinear triplet, every depth above ``delta_z``, not degenerate
    in all three axes."""
    pw = pw.detach()
    pw_diff = torch.stack([pw[..., 1] - pw[..., 0], pw[..., 2] - pw[..., 0],
                           pw[..., 2] - pw[..., 1]], dim=-1)  # (..., 3xyz, 3)
    q = pw_diff.transpose(-1, -2)                             # (..., 3, 3xyz)
    qn = torch.linalg.vector_norm(q, dim=-1)
    nm = qn[..., :, None] * qn[..., None, :]
    energy = torch.einsum("...ik,...jk->...ij", q, q)
    norm_energy = energy / (nm + 1e-8)
    mask_cos = ((norm_energy > delta_cos) | (norm_energy < -delta_cos)
                ).sum(dim=(-2, -1)) > 3
    mask_pad = (pw[..., 2, :] > delta_z).sum(dim=-1) == 3
    near = pw_diff.abs() < delta_diff
    degenerate = (near[..., 0, :].any(-1) & near[..., 1, :].any(-1)
                  & near[..., 2, :].any(-1))
    return mask_pad & ~(degenerate | mask_cos)


def _safe_norm(x, dim, keepdim=False, eps=1e-12):
    """A norm whose gradient is finite at the zero vector."""
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim) + eps)


def _normals(pw):
    """Unit normals of (..., M, 3xyz, 3pts) triplets -> (..., M, 3)."""
    normal = torch.linalg.cross(pw[..., 1] - pw[..., 0],
                                pw[..., 2] - pw[..., 0], dim=-1)
    norm = _safe_norm(normal, -1, keepdim=True)
    norm = norm + (norm < 1e-5).float() * 0.01
    return normal / norm


def _cos_abs(a, b):
    num = (a * b).sum(-1)
    den = _safe_norm(a, -1) * _safe_norm(b, -1)
    return (num / den.clamp(min=1e-8)).abs()


def _hardest75_mean(loss, valid):
    """Mean of the hardest 75% of the valid losses along the last axis
    (ascending sort, drop the first quarter); 0 where none is valid. The
    selection is made on a detached key."""
    n_valid = valid.sum(-1)
    keep = n_valid - torch.div(n_valid, 4, rounding_mode="floor")
    key = torch.where(valid, loss, torch.full_like(loss, -1e30)).detach()
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    ranked = torch.gather(loss, -1, order)
    sel = torch.arange(loss.shape[-1], device=loss.device) < keep[..., None]
    total = (ranked * sel).sum(-1)
    return torch.where(keep > 0, total / keep.clamp(min=1), 0.0)


def vnl_loss_from_indices(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                          k_matrix: torch.Tensor,
                          plane_normals: torch.Tensor,
                          plane_valid: torch.Tensor,
                          indices: Dict[str, torch.Tensor],
                          delta_z: float = DELTA_Z) -> torch.Tensor:
    """Per-image VNL loss (B,) from sampled triplet ids.

    pred_depth, gt_depth (B, H, W); k_matrix (B, 3, 3); plane_normals
    (B, NP, 3); plane_valid (B, NP) bool; ``indices`` as
    ``sample_vnl_indices`` returns them.
    """
    b, h, w = pred_depth.shape
    fx, fy = k_matrix[:, 0, 0], k_matrix[:, 1, 1]
    u0, v0 = w // 2, h // 2
    pred_flat = pred_depth.reshape(b, -1)
    gt_flat = gt_depth.reshape(b, -1)

    pw = _form_triplets(pred_flat, indices["plane_idx"], fx, fy, u0, v0, w)
    ok = indices["plane_ok"] & plane_valid                       # (B, NP)
    tri_valid = _filter_mask(pw, delta_z) & ok[..., None]
    loss = 1.0 - _cos_abs(_normals(pw), plane_normals[:, :, None, :])
    plane_losses = _hardest75_mean(loss, tri_valid)
    n_planes = ok.float().sum(-1)
    losses_sum = torch.where(ok, plane_losses, 0.0).sum(-1)

    np_idx, np_ok = indices["np_idx"], indices["np_ok"]
    pw_gt = _form_triplets(gt_flat, np_idx, fx, fy, u0, v0, w)
    tri_valid = (_filter_mask(pw_gt, delta_z,
                              delta_diff=DELTA_DIFF_NONPLANAR)
                 & np_ok[:, None])
    pw_pred = _form_triplets(pred_flat, np_idx, fx, fy, u0, v0, w)
    z = pw_pred[..., 2, :]
    pw_pred = torch.cat([pw_pred[..., :2, :],
                         torch.where(z == 0, 1e-4, z)[..., None, :]], dim=-2)
    np_loss = _hardest75_mean(
        1.0 - _cos_abs(_normals(pw_pred), _normals(pw_gt)), tri_valid)

    has_np = np_ok & (tri_valid.sum(-1) > 0)
    with_np = (losses_sum + np_loss) / (n_planes + 1.0).clamp(min=1.0)
    without = losses_sum / n_planes.clamp(min=1.0)
    return torch.where(has_np, with_np, without)
