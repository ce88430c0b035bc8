"""Depth and point-cloud geometry: back-projection, GeoNet least-squares
surface normals, PCA plane fitting and the point-to-plane error.

Counterpart of ``planerecnet_tpu/ops/geometry.py``, NHWC at the public
functions as there. Everything stays on the tensors' device, the batched
3x3 determinants and solves included (``torch.linalg``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def get_points_coordinate(depth: torch.Tensor,
                          intrinsic_inv: torch.Tensor) -> torch.Tensor:
    """Back-project (B, H, W, 1) depth to (B, H, W, 3) camera-space points
    with the (B, 3, 3) inverse intrinsics."""
    b, h, w, _ = depth.shape
    x = torch.arange(w, dtype=torch.float32, device=depth.device)
    y = torch.arange(h, dtype=torch.float32, device=depth.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    xy1 = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, -1)
    rays = torch.einsum("bij,jp->bip", intrinsic_inv.float(), xy1)
    pts = rays * depth.float().reshape(b, 1, -1)
    return pts.reshape(b, 3, h, w).permute(0, 2, 3, 1)


def _unfold_5x5_dilated2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 25, C): the 5x5 dilation-2 neighbourhood
    of each pixel, zero outside the image (GeoNet's
    ``F.unfold(kernel=5, padding=4, dilation=2)``, channels last)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 4, 4, 4, 4))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(0, 10, 2) for dx in range(0, 10, 2)],
                       dim=3)


def get_surface_normal(point_clouds: torch.Tensor,
                       valid_condition: torch.Tensor) -> torch.Tensor:
    """Per-pixel least-squares surface normals (GeoNet).

    point_clouds (B, H, W, 3) camera-space points; valid_condition
    (B, H, W, 1) validity (e.g. depth > 0). Returns (B, H, W, 3) unit
    normals. A pixel whose system is near-singular (det < 1e-5) is solved
    with the identity instead, as the reference gates it.
    """
    a = _unfold_5x5_dilated2(point_clouds.float())            # (B,H,W,25,3)
    valid = _unfold_5x5_dilated2(valid_condition.float()) > 0.5
    a_valid = torch.where(valid, a, 0.0)
    # The reference solves A^T (A_valid) n = A^T 1: its masked transpose is
    # overwritten by the unmasked one. Kept, as the JAX package keeps it.
    ata = torch.einsum("bhwki,bhwkj->bhwij", a, a_valid)      # (B,H,W,3,3)
    atb = a.sum(3)[..., None]                                 # (B,H,W,3,1)
    det = torch.linalg.det(ata)
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device).expand_as(ata)
    safe = torch.where((det >= 1e-5)[..., None, None], ata, eye)
    normal = torch.linalg.solve(safe, atb)[..., 0]            # (B,H,W,3)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return normal / norm.clamp(min=1e-12)


def pca_svd(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares plane fit of (N, 3) points: (centroid, unit normal),
    the normal being the scatter matrix's smallest singular vector (its
    sign is the solver's)."""
    mean = pts.mean(0)
    adj = pts - mean
    u, _, _ = torch.linalg.svd(adj.T @ adj)
    return mean, u[:, 2]


def point_to_plane_error(points: torch.Tensor, mask: torch.Tensor,
                         normal: torch.Tensor, offset) -> torch.Tensor:
    """Mean |p . n - d| over the masked points of positive depth: the
    dataset's geometric-consistency statistic. points (H, W, 3), mask
    (H, W) bool, normal (3,), offset a scalar."""
    m = mask.bool() & (points[..., 2] > 0)
    dist = (points @ normal.to(points.dtype)
            - torch.as_tensor(offset, dtype=points.dtype,
                              device=points.device)).abs()
    return torch.where(m, dist, 0.0).sum() / m.sum().clamp(min=1)
