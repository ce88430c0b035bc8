"""Dataset geometric-consistency checker.

Counterpart of ``tools/check_dataset.py``: iterates a split through the
training augmentation and reports, per image, the mean point-to-plane
distance between the GT plane parameters and the GT depth's point cloud,
an end-to-end check of annotations, intrinsics and depth scaling. The
back-projection and the distances run on the card unless ``--device cpu``
is passed.

Usage:
  python -m planerecnet_tpu_torch.tools.check_dataset \
      --config PlaneRecNet_50_config [--dataset scannet_dataset] \
      [--split valid] [--max_images N] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from planerecnet_tpu_torch.config import set_cfg, set_dataset
from planerecnet_tpu_torch.data import SSDAugmentation, build_dataset
from planerecnet_tpu_torch.ops.geometry import (get_points_coordinate,
                                                point_to_plane_error)
from planerecnet_tpu_torch.runner import resolve_device

SEED = 0        # of the augmentation's generator (the JAX tool's is unseeded)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the check; returns each image's mean point-to-plane error."""
    parser = argparse.ArgumentParser(description="Debugging datasets.")
    parser.add_argument("--dataset", default=None, type=str)
    parser.add_argument("--config", default="PlaneRecNet_50_config")
    parser.add_argument("--split", default="valid",
                        choices=["train", "valid", "eval"])
    parser.add_argument("--max_images", default=5000, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises where there is no "
                             "card) or cpu.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = set_cfg(args.config)
    if args.dataset is not None:
        cfg = set_dataset(cfg, args.dataset)
    print(cfg.backbone.name, cfg.backbone.path)
    dataset = build_dataset(cfg, args.split, transform=SSDAugmentation(
        cfg, rng=np.random.RandomState(SEED)))

    errors = []
    for idx in range(min(len(dataset), args.max_images)):
        _, inst, depth = dataset[idx]
        k_inv = np.linalg.inv(inst["k_matrix"]).astype(np.float32)
        pts = get_points_coordinate(
            torch.from_numpy(depth[None]).to(device),
            torch.from_numpy(k_inv[None]).to(device))[0]
        masks = torch.from_numpy(inst["masks"]).to(device).bool()
        planes = torch.from_numpy(inst["plane_paras"]).to(device)
        n = masks.shape[0]
        print(f"gt masks: {tuple(masks.shape)}, gt planes: "
              f"{tuple(planes.shape)}")
        per_plane = [point_to_plane_error(pts, masks[j], planes[j, :3],
                                          planes[j, 3]) for j in range(n)]
        error = float(torch.stack(per_plane).sum()) / max(n, 1)
        print(error)
        print()
        errors.append(error)
    return errors


if __name__ == "__main__":
    main()
