"""Procedural planar-scene dataset generator (the training-correctness probe).

Counterpart of ``tools/synth_scenes.py``: from the same seed it renders the
same scenes. Ray-casts textured planar "rooms" (an axis-aligned box
enclosing the camera plus a few free cuboids) into ScanNet-layout data the
loaders consume unchanged (``ScanNetDataset`` path conventions): colour as
8-bit PNGs (the JAX package's tool writes JPEGs), 16-bit millimetre depth
PNGs, both through ``data/image_io.py``, a per-scene intrinsics txt, and
COCO-format JSON with per-plane RLE masks and camera-frame
``plane_paras`` [nx, ny, nz, d] (n·X = d).

Every GT channel is *exact by construction* — depth comes from the analytic
ray-plane intersection at the same integer-pixel ray convention the
framework back-projects with (`ops/geometry.py::get_points_coordinate`,
X = depth · K⁻¹[u, v, 1]), masks are the z-buffer's plane-id map, and plane
parameters are the true scene planes — so a model trained on this set is
graded against noiseless ground truth: if the GT assignment, losses and
optimizer are wired right, mask AP and depth metrics must improve under
training.

RGB carries two monocular cues the net can learn depth/orientation from:
per-plane metric textures (checker/stripe period in *metres*, so on-screen
frequency encodes depth) and Lambertian shading from a per-scene light.

Usage:
  python -m planerecnet_tpu_torch.tools.synth_scenes --out OUT --train 1600 \
      --val 200 --eval 200 [--height 480 --width 640] [--seed 0]

writes ``<out>/scannet/{scans/, scannet_train.json, scannet_val.json,
scannet_eval.json}`` so the stock configs' relative ``./scannet/...`` paths
resolve when CLIs run with ``<out>`` as cwd.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from planerecnet_tpu_torch.data.coco import mask_to_rle
from planerecnet_tpu_torch.data.image_io import imwrite


# ---------------------------------------------------------------------------
# Scene construction (world frame: y up; camera frame: x right, y down,
# z forward — the CV convention the loaders/losses assume).
# ---------------------------------------------------------------------------

def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-12)


def _camera_pose(rng: np.random.RandomState, room_half: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Random camera inside the room. Returns (C, R) with R = cam->world
    (columns = camera x/y/z axes in world coordinates)."""
    c = (rng.uniform(-0.55, 0.55, 3)) * room_half
    yaw = rng.uniform(0, 2 * np.pi)
    pitch = rng.uniform(-0.25, 0.25)          # radians, + looks up
    roll = rng.uniform(-0.08, 0.08)
    fw = np.array([np.cos(pitch) * np.cos(yaw), np.sin(pitch),
                   np.cos(pitch) * np.sin(yaw)])
    camx = _unit(np.cross([0.0, 1.0, 0.0], fw))
    camy = -np.cross(fw, camx)                # y points down
    # roll about the forward axis
    cr, sr = np.cos(roll), np.sin(roll)
    camx, camy = cr * camx + sr * camy, -sr * camx + cr * camy
    r = np.stack([camx, _unit(camy), fw], axis=1)
    return c, r


def _box_faces(center: np.ndarray, axes: np.ndarray, half: np.ndarray
               ) -> List[Dict]:
    """Six rectangle faces of an oriented box: each is a dict with corner
    ``o`` and full edge vectors ``u``/``v`` (world frame)."""
    faces = []
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        for sgn in (-1.0, 1.0):
            fc = center + sgn * half[k] * axes[:, k]
            faces.append({
                "o": fc - half[i] * axes[:, i] - half[j] * axes[:, j],
                "u": 2 * half[i] * axes[:, i],
                "v": 2 * half[j] * axes[:, j],
            })
    return faces


def _texture_params(rng: np.random.RandomState) -> Dict:
    c1 = rng.uniform(45, 215, 3)
    c2 = np.clip(c1 + rng.choice([-1, 1]) * rng.uniform(35, 95, 3), 25, 235)
    return {
        "kind": int(rng.randint(0, 3)),       # 0 checker, 1 stripes, 2 grad
        "period": float(rng.uniform(0.12, 0.55)),   # metres
        "angle": float(rng.uniform(0, np.pi)),
        "c1": c1, "c2": c2,
    }


def build_scene(rng: np.random.RandomState, n_boxes: Tuple[int, int] = (2, 5)
                ) -> Dict:
    """A room box + free cuboids, camera pose, light, per-face textures.

    Cuboids are sampled *inside the camera frustum* (1.2-4.5 m ahead with
    lateral jitter) so nearly every frame shows several occluding planes in
    addition to the 2-4 visible room faces."""
    room_half = np.array([rng.uniform(2.2, 3.8), rng.uniform(1.35, 1.9),
                          rng.uniform(2.2, 3.8)])
    cam_c, cam_r = _camera_pose(rng, room_half)
    fw = cam_r[:, 2]

    rects = _box_faces(np.zeros(3), np.eye(3), room_half)
    for _ in range(rng.randint(n_boxes[0], n_boxes[1] + 1)):
        half = rng.uniform(0.18, 0.8, 3)
        dist = rng.uniform(1.2, 4.5)
        lateral = (rng.uniform(-0.45, 0.45) * dist * cam_r[:, 0]
                   + rng.uniform(-0.25, 0.25) * dist * cam_r[:, 1])
        ctr = cam_c + dist * fw + lateral
        yaw = rng.uniform(0, 2 * np.pi)
        cy, sy = np.cos(yaw), np.sin(yaw)
        axes = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]).T
        if rng.rand() < 0.7:                  # resting on the floor
            ctr[1] = -room_half[1] + half[1]
        ctr = np.clip(ctr, -(room_half - half - 1e-3),
                      room_half - half - 1e-3)
        # keep the camera safely outside this cuboid
        local = axes.T @ (cam_c - ctr)
        if np.all(np.abs(local) < half + 0.35):
            continue
        rects.extend(_box_faces(ctr, axes, half))

    for rect in rects:
        rect["tex"] = _texture_params(rng)
    return {
        "rects": rects, "cam_c": cam_c, "cam_r": cam_r,
        "light": _unit(rng.normal(size=3)),
        "ambient": float(rng.uniform(0.3, 0.45)),
    }


# ---------------------------------------------------------------------------
# Ray casting + shading
# ---------------------------------------------------------------------------

def render(scene: Dict, k_matrix: np.ndarray, h: int, w: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Dict]]:
    """Returns (rgb uint8 HxWx3 BGR, depth float32 metres HxW, plane-id
    int32 HxW with -1 = miss, plane records). Ray per *integer* pixel
    coordinate — exactly the back-projection convention of
    ops/geometry.py::get_points_coordinate, so depth·K⁻¹[u,v,1] lands on
    the analytic planes to float precision."""
    k_inv = np.linalg.inv(k_matrix)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(h * w)])   # (3, HW)
    dirs = (k_inv @ pix).astype(np.float32)                    # z == 1
    cam_c, cam_r = scene["cam_c"], scene["cam_r"]

    best_t = np.full(h * w, np.inf, np.float32)
    best_id = np.full(h * w, -1, np.int32)
    best_ab = np.zeros((2, h * w), np.float32)
    planes = []
    for rid, rect in enumerate(scene["rects"]):
        # world rect -> camera frame
        o = cam_r.T @ (rect["o"] - cam_c)
        u, v = cam_r.T @ rect["u"], cam_r.T @ rect["v"]
        n = np.cross(u, v)
        n = n / max(np.linalg.norm(n), 1e-12)
        d = float(n @ o)
        if d < 0:                              # normalize to n·X = d, d >= 0
            n, d = -n, -d
        planes.append({"n": n, "d": d, "rect": rect})

        # cull rects entirely behind the camera
        corners_z = np.array([o[2], o[2] + u[2], o[2] + v[2],
                              o[2] + u[2] + v[2]])
        if corners_z.max() < 0.05:
            continue

        denom = (n.astype(np.float32) @ dirs)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.float32(d) / denom
        cand = (np.abs(denom) > 1e-9) & (t > 0.05) & (t < best_t)
        if not cand.any():
            continue
        tc = t[cand]
        rel = dirs[:, cand] * tc - o[:, None].astype(np.float32)
        # local coords from the (2x2) gram inverse
        uu_, uv_, vv_ = u @ u, u @ v, v @ v
        det = uu_ * vv_ - uv_ * uv_
        ru, rv = u.astype(np.float32) @ rel, v.astype(np.float32) @ rel
        a = (vv_ * ru - uv_ * rv) / det
        b = (uu_ * rv - uv_ * ru) / det
        ok = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        hit = np.flatnonzero(cand)[ok]
        best_t[hit] = tc[ok]
        best_id[hit] = rid
        best_ab[0, hit] = a[ok]
        best_ab[1, hit] = b[ok]

    rgb = np.zeros((h * w, 3), np.float64)
    light, ambient = scene["light"], scene["ambient"]
    for rid, pl in enumerate(planes):
        sel = best_id == rid
        if not sel.any():
            continue
        rect, tex = pl["rect"], pl["rect"]["tex"]
        xm = best_ab[0, sel] * np.linalg.norm(rect["u"])       # metres
        ym = best_ab[1, sel] * np.linalg.norm(rect["v"])
        p = tex["period"]
        if tex["kind"] == 0:
            phase = ((np.floor(xm / p) + np.floor(ym / p)) % 2)
        elif tex["kind"] == 1:
            ca, sa = np.cos(tex["angle"]), np.sin(tex["angle"])
            phase = (np.floor((ca * xm + sa * ym) / p) % 2)
        else:
            phase = 0.5 + 0.5 * np.sin(2 * np.pi * xm / (2 * p)) \
                * np.sin(2 * np.pi * ym / (2 * p))
        color = tex["c1"][None] * (1 - phase[:, None]) \
            + tex["c2"][None] * phase[:, None]
        n_world = _unit(np.cross(rect["u"], rect["v"]))
        lam = ambient + (1 - ambient) * abs(float(n_world @ light))
        rgb[sel] = color * lam

    depth = np.where(np.isfinite(best_t), best_t, 0.0)
    return (rgb.reshape(h, w, 3), depth.reshape(h, w).astype(np.float32),
            best_id.reshape(h, w), planes)


# ---------------------------------------------------------------------------
# Dataset writer (ScanNet layout + COCO json)
# ---------------------------------------------------------------------------

def _intrinsics(h: int, w: int) -> np.ndarray:
    f = 0.9 * w                                # ScanNet-ish FOV
    return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])


def _write_intrinsics_txt(path: str, k: np.ndarray) -> None:
    """ScanNet .sens-style info file: the loader reads 16 values from
    line 10, words[2:18] (``data/datasets.py::ScanNetDataset``)."""
    k4 = np.eye(4)
    k4[:3, :3] = k
    vals = " ".join(f"{x:.6f}" for x in k4.ravel())
    lines = ["synthetic planar scene\n"] * 9
    lines.append("m_calibrationColorIntrinsic = " + vals + "\n")
    with open(path, "w") as f:
        f.writelines(lines)


def generate_split(out_root: str, scene_name: str, n_images: int,
                   h: int, w: int, seed: int, min_area: int = 600,
                   n_boxes: Tuple[int, int] = (2, 5),
                   noise_sigma: float = 4.0,
                   progress: bool = True) -> Dict:
    """Renders ``n_images`` scenes into ``<out_root>/scans/<scene_name>/``
    and returns the COCO annotation dict."""
    rng = np.random.RandomState(seed)
    scans = osp.join(out_root, "scans")
    color_dir = osp.join(scans, scene_name, "color")
    depth_dir = osp.join(scans, scene_name, "depth")
    intr_dir = osp.join(scans, scene_name, "frame", "intrinsic")
    for d in (color_dir, depth_dir, intr_dir):
        os.makedirs(d, exist_ok=True)

    k = _intrinsics(h, w)
    _write_intrinsics_txt(osp.join(intr_dir, scene_name + ".txt"), k)

    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        scene = build_scene(rng, n_boxes=n_boxes)
        rgb, depth, ids, planes = render(scene, k, h, w)
        rgb = np.clip(rgb + rng.normal(0, noise_sigma, rgb.shape), 0, 255)
        # The array written is BGR, as the JAX package's tool writes it.
        imwrite(osp.join(color_dir, f"{i}.png"),
                rgb[..., ::-1].astype(np.uint8))
        depth_mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(
            np.uint16)
        imwrite(osp.join(depth_dir, f"{i}.png"), depth_mm)

        images.append({"id": i, "file_name": f"{scene_name}/color/{i}.png",
                       "height": h, "width": w})
        for rid, pl in enumerate(planes):
            mask = (ids == rid)
            area = int(mask.sum())
            if area < min_area:
                continue
            ys, xs = np.nonzero(mask)
            x0, x1 = int(xs.min()), int(xs.max())
            y0, y1 = int(ys.min()), int(ys.max())
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": 1,
                "segmentation": mask_to_rle(mask.astype(np.uint8)),
                "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                "area": area, "iscrowd": 0,
                "plane_paras": [float(pl["n"][0]), float(pl["n"][1]),
                                float(pl["n"][2]), float(pl["d"])],
            })
            ann_id += 1
        if progress and (i + 1) % 50 == 0:
            print(f"  {scene_name}: {i + 1}/{n_images}", flush=True)

    return {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "plane"}]}


def generate_dataset(out: str, n_train: int, n_val: int, n_eval: int,
                     h: int = 480, w: int = 640, seed: int = 0,
                     min_area: int = 600,
                     n_boxes: Tuple[int, int] = (2, 5),
                     progress: bool = True) -> str:
    """Writes the full ``<out>/scannet/...`` tree; returns its root."""
    root = osp.join(out, "scannet")
    splits = [("scannet_train.json", "scene0000_00", n_train, seed),
              ("scannet_val.json", "scene0001_00", n_val, seed + 77777),
              ("scannet_eval.json", "scene0002_00", n_eval, seed + 155555)]
    for json_name, scene, n, s in splits:
        if n <= 0:
            continue
        anno = generate_split(root, scene, n, h, w, s, min_area=min_area,
                              n_boxes=n_boxes, progress=progress)
        with open(osp.join(root, json_name), "w") as f:
            json.dump(anno, f)
        if progress:
            print(f"{json_name}: {n} images, "
                  f"{len(anno['annotations'])} plane instances", flush=True)
    return root


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=1600)
    p.add_argument("--val", type=int, default=200)
    p.add_argument("--eval", type=int, default=200)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min_area", type=int, default=600)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    root = generate_dataset(args.out, args.train, args.val, args.eval,
                            h=args.height, w=args.width, seed=args.seed,
                            min_area=args.min_area)
    print(f"dataset root: {root} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
