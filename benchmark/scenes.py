"""Traffic: planar rooms rendered from the seed, and the rows, frames and
wire batches made of them.

The renderer is a copy of the program's ``tools/synth_scenes.py`` (ray-cast
textured rooms with cuboids; exact depth, plane masks and camera-frame plane
parameters n.X = d), kept here so that the traffic does not change when the
program does. Rendering costs ~0.5-0.7 s a frame on the host, so a run
renders a small pool of scenes in set-up and makes its rows from them with
the training augmentations that keep the labels exact: a horizontal mirror
(n_x negated), a vertical flip (n_y negated) and a photometric change
(contrast and brightness, then the u8 range). A traffic file states the
pool, the sizes and the ring of distinct rows that the window cycles
through.

Training rows become the program's wire batch as its loader makes it
(``collate``: u8 BGR image, u16 depth in the dataset's resolution, the
valid slots' bit-packed masks with their slot ids, boxes, classes, plane
parameters, validity and intrinsics); ``dense`` is the same batch unpacked
for the yardstick.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MIN_AREA = 600       # px: smaller planes are not annotated (as the tool)
NOISE_SIGMA = 4.0    # sensor noise on the rendered colour


def rng_for(seed: int, *stream: int) -> np.random.RandomState:
    """A legacy generator (the renderer's) for any whole ``seed``."""
    return np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence([seed, *stream])))


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


def _intrinsics(h: int, w: int) -> np.ndarray:
    f = 0.9 * w
    return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])


def render_pool(seed: int, n: int, h: int, w: int) -> List[Dict]:
    """``n`` scenes: BGR u8 image, depth (m), plane masks (u8), boxes
    (xyxy, exclusive end), plane parameters and intrinsics."""
    rng = rng_for(seed, 0)
    k = _intrinsics(h, w)
    pool = []
    for _ in range(n):
        rgb, depth, ids, planes = render(build_scene(rng), k, h, w)
        rgb = np.clip(rgb + rng.normal(0, NOISE_SIGMA, rgb.shape), 0, 255)
        masks, boxes, paras = [], [], []
        for rid, pl in enumerate(planes):
            m = ids == rid
            if m.sum() < MIN_AREA:
                continue
            ys, xs = np.nonzero(m)
            masks.append(m)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            paras.append([*pl["n"], pl["d"]])
        pool.append({"image": rgb[..., ::-1].astype(np.uint8),
                     "depth": (np.round(depth * 1000.0) / 1000.0).astype(
                         np.float32),
                     "masks": np.asarray(masks, np.uint8).reshape(
                         -1, h, w),
                     "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                     "plane_paras": np.asarray(paras, np.float32).reshape(
                         -1, 4),
                     "k_matrix": k.astype(np.float32)})
    return pool


def make_row(scene: Dict, rng: np.random.RandomState) -> Dict:
    """One augmented row of a pooled scene (a new dict; the pool is
    unchanged)."""
    row = dict(scene)
    img = scene["image"].astype(np.float32)
    img = img * rng.uniform(0.6, 1.4) + rng.uniform(-32, 32)
    w = img.shape[1]
    h = img.shape[0]
    masks, depth, boxes = scene["masks"], scene["depth"], scene["boxes"]
    paras = scene["plane_paras"].copy()
    if rng.rand() < 0.5:                       # mirror
        img, depth, masks = img[:, ::-1], depth[:, ::-1], masks[..., ::-1]
        boxes = np.stack([w - boxes[:, 2], boxes[:, 1], w - boxes[:, 0],
                          boxes[:, 3]], 1)
        paras[:, 0] = -paras[:, 0]
    if rng.rand() < 0.5:                       # vertical flip
        img, depth, masks = img[::-1], depth[::-1], masks[:, ::-1]
        boxes = np.stack([boxes[:, 0], h - boxes[:, 3], boxes[:, 2],
                          h - boxes[:, 1]], 1)
        paras[:, 1] = -paras[:, 1]
    row.update(image=np.clip(np.round(img), 0, 255).astype(np.uint8),
               depth=np.ascontiguousarray(depth),
               masks=np.ascontiguousarray(masks),
               boxes=boxes.astype(np.float32), plane_paras=paras)
    return row


def make_rows(pool: List[Dict], n: int, seed: int) -> List[Dict]:
    """``n`` rows, cycling through the pool in a seeded order."""
    rng = rng_for(seed, 1)
    order = np.concatenate([rng.permutation(len(pool))
                            for _ in range(-(-n // len(pool)))])[:n]
    return [make_row(pool[i], rng) for i in order]


def collate(rows: List[Dict], max_instances: int, depth_resolution: float
            ) -> Dict[str, np.ndarray]:
    """The program's wire batch (its loader's ``collate_batch`` with the
    default wire: u8 image, sparse bit-packed masks)."""
    b = len(rows)
    h, w = rows[0]["image"].shape[:2]
    n_cap = max_instances
    boxes = np.zeros((b, n_cap, 4), np.float32)
    classes = np.zeros((b, n_cap), np.int32)
    paras = np.zeros((b, n_cap, 4), np.float32)
    valid = np.zeros((b, n_cap), bool)
    packed, slots = [], []
    for i, r in enumerate(rows):
        n = min(len(r["masks"]), n_cap)
        boxes[i, :n] = r["boxes"][:n]
        paras[i, :n] = r["plane_paras"][:n]
        valid[i, :n] = True
        if n:
            packed.append(np.packbits(r["masks"][:n], axis=-1))
            slots.extend(range(i * n_cap, i * n_cap + n))
    m = len(slots)
    m16 = max(16, -(-m // 16) * 16)
    sparse = np.zeros((m16, h, -(-w // 8)), np.uint8)
    if m:
        sparse[:m] = np.concatenate(packed)
    slot_ids = np.full((m16,), b * n_cap, np.int32)
    slot_ids[:m] = slots
    depth = np.stack([r["depth"] for r in rows])[..., None]
    return {"image": np.stack([r["image"] for r in rows]),
            "depth_q": np.clip(np.round(depth / depth_resolution), 0,
                               65535).astype(np.uint16),
            "masks_sparse": sparse, "mask_slots": slot_ids,
            "boxes": boxes, "classes": classes, "plane_paras": paras,
            "gt_valid": valid,
            "k_matrix": np.stack([r["k_matrix"] for r in rows])}


def dense(wire: Dict[str, np.ndarray], max_instances: int,
          depth_resolution: float, device) -> Dict:
    """The wire batch unpacked on ``device`` for the yardstick: masks
    (B, N, H, W) {0, 1}, depth (B, H, W) in metres, the rest as they
    are."""
    import torch

    b, h, w = wire["image"].shape[:3]
    masks = np.zeros((b * max_instances, h, w), np.uint8)
    keep = wire["mask_slots"] < b * max_instances
    masks[wire["mask_slots"][keep]] = np.unpackbits(
        wire["masks_sparse"][keep], axis=-1)[..., :w]
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in wire.items()
           if k not in ("depth_q", "masks_sparse", "mask_slots")}
    out["masks"] = torch.from_numpy(masks.reshape(
        b, max_instances, h, w)).to(device)
    out["depth"] = (torch.from_numpy(wire["depth_q"][..., 0].astype(
        np.float32)).to(device) * depth_resolution)
    return out

