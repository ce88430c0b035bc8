"""The port's inference CLI: ``python -m planerecnet_tpu_torch.simple_inference``.

Counterpart of the repository's ``simple_inference.py`` with the same flags
and modes: ``--image in[:out]``, ``--images in:out``, ``--ibims1 in:out``
and ``--ibims1_pd in:out`` (iBims-1 ``.mat`` files through ``scipy.io``),
the display toggles and the NMS overrides, plus ``--device`` (``cuda``
unless ``cpu`` is passed; raises where there is no card). Images are read
and written as PNG through ``data/image_io.py``; a JPEG goes through cv2
or PIL where one imports.

``display_on_frame`` draws what the JAX package's draws with OpenCV,
without it: the masks' alpha blend, the contours that ``cv2.findContours``
(``RETR_TREE``, ``CHAIN_APPROX_SIMPLE``) and ``cv2.drawContours(..., 1)``
draw (every mask pixel with a 4-neighbour outside the mask or the image),
the boxes of ``cv2.rectangle(..., 1)`` and each label's filled box. The
labels' text cannot be drawn in cv2's Hershey font, which is not
reproduced here: it is drawn in this module's own 5x7 bitmap font
(``FONT``), so the label boxes have other sizes than cv2's.
``save_depth`` colours with its own copy of OpenCV's ``COLORMAP_VIRIDIS``
table, or writes 16-bit PNGs.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from planerecnet_tpu_torch.config import COLORS, set_cfg
from planerecnet_tpu_torch.data.image_io import imread, imwrite, resize_linear
from planerecnet_tpu_torch.ops.image import (calc_size_preserve_ar,
                                             pad_to_multiple)
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from planerecnet_tpu_torch.utils import timer

# OpenCV's COLORMAP_VIRIDIS, BGR, level 0 to 255 (3 bytes a level).
VIRIDIS_BGR = np.frombuffer(bytes.fromhex(
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147"
    "6513476714486816486917486a18486c1a486d1b486e1c486f1d48701f48712048732148"
    "7423487524487625487726487828487929487a2a477a2c477b2d477c2e477d2f477e3046"
    "7e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42"
    "86404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d"
    "8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c543a8c55398c56398c58388c59388c5a37"
    "8d5b378d5c368d5d368d5e358d5f358d60348d61348d62338d63338e64328e65328e6631"
    "8e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c"
    "8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d28"
    "8e7e278e7f278e80278e81268e82268e82268e83258e84258e85258e86248e87248e8823"
    "8e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c9320"
    "8c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f"
    "88a01f88a11f87a11f87a21f86a32086a42085a52185a62185a72284a82283a92383aa24"
    "82ab2582ac2581ad2681ad2780ae287faf297fb02a7eb12c7db22d7cb32e7cb42f7bb531"
    "7ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d73bc3f72bd4071be4270bf44"
    "6fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c"
    "62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d177"
    "51d17a50d27c4ed37f4dd3814bd48449d58648d58946d68b45d68e43d79041d79340d895"
    "3ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa30dcad2fddb02dddb22bdeb5"
    "29deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5"
    "19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f4"
    "20e6f621e6f823e7fb25e7fd"
), np.uint8).reshape(256, 3)

# A 5x7 bitmap font: 7 rows a glyph, top first, bit 4 the left column.
# Upper case is drawn as lower case; any other character as a box.
FONT = {
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f",
    "3": "1f02040201110e", "4": "02060a121f0202", "5": "1f101e0101110e",
    "6": "0608101e11110e", "7": "1f010204080808", "8": "0e11110e11110e",
    "9": "0e11110f01020c", ":": "000c0c000c0c00", ".": "00000000000c0c",
    "-": "0000001f000000", "_": "0000000000001f", " ": "00000000000000",
    "a": "00000e010f110f", "b": "1010161911111e", "c": "00000e1010110e",
    "d": "01010d1311110f", "e": "00000e111f100e", "f": "0609081c080808",
    "g": "000f11110f010e", "h": "10101619111111", "i": "04000c0404040e",
    "j": "0200060202120c", "k": "10101214181412", "l": "0c04040404040e",
    "m": "00001a15151111", "n": "00001619111111", "o": "00000e1111110e",
    "p": "00001e111e1010", "q": "00000d130f0101", "r": "00001619101010",
    "s": "00000e100e011e", "t": "08081c08080906", "u": "0000111111130d",
    "v": "00001111110a04", "w": "0000111115150a", "x": "0000110a040a11",
    "y": "000011110f010e", "z": "00001f0204081f",
}
_BOX_GLYPH = "1f11111111111f"
FONT_W, FONT_H = 6, 7   # advance and height of a glyph in pixels


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PlaneRecNet Inference")
    parser.add_argument("--trained_model", default=None, type=str,
                        help="Trained weights file (.npz, or reference .pth "
                             "to auto-convert).")
    parser.add_argument("--config", default="PlaneRecNet_50_config",
                        help="The config object to use.")
    parser.add_argument("--image", default=None, type=str,
                        help="Inference with a single image (in[:out]).")
    parser.add_argument("--images", default=None, type=str,
                        help="Inference with multiple images (in:out).")
    parser.add_argument("--max_img", default=0, type=int)
    parser.add_argument("--ibims1", default=None, type=str,
                        help="iBims-1 .mat outputs (in:out).")
    parser.add_argument("--ibims1_pd", default=None, type=str,
                        help="iBims-1 with PCA plane-depth re-render.")
    parser.add_argument("--no_mask", action="store_true")
    parser.add_argument("--no_box", action="store_true")
    parser.add_argument("--no_text", action="store_true")
    parser.add_argument("--top_k", default=100, type=int)
    parser.add_argument("--nms_mode", default="matrix", type=str,
                        choices=["matrix", "mask"])
    # As in the JAX CLI (and the reference's), --score_threshold sets
    # mask_thr and update_thr, not score_thr.
    parser.add_argument("--score_threshold", default=0.3, type=float,
                        help="Overrides mask_thr and update_thr (NOT "
                             "score_thr), as the reference CLI does.")
    parser.add_argument("--depth_mode", default="colored", type=str,
                        choices=["colored", "gray"])
    parser.add_argument("--depth_shift", default=512, type=float)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises where there is no card) "
                             "or cpu.")
    return parser.parse_args(argv)


def get_color(j: int) -> Tuple[int, int, int]:
    """Detection j's colour, BGR."""
    color = COLORS[(j * 5) % len(COLORS)]
    return (color[2], color[1], color[0])


def draw_contours(img: np.ndarray, mask: np.ndarray, color) -> None:
    """``cv2.drawContours`` of ``cv2.findContours(mask, RETR_TREE,
    CHAIN_APPROX_SIMPLE)`` at thickness 1, in place: the outer and hole
    borders of the mask are its pixels with a 4-neighbour outside it (the
    image's edge counts as outside)."""
    m = np.pad(mask.astype(bool), 1)
    inner = (m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:])
    img[mask.astype(bool) & ~inner] = color


def draw_rectangle(img: np.ndarray, p0, p1, color, filled=False) -> None:
    """``cv2.rectangle(img, p0, p1, color, 1 or -1)``, clipped to the
    image, in place."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    cx0, cx1 = max(x0, 0), min(x1, w - 1)
    cy0, cy1 = max(y0, 0), min(y1, h - 1)
    if cx0 > cx1 or cy0 > cy1:
        return
    if filled:
        img[cy0:cy1 + 1, cx0:cx1 + 1] = color
        return
    for y in (y0, y1):
        if 0 <= y < h:
            img[y, cx0:cx1 + 1] = color
    for x in (x0, x1):
        if 0 <= x < w:
            img[cy0:cy1 + 1, x] = color


def text_size(text: str) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` in ``FONT``."""
    return FONT_W * len(text), FONT_H


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """Draws ``text`` in ``FONT`` with its top-left corner at ``org``
    (x, y), clipped to the image, in place."""
    h, w = img.shape[:2]
    x0, y0 = int(org[0]), int(org[1])
    for i, ch in enumerate(text):
        rows = bytes.fromhex(FONT.get(ch.lower(), _BOX_GLYPH))
        for r, bits in enumerate(rows):
            y = y0 + r
            if not 0 <= y < h:
                continue
            for c in range(5):
                x = x0 + FONT_W * i + c
                if bits >> (4 - c) & 1 and 0 <= x < w:
                    img[y, x] = color


def display_on_frame(result: Dict, frame: np.ndarray, cfg,
                     mask_alpha: float = 0.5, no_mask: bool = False,
                     no_box: bool = False, no_text: bool = False,
                     det_index: int = 0):
    """Blends the masks onto a BGR frame and draws contours, boxes and
    labels; returns (u8 frame, depth). ``result`` holds numpy arrays of
    one image's valid detections (``_valid_result``)."""
    frame_f = frame.astype(np.float32) / 255.0
    pred_depth = np.asarray(result["pred_depth"])
    pred_scores = result["pred_scores"]
    num_dets = 0 if pred_scores is None else len(pred_scores)

    if no_mask or num_dets == 0:
        return frame.astype(np.uint8), pred_depth

    pred_masks = np.asarray(result["pred_masks"], np.float32)
    pred_boxes = np.asarray(result["pred_boxes"])
    pred_classes = np.asarray(result["pred_classes"])

    for j in range(num_dets):
        color = np.asarray(get_color(j), np.float32) / 255.0
        m = pred_masks[j][:, :, None]
        frame_f = frame_f * (1 - mask_alpha * m) + m * color * mask_alpha
    frame_numpy = (frame_f * 255).astype(np.uint8)

    for j in range(num_dets):
        draw_contours(frame_numpy, pred_masks[j].astype(np.uint8),
                      (255, 255, 255))

    if not (no_text and no_box):
        for j in reversed(range(num_dets)):
            x1, y1, x2, y2 = pred_boxes[j].astype(int)
            color = get_color(j)
            score = float(pred_scores[j])
            if not no_box:
                draw_rectangle(frame_numpy, (x1, y1), (x2, y2), color)
            if not no_text:
                _class = cfg.dataset.class_names[
                    min(int(pred_classes[j]),
                        len(cfg.dataset.class_names) - 1)]
                text_str = "%s: %.2f" % (_class, score)
                tw, th = text_size(text_str)
                draw_rectangle(frame_numpy, (x1, y1),
                               (x1 + tw, y1 + th + 4), color, filled=True)
                put_text(frame_numpy, text_str, (x1 + 1, y1 + 2),
                         (255, 255, 255))
    return frame_numpy, pred_depth


def _valid_result(batched: Dict, idx: int = 0) -> Dict:
    """Image ``idx`` of a batched ``infer`` output on the host, its invalid
    slots dropped (the masks, scores, classes and boxes are None where no
    slot is valid)."""
    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else \
            np.asarray(t)
    valid = host(batched["pred_valid"][idx]).astype(bool)
    clip = host(batched.get("candidates_clipped",
                            np.zeros(1))).reshape(-1)
    if bool(clip[min(idx, clip.size - 1)]):
        print("WARNING: >max_candidates cells passed score_thr; overflow "
              "candidates were dropped before mask scoring (raise "
              "cfg.solov2.max_candidates or score_thr for exact reference "
              "semantics).")
    out = {"pred_depth": host(batched["pred_depth"][idx])}
    for k in ("pred_masks", "pred_scores", "pred_classes", "pred_boxes"):
        out[k] = host(batched[k][idx])[valid] if valid.any() else None
    return out


def save_depth(depth: np.ndarray, depth_path: str,
               depth_mode: str = "colored", depth_shift: float = 512.0
               ) -> None:
    """A depth map as a PNG: colour (the 1st-99th percentile range through
    viridis) or 16-bit grey (depth x ``depth_shift``)."""
    if depth_mode == "colored":
        vmin = np.percentile(depth, 1)
        vmax = np.percentile(depth, 99)
        depth = depth.clip(min=vmin, max=vmax)
        rng = max(depth.max() - depth.min(), 1e-12)
        depth = ((depth - depth.min()) / rng * 255).astype(np.uint8)
        imwrite(depth_path, VIRIDIS_BGR[depth])
    else:
        imwrite(depth_path, (depth * depth_shift).astype(np.uint16))


def _png_path(path: str) -> str:
    """Where a colour image meant for ``path`` is written: PNG, the one
    format ``data/image_io.py`` writes."""
    name, ext = os.path.splitext(path)
    return path if ext.lower() == ".png" else name + ".png"


def inference_image(net: PlaneRecNetRunner, path: str,
                    save_path: Optional[str] = None,
                    depth_mode: str = "colored", no_mask=False, no_box=False,
                    no_text=False, depth_shift=512.0) -> None:
    """One image: resized to ``max_size`` on its long side, padded to a
    multiple of 32, inferred; writes ``<out>`` (the drawn frame) and
    ``<out>_dep.png`` (the depth)."""
    frame_np = imread(path)
    h, w, _ = frame_np.shape
    frame_np = resize_linear(frame_np, calc_size_preserve_ar(
        w, h, net.cfg.max_size))
    frame_np = pad_to_multiple(frame_np.astype(np.float32), 32)

    batched = net.infer(frame_np[None])
    result = _valid_result(batched, 0)
    blended, depth = display_on_frame(result, frame_np, net.cfg,
                                      no_mask=no_mask, no_box=no_box,
                                      no_text=no_text)
    if save_path is None:
        name, ext = os.path.splitext(path)
        save_path = name + "_seg" + ext
    name, _ = os.path.splitext(save_path)
    if _png_path(save_path) != save_path:
        print(f"{save_path}: written as {_png_path(save_path)} (PNG only)")
    imwrite(_png_path(save_path), blended)
    save_depth(depth, name + "_dep.png", depth_mode, depth_shift)


def inference_images(net, in_folder, out_folder, max_img=0,
                     depth_mode="colored", **kw) -> None:
    """Every .png and .jpg of ``in_folder``, in name order."""
    os.makedirs(out_folder, exist_ok=True)
    index = 0
    input_list = list(Path(in_folder).glob("*"))
    max_img = min(max_img, len(input_list)) if max_img > 0 else len(input_list)
    for p in sorted(input_list):
        img_path = str(p)
        name, ext = os.path.splitext(os.path.basename(img_path))
        if ext not in (".png", ".jpg"):
            continue
        out_path = os.path.join(out_folder, name + ext)
        inference_image(net, img_path, out_path, depth_mode=depth_mode, **kw)
        print("Inference images: " + os.path.basename(img_path) + " -> "
              + os.path.basename(out_path), end="\r")
        index += 1
        if index >= max_img:
            break
    print("\nDone.")


def ibims1(net, in_folder, out_folder) -> None:
    """iBims-1: each ``.mat``'s rgb -> ``<name>_results.mat`` holding
    ``pred_depths``, and its colour PNG."""
    import scipy.io
    os.makedirs(out_folder, exist_ok=True)
    for p in sorted(Path(in_folder).glob("*")):
        img_path = str(p)
        name, ext = os.path.splitext(os.path.basename(img_path))
        if ext != ".mat":
            continue
        depth_out_path = os.path.join(out_folder, name + "_results.mat")
        data = scipy.io.loadmat(img_path)["data"]
        rgb = data["rgb"][0][0]
        if rgb is None:
            return
        batched = net.infer(np.asarray(rgb, np.float32)[None])
        pred_depth = batched["pred_depth"][0].cpu().numpy()
        scipy.io.savemat(depth_out_path, {"pred_depths": pred_depth})
        save_depth(pred_depth, depth_out_path.replace(".mat", ".png"))
        print(os.path.basename(img_path), end="\r")
    print("\nDone.")


def pca_svd(pts: np.ndarray):
    """Least-squares plane: the points' mean and the direction of least
    variance."""
    mean = pts.mean(axis=0)
    adj = pts - mean
    u, _, _ = np.linalg.svd(adj.T @ adj)
    return mean, u[:, 2]


def ibims1_pd(net, in_folder, out_folder) -> None:
    """iBims-1 with each mask's depth replaced by its PCA plane's."""
    import scipy.io
    os.makedirs(out_folder, exist_ok=True)
    for p in sorted(Path(in_folder).glob("*")):
        img_path = str(p)
        name, ext = os.path.splitext(os.path.basename(img_path))
        if ext != ".mat":
            continue
        depth_out_path = os.path.join(out_folder, name + "_results.mat")
        data = scipy.io.loadmat(img_path)["data"]
        calib = data["calib"][0][0]
        rgb = data["rgb"][0][0]
        if rgb is None:
            return
        batched = net.infer(np.asarray(rgb, np.float32)[None])
        result = _valid_result(batched, 0)
        pred_depth = np.asarray(result["pred_depth"], np.float64)
        pred_masks = result["pred_masks"]

        if pred_masks is not None:
            k_matrix = np.asarray(calib).T.astype(np.float64)
            k_inv = np.linalg.inv(k_matrix)
            h, w = pred_depth.shape
            u, v = np.meshgrid(np.arange(w), np.arange(h))
            cx, cy = k_matrix[0][2], k_matrix[1][2]
            fx, fy = k_matrix[0][0], k_matrix[1][1]
            z = pred_depth
            x = (u - cx) * z / fx
            y = (v - cy) * z / fy
            point_cloud = np.stack([x, y, z], axis=-1)
            xy1 = np.stack([u.ravel(), v.ravel(),
                            np.ones(h * w)]).astype(np.float64)
            k_inv_dot_xy1 = k_inv @ xy1
            for idx in range(pred_masks.shape[0]):
                mask = pred_masks[idx].astype(bool)
                pts = point_cloud[mask]
                if pts.shape[0] < 3:
                    continue
                center, normal = pca_svd(pts)
                plane_depth = (center @ normal) / (normal @ k_inv_dot_xy1)
                pred_depth = np.where(mask, plane_depth.reshape(h, w),
                                      pred_depth)

        pred_depth[pred_depth <= 0] = np.nan
        pred_depth[pred_depth >= 10] = np.nan
        scipy.io.savemat(depth_out_path, {"pred_depths": pred_depth})
        save_depth(np.nan_to_num(pred_depth, nan=0.0),
                   depth_out_path.replace(".mat", ".png"))
        print(os.path.basename(img_path), end="\r")
    print("\nDone.")


def build_runner(args) -> PlaneRecNetRunner:
    """The config with the CLI's NMS overrides, and its runner with the
    weights asked for (a ``.npz`` or ``.pth``; else fresh, with an ImageNet
    backbone where ``weights/<backbone path>`` exists)."""
    cfg = set_cfg(args.config)
    cfg = cfg.copy(dict(solov2=cfg.solov2.copy(dict(
        nms_type=args.nms_mode, mask_thr=args.score_threshold,
        update_thr=args.score_threshold, top_k=args.top_k))))
    net = PlaneRecNetRunner(cfg, device=args.device)
    if args.trained_model is not None:
        net.load_weights(args.trained_model)
    else:
        backbone_path = os.path.join("weights", cfg.backbone.path)
        net.init_weights(backbone_path if os.path.exists(backbone_path)
                         else None)
        print(cfg.backbone.name)
    return net


def main(argv=None) -> None:
    args = parse_args(argv)
    timer.disable_all()
    net = build_runner(args)
    kw = dict(no_mask=args.no_mask, no_box=args.no_box, no_text=args.no_text,
              depth_shift=args.depth_shift)
    if args.image is not None:
        if ":" in args.image:
            inp, out = args.image.split(":")
            print(f"Inference image: {inp}")
            inference_image(net, inp, out, depth_mode=args.depth_mode, **kw)
        else:
            print(f"Inference image: {args.image}")
            inference_image(net, args.image, depth_mode=args.depth_mode,
                            **kw)
    if args.images is not None:
        inp, out = args.images.split(":")
        inference_images(net, inp, out, max_img=args.max_img,
                         depth_mode=args.depth_mode, **kw)
    if args.ibims1 is not None:
        inp, out = args.ibims1.split(":")
        ibims1(net, inp, out)
    if args.ibims1_pd is not None:
        inp, out = args.ibims1_pd.split(":")
        ibims1_pd(net, inp, out)


if __name__ == "__main__":
    main()
