"""Host-side augmentation and preprocessing chain.

Counterpart of ``planerecnet_tpu/data/augmentations.py``: a 6-tuple
``(img, depth, masks, boxes, labels, plane_paras)`` pipeline with
photometric distortion, flips that also turn the GT plane normals, motion
blur and gaussian noise, the square resize to ``max_size`` and the
backbone's normalisation. Randomness flows through the
``np.random.RandomState`` each transform is given, drawn in the JAX
package's order, so one seed gives the same sample in both packages. The
OpenCV calls of the JAX package are ``image_io``'s functions here.

The device-side normalisation is ``ops/image.py::fast_base_transform``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from planerecnet_tpu_torch.config import MEANS, STD, PlaneRecNetConfig
from planerecnet_tpu_torch.data.image_io import (bgr_to_hsv, filter2d,
                                                 hsv_to_bgr,
                                                 motion_blur_kernel,
                                                 normalize_minmax,
                                                 resize_linear)


class SSDAugmentation:
    """Train-time chain: photometric -> mirror -> flip -> [rot90] ->
    [motion blur] -> [noise] -> square resize -> normalise + BGR->RGB.

    With ``device_normalize`` (default ``cfg.device_normalize``, True in
    every preset) the normalisation and channel swap run on the device
    (``trainer.unpack_wire_batch``) and the host ships the augmented
    image as u8 BGR, a quarter of the f32 bytes; photometric values
    outside [0, 255] are clipped and rounded to the u8 range. Pass
    ``device_normalize=False`` (or ``--cfg_overrides
    '{"device_normalize": false}'``) for the unclipped f32 image.
    """

    def __init__(self, cfg: PlaneRecNetConfig, mean=MEANS, std=STD,
                 rng: Optional[np.random.RandomState] = None,
                 device_normalize: Optional[bool] = None):
        self.cfg = cfg
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rng = rng if rng is not None else np.random.RandomState()
        self.device_normalize = (getattr(cfg, "device_normalize", True)
                                 if device_normalize is None
                                 else device_normalize)

    def __call__(self, img, depth, masks, boxes, labels, plane_paras):
        cfg, rng = self.cfg, self.rng
        a = cfg.augment
        if a.photometric_distort:
            img = photometric_distort(img, rng)
        if a.random_mirror:
            img, depth, masks, boxes, plane_paras = random_mirror(
                img, depth, masks, boxes, plane_paras, rng)
        if a.random_flip:
            img, depth, masks, boxes, plane_paras = random_flip(
                img, depth, masks, boxes, plane_paras, rng)
        if a.random_rot90:
            img, depth, masks, boxes, plane_paras = random_rot90(
                img, depth, masks, boxes, plane_paras, rng)
        if a.motion_blur:
            img = random_motion_blur(img, rng)
        if a.gaussian_noise:
            img = random_gaussian_noise(img, rng)
        img, depth, masks, boxes, labels, plane_paras = resize_square(
            cfg, img, depth, masks, boxes, labels, plane_paras)
        if self.device_normalize:
            img = np.clip(np.round(img), 0, 255).astype(np.uint8)  # BGR u8
        else:
            img = backbone_transform(cfg, img, self.mean, self.std)
        return img, depth, masks, boxes, labels, plane_paras


class BaseTransform:
    """Eval-time chain: square resize + normalise."""

    def __init__(self, cfg: PlaneRecNetConfig, mean=MEANS, std=STD):
        self.cfg = cfg
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, depth, masks, boxes, labels, plane_paras):
        img, depth, masks, boxes, labels, plane_paras = resize_square(
            self.cfg, img, depth, masks, boxes, labels, plane_paras)
        img = backbone_transform(self.cfg, img, self.mean, self.std)
        return img, depth, masks, boxes, labels, plane_paras


class ResizeAndPad:
    """Aspect-preserving resize (long side = max_size) + mean-fill pad to a
    max_size square, image in the top-left."""

    def __init__(self, cfg: PlaneRecNetConfig, mean=MEANS,
                 resize_gt: bool = True, pad_gt: bool = True):
        self.cfg = cfg
        self.mean = np.asarray(mean, np.float32)
        self.resize_gt = resize_gt
        self.pad_gt = pad_gt

    def __call__(self, image, depth, masks, boxes, labels, plane_paras):
        cfg = self.cfg
        size = cfg.max_size
        img_h, img_w, channels = image.shape
        if img_h == size and img_w == size:
            return _discard_small(cfg, image, depth, masks, boxes, labels,
                                  plane_paras)
        if img_h > img_w:
            height, width = size, int(img_w * (size / img_h))
        else:
            height, width = int(img_h * (size / img_w)), size
        image = resize_linear(image, (width, height))
        depth = resize_linear(depth, (width, height))
        if self.resize_gt and masks.size:
            m = resize_linear(masks.transpose(1, 2, 0), (width, height))
            masks = m[None] if m.ndim == 2 else m.transpose(2, 0, 1)
            boxes = boxes.copy()
            boxes[:, [0, 2]] *= width / img_w
            boxes[:, [1, 3]] *= height / img_h

        exp_img = np.zeros((size, size, channels), image.dtype)
        exp_img[:, :, :] = self.mean
        exp_img[:height, :width] = image
        exp_depth = np.zeros((size, size), depth.dtype)
        exp_depth[:height, :width] = depth
        if self.pad_gt and masks.size:
            exp_masks = np.zeros((masks.shape[0], size, size), masks.dtype)
            exp_masks[:, :height, :width] = masks
            masks = exp_masks
        return _discard_small(cfg, exp_img, exp_depth, masks, boxes, labels,
                              plane_paras)


class Pad:
    """Mean-fill pad to (height, width), image in the top-left."""

    def __init__(self, width: int, height: int, mean=MEANS,
                 pad_gt: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.width = width
        self.height = height
        self.pad_gt = pad_gt

    def __call__(self, image, depth, masks, boxes=None, labels=None,
                 plane_paras=None):
        im_h, im_w, channels = image.shape
        exp_img = np.zeros((self.height, self.width, channels), image.dtype)
        exp_img[:, :, :] = self.mean
        exp_img[:im_h, :im_w] = image
        exp_depth = np.zeros((self.height, self.width), depth.dtype)
        exp_depth[:im_h, :im_w] = depth
        if self.pad_gt and masks is not None and masks.size:
            exp_masks = np.zeros((masks.shape[0], self.height, self.width),
                                 masks.dtype)
            exp_masks[:, :im_h, :im_w] = masks
            masks = exp_masks
        return exp_img, exp_depth, masks, boxes, labels, plane_paras


def _discard_small(cfg, img, depth, masks, boxes, labels, plane_paras):
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    keep = (w > cfg.discard_box_width) & (h > cfg.discard_box_height)
    masks = masks[keep]
    boxes = boxes[keep]
    labels = labels[keep]
    if plane_paras is not None and plane_paras.size:
        plane_paras = plane_paras[keep]
    return img, depth, masks, boxes, labels, plane_paras


# ---------------------------------------------------------------- pieces


def photometric_distort(img: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
    """Brightness / contrast / HSV saturation+hue jitter. Input float BGR
    [0,255]."""
    img = img.copy()
    if rng.randint(2):
        img += rng.uniform(-32, 32)

    # One of the two contrast slots is active per sample.
    first_contrast = bool(rng.randint(2))

    def contrast(x):
        if rng.randint(2):
            x *= rng.uniform(0.5, 1.5)
        return x

    if first_contrast:
        img = contrast(img)
    hsv = bgr_to_hsv(img.astype(np.float32))
    if rng.randint(2):
        hsv[:, :, 1] *= rng.uniform(0.5, 1.5)
    if rng.randint(2):
        hsv[:, :, 0] += rng.uniform(-18.0, 18.0)
        hsv[:, :, 0][hsv[:, :, 0] > 360.0] -= 360.0
        hsv[:, :, 0][hsv[:, :, 0] < 0.0] += 360.0
    img = hsv_to_bgr(hsv)
    if not first_contrast:
        img = contrast(img)
    return img


def random_mirror(img, depth, masks, boxes, plane_paras, rng):
    """Horizontal mirror; also mirrors plane normals."""
    if rng.randint(2):
        width = img.shape[1]
        img = img[:, ::-1].copy()
        depth = depth[:, ::-1].copy()
        masks = masks[:, :, ::-1].copy()
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
        if plane_paras is not None and plane_paras.size:
            plane_paras = plane_paras.copy()
            plane_paras[:, 0] *= -1
    return img, depth, masks, boxes, plane_paras


def random_flip(img, depth, masks, boxes, plane_paras, rng):
    """Vertical flip; flips plane normal y."""
    if rng.randint(2):
        height = img.shape[0]
        img = img[::-1, :].copy()
        depth = depth[::-1, :].copy()
        masks = masks[:, ::-1, :].copy()
        boxes = boxes.copy()
        boxes[:, 1::2] = height - boxes[:, 3::-2]
        if plane_paras is not None and plane_paras.size:
            plane_paras = plane_paras.copy()
            plane_paras[:, 1] *= -1
    return img, depth, masks, boxes, plane_paras


def random_rot90(img, depth, masks, boxes, plane_paras, rng):
    """k*90-degree rotation."""
    k = rng.randint(4)
    if k:
        old_h, old_w = img.shape[:2]
        img = np.rot90(img, k).copy()
        depth = np.rot90(depth, k).copy()
        masks = np.stack([np.rot90(m, k) for m in masks]) if masks.size \
            else masks
        boxes = boxes.copy()
        for _ in range(k):
            boxes = np.stack([
                np.array([b[1], old_w - 1 - b[2], b[3], old_w - 1 - b[0]])
                for b in boxes]) if len(boxes) else boxes
            old_w, old_h = old_h, old_w
        if plane_paras is not None and plane_paras.size:
            rot = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
            plane_paras = plane_paras.copy()
            # The single 90-degree rotation once, whatever k, as the JAX
            # package does.
            plane_paras[:, :3] = (rot @ plane_paras[:, :3].T).T
    return img, depth, masks, boxes, plane_paras


def random_motion_blur(img, rng, lower=3, upper=12, angle=180):
    """Directional motion blur."""
    if rng.randint(3) < 1:
        degree = rng.randint(lower, upper)
        ang = rng.randint(0, angle)
        blurred = filter2d(img, motion_blur_kernel(degree, ang))
        return normalize_minmax(blurred, 0, 255).astype(np.float32)
    return img


def random_gaussian_noise(img, rng, mean=0.0, var=0.0002):
    """Additive gaussian noise."""
    if rng.randint(3) < 1:
        x = img / 255.0
        v = rng.randint(5, 11) * var
        noise = rng.normal(mean, v ** 0.5, x.shape)
        out = np.clip(x + noise, -1.0 if (x + noise).min() < 0 else 0.0, 1.0)
        return (out * 255).astype(np.float32)
    return img


def resize_square(cfg, img, depth, masks, boxes, labels, plane_paras):
    """Resize to max_size x max_size and drop degenerate boxes."""
    img_h, img_w = img.shape[:2]
    size = cfg.max_size
    if img_h != size and img_w != size:
        img = resize_linear(img, (size, size))
        depth = resize_linear(depth, (size, size))
        if masks.size:
            m = masks.transpose(1, 2, 0)
            m = resize_linear(m, (size, size))
            masks = m[None] if m.ndim == 2 else m.transpose(2, 0, 1)
        else:
            masks = np.zeros((0, size, size), masks.dtype)
        boxes = boxes.copy()
        boxes[:, [0, 2]] *= size / img_w
        boxes[:, [1, 3]] *= size / img_h

    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    keep = (w > cfg.discard_box_width) & (h > cfg.discard_box_height)
    masks = masks[keep]
    boxes = boxes[keep]
    labels = labels[keep]
    if plane_paras is not None and plane_paras.size:
        plane_paras = plane_paras[keep]
    return img, depth, masks, boxes, labels, plane_paras


def backbone_transform(cfg, img, mean, std):
    """Normalise + channel permutation. Input float BGR [0,255], output
    RGB."""
    t = cfg.backbone.transform
    img = img.astype(np.float32)
    if t.normalize:
        img = (img - mean) / std
    elif t.subtract_means:
        img = img - mean
    elif t.to_float:
        img = img / 255.0
    if t.channel_order == "RGB":
        img = img[:, :, ::-1]
    return np.ascontiguousarray(img, np.float32)
