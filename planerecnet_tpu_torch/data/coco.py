"""COCO-format annotations: the JSON index, the RLE codec and polygon masks.

Counterpart of ``planerecnet_tpu/data/coco.py`` (a stand-in for
``pycocotools``). ``rle_to_mask`` and ``mask_to_rle`` run the C codec
(``native/rle.c``, built at first use), with no fallback; the numpy codec
beside them (``rle_to_mask_plain``, ``mask_to_rle_plain``) is its plain
version. Polygons are rasterised by ``image_io.fill_poly``, which draws as
``cv2.fillPoly`` does.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from planerecnet_tpu_torch.data.image_io import fill_poly
from planerecnet_tpu_torch.native import (rle_decode_counts_native,
                                          rle_encode_mask_native,
                                          rle_fill_native)


def _decode_rle_counts(s: str) -> List[int]:
    """Decode a COCO compressed-RLE counts string (6-bit varint with sign
    extension and delta coding for runs past the first two)."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_rle_counts(counts) -> str:
    """Encode runs as a COCO compressed counts string, the inverse of
    ``_decode_rle_counts``, so that dumped detections are read by
    pycocotools-based scorers."""
    chars: List[str] = []
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # arithmetic shift: sign-fills for negative deltas
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Decode an RLE segmentation dict, compressed (str counts) or not
    (list counts), to a (H, W) uint8 mask with the C codec. COCO RLE is
    column-major: counts alternate runs of 0s and 1s down the columns."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_decode_counts_native(counts)
    return rle_fill_native(counts, h, w)


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Encode a (H, W) binary mask as uncompressed column-major RLE with
    the C codec."""
    h, w = mask.shape
    return {"size": [h, w], "counts": rle_encode_mask_native(mask)}


def rle_to_mask_plain(rle: Dict) -> np.ndarray:
    """``rle_to_mask`` in numpy: the C codec's plain version."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        counts = _decode_rle_counts(counts)
    counts = np.asarray(counts, np.int64)
    if counts.sum() != h * w:
        raise ValueError(f"RLE counts sum to {int(counts.sum())}, not "
                         f"{h} x {w}")
    flat = np.repeat((np.arange(counts.size) % 2).astype(np.uint8), counts)
    return flat.reshape(w, h).T  # column-major -> (H, W)


def mask_to_rle_plain(mask: np.ndarray) -> Dict:
    """``mask_to_rle`` in numpy: the C codec's plain version."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    # run-length encode, starting with a (possibly zero-length) 0-run.
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def mask_to_compressed_rle(mask: np.ndarray) -> Dict:
    """Encode a (H, W) binary mask as COCO compressed RLE (string counts),
    the format pycocotools' ``encode`` emits and external scorers expect."""
    rle = mask_to_rle(mask)
    return {"size": rle["size"], "counts": _encode_rle_counts(rle["counts"])}


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    """Rasterise COCO polygon segmentation to a (H, W) uint8 mask."""
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int64)
           for p in polys if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


class COCO:
    """Tiny pycocotools.coco.COCO work-alike over a COCO-format JSON file."""

    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: Dict = {}
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.imgToAnns: Dict[int, List[Dict]] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self._create_index()

    def _create_index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns[ann["image_id"]].append(ann)
        self.imgToAnns = dict(self.imgToAnns)

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return list(self.anns.keys())
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        out = []
        for i in imgIds:
            out.extend(a["id"] for a in self.imgToAnns.get(i, []))
        return out

    def loadAnns(self, ids) -> List[Dict]:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids) -> List[Dict]:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annToMask(self, ann: Dict) -> np.ndarray:
        """Decode an annotation's segmentation to a (H, W) uint8 mask."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        seg = ann["segmentation"]
        if isinstance(seg, list):
            return polygons_to_mask(seg, h, w)
        if isinstance(seg, dict):
            return rle_to_mask(seg)
        raise TypeError(f"unsupported segmentation type {type(seg)}")
