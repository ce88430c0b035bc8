"""COCO-format plane datasets, the fixed-capacity batcher and the loader.

Counterpart of ``planerecnet_tpu/data/datasets.py``: COCO-json annotations
extended with ``plane_paras`` and camera intrinsics, the per-dataset path
conventions (ScanNet, NYU, Stanford-2D3DS), 16-bit depth PNGs scaled by
``depth_resolution``, and the empty-GT resample. Instances are padded to
``cfg.max_instances`` with a validity mask, so a batch is one dict of
fixed-shape arrays: the wire batch that ``trainer.unpack_wire_batch``
takes. Files are read by ``image_io`` (no OpenCV).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.data.coco import COCO
from planerecnet_tpu_torch.data.image_io import imread, resize_linear


def get_label_map(cfg: PlaneRecNetConfig) -> Dict[int, int]:
    """category_id -> label map."""
    lm = cfg.dataset.label_map
    if lm is None:
        return {x + 1: x + 1
                for x in range(len(cfg.dataset.class_names))}
    return dict(lm)


class PlaneAnnoDataset:
    """Base reader: colour image + 16-bit depth PNG + COCO instance anns
    with plane parameters and intrinsics."""

    def __init__(self, cfg: PlaneRecNetConfig, image_path: str,
                 anno_file: str, transform=None, dataset_name: str = None,
                 has_gt: bool = True, has_pos: bool = True):
        self.cfg = cfg
        self.root = image_path
        self.coco = COCO(anno_file)
        self.ids = list(self.coco.imgToAnns.keys())
        if len(self.ids) == 0 or not has_gt:
            self.ids = list(self.coco.imgs.keys())
        self.transform = transform
        self.name = dataset_name
        self.has_gt = has_gt
        self.has_pos = has_pos

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int):
        return self.pull_item(index)

    def pull_image(self, index: int) -> np.ndarray:
        """Original BGR image."""
        img_id = self.ids[index]
        path = self.coco.loadImgs(img_id)[0]["file_name"]
        return imread(osp.join(self.root, path))

    def pull_depth(self, index: int) -> np.ndarray:
        """Original uint16 depth map."""
        img_id = self.ids[index]
        img_path = self.coco.loadImgs(img_id)[0]["file_name"]
        return imread(self.get_depth_path(img_path), color=False)

    def pull_anno(self, index: int):
        """Original annotations."""
        img_id = self.ids[index]
        return self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))

    # -- path conventions overridden per dataset --
    def get_depth_path(self, rgb_file_name: str) -> str:
        raise NotImplementedError

    def get_camera_matrix(self, rgb_file_name: str) -> np.ndarray:
        raise NotImplementedError

    def get_plane_para(self, target: List[Dict]) -> List[List[float]]:
        return [[obj["plane_paras"][i] for i in range(4)] for obj in target]

    def pull_item(self, index: int):
        """Returns (HWC float image, instances dict, HxWx1 depth in
        metres)."""
        cfg = self.cfg
        img_id = self.ids[index]
        if self.has_gt:
            target = [a for a in self.coco.loadAnns(
                self.coco.getAnnIds(imgIds=img_id))
                if a["image_id"] == img_id]
        else:
            target = []
        file_name = self.coco.loadImgs(img_id)[0]["file_name"]
        path = osp.join(self.root, file_name)
        assert osp.exists(path), f"Image path does not exist: {path}"
        img = imread(path).astype(np.float32)
        height, width, _ = img.shape

        depth = imread(self.get_depth_path(file_name),
                       color=False).astype(np.float32)

        if self.has_pos:
            k_matrix = self.get_camera_matrix(file_name)
            s = cfg.dataset.scale_factor
            scale = np.asarray([[s, 0, s], [0, s, s], [0, 0, 1]])
            k_matrix = scale * k_matrix
        else:
            k_matrix = np.zeros((3, 3))

        masks = boxes = labels = plane_paras = None
        if len(target) > 0:
            masks = np.stack([self.coco.annToMask(o) for o in target]
                             ).reshape(-1, height, width)
            boxes = np.array([[o["bbox"][0], o["bbox"][1],
                               o["bbox"][0] + o["bbox"][2],
                               o["bbox"][1] + o["bbox"][3]] for o in target],
                             np.float32)
            lm = get_label_map(cfg)
            labels = np.array([lm[o["category_id"]] - 1 for o in target])
            if cfg.dataset.has_pos:
                plane_paras = np.array(self.get_plane_para(target),
                                       np.float32)
            else:
                plane_paras = np.zeros((len(target), 4), np.float32)

        if self.transform is not None and len(target) > 0:
            img, depth, masks, boxes, labels, plane_paras = self.transform(
                img, depth, masks, boxes, labels, plane_paras)

        if masks is None or len(masks) == 0:
            # Empty-GT resample, drawn from numpy's global generator as
            # the JAX package draws it (another generator would pick
            # another image).
            return self.pull_item(np.random.randint(0, len(self.ids)))

        instances = {
            "masks": masks.astype(np.float32),
            "boxes": boxes.astype(np.float32),
            "classes": labels.astype(np.int32),
            "plane_paras": plane_paras.astype(np.float32),
            "k_matrix": k_matrix.astype(np.float32),
        }
        depth_m = depth[..., None] * (cfg.dataset.depth_resolution or 1.0)
        # Keep the transform's dtype: SSDAugmentation(device_normalize=True)
        # emits u8 wire images (normalisation happens on device).
        if img.dtype != np.uint8:
            img = img.astype(np.float32)
        return img, instances, depth_m.astype(np.float32)


class ScanNetDataset(PlaneAnnoDataset):
    """ScanNet path conventions."""

    def get_depth_path(self, rgb_file_name: str) -> str:
        name = rgb_file_name.replace("color", "depth").replace(".jpg", ".png")
        return osp.join(self.root, name)

    def get_camera_matrix(self, rgb_file_name: str) -> np.ndarray:
        sens = rgb_file_name.split("/")[0]
        pose_path = os.path.join(self.root, sens, "frame", "intrinsic",
                                 sens + ".txt")
        with open(pose_path) as f:
            lines = f.readlines()
        words = lines[9].split(" ")
        return np.asarray([float(words[i]) for i in range(2, 18)]
                          ).reshape(4, 4)[:3, :3]


class NYUDataset(PlaneAnnoDataset):
    """NYU depth path convention."""

    def get_depth_path(self, rgb_file_name: str) -> str:
        root = self.root.replace("images", "depths")
        return osp.join(root, rgb_file_name.replace(".jpg", ".png"))


class S2D3DSDataset(PlaneAnnoDataset):
    """Stanford 2D-3D-S conventions."""

    def get_depth_path(self, rgb_file_name: str) -> str:
        root = self.root.replace("images", "depths")
        name = rgb_file_name.replace("rgb", "depth").replace(".jpg", ".png")
        return osp.join(root, name)

    def get_camera_matrix(self, rgb_file_name: str) -> np.ndarray:
        root = self.root.replace("images_val", "poses").replace(
            "images", "poses")
        name = rgb_file_name.replace("rgb", "pose").replace(".jpg", ".json")
        with open(os.path.join(root, name)) as f:
            pose = json.load(f)
        return np.asarray(pose["camera_k_matrix"])

    def get_plane_para(self, target: List[Dict]) -> List[List[float]]:
        return [[o["plane_paras"][i] for i in range(6)] for o in target]


DATASET_CLASSES = {
    "PlaneAnnoDataset": PlaneAnnoDataset,
    "ScanNetDataset": ScanNetDataset,
    "NYUDataset": NYUDataset,
    "S2D3DSDataset": S2D3DSDataset,
}


def build_dataset(cfg: PlaneRecNetConfig, split: str = "train",
                  transform=None) -> PlaneAnnoDataset:
    """The dataset class that ``cfg.dataset.name`` names, on ``split``."""
    d = cfg.dataset
    paths = {
        "train": (d.train_images, d.train_info),
        "valid": (d.valid_images, d.valid_info),
        "eval": (d.eval_images, d.eval_info),
    }[split]
    cls = DATASET_CLASSES[d.name]
    return cls(cfg, paths[0], paths[1], transform=transform,
               dataset_name=d.name, has_gt=d.has_gt, has_pos=d.has_pos)


def pad_instances(cfg: PlaneRecNetConfig, instances: Dict,
                  img_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Pad one image's instance dict to ``cfg.max_instances`` slots with a
    validity mask."""
    n_cap = cfg.max_instances
    h, w = img_hw
    n = min(len(instances["classes"]), n_cap)
    out = {
        # Binary masks travel as uint8 (the loss casts on the device); the
        # float->uint8 assignment truncates fractional resize-edge values,
        # as the JAX package does.
        "masks": np.zeros((n_cap, h, w), np.uint8),
        "boxes": np.zeros((n_cap, 4), np.float32),
        "classes": np.zeros((n_cap,), np.int32),
        "plane_paras": np.zeros((n_cap, max(
            4, instances["plane_paras"].shape[-1]
            if instances["plane_paras"].ndim == 2 else 4)), np.float32),
        "gt_valid": np.zeros((n_cap,), bool),
        "k_matrix": instances["k_matrix"].astype(np.float32),
    }
    if n:
        out["masks"][:n] = instances["masks"][:n]
        out["boxes"][:n] = instances["boxes"][:n]
        out["classes"][:n] = instances["classes"][:n]
        if instances["plane_paras"].ndim == 2 and instances["plane_paras"].size:
            pp = instances["plane_paras"][:n]
            out["plane_paras"][:n, :pp.shape[1]] = pp
        out["gt_valid"][:n] = True
    return out


def collate_batch(cfg: PlaneRecNetConfig, samples: List,
                  stats: Optional[Dict[str, int]] = None,
                  sparse_masks: Optional[bool] = None
                  ) -> Dict[str, np.ndarray]:
    """Stack padded samples into the fixed-shape wire batch dict, which
    the trainer's ``unpack_wire_batch`` turns dense on the device.

    Wire format:
      * ``masks_sparse`` + ``mask_slots`` (default, ``cfg.wire_sparse_masks``):
        only the valid instance slots' bit-packed masks, a (M16, H,
        ceil(W/8)) u8 row array and an int32 vector mapping row -> flat
        (image, slot) index; M16 = n_valid rounded up to a multiple of 16.
        Padding rows carry the out-of-range slot ``B * max_instances``.
      * ``masks_packed`` (``sparse_masks=False``): all ``max_instances``
        slots, bit-packed along W (``np.packbits``).
      * ``depth_q``: u16 depth in ``depth_resolution`` units, lossless for
        16-bit PNGs at that resolution; interpolated values round to half
        a unit.
      * ``image``: u8 BGR when the transform leaves normalisation to the
        device (SSDAugmentation), f32 otherwise (eval transforms).
    ``stats`` counts the GT that the capacities truncate.
    """
    imgs, insts, depths = zip(*samples)
    h, w = imgs[0].shape[:2]
    padded = [pad_instances(cfg, i, (h, w)) for i in insts]
    if stats is not None:
        # Instances beyond max_instances are dropped by pad_instances, and
        # planes beyond vnl_max_planes never reach the VNL sampler; both
        # are counted, so that the truncation is seen.
        for i in insts:
            n = len(i["classes"])
            stats["instances_dropped"] = stats.get(
                "instances_dropped", 0) + max(0, n - cfg.max_instances)
            if cfg.use_plane_loss:
                stats["vnl_planes_dropped"] = stats.get(
                    "vnl_planes_dropped", 0) + max(
                        0, min(n, cfg.max_instances) - cfg.vnl_max_planes)
    depth = np.stack(depths)
    res = cfg.dataset.depth_resolution or 1e-3
    batch = {
        "image": np.stack(imgs),
        "depth_q": np.clip(np.round(depth / res), 0, 65535).astype(
            np.uint16),
    }
    if sparse_masks is None:
        sparse_masks = getattr(cfg, "wire_sparse_masks", True)
    if sparse_masks:
        n_cap = cfg.max_instances
        rows, slots = [], []
        for bi, p in enumerate(padded):
            n = int(p["gt_valid"].sum())
            if n:
                rows.append(np.packbits(p["masks"][:n], axis=-1))
                slots.extend(range(bi * n_cap, bi * n_cap + n))
        m = len(slots)
        m16 = max(16, -(-m // 16) * 16)
        w8 = -(-w // 8)
        masks_sparse = np.zeros((m16, h, w8), np.uint8)
        if m:
            masks_sparse[:m] = np.concatenate(rows, axis=0)
        mask_slots = np.full((m16,), len(padded) * n_cap, np.int32)
        mask_slots[:m] = slots
        batch["masks_sparse"] = masks_sparse
        batch["mask_slots"] = mask_slots
    else:
        masks = np.stack([p["masks"] for p in padded])
        batch["masks_packed"] = np.packbits(masks, axis=-1)
    for key in ("boxes", "classes", "plane_paras", "gt_valid",
                "k_matrix"):
        batch[key] = np.stack([p[key] for p in padded])
    # The loss consumes 4-vector plane params (normal + offset); S2D3DS
    # stores 6 values, of which the first 4 are used.
    batch["plane_paras"] = batch["plane_paras"][:, :, :4]
    return batch


def enforce_size(cfg: PlaneRecNetConfig, img: np.ndarray,
                 depth: np.ndarray, instances: Dict, new_w: int,
                 new_h: int):
    """Aspect-preserving resize + top-left zero pad to (new_h, new_w)."""
    h, w = img.shape[:2]
    if h == new_h and w == new_w:
        return img, depth, instances

    w_prime = new_w
    h_prime = h * new_w / w
    if h_prime > new_h:
        w_prime *= new_h / h_prime
        h_prime = new_h
    w_prime, h_prime = int(w_prime), int(h_prime)

    img = resize_linear(img, (w_prime, h_prime))
    depth = resize_linear(depth, (w_prime, h_prime))
    masks = instances["masks"]
    if masks.size:
        m = resize_linear(masks.transpose(1, 2, 0), (w_prime, h_prime))
        masks = m[None] if m.ndim == 2 else m.transpose(2, 0, 1)

    boxes = instances["boxes"].copy()
    boxes[:, [0, 2]] *= w_prime / new_w
    boxes[:, [1, 3]] *= h_prime / new_h

    def pad2(x, tgt_h, tgt_w):
        out = np.zeros(x.shape[:-2] + (tgt_h, tgt_w) if x.ndim == 3
                       else (tgt_h, tgt_w) + x.shape[2:], x.dtype)
        if x.ndim == 3:
            out[:, :x.shape[1], :x.shape[2]] = x
        else:
            out[:x.shape[0], :x.shape[1], ...] = x
        return out

    img_p = np.zeros((new_h, new_w) + img.shape[2:], img.dtype)
    img_p[:h_prime, :w_prime] = img
    depth_p = np.zeros((new_h, new_w) + depth.shape[2:], depth.dtype)
    depth_p[:h_prime, :w_prime] = depth
    masks_p = np.zeros((masks.shape[0], new_h, new_w), masks.dtype)
    if masks.size:
        masks_p[:, :h_prime, :w_prime] = masks

    out = dict(instances)
    out["masks"] = masks_p
    out["boxes"] = boxes
    return img_p, depth_p, out


class PrefetchIterator:
    """Background-thread prefetcher: host loading, augmentation and
    collation, and with ``to_device`` the upload, overlap the device's
    step. Counterpart of the JAX package's ``PrefetchIterator``, whose
    worker calls ``jax.device_put``.

    Upload (``to_device`` and a CUDA ``device``): the worker pins each
    batch's arrays and copies them on a stream of its own. The consumer
    makes its current stream wait for that copy, and marks each tensor as
    used on its stream (``record_stream``): the tensors were allocated on
    the worker's stream, and without the mark the caching allocator could
    give their memory to the next upload while the step that reads them is
    still queued. Otherwise batches stay numpy. An exception in the worker
    is raised to the consumer. Leaving the loop early stops the worker.
    """

    def __init__(self, iterable, buffer_size: int = 2,
                 to_device: bool = True, device="cuda"):
        self.iterable = iterable
        self.buffer_size = buffer_size
        self.device = torch.device(device)
        self.upload = to_device and self.device.type == "cuda"
        # Occupancy probe, sampled at every consumer get: ~0 means the
        # device waits on the host loader, ~buffer_size that the loader
        # keeps up.
        self.occupancy_sum = 0
        self.occupancy_n = 0

    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.occupancy_n, 1)

    def _upload(self, batch, stream):
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        stop = threading.Event()
        sentinel = object()
        errors: List[BaseException] = []
        stream = torch.cuda.Stream(self.device) if self.upload else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.iterable:
                    item = (self._upload(batch, stream) if self.upload
                            else (batch, None))
                    if not put(item):
                        return
            except BaseException as e:   # raised again by the consumer
                errors.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                self.occupancy_sum += q.qsize()
                self.occupancy_n += 1
                item = q.get()
                if item is sentinel:
                    if errors:
                        raise errors[0]
                    return
                batch, done = item
                if done is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    for v in batch.values():
                        v.record_stream(current)
                yield batch
        finally:
            stop.set()
            t.join()


class BatchIterator:
    """Shuffled epoch iterator yielding fixed-shape batches.

    Sharding: with ``num_shards > 1`` every process draws the same seeded
    permutation but loads only its ``shard_index``-th slice of each global
    batch, so the per-process batches are disjoint and together form the
    global batch. ``batch_size`` stays the global batch size; the yielded
    batch has ``batch_size // num_shards`` rows.
    """

    def __init__(self, cfg: PlaneRecNetConfig, dataset: PlaneAnnoDataset,
                 batch_size: int, seed: int = 0, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        if batch_size % num_shards != 0:
            raise ValueError(
                f"global batch size {batch_size} not divisible by "
                f"{num_shards} processes")
        self.cfg = cfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        # GT-truncation counters, accumulated by collate_batch; the train
        # CLI reports and resets them per epoch.
        self.truncation_stats: Dict[str, int] = {}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.dataset))
        per_shard = self.batch_size // self.num_shards
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            # A short tail batch is always dropped when sharding: a partial
            # global batch would give processes empty/unequal shards and
            # desynchronise their step counts.
            if len(idx) < self.batch_size and (
                    self.drop_last or self.num_shards > 1):
                return
            lo = self.shard_index * per_shard
            samples = [self.dataset[j] for j in idx[lo:lo + per_shard]]
            # Sparse mask rows have a data-dependent count; sharded runs
            # need shards of one shape, so they take the all-slots wire.
            yield collate_batch(
                self.cfg, samples, stats=self.truncation_stats,
                sparse_masks=(getattr(self.cfg, "wire_sparse_masks", True)
                              and self.num_shards == 1))
