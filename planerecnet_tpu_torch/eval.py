"""The port's evaluation CLI: ``python -m planerecnet_tpu_torch.eval``.

Counterpart of the repository's ``eval.py``: mask and box mAP (greedy
matching, COCO-style 101-point interpolation) and the eight depth metrics
over an annotation split, with the time per image (the first two frames
left out), or, with ``--output_coco_json``, the detections as COCO result
files; ``--autopsy`` adds seg/depth image panels of 3 images to
TensorBoard under ``--log_folder``. Runs on ``cuda`` unless ``--device
cpu`` is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from planerecnet_tpu_torch.config import (apply_overrides, set_cfg,
                                          set_dataset)
from planerecnet_tpu_torch.data import BaseTransform, build_dataset
from planerecnet_tpu_torch.data.coco import mask_to_compressed_rle
from planerecnet_tpu_torch.data.datasets import get_label_map
from planerecnet_tpu_torch.data.image_io import resize_linear
from planerecnet_tpu_torch.evaluation import (DEPTH_METRICS, calc_map,
                                              compute_depth_metrics,
                                              compute_segmentation_metrics,
                                              make_ap_data)
from planerecnet_tpu_torch.runner import PlaneRecNetRunner, resolve_device
from planerecnet_tpu_torch.utils import (MovingAverage, ProgressBar,
                                         SavePath)
from planerecnet_tpu_torch.utils import timer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PlaneRecNet Evaluation")
    parser.add_argument("--trained_model", default=None, type=str,
                        help='Weights to evaluate ("interrupt"/"latest" '
                             "resolve from weights/).")
    parser.add_argument("--config", default=None,
                        help="Config name; parsed from the model file name "
                             "when omitted.")
    parser.add_argument("--dataset", default=None, type=str)
    parser.add_argument("--max_images", default=-1, type=int,
                        help="Images to evaluate; -1: all but one, as the "
                             "JAX package's CLI does.")
    parser.add_argument("--no_bar", action="store_true")
    parser.add_argument("--batch_size", default=1, type=int,
                        help="Images per call (tail padded). Metrics are "
                             "identical at any batch size.")
    parser.add_argument("--host_metrics", action="store_true",
                        help="Compute the pred-vs-GT mask IoU on the host "
                             "from the full masks instead of on the device "
                             "(identical results; a debugging aid).")
    # A flagless run uses the preset's thresholds (the JAX CLI's pinned
    # parity configuration); each flag overrides one field.
    parser.add_argument("--top_k", default=None, type=int,
                        help="Max detections kept per image "
                             "(default: config preset, 100).")
    parser.add_argument("--nms_mode", default=None, type=str,
                        choices=["matrix", "mask"],
                        help="NMS type (default: config preset, matrix).")
    parser.add_argument("--score_threshold", default=None, type=float,
                        help="Detections with a score under this threshold "
                             "are not considered (score_thr; default: "
                             "config preset, 0.1).")
    parser.add_argument("--mask_threshold", default=None, type=float,
                        help="Mask binarisation / NMS-IoU threshold "
                             "(mask_thr; default: config preset, 0.1).")
    parser.add_argument("--update_threshold", default=None, type=float,
                        help="Post-NMS rescored-confidence filter "
                             "(update_thr; default: config preset, 0.15).")
    parser.add_argument("--seed", default=None, type=int,
                        help="Seed of the image order.")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "auto"],
                        help="Compute dtype of the evaluated model.")
    parser.add_argument("--output_coco_json", action="store_true",
                        help="Instead of computing IoU metrics, dump "
                             "detections as COCO-format box + mask-RLE "
                             "result JSONs for external scorers.")
    parser.add_argument("--bbox_det_file",
                        default="results/bbox_detections.json", type=str)
    parser.add_argument("--mask_det_file",
                        default="results/mask_detections.json", type=str)
    parser.add_argument("--metrics_json", default=None, type=str,
                        help="Write the mAP table + depth metrics as JSON "
                             "to this path.")
    parser.add_argument("--cfg_overrides", default=None, type=str,
                        help="JSON dict of (possibly nested) config "
                             "overrides applied after --config/--dataset.")
    parser.add_argument("--device", default="cuda",
                        help="Where the model runs: cuda (default; raises "
                             "where there is no card) or cpu.")
    parser.add_argument("--autopsy", action="store_true",
                        help="Also write predicted seg/depth image panels "
                             "to TensorBoard.")
    parser.add_argument("--log_folder", default="./logs/", type=str)
    return parser.parse_args(argv)


class COCODetectionDumper:
    """Accumulates predictions as COCO-format detection results: per
    image, score-sorted box and compressed-RLE mask entries at the
    original image resolution."""

    def __init__(self, dataset):
        # Predictions are 0-based contiguous labels; invert the dataset's
        # category_id -> label map to recover COCO category ids.
        lm = get_label_map(dataset.cfg)
        self.label_to_cat = {v - 1: k for k, v in lm.items()}
        self.dataset = dataset
        self.bbox_entries: List[Dict] = []
        self.mask_entries: List[Dict] = []

    def add_image(self, dataset_index, masks, boxes, classes, scores):
        """masks: (N, h, w) bool at the evaluated resolution; boxes xyxy in
        the same space; entries are rescaled to the original image size."""
        img_id = self.dataset.ids[dataset_index]
        info = self.dataset.coco.loadImgs(img_id)[0]
        oh, ow = info["height"], info["width"]
        order = np.argsort(-np.asarray(scores))
        for i in order:
            score = float(scores[i])
            cat_id = self.label_to_cat.get(int(classes[i]))
            if cat_id is None:
                # The extra, never-positive class channel has no COCO
                # category to score against.
                continue
            m = np.asarray(masks[i], np.float32)
            h, w = m.shape
            if (h, w) != (oh, ow):
                m = resize_linear(m, (ow, oh))
            rle = mask_to_compressed_rle(m > 0.5)
            x1, y1, x2, y2 = np.asarray(boxes[i], np.float64)
            sx, sy = ow / w, oh / h
            bbox = [x1 * sx, y1 * sy, (x2 - x1) * sx, (y2 - y1) * sy]
            self.bbox_entries.append({
                "image_id": int(img_id), "category_id": int(cat_id),
                "bbox": [round(float(v), 2) for v in bbox],
                "score": round(score, 5)})
            self.mask_entries.append({
                "image_id": int(img_id), "category_id": int(cat_id),
                "segmentation": rle, "score": round(score, 5)})

    def dump(self, bbox_file, mask_file):
        for path, entries in ((bbox_file, self.bbox_entries),
                              (mask_file, self.mask_entries)):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(entries, f)
        print(f"\nDumped {len(self.bbox_entries)} detections to "
              f"{bbox_file} / {mask_file}")


def apply_nms_overrides(cfg, args):
    """Apply only the NMS/threshold flags that were passed."""
    overrides = {}
    if args.nms_mode is not None:
        overrides["nms_type"] = args.nms_mode
    if args.score_threshold is not None:
        overrides["score_thr"] = args.score_threshold
    if args.mask_threshold is not None:
        overrides["mask_thr"] = args.mask_threshold
    if args.update_threshold is not None:
        overrides["update_thr"] = args.update_threshold
    if args.top_k is not None:
        overrides["top_k"] = args.top_k
    if overrides:
        cfg = cfg.copy(dict(solov2=cfg.solov2.copy(overrides)))
    return cfg


def _host(batched: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in batched.items()}


def tensorboard_visual_log(net, dataset, writer, iteration, eval_nums):
    """Predicted seg/depth panels of ``eval_nums`` random images (the JAX
    CLI's)."""
    from planerecnet_tpu_torch.simple_inference import (_valid_result,
                                                        display_on_frame)
    indices = list(range(len(dataset)))
    random.shuffle(indices)
    for it, image_idx in enumerate(indices[:eval_nums]):
        image, _, _ = dataset.pull_item(image_idx)
        frame_ori = dataset.pull_image(image_idx) \
            if hasattr(dataset, "pull_image") else None
        batched = net.infer_normalized(image[None], image.shape[:2])
        result = _valid_result(batched, 0)
        if frame_ori is None:
            frame_ori = ((image - image.min())
                         / max(float(np.ptp(image)), 1e-6) * 255)
        seg, depth = display_on_frame(
            result, frame_ori.astype(np.float32), net.cfg, mask_alpha=0.35)
        h, w = depth.shape
        crop = depth[min(20, h // 4):h - min(20, h // 4),
                     min(20, w // 4):w - min(20, w // 4)]
        vmin, vmax = np.percentile(crop, 1), np.percentile(crop, 99)
        crop = crop.clip(vmin, vmax)
        crop = ((crop - crop.min()) / max(float(np.ptp(crop)), 1e-12)
                * 255).astype(np.uint8)
        writer.add_image(f"depth/pred/{it}", crop, iteration,
                         dataformats="HW")
        writer.add_image(f"seg/pred/{it}", seg[:, :, ::-1], iteration,
                         dataformats="HWC")


def evaluate(net: PlaneRecNetRunner, dataset, during_training=False,
             eval_nums=-1, no_bar=False, batch_size=1, device_metrics=True,
             dumper=None, stats: Optional[Dict] = None):
    """The eval loop. Returns (mAP tables, depth metric means), or
    (None, None) when ``dumper`` collects the detections instead.

    Images go to the model ``batch_size`` at a time (the tail batch padded
    by repeating its last image, the padded results discarded); the
    metric bookkeeping is per image on the host. ``device_metrics``
    computes the pred-vs-GT mask IoU on the device
    (``infer_normalized_with_gt_iou``), so the full masks never come back
    to the host; a batch with an image of more GT planes than
    ``cfg.max_instances`` takes the host path. ``stats``, where given,
    receives the mean ms per image after the first two and the count of
    valid detections.
    """
    frame_times = MovingAverage()
    eval_nums = len(dataset) - 1 if eval_nums < 0 else min(eval_nums,
                                                           len(dataset))
    progress_bar = ProgressBar(30, max(eval_nums, 1))
    print()

    dataset_indices = list(range(len(dataset)))
    random.shuffle(dataset_indices)
    dataset_indices = dataset_indices[:eval_nums]

    infos = []
    ap_data = make_ap_data()
    clipped_images = 0
    detections = 0
    it = -1

    for lo in range(0, len(dataset_indices), batch_size):
        chunk = dataset_indices[lo:lo + batch_size]
        timer.reset()
        with timer.env("everything"):
            items = [dataset.pull_item(i) for i in chunk]
            images = np.stack([im for im, _, _ in items])
            if len(items) < batch_size:   # pad the tail batch (discarded)
                reps = np.repeat(images[-1:], batch_size - len(items), axis=0)
                images = np.concatenate([images, reps], axis=0)
            h, w = images.shape[1:3]
            n_cap = net.cfg.max_instances
            gts = [gt for _, gt, _ in items]
            # the COCO dump needs the full binarised masks on host
            use_dev = dumper is None and device_metrics and all(
                len(g["classes"]) <= n_cap for g in gts)
            if use_dev:
                gt_pad = np.zeros((images.shape[0], n_cap, h, w), np.float32)
                for j, g in enumerate(gts):
                    m = np.asarray(g["masks"], np.float32)
                    if m.size:
                        gt_pad[j, :m.shape[0]] = m.reshape(-1, h, w)
                batched = net.infer_normalized_with_gt_iou(
                    images, gt_pad, (h, w))
            else:
                batched = net.infer_normalized(images, (h, w))
            batched = _host(batched)   # waits for the device

        clipped_images += int(np.asarray(
            batched.get("candidates_clipped", np.zeros(1))).reshape(-1)[0])
        batch_ms = timer.total_time() * 1000 / max(len(chunk), 1)

        for j, (_, gt_instances, gt_depth) in enumerate(items):
            it += 1
            valid = batched["pred_valid"][j]
            detections += int(valid.sum())
            if dumper is None:
                depth_err = compute_depth_metrics(
                    batched["pred_depth"][j], gt_depth[..., 0], net.cfg,
                    median_scaling=True)
                infos.append(depth_err)

            if valid.any():
                pred_boxes = batched["pred_boxes"][j][valid]
                pred_classes = batched["pred_classes"][j][valid]
                pred_scores = batched["pred_scores"][j][valid]
                if dumper is not None:
                    dumper.add_image(chunk[j], batched["pred_masks"][j][valid],
                                     pred_boxes, pred_classes, pred_scores)
                elif use_dev:
                    n_gt = len(gt_instances["classes"])
                    iou_cache = batched["gt_mask_iou"][j][valid][:, :n_gt]
                    compute_segmentation_metrics(
                        ap_data, None, gt_instances["boxes"],
                        gt_instances["classes"], None, pred_boxes,
                        pred_classes, pred_scores,
                        mask_iou_cache=iou_cache)
                else:
                    compute_segmentation_metrics(
                        ap_data, gt_instances["masks"], gt_instances["boxes"],
                        gt_instances["classes"],
                        batched["pred_masks"][j][valid], pred_boxes,
                        pred_classes, pred_scores)

            if it > 1:
                frame_times.add(batch_ms)
            if not no_bar:
                fps = 1000 / frame_times.get_avg() if it > 1 and len(
                    frame_times) else 0
                progress = (it + 1) / max(eval_nums, 1) * 100
                progress_bar.set_val(it + 1)
                print("\rProcessing Images  %s %6d / %6d (%5.2f%%)  "
                      "%5.2f fps  "
                      % (repr(progress_bar), it + 1, eval_nums, progress,
                         fps), end="")

    if stats is not None:
        stats["ms_per_image"] = frame_times.get_avg()
        stats["detections"] = detections
    if clipped_images:
        print(f"\nWARNING: candidate capacity saturated on {clipped_images} "
              f"image(s) (raise cfg.solov2.max_candidates).")
    if dumper is not None:
        return None, None
    all_maps = calc_map(ap_data)
    infos = np.asarray(infos, dtype=np.double)
    means = infos.sum(axis=0) / max(infos.shape[0], 1)
    print("\nDepth Metrics:")
    print(", ".join(f"{k}: {v:.5f}" for k, v in zip(DEPTH_METRICS, means)))
    return all_maps, means


def main(argv=None) -> Optional[Dict]:
    """Run the CLI. Returns what ``--metrics_json`` writes, with the mean
    ms per image and the count of valid detections, or None in
    ``--output_coco_json`` mode."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.seed is not None:
        random.seed(args.seed)
    if args.trained_model == "interrupt":
        args.trained_model = SavePath.get_interrupt("weights/")
    elif args.trained_model == "latest":
        args.trained_model = SavePath.get_latest(
            "weights/", set_cfg(args.config).name if args.config else "")
    if args.config is None:
        model_path = SavePath.from_str(args.trained_model)
        args.config = model_path.model_name + "_config"
        print("Config not specified. Parsed %s from the file name.\n"
              % args.config)
    cfg = set_cfg(args.config)
    if args.dataset is not None:
        cfg = set_dataset(cfg, args.dataset)
    if args.cfg_overrides:
        cfg = apply_overrides(cfg, json.loads(args.cfg_overrides))
    cfg = cfg.copy(dict(compute_dtype=args.dtype))
    cfg = apply_nms_overrides(cfg, args)

    dataset = build_dataset(cfg, "eval", transform=BaseTransform(cfg))
    print("Loading model...", end="")
    net = PlaneRecNetRunner(cfg, device=device)
    if args.trained_model:
        net.load_weights(args.trained_model)
    print("done.")

    dumper = COCODetectionDumper(dataset) if args.output_coco_json else None
    stats: Dict = {}
    all_maps, depth_means = evaluate(
        net, dataset, eval_nums=args.max_images, no_bar=args.no_bar,
        batch_size=args.batch_size, device_metrics=not args.host_metrics,
        dumper=dumper, stats=stats)
    if dumper is not None:
        dumper.dump(args.bbox_det_file, args.mask_det_file)
        return None
    payload = {"box": all_maps["box"], "mask": all_maps["mask"],
               "depth": {k: float(v) for k, v in
                         zip(DEPTH_METRICS, depth_means)},
               "model": args.trained_model, "config": args.config,
               "images": args.max_images}
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"Metrics written to {args.metrics_json}")
    if args.autopsy:
        autopsy(args, cfg, net, dataset)
    return dict(payload, **stats)


def autopsy(args, cfg, net, dataset) -> None:
    """``--autopsy``: panels of 3 images to ``<log_folder>/autopsy_*``."""
    import datetime
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("TensorBoard unavailable; skipping --autopsy.")
        return
    begin = datetime.datetime.now().strftime("%d%m%Y%H%M%S")
    logpath = os.path.join(args.log_folder, "autopsy_" + begin + "_" + cfg.name)
    os.makedirs(logpath, exist_ok=True)
    writer = SummaryWriter(logpath)
    try:
        tensorboard_visual_log(net, dataset, writer, 0, eval_nums=3)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
