"""Inference benchmark of the port: prints ONE JSON line with images/sec.

    python -m planerecnet_tpu_torch.bench [--config PlaneRecNet_50_config]
        [--batch_size 8] [--iters 50] [--warmup 5] [--height 480]
        [--width 640] [--sync_iters 10] [--dtype float32] [--image PNG]
        [--device cuda]

Counterpart of the repository's ``bench.py``, with the same flags (and
``--device``) and the same JSON keys: the full pipeline of
``PlaneRecNetRunner.infer`` (normalisation, forward, post-processing) on
``--iters`` distinct frames, staged on the device before the timed loop.
``value`` is images per second over the whole loop, timed on the host
clock from a ``torch.cuda.synchronize()`` before the first request to one
after the last; ``sync_roundtrip_ms`` the mean of requests each followed
by reading its scores back to the host. ``baseline`` is the upstream
model's published FPS on an RTX 3090 (19.1 for PRN-50, 14.4 for PRN-101;
no figure for the other presets), a different card: ``vs_baseline`` is a
ratio across cards, not a speed-up of this code. The config's "auto"
dtype runs in f32 in the port and is reported as ``auto:f32``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# The upstream model's FPS on an RTX 3090 (its README), by config name.
RTX3090_FPS = {"PlaneRecNet_50": 19.1, "PlaneRecNet_101": 14.4}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="PlaneRecNet_50_config")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--iters", default=50, type=int)
    parser.add_argument("--warmup", default=5, type=int)
    parser.add_argument("--height", default=480, type=int)
    parser.add_argument("--width", default=640, type=int)
    parser.add_argument("--sync_iters", default=10, type=int,
                        help="requests of the round-trip measurement, each "
                             "read back to the host (0 disables)")
    parser.add_argument("--dtype", default=None,
                        choices=[None, "float32", "bfloat16"])
    parser.add_argument("--image", default=None, type=str,
                        help="Benchmark on a real image (distinct noise is "
                             "added per frame so inputs still differ).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises where there is no card) "
                             "or cpu.")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.utils.timer import sync

    cfg = set_cfg(args.config)
    if args.dtype:
        cfg = cfg.copy(dict(compute_dtype=args.dtype))
    net = PlaneRecNetRunner(cfg, device=args.device)

    rng = np.random.RandomState(0)
    shape = (args.batch_size, args.height, args.width, 3)
    if args.image:
        from planerecnet_tpu_torch.data.image_io import imread, resize_linear
        img = resize_linear(imread(args.image).astype(np.float32),
                            (args.width, args.height))
        base = np.broadcast_to(img, shape)
        frames = [np.clip(base + rng.randn(*shape).astype(np.float32) * 2,
                          0, 255) for _ in range(args.iters)]
    else:
        frames = [(rng.rand(*shape) * 255).astype(np.float32)
                  for _ in range(args.iters)]

    for i in range(args.warmup):
        net.infer(frames[i % args.iters])
    # Every distinct frame staged on the device: the timed loop measures
    # the pipeline, not the copies of the inputs.
    device_frames = [torch.from_numpy(f).to(net.device) for f in frames]
    net.infer(device_frames[-1])
    sync(net.device)

    t0 = time.perf_counter()
    for f in device_frames:
        net.infer(f)
    sync(net.device)
    dt = time.perf_counter() - t0
    imgs_per_sec = args.batch_size * args.iters / dt

    sync_ms = None
    if args.sync_iters:
        t0 = time.perf_counter()
        for i in range(args.sync_iters):
            net.infer(device_frames[i % args.iters])["pred_scores"].cpu()
        sync_ms = (time.perf_counter() - t0) / args.sync_iters * 1000

    baseline = RTX3090_FPS.get(cfg.name)
    dtype = cfg.compute_dtype
    if dtype == "auto":
        dtype = "auto:f32"
    out = {
        "metric": f"{args.height}x{args.width} images/sec/chip "
                  f"({cfg.name} inference, batch={args.batch_size}, "
                  f"{dtype}, distinct frames)",
        "value": round(imgs_per_sec, 2),
        "unit": "images/sec",
        "baseline": baseline,
        "vs_baseline": (round(imgs_per_sec / baseline, 3)
                        if baseline is not None else None),
    }
    if sync_ms is not None:
        out["sync_roundtrip_ms"] = round(sync_ms, 1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
