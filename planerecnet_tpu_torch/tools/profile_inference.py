"""Per-stage inference profile on the card.

    python -m planerecnet_tpu_torch.tools.profile_inference
        [--config PlaneRecNet_50_config] [--height 480] [--width 640]
        [--batch_size 1] [--dtype float32|bfloat16] [--iters 20]
        [--trace DIR] [--device cuda]

Counterpart of ``tools/profile_inference.py``: times each stage of a
request apart, after warm-up, on one frame batch staged on the device:
``fast_base_transform``, the backbone, the backbone and FPN, the full
forward (backbone, FPN, heads, depth decoder), ``postprocess_batch`` of
that forward's predictions, and the whole ``PlaneRecNetRunner.infer``.
On the card each stage is the mean of ``--iters`` calls, after
``WARMUP``, between two CUDA events (the device's time for the queued
work); on the CPU (``--device cpu``) the host clock's. On a card the
``forward`` and ``infer`` stages replay CUDA graphs after their warm-up
(``utils/graphs.py``), while the backbone stages, which call submodules,
and ``postprocess_batch`` run eagerly: the stages' times then do not add
up, an eager stage carrying the host's launches that a replay leaves
out. The weights are
the model's seeded initial ones (seed 0: the DCN offsets are zero and
sample the integer grid), unless a caller of ``main`` passes
``set_weights``, which is applied to the model before anything runs.
Prints one JSON line of ms by stage (``stages_ms``) and the request's
images per second. ``--dtype
bfloat16`` runs the forward under the model's ``torch.autocast`` mode.
``--trace DIR`` then profiles two requests with ``torch.profiler`` and
writes the trace and its kernel table (``parse_trace.record``) to DIR.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

STAGES = ("fast_base_transform", "backbone", "backbone+fpn", "forward",
          "postprocess_batch", "infer")
SEED = 0        # of the random weights and the frames
WARMUP = 3      # untimed calls of each stage


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="PlaneRecNet_50_config")
    p.add_argument("--height", default=480, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "bfloat16"])
    p.add_argument("--iters", default=20, type=int)
    p.add_argument("--trace", default=None, type=str,
                   help="profile two requests into this directory")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def stage_fns(runner, frames: torch.Tensor) -> Dict:
    """{stage: a function computing it} on ``frames`` (B, H, W, 3) BGR in
    [0, 255], already on the runner's device."""
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.ops.postprocess import postprocess_batch

    model, cfg = runner.model, runner.cfg
    x = fast_base_transform(frames)
    nchw = x.permute(0, 3, 1, 2)
    size = tuple(frames.shape[1:3])
    preds = model(x)

    def autocast():
        return torch.autocast(frames.device.type, dtype=torch.bfloat16,
                              enabled=model.dtype == torch.bfloat16)

    def backbone():
        with autocast():
            return model.backbone(nchw)

    def backbone_fpn():
        with autocast():
            feats = model.backbone(nchw)
            return model.fpn([feats[i] for i in cfg.fpn.selected_layers])

    return {"fast_base_transform": lambda: fast_base_transform(frames),
            "backbone": backbone, "backbone+fpn": backbone_fpn,
            "forward": lambda: model(x),
            "postprocess_batch": lambda: postprocess_batch(preds, cfg, size),
            "infer": lambda: runner.infer(frames)}


def main(argv: Optional[List[str]] = None,
         set_weights: Optional[Callable[[torch.nn.Module], None]] = None
         ) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.tools import parse_trace
    from planerecnet_tpu_torch.utils.timer import time_ms

    cfg = set_cfg(args.config)
    if args.dtype:
        cfg = cfg.copy(dict(compute_dtype=args.dtype))
    runner = PlaneRecNetRunner(cfg, seed=SEED, device=args.device)
    if set_weights is not None:
        set_weights(runner.model)
    device = runner.device
    rng = np.random.RandomState(SEED)
    b, h, w = args.batch_size, args.height, args.width
    frames = torch.from_numpy((rng.rand(b, h, w, 3) * 255).astype(
        np.float32)).to(device)
    out = {"config": cfg.name, "batch": b, "height": h, "width": w,
           "dtype": ("bfloat16" if runner.model.dtype == torch.bfloat16
                     else "float32"),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "clock": "cuda events" if device.type == "cuda" else "host",
           "iters": args.iters}
    with torch.no_grad():
        fns = stage_fns(runner, frames)
        out["stages_ms"] = {name: time_ms(fns[name], device, args.iters,
                                          WARMUP) for name in STAGES}
        out["img_per_s"] = b / out["stages_ms"]["infer"] * 1e3
        if args.trace:
            summary = parse_trace.record(fns["infer"], 2, args.trace,
                                         "request", device)
            out["trace"] = summary["trace"]
            out["busy_ms"], out["idle_share"] = (summary["busy_ms"],
                                                 summary["idle_share"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
