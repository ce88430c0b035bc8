"""Training-step profiler: steady-state ms/step of ``trainer.train_step``.

    python -m planerecnet_tpu_torch.tools.profile_train
        [--config PlaneRecNet_101_config] [--batch_size 8] [--size 640]
        [--dtype float32|bfloat16] [--iters 20] [--warmup 2]
        [--no_dcn] [--forward_only] [--net_grad_only [--aux_losses]]
        [--losses ins,cat,dpt [--no_opt]] [--fused_loss on|off]
        [--remat auto|on|off | --no_remat]
        [--split_timing] [--trace DIR] [--device cuda]

Counterpart of ``tools/profile_train.py``. Times the full training step
(forward, the five losses, backward, Adam) on synthetic batches
(``synth_batch``, the JAX tool's, equal byte for byte for the same seed)
uploaded to the device before timing, two of them taken in turn, while
the weights evolve step by step. The step time is the host clock over
``--iters`` steps ending in a synchronize; the peak memory is
``torch.cuda.max_memory_allocated`` over them. Prints one JSON line.
The weights start as the model's seeded initial ones (seed 0: the DCN
offsets are zero and sample the integer grid), unless a caller of
``main`` passes ``set_weights``, which is applied to the model before
the first step.

Ablations, as the JAX tool's: ``--dtype``; ``--no_dcn`` (plain-conv
backbone); ``--forward_only`` (the losses' forward, no backward or
update); ``--net_grad_only`` (the gradient of sum(preds^2) through the
network alone; ``--aux_losses`` also computes the losses on the detached
predictions); ``--losses`` (only the named losses give gradients, and
``pln``/``lav`` are switched off unless named; ``--no_opt`` then skips
Adam); ``--fused_loss on|off`` (sets ``cfg.fused_loss_kernel``: off
takes the dice/lava loss's plain PyTorch composition instead of the CUDA
kernels); ``--remat auto|on|off`` (sets ``cfg.remat_backbone``;
``--no_remat`` is ``--remat off``); ``--split_timing`` (the gradient, ``trainer.grad_step``,
and the update, ``trainer.apply_grads`` with its host sync, each timed
alone, with a synchronize between them; also the forward with losses and
the backward apart); ``--trace DIR`` (three steps under ``torch.profiler``
before the timed loop, the trace and its kernel table written to DIR by
``parse_trace.record``). The JAX tool's ``--dcn_vjp`` has no
counterpart: the port's DCN always runs its autograd Function with the
hand-written scatter kernel.

The upstream reference trains 125k iterations in ~37 h on an RTX 3090
(~1065.6 ms/iter, its README): ``vs_baseline`` is a ratio across cards.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

NUM_BATCHES = 2
SEED = 0        # of the random weights; batch i is synth_batch's seed i
REFERENCE_MS = 37 * 3600 * 1000 / 125000


def synth_batch(cfg, b, h, w, seed=0):
    """Synthetic fixed-capacity batch matching collate_batch's layout."""
    rng = np.random.RandomState(seed)
    n = cfg.max_instances
    masks = np.zeros((b, n, h, w), np.float32)
    boxes = np.zeros((b, n, 4), np.float32)
    gt_valid = np.zeros((b, n), bool)
    for i in range(b):
        k = int(rng.randint(1, min(n, 6) + 1))
        for j in range(k):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            y1 = y0 + rng.randint(h // 8, h // 2)
            x1 = x0 + rng.randint(w // 8, w // 2)
            masks[i, j, y0:y1, x0:x1] = 1
            boxes[i, j] = [x0, y0, min(x1, w - 1), min(y1, h - 1)]
            gt_valid[i, j] = True
    planes = rng.randn(b, n, 4).astype(np.float32)
    planes[..., :3] /= np.linalg.norm(planes[..., :3], axis=-1,
                                      keepdims=True) + 1e-6
    return {
        "image": rng.randn(b, h, w, 3).astype(np.float32),
        "depth": (rng.rand(b, h, w, 1) * 4 + 0.3).astype(np.float32),
        "masks": masks,
        "boxes": boxes,
        "classes": np.ones((b, n), np.int32),
        "gt_valid": gt_valid,
        "plane_paras": planes,
        "k_matrix": np.tile(
            np.array([[577.0, 0, w / 2], [0, 577.0, h / 2], [0, 0, 1]],
                     np.float32), (b, 1, 1)),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="PlaneRecNet_101_config")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--size", default=640, type=int)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--iters", default=20, type=int)
    p.add_argument("--warmup", default=2, type=int,
                   help="untimed steps after the first")
    p.add_argument("--no_dcn", action="store_true",
                   help="ablation: plain-conv backbone")
    p.add_argument("--forward_only", action="store_true",
                   help="ablation: the losses' forward only")
    p.add_argument("--net_grad_only", action="store_true",
                   help="ablation: the gradient of sum(preds^2) through "
                        "the network only")
    p.add_argument("--aux_losses", action="store_true",
                   help="with --net_grad_only: also the losses on the "
                        "detached predictions")
    p.add_argument("--no_opt", action="store_true",
                   help="with --losses: no Adam update")
    p.add_argument("--split_timing", action="store_true",
                   help="time the gradient and the update apart")
    p.add_argument("--trace", default=None, type=str,
                   help="profile three steps into this directory")
    p.add_argument("--losses", default=None, type=str,
                   help="comma list of the losses that give gradients "
                        "(e.g. 'ins,cat,dpt' drops VNL and lava)")
    p.add_argument("--fused_loss", default=None, choices=["on", "off"],
                   help="override cfg.fused_loss_kernel (off: the dice/lava "
                        "loss's plain PyTorch composition, not its kernels)")
    p.add_argument("--remat", default=None, choices=["auto", "on", "off"],
                   help="override cfg.remat_backbone (default: the config's "
                        "'auto' rule)")
    p.add_argument("--no_remat", action="store_true",
                   help="shorthand for --remat off")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def config(args):
    """The preset with the ablations' switches."""
    from planerecnet_tpu_torch.config import set_cfg
    cfg = set_cfg(args.config).copy(dict(compute_dtype=args.dtype))
    remat = "off" if args.no_remat else args.remat
    if remat is not None:
        cfg = cfg.copy(dict(remat_backbone={
            "auto": "auto", "on": True, "off": False}[remat]))
    if args.fused_loss is not None:
        cfg = cfg.copy(dict(fused_loss_kernel=args.fused_loss))
    if args.no_dcn:
        cfg = cfg.copy(dict(backbone=cfg.backbone.copy(dict(
            dcn_layers=(0, 0, 0, 0)))))
    if args.losses is not None:
        keep = set(args.losses.split(","))
        cfg = cfg.copy(dict(use_plane_loss="pln" in keep,
                            use_lava_loss="lav" in keep))
    return cfg


def make_step(args, state) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """The step the flags select: a function of a device batch that takes
    it and returns its losses (with ``total``)."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.losses import compute_losses

    cfg = state.cfg

    def forward(batch):
        return state.model(batch["image"])

    def losses_of(preds, batch):
        losses = compute_losses(cfg, preds, batch,
                                generator=state.generator(),
                                deterministic=state.deterministic)
        return dict(losses, total=sum(losses.values()))

    if args.forward_only:
        def step(batch):
            with torch.no_grad():
                out = losses_of(forward(batch), batch)
            state.step += 1
            return out
    elif args.losses is not None:
        keep = set(args.losses.split(","))

        def step(batch):
            saved = [b.clone() for b in trainer._bn_buffers(state.model)]
            state.optimizer.zero_grad(set_to_none=True)
            out = losses_of(forward(batch), batch)
            sum(v for k, v in out.items() if k in keep).backward()
            if args.no_opt:
                state.step += 1
            else:
                trainer.apply_grads(state, out["total"].detach(), saved)
            return {k: v.detach() for k, v in out.items()}
    elif args.net_grad_only:
        def step(batch):
            state.optimizer.zero_grad(set_to_none=True)
            preds = forward(batch)
            leaves = [*preds["cate_preds"], *preds["kernel_preds"],
                      preds["mask_pred"], *([preds["depth_pred"]]
                                            if "depth_pred" in preds else [])]
            total = sum(t.float().square().sum() for t in leaves) * 1e-6
            out = {}
            if args.aux_losses:
                out = losses_of({k: ([t.detach() for t in v]
                                     if isinstance(v, list) else v.detach())
                                 for k, v in preds.items()}, batch)
                out = {k: v.detach() for k, v in out.items()}
            total.backward()
            state.step += 1
            return dict(out, total=total.detach())
    else:
        def step(batch):
            return trainer.train_step(state, batch)
    return step


def split_timing(state, batches, iters) -> Dict[str, float]:
    """Mean ms of the forward with losses, the backward, the whole
    gradient (``grad_step``) and the update (``apply_grads``), each alone
    between synchronizes, over ``iters`` steps."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.losses import compute_losses
    from planerecnet_tpu_torch.utils.timer import sync

    dev = state.device
    keys = ("forward_loss_ms", "backward_ms", "grad_ms", "update_ms")
    total = dict.fromkeys(keys, 0.0)
    for i in range(iters):
        batch = batches[i % len(batches)]
        sync(dev)
        t0 = time.perf_counter()
        saved = [b.clone() for b in trainer._bn_buffers(state.model)]
        state.optimizer.zero_grad(set_to_none=True)
        losses = compute_losses(state.cfg, state.model(batch["image"]),
                                batch, generator=state.generator(),
                                deterministic=state.deterministic)
        loss = sum(losses.values())
        sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        sync(dev)
        t2 = time.perf_counter()
        trainer.apply_grads(state, loss.detach(), saved)
        sync(dev)
        t3 = time.perf_counter()
        for key, dt in zip(keys, (t1 - t0, t2 - t1, t2 - t0, t3 - t2)):
            total[key] += dt * 1e3 / iters
    return total


def main(argv: Optional[List[str]] = None,
         set_weights: Optional[Callable[[torch.nn.Module], None]] = None
         ) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.tools import parse_trace
    from planerecnet_tpu_torch.utils.timer import sync

    cfg = config(args)
    t0 = time.perf_counter()
    state = trainer.create_train_state(cfg, seed=SEED, device=args.device)
    if set_weights is not None:
        set_weights(state.model)
    dev = state.device
    h = w = args.size
    batches = [trainer.unpack_wire_batch(cfg, synth_batch(
        cfg, args.batch_size, h, w, seed=i), dev)
        for i in range(NUM_BATCHES)]
    print(f"state init and upload: {time.perf_counter() - t0:.1f}s",
          flush=True)
    out = {"config": cfg.name, "batch": args.batch_size, "size": args.size,
           "dtype": args.dtype, "remat_backbone": cfg.remat_backbone,
           "fused_loss_kernel": cfg.fused_loss_kernel,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    step = make_step(args, state)
    t0 = time.perf_counter()
    out["first_losses"] = {k: float(v) for k, v in
                           step(batches[0]).items()}
    sync(dev)
    print(f"first step: {time.perf_counter() - t0:.1f}s", flush=True)
    for i in range(args.warmup):
        step(batches[(i + 1) % NUM_BATCHES])
    if args.trace:
        it = iter(range(3))
        summary = parse_trace.record(
            lambda: step(batches[next(it) % NUM_BATCHES]), 3,
            args.trace, "step", dev)
        out["trace"] = summary["trace"]
        out["busy_ms"], out["idle_share"] = (summary["busy_ms"],
                                             summary["idle_share"])
    if args.split_timing:
        out["split_ms"] = split_timing(state, batches, args.iters)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(args.iters):
        losses = step(batches[i % NUM_BATCHES])
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / args.iters
    total = float(losses["total"])
    out.update({
        "metric": f"train step ms/iter ({args.config}, bs="
                  f"{args.batch_size}, {h}x{w}, {args.dtype})",
        "value": ms, "unit": "ms/iter",
        "vs_baseline": REFERENCE_MS / ms,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if dev.type == "cuda" else None),
        "final_total_loss": total, "loss_finite": bool(np.isfinite(total))})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
