"""Roofline accounting of a request and a training step on the card.

    python -m planerecnet_tpu_torch.tools.roofline
        [--config PlaneRecNet_50_config] [--imgs_per_s N]
        [--train --train_ms T] [--dcn_bytes [--gather_gbs G]] [--gather]
        [--peak_tflops P] [--peak_hbm_gbs B] [--device cuda]

Counterpart of ``tools/roofline.py``. ``PEAKS`` holds the card's published
peaks, keyed by ``torch.cuda.get_device_name()``: one NVIDIA H100 (SXM,
NVIDIA's data sheet, dense rates): HBM 3.35 TB/s; 67 TFLOP/s f32 outside
the tensor cores, 495 TF32 and 989 bf16 on them. ``chip_smoke.py``
bounds its kernels with the same table.

``analyze_inference`` counts one request of ``--batch_size`` frames at
``--height`` x ``--width`` (``PlaneRecNetRunner.infer``: normalisation,
forward, post-processing) and ``analyze_train`` one ``trainer.train_step``
at ``--batch_size`` x ``--train_size``^2 (forward, the five losses,
backward, Adam), each run once on the device first and counted on its
second run, per image and per step, with the model's seeded initial
weights or, where a caller of ``main`` passes ``set_weights``, with the
weights it sets on each model before it runs:

- FLOPs are those of ``torch.utils.flop_counter`` (the registry that
  ``FlopCounterMode`` reads: matmuls, convolutions, attention), applied
  to every aten op the run dispatches;
- bytes are the sum over every aten op of its input and output tensors'
  sizes (views and ``empty`` move nothing and count nothing): what eager
  PyTorch moves through memory, op by op, with no fusion;
- the port's hand-written kernels, which no aten op shows (the DCN
  im2col and scatter, the dice/lava forward and backward), are counted
  by their shapes on every device, their plain versions on the CPU not
  at all: each reads its inputs once and writes its outputs once, and
  the im2col does 9 FLOPs a sample (4 bilinear corners of 2, the mask's
  1), the scatter 8, dice/lava its products (2 B P HW (K + N) forward,
  4 B P HW K more backward).

XLA's ``cost_analysis``, which the JAX tool reads, counts the
elementwise work too and the bytes of fused programs, so the two
packages' totals are not the same quantity. With ``--imgs_per_s`` (a
measured request rate) and ``--train_ms`` (a measured step), ``mfu`` is
the achieved FLOP rate over the card's peak for the compute type (TF32
for f32, whose convolutions cuDNN runs in TF32, and bf16 for bf16), and
``hbm_share`` the achieved byte rate over the HBM peak.

``--dcn_bytes`` prints the DCN layers' sampled bytes per image from the
backbone's own plan (``dcn_bytes``, as the JAX tool counts them: 9 taps
x 4 corners x C channels of 2 bytes per output pixel). ``--gather``
times random-row gathers (``index_select`` of a bf16 table with indices
that change every iteration, CUDA events) for the gather bandwidth that
bounds the im2col's corner reads.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, Dict, List, Optional
from unittest import mock

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# Published peaks by device-name prefix: bytes/s of HBM and FLOP/s by
# type (NVIDIA H100 SXM data sheet, dense, at its 700 W limit).
PEAKS = {
    "NVIDIA H100": {"hbm_bytes_per_s": 3.35e12, "float32": 67e12,
                    "tf32": 495e12, "bfloat16": 989e12},
}
H100 = PEAKS["NVIDIA H100"]
# The peak that ``mfu`` divides by, by compute type.
MFU_PEAK = {"float32": "tf32", "bfloat16": "bfloat16"}
_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_like,
             torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
             torch.ops.aten.new_empty_strided}


def peaks_for(name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``name``, or None for another card."""
    for prefix, peaks in sorted(PEAKS.items(), key=lambda kv: -len(kv[0])):
        if name.startswith(prefix):
            return peaks
    return None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class Accounting(TorchDispatchMode):
    """FLOPs and bytes of every aten op run under it (module docstring),
    and of the hand-written kernels through ``kernels``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.paused = 0
        self.flops_by_op: Dict[str, int] = {}
        self.by_kernel: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += flops
            name = str(packet)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops
        if not getattr(func, "is_view", False) and packet not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)))
        return out

    def add_kernel(self, name: str, tensors, flops: int):
        nbytes = sum(_nbytes(t) for t in tree_leaves(tensors))
        rec = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += int(flops)
        rec["bytes"] += nbytes
        self.flops += int(flops)
        self.bytes += nbytes


def _im2col_flops(x, offset, mask, out):
    return 9 * out.numel()


def _scatter_flops(corner_idx, corner_w, dcols, *rest):
    return 8 * dcols.numel()


def _dice_fwd_flops(kernels, mask_feat, onehot, targets, *rest):
    b, p, k = kernels.shape
    return 2 * b * p * mask_feat.shape[1] * (k + onehot.shape[2])


def _dice_bwd_flops(kernels, mask_feat, *rest):
    b, p, k = kernels.shape
    return _dice_fwd_flops(kernels, mask_feat, *rest) + \
        4 * b * p * mask_feat.shape[1] * k


@contextlib.contextmanager
def kernels(acc: Accounting):
    """Count the port's hand-written kernels by their shapes (module
    docstring) while ``acc`` is active, their own aten ops not at all."""
    from planerecnet_tpu_torch.ops import dcn, dice_lava

    def hook(module, name, flops_of):
        orig = getattr(module, name)

        def counted(*args, **kwargs):
            # The wrapper adds to its launch count through its module's
            # name, which must be itself while it runs.
            setattr(module, name, orig)
            acc.paused += 1
            try:
                out = orig(*args, **kwargs)
            finally:
                acc.paused -= 1
                setattr(module, name, counted)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            acc.add_kernel(name, (tensors, out),
                           flops_of(*tensors, out))
            return out
        return mock.patch.object(module, name, counted)

    with hook(dcn, "deform_im2col", _im2col_flops), \
            hook(dcn, "dcn_input_grad", _scatter_flops), \
            hook(dice_lava, "dice_lava_fwd", _dice_fwd_flops), \
            hook(dice_lava, "dice_lava_bwd", _dice_bwd_flops):
        yield


def count(fn) -> Accounting:
    """Run ``fn()`` once untouched (caches, the kernels' builds), then
    once counted."""
    fn()
    acc = Accounting()
    with kernels(acc), acc:
        fn()
    return acc


def analyze_inference(cfg, args, set_weights=None) -> Dict:
    """FLOPs and bytes per image of one request (module docstring)."""
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    runner = PlaneRecNetRunner(cfg, device=args.device)
    if set_weights is not None:
        set_weights(runner.model)
    b = args.batch_size
    x = torch.zeros((b, args.height, args.width, 3), device=runner.device)
    acc = count(lambda: runner.infer(x))
    return {"flops": acc.flops / b, "bytes": acc.bytes / b,
            "flops_by_op": acc.flops_by_op, "kernels": acc.by_kernel,
            "per": "image", "batch": b}


def analyze_train(cfg, args, set_weights=None) -> Dict:
    """FLOPs and bytes of one training step (module docstring)."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.tools.profile_train import synth_batch
    state = trainer.create_train_state(cfg, device=args.device)
    if set_weights is not None:
        set_weights(state.model)
    s = args.train_size
    batch = trainer.unpack_wire_batch(
        cfg, synth_batch(cfg, args.batch_size, s, s), state.device)
    acc = count(lambda: trainer.train_step(state, batch))
    return {"flops": acc.flops, "bytes": acc.bytes,
            "flops_by_op": acc.flops_by_op, "kernels": acc.by_kernel,
            "per": "step"}


def dcn_bytes(cfg, args):
    """Gather bytes per image of the DCN layers: per output pixel the
    deformable conv samples 9 taps x 4 bilinear corners x C channels of
    its stage's input (2 bytes each, as in bf16), over the blocks that
    ``models/backbone.py::_stage_plan`` makes deformable."""
    from planerecnet_tpu_torch.models.backbone import _stage_plan

    bb = cfg.backbone
    plan = _stage_plan(bb.layers, bb.dcn_layers, bb.dcn_interval,
                       getattr(bb, "atrous_layers", ()) or ())
    h, w = args.height, args.width
    total = 0
    print(f"\nDCN gather bytes/image ({args.config}, {h}x{w}, bf16):")
    stride = 4  # C2's stride; the plan's strides are relative
    for s, (planes, blocks, st, _dil, flags) in enumerate(plan):
        if s > 0:
            stride *= st
        n = sum(flags)
        if not n:
            continue
        per = (h // stride) * (w // stride) * 9 * 4 * planes * 2
        total += n * per
        print(f"  conv{s + 2}: {n} DCN block(s) x {per / 1e6:.2f} MB "
              f"({h // stride}x{w // stride} x 36 x {planes}ch bf16)"
              f" = {n * per / 1e6:.1f} MB")
    print(f"  total {total / 1e6:.1f} MB gathered/image")
    if args.gather_gbs:
        floor_ms = total / (args.gather_gbs * 1e9) * 1e3
        print(f"  at {args.gather_gbs} GB/s random-gather bandwidth: "
              f"{floor_ms:.2f} ms/image for the gathers alone")
    return total


def gather_bench(args) -> Dict:
    """Random-row gather bandwidth: ``index_select`` of ``--gather_m``
    rows of a (``--gather_rows``, ``--gather_cols``) bf16 table, the
    indices shifted every iteration, timed with ``utils.timer.time_ms``
    (CUDA events on the card)."""
    from planerecnet_tpu_torch.runner import resolve_device
    from planerecnet_tpu_torch.utils.timer import time_ms

    device = resolve_device(args.device)
    rows, c, m = args.gather_rows, args.gather_cols, args.gather_m
    table = torch.arange(rows * c, device=device).reshape(rows, c).to(
        torch.bfloat16)
    gen = torch.Generator(device).manual_seed(0)
    base = torch.randint(0, rows, (m,), device=device, generator=gen)
    it = [0]

    def gather():
        it[0] += 1
        return table.index_select(0, (base + it[0]) % rows)

    ms = time_ms(gather, device, iters=args.gather_iters)
    gbs = m * c * 2 / (ms * 1e-3) / 1e9
    print(f"random gather: {m} rows x {c} cols bf16 a call, {ms:.4f} ms "
          f"-> {gbs:.1f} GB/s")
    return {"ms": ms, "gbs": gbs}


def _report(what, res, peaks, peak_key, rate_per_s):
    flops, nbytes = res["flops"], res["bytes"]
    print(f"\n{what}: {flops / 1e9:.2f} GFLOP/{res['per']}, "
          f"{nbytes / 1e6:.1f} MB moved/{res['per']}")
    per = res.get("batch", 1)
    for name, f in sorted(res["flops_by_op"].items()):
        print(f"  of which {name}: {f / per / 1e9:.2f} GFLOP")
    for name, k in sorted(res["kernels"].items()):
        print(f"  of which {name}: x{k['calls']} a run, "
              f"{k['flops'] / per / 1e9:.2f} GFLOP, "
              f"{k['bytes'] / per / 1e6:.1f} MB")
    if rate_per_s and peaks:
        res["mfu"] = flops * rate_per_s / peaks[peak_key]
        res["hbm_share"] = nbytes * rate_per_s / peaks["hbm_bytes_per_s"]
        print(f"  at {rate_per_s:.4g} {res['per']}s/s: "
              f"{flops * rate_per_s / 1e12:.2f} TFLOP/s, mfu "
              f"{res['mfu']:.4f} of {peaks[peak_key] / 1e12:g} TFLOP/s "
              f"({peak_key}); {nbytes * rate_per_s / 1e9:.0f} GB/s, "
              f"hbm_share {res['hbm_share']:.4f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="PlaneRecNet_50_config")
    p.add_argument("--height", default=480, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--imgs_per_s", default=None, type=float,
                   help="a measured request rate, for the request's mfu")
    p.add_argument("--train", action="store_true")
    p.add_argument("--train_size", default=640, type=int)
    p.add_argument("--train_ms", default=None, type=float,
                   help="a measured step, for the step's mfu")
    p.add_argument("--gather", action="store_true")
    p.add_argument("--gather_rows", default=40 * 60, type=int)
    p.add_argument("--gather_cols", default=256, type=int)
    p.add_argument("--gather_m", default=40 * 60 * 36, type=int,
                   help="rows gathered a call (pixels x 9 taps x 4 "
                        "corners)")
    p.add_argument("--gather_iters", default=200, type=int)
    p.add_argument("--dcn_bytes", action="store_true")
    p.add_argument("--gather_gbs", default=None, type=float)
    p.add_argument("--peak_tflops", default=None, type=float)
    p.add_argument("--peak_hbm_gbs", default=None, type=float)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         set_weights: Optional[Callable[[torch.nn.Module], None]] = None
         ) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.models.planerecnet import compute_dtype
    from planerecnet_tpu_torch.runner import resolve_device

    device = resolve_device(args.device)
    cfg = set_cfg(args.config)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peaks = dict(peaks_for(kind) or {})
    dtype = "bfloat16" if compute_dtype(cfg) == torch.bfloat16 \
        else "float32"
    peak_key = MFU_PEAK[dtype]
    if args.peak_tflops:
        peaks[peak_key] = args.peak_tflops * 1e12
    if args.peak_hbm_gbs:
        peaks["hbm_bytes_per_s"] = args.peak_hbm_gbs * 1e9
    print(f"device: {kind}; peaks {json.dumps(peaks) if peaks else 'unknown'}"
          " (published; override with --peak_*)")
    out = {"device": kind, "config": cfg.name, "peaks": peaks}
    if args.dcn_bytes:
        out["dcn_bytes"] = dcn_bytes(cfg, args)
        if not (args.imgs_per_s or args.train or args.gather):
            return out
    out["request"] = analyze_inference(cfg, args, set_weights)
    _report(f"request ({args.config}, {args.batch_size}x{args.height}x"
            f"{args.width}, {dtype})", out["request"], peaks, peak_key,
            args.imgs_per_s)
    if args.train:
        out["step"] = analyze_train(cfg, args, set_weights)
        _report(f"train step ({args.batch_size}x{args.train_size}^2, "
                f"{dtype})", out["step"], peaks, peak_key,
                1e3 / args.train_ms if args.train_ms else None)
    if args.gather:
        out["gather"] = gather_bench(args)
    return out


if __name__ == "__main__":
    main()
