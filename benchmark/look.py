"""Where a training cell's gradient gaps come from: two looks on the card.

    python3 -m benchmark.look --workload prn50_train_b8 --seeds 11 12 \\
        [--out FILE]

1. One deformable layer alone, at each of the cell's deformable shapes,
   with offsets spread as the cell's weights spread them: the program's
   forward and backward (its CUDA kernels) and the yardstick's, both in
   f32 with TF32 off, each against the yardstick in f64 on the card and
   on the CPU (the witnesses). Compared: the output, dx, the offsets' and
   modulators' gradients, the weight's, and the per-channel sums of the
   offsets' and modulators' gradients (what their convolutions' biases
   get), each as the largest |difference| over the largest |witness|.
2. The first training step of the whole model on the cell's batch, TF32
   off unless named: pairs of sides that differ only in rounding (the
   program against itself, its deterministic backward against its
   atomic one, the yardstick with cuDNN's convolutions against its own
   with PyTorch's native ones) beside the pairs that ``correct`` compares
   (the program as it runs, and its bf16 control, against the
   yardstick). Each pair gives the step's loss gap, the raw predictions'
   gap and the leaf gaps of the gradient (``check.leaf_gaps`` over the
   leaves that move) as their worst, median and 90th percentile.

Prints one JSON line a result and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict

import torch

from benchmark import check, scenes, work
from benchmark.reference.model import deform_conv
from benchmark.reference.train import Trainer
from benchmark.spec import find_cell
from benchmark.weights import make_weights


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.double()
    return float((a.double().to(b.device) - b).abs().max()
                 / b.abs().max().clamp_min(1e-300))


def _dcn_sides(x, off, mod, wt, dout, stride):
    """{side: [out, dx, doffset, dmask, dweight]} in NCHW / OIHW."""
    from planerecnet_tpu_torch.ops import dcn

    out = {}
    for side in ("program", "yardstick", "f64", "f64_cpu"):
        dev = "cpu" if side == "f64_cpu" else x.device
        dt = torch.float64 if side.startswith("f64") else torch.float32
        ts = [t.detach().to(dev, dt).clone().requires_grad_()
              for t in (x, off, mod, wt)]
        bias = torch.zeros(wt.shape[0], device=dev, dtype=dt)
        if side == "program":
            y = dcn.deform_conv2d(
                ts[0].permute(0, 2, 3, 1).contiguous(),
                ts[1].permute(0, 2, 3, 1).contiguous(),
                ts[2].permute(0, 2, 3, 1).contiguous(),
                ts[3].permute(2, 3, 1, 0), bias, stride=stride,
                padding=1).permute(0, 3, 1, 2)
        else:
            y = deform_conv(*ts, bias, stride, 1)
        y.backward(dout.to(dev, dt))
        out[side] = [y.detach()] + [t.grad for t in ts]
        del ts, y
    return out


def dcn_layers(cfg: Dict, b: int, h: int, w: int, offset_std: float,
               device) -> list:
    names = ("out", "dx", "doffset", "dmask", "dweight")
    rows = []
    shapes = {(s["c"], s["h"], s["w"], s["h"] // s["ho"])
              for s in work.dcn_shapes(cfg, b, h, w)}
    g = torch.Generator(device).manual_seed(0)
    with check.exact_f32():
        for cin, hi, wi, stride in sorted(shapes):
            ho, wo = (hi - 1) // stride + 1, (wi - 1) // stride + 1
            x = torch.randn(b, cin, hi, wi, generator=g,
                            device=device).relu()
            off = torch.randn(b, 18, ho, wo, generator=g,
                              device=device) * offset_std
            mod = 2 * torch.sigmoid(torch.randn(b, 9, ho, wo, generator=g,
                                                device=device))
            wt = torch.randn(cin, cin, 3, 3, generator=g,
                             device=device) / (9 * cin) ** 0.5
            # A BatchNorm follows the layer: its gradient sums to 0 by
            # channel, so the offsets' and modulators' sums cancel.
            dout = torch.randn(b, cin, ho, wo, generator=g, device=device)
            dout = dout - dout.mean((0, 2, 3), keepdim=True)
            res = _dcn_sides(x, off, mod, wt, dout, stride)
            for side in ("program", "yardstick", "f64_cpu"):
                row = {"look": "dcn_layer", "shape": [b, cin, hi, wi, stride],
                       "side": side, "against": "f64"}
                for n, a, r in zip(names, res[side], res["f64"]):
                    row[n] = _rel(a, r)
                for n, i in (("doffset_sum", 2), ("dmask_sum", 3)):
                    a = res[side][i].double().sum((0, 2, 3))
                    r = res["f64"][i].sum((0, 2, 3))
                    row[n] = _rel(a, r)
                    row[n + "_norm_gap"] = abs(
                        float(a.norm()) - float(r.norm())) / float(r.norm())
                rows.append(row)
            del x, off, mod, wt, dout, res
            torch.cuda.empty_cache()
    return rows


def _program_step(cell, seed, ring, device, deterministic=False,
                  overrides=None) -> Dict:
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)

    cfg = cell.config["config"]
    pcfg = apply_overrides(PlaneRecNetConfig(), dict(cfg, **(overrides
                                                          or {})))
    state = trainer.create_train_state(pcfg, seed=seed, device=device,
                                       deterministic=deterministic)
    state.model.load_state_dict(make_weights(cfg, cell.config["weights"],
                                             seed, device, False))
    keep = {}
    hook = state.model.register_forward_hook(
        lambda m, i, o: _keep(keep, o))
    out = trainer.train_step(state, ring[0])
    hook.remove()
    names = [n for n, _ in state.model.named_parameters()]
    grad = {n: (state.optimizer.state[p].get(
        "exp_avg", torch.zeros_like(p)) / 0.1).float().cpu()
        for n, p in zip(names, state.model.parameters())}
    loss = {k: float(v) for k, v in out.items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "grad": grad, "preds": keep["preds"]}


def _keep(keep, preds):
    keep.setdefault("preds", _host(preds))     # returns None: output kept


def _host(preds):
    return {k: ([t.detach().float().cpu() for t in v] if isinstance(v, list)
                else v.detach().float().cpu()) for k, v in preds.items()}


def _yardstick_step(cell, seed, ring, device) -> Dict:
    cfg = cell.config["config"]
    res = cfg["dataset"]["depth_resolution"]
    ref = Trainer(cfg, make_weights(cfg, cell.config["weights"], seed,
                                    device, False), seed, device)
    keep = {}
    hook = ref.net.register_forward_hook(
        lambda m, i, o: _keep(keep, o))
    batch = scenes.dense(ring[0], cfg["max_instances"], res, device)
    out = ref.step(batch, 0)
    hook.remove()
    names = [n for n, _ in ref.net.named_parameters()]
    grad = {n: (m / 0.1).float().cpu() for n, m in zip(names, ref.m)}
    loss = {k: float(v) for k, v in out.items()}
    del ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "grad": grad, "preds": keep["preds"]}


def _raw_gap(p: Dict, r: Dict) -> float:
    return max(_rel(a, b) for k in r
               for a, b in zip(p[k] if isinstance(p[k], list) else [p[k]],
                               r[k] if isinstance(r[k], list) else [r[k]]))


def whole_step(cell, seed: int, device) -> list:
    tr, cfg = cell.traffic, cell.config["config"]
    b, h, w = tr["batch"], tr["height"], tr["width"]
    pool = scenes.render_pool(seed, tr["pool"], h, w)
    rows = scenes.make_rows(pool, b, seed)
    ring = [scenes.collate(rows, cfg["max_instances"],
                           cfg["dataset"]["depth_resolution"])]
    sides = {}
    with check.exact_f32():
        sides["program"] = _program_step(cell, seed, ring, device)
        sides["program_again"] = _program_step(cell, seed, ring, device)
        sides["program_det"] = _program_step(cell, seed, ring, device, True)
        sides["yardstick"] = _yardstick_step(cell, seed, ring, device)
        with torch.backends.cudnn.flags(enabled=False):
            sides["yardstick_native"] = _yardstick_step(cell, seed, ring,
                                                        device)
    sides["program_tf32"] = _program_step(cell, seed, ring, device)
    sides["control_bf16"] = _program_step(
        cell, seed, ring, device, overrides={"compute_dtype": "bfloat16"})
    moving = check.moving_leaves(sides["yardstick"]["grad"])
    out = []
    for a, r in (("program_again", "program"), ("program_det", "program"),
                 ("yardstick_native", "yardstick"), ("program", "yardstick"),
                 ("program_tf32", "yardstick"),
                 ("control_bf16", "yardstick")):
        gaps = check.leaf_gaps(sides[a]["grad"], sides[r]["grad"], moving)
        v = sorted(gaps.values())
        la, lr = sides[a]["loss"], sides[r]["loss"]
        out.append({
            "look": "first_step", "seed": seed, "side": a, "against": r,
            "loss_gap": {k: abs(la[k] - lr[k]) / max(abs(lr[k]), 1e-30)
                         for k in lr},
            "raw_gap": _raw_gap(sides[a]["preds"], sides[r]["preds"]),
            "grad_worst": v[-1], "grad_median": v[len(v) // 2],
            "grad_p90": v[int(0.9 * (len(v) - 1))],
            "worst_leaves": sorted(gaps.items(), key=lambda kv: -kv[1])[:6],
            "moving": len(moving), "leaves": len(gaps)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    tr, cfg = cell.traffic, cell.config["config"]
    rows = dcn_layers(cfg, tr["batch"], tr["height"], tr["width"],
                      cell.config["weights"]["offset_std_px"], "cuda")
    for r in rows:
        print(json.dumps(r), flush=True)
    for seed in args.seeds:
        for r in whole_step(cell, seed, "cuda"):
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
