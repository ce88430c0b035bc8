"""The yardstick's counts of work: the card's peaks, the model's operations
and each kernel's least time, from the cell's shapes alone.

Operations of the model are counted by ``torch.utils.flop_counter`` over
the yardstick's network on the meta device (convolutions and matrix
products; no memory, no data), forward and, for a training step, its
backward. Recompute is not counted (the yardstick runs without remat), nor
is anything that depends on the data (post-processing's products over its
candidates). A step's dice/lava products are counted as the loss needs
them: the logits once and the two products of the backward.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the units' rate, with each input read once and each
output written once, as its operation needs them (not as the program lays
them out). The deformable sampling and its input gradient are bound by
bytes at any offsets (their ~2-9 operations a byte are far under the
card's ~148 a byte at the TF32 rate), so the bound does not depend on the
offsets. f32 work is held against the TF32 rate, the rate at which the
program's convolutions run.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference.model import PlaneRecNet

# NVIDIA H100 SXM data sheet, dense rates (the program's
# ``tools/roofline.py::PEAKS``), at the full 700 W power limit.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "tf32_flops_per_s": 495e12,
         "bf16_flops_per_s": 989e12, "f32_flops_per_s": 67e12}


def _least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["tf32_flops_per_s"])


def _meta_net(cfg: Dict) -> PlaneRecNet:
    with torch.device("meta"):
        return PlaneRecNet(cfg)


def dcn_shapes(cfg: Dict, batch: int, h: int, w: int) -> List[Dict]:
    """(B, C, H, W, Ho, Wo) of every deformable layer's input and output
    at this input size, from a forward on the meta device."""
    net = _meta_net(cfg)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(dict(
            b=inp[0].shape[0], c=inp[0].shape[1], h=inp[0].shape[2],
            w=inp[0].shape[3], ho=out.shape[2], wo=out.shape[3])))
        for m in net.dcn_layers()]
    with torch.no_grad():
        net(torch.empty(batch, h, w, 3, device="meta"))
    for hk in hooks:
        hk.remove()
    return shapes


def model_flops(cfg: Dict, batch: int, h: int, w: int, train: bool) -> float:
    """The network's operations for one forward (and with ``train`` its
    backward, plus the loss's dice/lava products) at this batch."""
    from torch.utils.flop_counter import FlopCounterMode

    net = _meta_net(cfg).train(train)
    x = torch.empty(batch, h, w, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        if train:
            out = net(x)
            total = sum(t.sum() for v in out.values()
                        for t in (v if isinstance(v, list) else [v]))
            total.backward()
        else:
            with torch.no_grad():
                net(x)
    flops = float(counter.get_total_flops())
    if train:
        d = dice_shape(cfg, batch, h, w)
        flops += 3 * 2 * d["b"] * d["p"] * d["hw"] * d["k"] * d["levels"]
    return flops


def dice_shape(cfg: Dict, batch: int, h: int, w: int) -> Dict:
    return dict(b=batch, p=cfg["max_positives"],
                k=cfg["solov2"]["num_kernels"], n=cfg["max_instances"],
                hw=(h // 4) * (w // 4), levels=4)


def im2col_least_s(s: Dict) -> float:
    """One sampling: x, offsets and modulators read; the columns
    written."""
    k, out = 9, s["b"] * s["ho"] * s["wo"]
    nbytes = 4 * (s["b"] * s["c"] * s["h"] * s["w"] + out * 3 * k
                  + out * k * s["c"])
    return _least_s(nbytes, 9 * out * k * s["c"])


def scatter_least_s(s: Dict) -> float:
    """One input gradient: offsets, modulators and the columns' gradient
    read; dx written."""
    k, out = 9, s["b"] * s["ho"] * s["wo"]
    nbytes = 4 * (out * 3 * k + out * k * s["c"]
                  + s["b"] * s["c"] * s["h"] * s["w"])
    return _least_s(nbytes, 8 * out * k * s["c"])


def dice_lava_least_s(d: Dict) -> float:
    """One level's loss forward and backward together: kernels, mask
    features, slot one-hots, targets, the gradient map and the three
    incoming gradients read; the three sums and both gradients written;
    the logits once and the backward's two products."""
    b, p, k, n, hw = d["b"], d["p"], d["k"], d["n"], d["hw"]
    nbytes = 4 * (b * p * k + b * hw * k + b * p * n + b * n * hw + b * hw
                  + 3 * b * p + 3 * b * p + b * p * k + b * hw * k)
    return _least_s(nbytes, 3 * 2 * b * p * hw * k)
