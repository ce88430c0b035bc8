"""Micro-bench of the fused dice/lava kernels against their plain
composition.

    python -m planerecnet_tpu_torch.tools.bench_dice_kernel [--b 8]
        [--p 128] [--k 128] [--n 32] [--hw 25600] [--iters 20]
        [--device cuda]

Counterpart of ``tools/bench_dice_kernel.py``, at its default shape, the
PRN-101 training shape (B=8, P=128, K=128, N=32, HW=160*160): the port's
``ops.dice_lava.fused_dice_lava`` (the CUDA forward and backward kernels
behind an autograd Function) against ``fused_dice_lava_plain``, the same
function as plain PyTorch ops differentiated by autograd, forward alone
and forward with the gradients in the kernels and the mask features. The
inputs change every iteration (a shift of 1e-6 times the iteration), and
each case is timed with ``utils.timer.time_ms`` (CUDA events on the card,
the host clock on the CPU, where both sides run the plain version).
Prints one JSON line of ms by case.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--b", default=8, type=int)
    p.add_argument("--p", default=128, type=int)
    p.add_argument("--k", default=128, type=int)
    p.add_argument("--n", default=32, type=int)
    p.add_argument("--hw", default=160 * 160, type=int)
    p.add_argument("--iters", default=20, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def inputs(args, device):
    """(kernels, mask features, one-hot, targets, lava map), seed 0."""
    rng = np.random.RandomState(0)
    b, p, k, n, hw = args.b, args.p, args.k, args.n, args.hw
    arrays = (rng.randn(b, p, k), rng.randn(b, hw, k),
              np.eye(n)[rng.randint(0, n, (b, p))],
              rng.rand(b, n, hw) > 0.8, rng.rand(b, hw))
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device)
            for a in arrays]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch.ops.dice_lava import (fused_dice_lava,
                                                     fused_dice_lava_plain)
    from planerecnet_tpu_torch.runner import resolve_device
    from planerecnet_tpu_torch.utils.timer import time_ms

    device = resolve_device(args.device)
    kernels, feat, onehot, targets, grad_low = inputs(args, device)

    def case(fn, grad):
        it = [0]

        def run():
            it[0] += 1
            kr = (kernels + it[0] * 1e-6).requires_grad_(grad)
            ft = (feat + it[0] * 1e-6).requires_grad_(grad)
            a, b, lava = fn(kr, ft, onehot, targets, grad_low)
            total = a.sum() + b.sum() + lava.sum()
            return torch.autograd.grad(total, (kr, ft)) if grad else total
        return lambda: time_ms(run, device, iters=args.iters)

    out = {"shape": dict(b=args.b, p=args.p, k=args.k, n=args.n,
                         hw=args.hw),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for name, fn, grad in (("fused_fwd", fused_dice_lava, False),
                           ("plain_fwd", fused_dice_lava_plain, False),
                           ("fused_fwd_bwd", fused_dice_lava, True),
                           ("plain_fwd_bwd", fused_dice_lava_plain, True)):
        out[f"{name}_ms"] = case(fn, grad)()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
