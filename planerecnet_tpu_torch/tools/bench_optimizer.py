"""The optimizer update alone, on the real parameter list.

    python -m planerecnet_tpu_torch.tools.bench_optimizer
        [--config PlaneRecNet_101_config] [--iters 50]
        [--variant all|trainer|foreach|fused|sgd] [--device cuda]

Counterpart of ``tools/bench_optimizer.py``: the model's parameters (no
forward) with a gradient of 1e-3 in every element, updated ``--iters``
times after one untimed update, timed with ``utils.timer.time_ms`` (CUDA
events on the card). Variants: ``trainer``, the optimizer that
``trainer.create_train_state`` builds (``trainer.make_optimizer``: Adam,
PyTorch's choice of implementation); ``foreach`` and ``fused``, Adam with
that implementation named; ``sgd``, plain SGD, the floor of a pass over
the parameters. Each takes the learning rate of ``trainer``'s schedule at
its update count. Also timed: ``apply_grads``, the trainer's whole update
(``trainer.apply_grads``: the non-finite check, which reads the loss back
to the host, then the ``trainer`` optimizer's step), and ``sync``, that
check's ``bool(torch.isfinite(total))`` alone on an idle device. The
gradients need not change between updates: eager PyTorch caches no
results. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

VARIANTS = ("trainer", "foreach", "fused", "sgd")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="PlaneRecNet_101_config")
    p.add_argument("--iters", default=50, type=int)
    p.add_argument("--variant", default="all", choices=("all",) + VARIANTS)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def make_state(cfg, device, seed=0):
    """A train state whose every parameter holds a gradient of 1e-3."""
    from planerecnet_tpu_torch import trainer
    state = trainer.create_train_state(cfg, seed=seed, device=device)
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    return state


def updater(variant: str, state):
    """A function that takes one update of ``variant`` on ``state``'s
    parameters, at the learning rate of the trainer's schedule."""
    params = list(state.model.parameters())
    if variant == "trainer":
        opt = state.optimizer
    elif variant in ("foreach", "fused"):
        opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=0.0, **{variant: True})
    elif variant == "sgd":
        opt = torch.optim.SGD(params, lr=0.0)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    count = [0]

    def update():
        lr = state.schedule(count[0])
        for group in opt.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
        opt.step()
        count[0] += 1
    return update


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.utils.timer import time_ms

    cfg = set_cfg(args.config)
    state = make_state(cfg, args.device)
    device = state.device
    params = list(state.model.parameters())
    out = {"config": cfg.name, "leaves": len(params),
           "params": sum(p.numel() for p in params),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    for v in variants:
        out[f"{v}_ms"] = time_ms(updater(v, state), device,
                                 iters=args.iters, warmup=1)
    total = torch.ones((), device=device)
    out["apply_grads_ms"] = time_ms(
        lambda: trainer.apply_grads(state, total, []), device,
        iters=args.iters, warmup=1)
    out["sync_ms"] = time_ms(lambda: bool(torch.isfinite(total)), device,
                             iters=args.iters, warmup=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
