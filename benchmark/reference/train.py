"""A training step in plain PyTorch: forward, the joint loss, backward and
Adam, on the same seeded weights and batches as the program.

Adam is written out (beta 0.9, 0.999, eps 1e-8, no weight decay, bias
correction), with every parameter at the scheduled learning rate: linear
warm-up from ``lr_warmup_init`` to ``lr`` over ``lr_warmup_until`` updates,
then ``gamma`` at each of ``lr_steps`` (the upstream recipe). The VNL
generator of step ``i`` is seeded ``seed * 1_000_003 + i`` on the device,
as the program seeds its own.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.losses import losses
from benchmark.reference.model import PlaneRecNet, normalise


def learning_rate(cfg: Dict, it: int) -> float:
    lr = cfg["lr"]
    if cfg["lr_warmup_until"] > 0 and it <= cfg["lr_warmup_until"]:
        return ((lr - cfg["lr_warmup_init"]) * (it / cfg["lr_warmup_until"])
                + cfg["lr_warmup_init"])
    return lr * cfg["gamma"] ** sum(it >= s for s in cfg["lr_steps"])


class Trainer:
    def __init__(self, cfg: Dict, state: Dict[str, torch.Tensor], seed: int,
                 device, remat: bool = False):
        self.cfg, self.seed, self.remat = cfg, seed, remat
        with torch.device("meta"):
            net = PlaneRecNet(cfg)
        net = net.to_empty(device=device)
        net.load_state_dict(state)
        self.net = net.train()
        self.params = [p for p in net.parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.updates = 0

    def step(self, batch: Dict[str, torch.Tensor], index: int
             ) -> Dict[str, torch.Tensor]:
        """One step on a dense batch (``image`` u8 BGR); returns the losses
        with ``total``."""
        dev = self.params[0].device
        gen = torch.Generator(dev).manual_seed(self.seed * 1_000_003 + index)
        for p in self.params:
            p.grad = None
        preds = self.net(normalise(batch["image"]), remat=self.remat)
        out = losses(self.cfg, preds, batch, gen, checkpoint_sums=self.remat)
        total = sum(out.values())
        total.backward()
        lr = learning_rate(self.cfg, self.updates)
        self.updates += 1
        t = self.updates
        with torch.no_grad():
            for p, m, v in zip(self.params, self.m, self.v):
                g = p.grad
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.999).addcmul_(g, g, value=0.001)
                mh = m / (1 - 0.9 ** t)
                vh = v / (1 - 0.999 ** t)
                p.sub_(lr * mh / (vh.sqrt() + 1e-8))
        return {k: val.detach() for k, val in dict(out, total=total).items()}
