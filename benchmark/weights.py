"""Seeded weights for both sides, made on the device in a few large calls.

One uniform and one normal draw from a ``torch.Generator`` on the device
cover every tensor; each tensor is a slice of one of them, scaled by the
recipe below. The same seed gives the same weights, to the bit, on the same
device. The recipe (a configuration file's ``weights`` group states its
numbers):

* convolutions of the backbone: PyTorch's default, U(-1/sqrt(fan_in),
  +1/sqrt(fan_in)) for weight and bias;
* every other convolution: Xavier-uniform weights, zero biases, and the
  focal prior on ``cate_pred``'s bias (a served model's is
  ``serve_cate_bias``: its scores reach the threshold, a fresh one's do
  not);
* the deformable layers' offset convolutions N(0, s^2) with s chosen so
  that the offsets spread ``offset_std_px`` over a unit-variance ReLU input
  (s = offset_std_px / sqrt(fan_in / 2)), zero bias; the modulator
  convolutions likewise with ``modulator_logit_std``;
* norms: weight 1, bias 0; with ``perturb_running_stats`` the BatchNorm
  running means N(0, 0.5^2) and variances U(0.5, 2) (a served model's
  statistics are not the fresh 0 and 1), else 0 and 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import named_shapes, prior_bias


def _plan(cfg: Dict, recipe: Dict, serve: bool) -> List[Tuple]:
    """(name, shape, draw, a, b): value = a + b * draw ("u": U[0, 1),
    "n": N(0, 1), "c": the constant a)."""
    out = []
    shapes = {n: s for n, s, _ in named_shapes(cfg)}
    for name, shape, _ in named_shapes(cfg):
        leaf = name.rsplit(".", 1)[-1]
        module = name.rsplit(".", 1)[0]
        conv = len(shape) == 4 or (leaf == "bias"
                                   and len(shapes.get(module + ".weight",
                                                      ())) == 4)
        if conv:
            wshape = shapes[module + ".weight"]
            fan_in = wshape[1] * wshape[2] * wshape[3]
            fan_out = wshape[0] * wshape[2] * wshape[3]
            if module.endswith(("offset_conv", "modulator_conv")):
                std = (recipe["offset_std_px"] if "offset" in module
                       else recipe["modulator_logit_std"])
                scale = std / math.sqrt(fan_in / 2)
                out.append((name, shape, "n", 0.0, scale) if leaf == "weight"
                           else (name, shape, "c", 0.0, 0.0))
            elif module.startswith("backbone"):
                bound = 1 / math.sqrt(fan_in)
                out.append((name, shape, "u", -bound, 2 * bound))
            elif leaf == "weight":
                bound = math.sqrt(6 / (fan_in + fan_out))
                out.append((name, shape, "u", -bound, 2 * bound))
            elif module == "inst_head.cate_pred":
                bias = recipe["serve_cate_bias"] if serve else None
                if bias is None:
                    bias = prior_bias(cfg["solov2"]["focal_loss_init_pi"])
                out.append((name, shape, "c", float(bias), 0.0))
            else:
                out.append((name, shape, "c", 0.0, 0.0))
        elif leaf == "running_mean":
            out.append((name, shape, "n", 0.0, 0.5) if serve
                       and recipe["perturb_running_stats"]
                       else (name, shape, "c", 0.0, 0.0))
        elif leaf == "running_var":
            out.append((name, shape, "u", 0.5, 1.5) if serve
                       and recipe["perturb_running_stats"]
                       else (name, shape, "c", 1.0, 0.0))
        elif leaf == "num_batches_tracked":
            out.append((name, shape, "c", 0.0, 0.0))
        elif leaf == "weight":
            out.append((name, shape, "c", 1.0, 0.0))
        else:
            out.append((name, shape, "c", 0.0, 0.0))
    return out


def make_weights(cfg: Dict, recipe: Dict, seed: int, device,
                 serve: bool) -> Dict[str, torch.Tensor]:
    """The state dict (f32; ``num_batches_tracked`` int64) of ``cfg``'s
    network for ``seed``, on ``device``."""
    plan = _plan(cfg, recipe, serve)
    sizes = {"u": 0, "n": 0}
    for _, shape, draw, _, _ in plan:
        if draw in sizes:
            sizes[draw] += math.prod(shape)
    gen = torch.Generator(device).manual_seed(seed)
    pools = {"u": torch.rand(sizes["u"], generator=gen, device=device),
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    used = {"u": 0, "n": 0}
    state = {}
    for name, shape, draw, a, b in plan:
        n = math.prod(shape)
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif draw == "c":
            state[name] = torch.full(shape, a, device=device)
        else:
            x = pools[draw][used[draw]:used[draw] + n].view(shape)
            used[draw] += n
            state[name] = x * b + a
    return state
