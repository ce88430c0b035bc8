"""The numbers that decide ``correct``, each held against its limit.

Training (the first steps that set-up drives through the window's own
call, against the yardstick's same steps):
* ``loss_gap``: the largest |program - yardstick| of a step's total loss
  over the yardstick's (each term is logged beside it: the lava term,
  a sum of sigmoids far in their tails, moves by percents under TF32);
* ``grad_gap``: the first step's gradient as Adam got it (its first
  moment over 1 - beta1), by the worst leaf: |norm(program) -
  norm(yardstick)| over the yardstick's norm of that leaf or of the median
  leaf, whichever is larger, over the leaves that move: those whose
  yardstick gradient is at least a thousandth of the median leaf's (the
  others, such as most conv biases in front of a training BatchNorm,
  have a gradient of round-off alone);
* ``change_gap``: the parameters' change over the steps, by the worst
  moving leaf as above;
* ``stats_gap``: the BatchNorm running statistics' change, as above.

Serving (sampled requests of the window):
* ``raw_gap``: the network's outputs (category logits, kernels, mask
  features, depth) against the yardstick's forward on the same frame, the
  largest |difference| over the largest |yardstick value|, by tensor;
* ``post_gap``: the program's post-processed outputs against the
  yardstick's post-processing of the program's own raw outputs, by the
  largest of: the share of mask pixels that differ, the largest score
  difference, the depth's largest relative difference and the count of
  slots whose validity differs.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


@contextlib.contextmanager
def exact_f32():
    """Convolutions and matrix products in full f32 (TF32 off), as the
    yardstick runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |norm(program) - norm(yardstick)| over the larger of
    its yardstick norm and the median leaf's."""
    keys = list(ref if keys is None else keys)
    pn = {k: float(prog[k].double().norm()) for k in keys}
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(rn.values()) if rn else 0.0
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def gap_of_norms(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keys: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) of the leaves ``keys`` (default: all)."""
    gaps = leaf_gaps(prog, ref, keys)
    if not gaps:
        return 0.0, ""
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def spread(gaps: Dict[str, float]) -> Dict[str, object]:
    """The median, the 90th percentile and the five worst of leaf gaps."""
    v = sorted(gaps.values())
    return {"median": v[len(v) // 2], "p90": v[int(0.9 * (len(v) - 1))],
            "worst": sorted(gaps.items(), key=lambda kv: -kv[1])[:5]}


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]
             ) -> Tuple[float, str]:
    """The largest relative gap of a step's total loss."""
    worst, where = 0.0, ""
    for i, (p, r) in enumerate(zip(prog, ref)):
        g = abs(p["total"] - r["total"]) / max(abs(r["total"]), 1e-30)
        if g >= worst:
            worst, where = g, f"step {i}"
    return worst, where


def raw_gap(prog: Dict, ref: Dict) -> Tuple[float, str]:
    worst, where = 0.0, ""
    for key in ("cate_preds", "kernel_preds", "mask_pred", "depth_pred"):
        ps = prog[key] if isinstance(prog[key], list) else [prog[key]]
        rs = ref[key] if isinstance(ref[key], list) else [ref[key]]
        for lvl, (p, r) in enumerate(zip(ps, rs)):
            r = r.float()
            g = float((p.float().to(r.device) - r).abs().max()
                      / r.abs().max().clamp_min(1e-30))
            if g >= worst:
                worst, where = g, f"{key}[{lvl}]"
    return worst, where


def post_gap(prog: Dict, ref: Dict) -> Tuple[float, str]:
    """The largest of: the share of mask pixels that differ, the largest
    score difference, the depth's largest relative difference, and the
    number of slots whose validity differs (boxes follow from the masks)."""
    gaps = post_gaps(prog, ref)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def post_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    dev = ref["pred_masks"].device
    pm = prog["pred_masks"].to(dev)
    union = (pm | ref["pred_masks"]).sum().clamp_min(1)
    rd = ref["pred_depth"].float()
    return {
        "post_mask_gap": float((pm != ref["pred_masks"]).sum() / union),
        "post_score_gap": float((prog["pred_scores"].to(dev).float()
                                 - ref["pred_scores"].float()).abs().max()),
        "post_depth_gap": float((prog["pred_depth"].to(dev).float() - rd)
                                .abs().max() / rd.abs().max().clamp_min(
                                    1e-30)),
        "post_valid_gap": float((prog["pred_valid"].to(dev)
                                 != ref["pred_valid"]).sum()),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Whether every number is within its limit (a missing or non-finite
    number fails), and {name: {value, limit}}."""
    table = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
             for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
