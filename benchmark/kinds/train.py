"""Training traffic: ``trainer.train_step`` as a closed loop of steps.

Set-up renders the scene pool, makes a ring of distinct wire batches (held
on the host: the copy to the card is in the step), builds the train state
with the seeded weights, and drives it through ``check_steps`` steps of
the window's own call on rows that all differ; those steps also build and
warm every kernel at the cell's one shape. Their losses, the first
gradient as Adam got it and the change after them are kept (on the host)
for the yardstick. The window then steps through the ring until
``seconds`` have passed; the rate is every image of every step over the
time from the first step's start to the last one's end (synchronised),
reported under the traffic's ``rate_metric`` (``train_img_per_s`` where
it names none).

With ``trace``: a few more steps under the profiler (device time, idle
gaps), then a few with a synchronised span around
``trainer.apply_grads``, called as ``train_step`` calls it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from benchmark import check, loop, scenes, trace as tracing, work
from benchmark.reference.train import Trainer
from benchmark.weights import make_weights


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters()}


def _stats(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _sub(a: Dict, b: Dict) -> Dict:
    return {k: a[k] - b[k] for k in a}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, out_dir=None) -> Dict:
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)
    from planerecnet_tpu_torch.models.planerecnet import resolve_remat

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tr, cfg = cell.traffic, cell.config["config"]
    b, h, w = tr["batch"], tr["height"], tr["width"]
    res = cfg["dataset"]["depth_resolution"]
    pcfg = apply_overrides(PlaneRecNetConfig(), dict(cfg, **(overrides
                                                          or {})))

    if tr["ring_batches"] < tr["check_steps"]:
        raise ValueError("the checked steps need rows that all differ: "
                         "ring_batches < check_steps")
    pool = scenes.render_pool(seed, tr["pool"], h, w)
    rows = scenes.make_rows(pool, b * tr["ring_batches"], seed)
    ring = [scenes.collate(rows[i * b:(i + 1) * b], cfg["max_instances"], res)
            for i in range(tr["ring_batches"])]
    del pool, rows

    state = trainer.create_train_state(pcfg, seed=seed, device=device)
    weights = make_weights(cfg, cell.config["weights"], seed, device, False)
    state.model.load_state_dict(weights)
    del weights
    p0, s0 = _params(state.model), _stats(state.model)
    names = [n for n, _ in state.model.named_parameters()]
    losses, grad1 = [], None
    n_check = tr["check_steps"]
    for i in range(n_check):
        out = trainer.train_step(state, ring[i % len(ring)])
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            # Adam's first moment after one step is (1 - beta1) * grad; a
            # step that applied nothing left none.
            grad1 = {n: (state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / 0.1).float().cpu()
                for n, p in zip(names, state.model.parameters())}
    p3, s3 = _params(state.model), _stats(state.model)
    sync()
    setup_s = time.perf_counter() - t0

    # The window.
    updates0 = state.updates
    _, window_s, host = loop.closed_loop(
        lambda i: trainer.train_step(state, ring[(n_check + i) % len(ring)]),
        seconds, sync, each=False)
    steps = state.step - n_check
    failed = steps - (state.updates - updates0)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rate = loop.rate(steps * b, window_s)
    nxt = n_check + steps
    remat = resolve_remat(pcfg.remat_backbone, True, b * h * w * (
        2 if pcfg.compute_dtype == "bfloat16" else 4),
        torch.cuda.get_device_properties(device).total_memory
        if cuda else None)
    result = {"setup_s": setup_s, "attempted": steps, "failed": failed,
              "e2e": {tr.get("rate_metric", "train_img_per_s"): rate,
                      "peak_mem_gib": peak / 2 ** 30,
                      "setup_s": setup_s},
              "memory_peak_bytes": peak, "remat": remat,
              "steps": steps, "window_s": window_s, "host": host}

    if trace:
        n_tr = tr["trace_steps"]

        def traced():
            for i in range(n_tr):
                trainer.train_step(state, ring[(nxt + i) % len(ring)])

        path = str(out_dir / "trace.json")
        summary = tracing.record(traced, n_tr, path, device)
        summary["idle_gaps"] = tracing.record(traced, n_tr, path, device,
                                              host=True)["idle_gaps"]
        nxt += 2 * n_tr
        spans = []
        for i in range(tr["span_steps"]):
            out, saved = trainer.grad_step(state, ring[(nxt + i) % len(ring)])
            sync()
            t = time.perf_counter()
            trainer.apply_grads(state, out["total"], saved)
            sync()
            spans.append(time.perf_counter() - t)
        dcn = work.dcn_shapes(cfg, b, h, w)
        result["ctx"] = {
            "kind": "train", "trace": summary, "rate_img_per_s": rate,
            "flops_per_img": work.model_flops(cfg, b, h, w, True) / b,
            "peaks": work.PEAKS, "dcn_shapes": dcn,
            "dice_shape": work.dice_shape(cfg, b, h, w),
            "spans": {"apply_grads": spans}}

    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = follow(cell, seed, device, ring, n_check, remat)
    moving = check.moving_leaves(ref["grad1"])
    gaps = {"loss_gap": check.loss_gap(losses, ref["losses"]),
            "grad_gap": check.gap_of_norms(grad1, ref["grad1"], moving),
            "change_gap": check.gap_of_norms(_sub(p3, p0), ref["change"],
                                             moving),
            "stats_gap": check.gap_of_norms(_sub(s3, s0), ref["stats"])}
    result["numbers"] = {k: v for k, (v, _) in gaps.items()}
    result["where"] = {k: f for k, (_, f) in gaps.items()}
    result["losses"] = {"program": losses, "yardstick": ref["losses"]}
    result["diag"] = {
        "grad": check.spread(check.leaf_gaps(grad1, ref["grad1"], moving)),
        "change": check.spread(check.leaf_gaps(_sub(p3, p0), ref["change"],
                                               moving)),
        "moving": len(moving), "leaves": len(grad1)}
    return result


def follow(cell, seed: int, device, ring, n_check: int, remat: bool
           ) -> Dict:
    """The yardstick's first ``n_check`` steps on the same weights and
    batches, in f32 with TF32 off."""
    cfg = cell.config["config"]
    res = cfg["dataset"]["depth_resolution"]
    weights = make_weights(cfg, cell.config["weights"], seed, device, False)
    p0 = {k: v.float().cpu().clone() for k, v in weights.items()}
    with check.exact_f32():
        ref = Trainer(cfg, weights, seed, device, remat=remat)
        del weights
        names = [n for n, _ in ref.net.named_parameters()]
        losses, grad1 = [], None
        for i in range(n_check):
            batch = scenes.dense(ring[i % len(ring)], cfg["max_instances"],
                                 res, device)
            out = ref.step(batch, i)
            del batch
            losses.append({k: float(v) for k, v in out.items()})
            if i == 0:
                grad1 = {n: (m / 0.1).float().cpu()
                         for n, m in zip(names, ref.m)}
    p3, s3 = _params(ref.net), _stats(ref.net)
    del ref
    gc.collect()
    return {"losses": losses, "grad1": grad1,
            "change": {k: p3[k] - p0[k] for k in p3},
            "stats": {k: s3[k] - p0[k] for k in s3}}
