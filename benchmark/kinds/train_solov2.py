"""SOLOv2 training traffic: ``trainer.train_step`` as a closed loop of
steps on frames of rendered rooms whose planes are instances of 80
classes.

As ``kinds/train.py`` (whose helpers it uses), with what SOLOv2 asks:

* the frames are the traffic's size (800x1344), rendered with 3-8
  cuboids and kept where they show at least 3 instances, each frame's
  20 largest at most (COCO averages about 7); each instance's class is
  drawn from the seed over 80 classes, the first (COCO's person) with
  the configuration's ``first_share``, the others evenly;
* the wire batch carries no depth (the model has no depth branch);
* the optimizer is SGD, so the first step's gradient is read from the
  parameters between ``trainer.grad_step`` and ``trainer.apply_grads``
  (before clipping), the two calls ``train_step`` makes;
* the yardstick is ``benchmark/reference/solov2.py``, run in blocks of
  images with the batch's normalisers;
* traced, ``benchmark/spans.py::train`` gives the device ms under the
  program's spans after the span loop (a program without the spans reads
  none).

The configuration is built first, so that a program that cannot run it
fails at once.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from benchmark import check, loop, scenes, spans as span_reader, \
    trace as tracing, weights, work
from benchmark.kinds.train import _params, _sub
from benchmark.reference import solov2

MAX_TRIES = 50        # scenes rendered for each frame kept, at most


def render_pool(seed: int, n: int, h: int, w: int, boxes=(3, 8),
                fewest: int = 3, most: int = 20) -> List[Dict]:
    """``n`` scenes as ``scenes.render_pool`` makes them, with ``boxes``
    cuboids, each showing at least ``fewest`` planes; the ``most``
    largest are kept."""
    rng = scenes.rng_for(seed, 0)
    k = scenes._intrinsics(h, w)
    pool = []
    for _ in range(n):
        for _ in range(MAX_TRIES):
            rgb, depth, ids, planes = scenes.render(
                scenes.build_scene(rng, boxes), k, h, w)
            found = [(int((ids == r).sum()), r) for r in range(len(planes))]
            found = sorted((a, r) for a, r in found
                           if a >= scenes.MIN_AREA)[::-1][:most]
            if len(found) >= fewest:
                break
        rgb = np.clip(rgb + rng.normal(0, scenes.NOISE_SIGMA, rgb.shape),
                      0, 255)
        masks, bx, paras = [], [], []
        for _, r in sorted(found, key=lambda ar: ar[1]):
            m = ids == r
            ys, xs = np.nonzero(m)
            masks.append(m)
            bx.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            paras.append([*planes[r]["n"], planes[r]["d"]])
        pool.append({"image": rgb[..., ::-1].astype(np.uint8),
                     "depth": depth,
                     "masks": np.asarray(masks, np.uint8).reshape(-1, h, w),
                     "boxes": np.asarray(bx, np.float32).reshape(-1, 4),
                     "plane_paras": np.asarray(paras, np.float32).reshape(
                         -1, 4),
                     "k_matrix": k.astype(np.float32)})
    return pool


def draw_classes(seed: int, shape, count: int, first_share: float
                 ) -> np.ndarray:
    """Class ids (``shape``, int32): 0 with ``first_share``, else one of
    1 .. count - 1 evenly."""
    rng = scenes.rng_for(seed, 7)
    other = rng.randint(1, count, size=shape)
    return np.where(rng.rand(*shape) < first_share, 0, other).astype(
        np.int32)


def make_ring(cell, seed: int) -> List[Dict]:
    """The ring of distinct wire batches: no depth, classes drawn."""
    tr, cfg = cell.traffic, cell.config["config"]
    b, n = tr["batch"], cfg["max_instances"]
    pool = render_pool(seed, tr["pool"], tr["height"], tr["width"])
    rows = scenes.make_rows(pool, b * tr["ring_batches"], seed)
    classes = draw_classes(seed, (tr["ring_batches"], b, n),
                           **cell.config["traffic_classes"])
    ring = []
    for i in range(tr["ring_batches"]):
        wire = scenes.collate(rows[i * b:(i + 1) * b], n,
                              cfg["dataset"]["depth_resolution"])
        del wire["depth_q"]
        wire["classes"] = classes[i]
        ring.append(wire)
    return ring


def dense(wire: Dict, max_instances: int, depth_resolution: float, device
          ) -> Dict:
    """``scenes.dense`` of a wire batch without depth."""
    b, h, w = wire["image"].shape[:3]
    out = scenes.dense(dict(wire, depth_q=np.zeros((b, h, w, 1), np.uint16)),
                       max_instances, depth_resolution, device)
    del out["depth"]
    return out


def make_weights(cfg: Dict, recipe: Dict, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """``benchmark/weights.py``'s recipe over SOLOv2's parameters."""
    with mock.patch.object(weights, "named_shapes", solov2.named_shapes):
        return weights.make_weights(cfg, recipe, seed, device, False)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, out_dir=None) -> Dict:
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)

    tr, cfg = cell.traffic, cell.config["config"]
    pcfg = apply_overrides(PlaneRecNetConfig(), dict(cfg, **(overrides
                                                          or {})))
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    b, h, w = tr["batch"], tr["height"], tr["width"]
    if tr["ring_batches"] < tr["check_steps"]:
        raise ValueError("the checked steps need rows that all differ: "
                         "ring_batches < check_steps")
    ring = make_ring(cell, seed)
    state = trainer.create_train_state(pcfg, seed=seed, device=device)
    state.model.load_state_dict(make_weights(cfg, cell.config["weights"],
                                             seed, device))
    p0 = _params(state.model)
    names = [n for n, _ in state.model.named_parameters()]
    losses, grad1 = [], None
    n_check = tr["check_steps"]
    for i in range(n_check):
        if i == 0:
            out, saved = trainer.grad_step(state, ring[0])
            grad1 = {n: p.grad.float().cpu().clone() for n, p in zip(
                names, state.model.parameters()) if p.grad is not None}
            trainer.apply_grads(state, out["total"], saved)
        else:
            out = trainer.train_step(state, ring[i % len(ring)])
        losses.append({k: float(v) for k, v in out.items()})
    p3 = _params(state.model)
    sync()
    setup_s = time.perf_counter() - t0

    updates0 = state.updates
    _, window_s, host = loop.closed_loop(
        lambda i: trainer.train_step(state, ring[(n_check + i) % len(ring)]),
        seconds, sync, each=False)
    steps = state.step - n_check
    failed = steps - (state.updates - updates0)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rate = loop.rate(steps * b, window_s)
    nxt = n_check + steps
    result = {"setup_s": setup_s, "attempted": steps, "failed": failed,
              "e2e": {"train_img_per_s": rate, "peak_mem_gib": peak / 2 ** 30,
                      "setup_s": setup_s},
              "memory_peak_bytes": peak, "remat": False, "steps": steps,
              "window_s": window_s, "host": host}

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
        timed = []
        for i in range(tr["span_steps"]):
            out, saved = trainer.grad_step(state, ring[(nxt + i) % len(ring)])
            sync()
            t = time.perf_counter()
            trainer.apply_grads(state, out["total"], saved)
            sync()
            timed.append(time.perf_counter() - t)
        nxt += tr["span_steps"]
        try:
            table = span_reader.train(state, ring, nxt, tr, device, out_dir)
        except ValueError:          # a program without spans
            table = {"spans": {}}
        result["ctx"] = {
            "kind": "solov2", "trace": summary, "rate_img_per_s": rate,
            "peaks": work.PEAKS, "dcn_shapes": solov2.dcn_shapes(cfg, b, h,
                                                                  w),
            "dice_shape": dict(work.dice_shape(cfg, b, h, w),
                               levels=solov2.NUM_LEVELS),
            "spans": {"apply_grads": timed}, "program_spans": table["spans"]}

    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = follow(cell, seed, device, ring, n_check)
    if trace:
        # The window runs the ring's batches in turn; the checked steps
        # ran its first ``n_check`` (all of it, in the cell's traffic):
        # their positives an image.
        per_img = sum(ref["positives_total"]) / (n_check * b)
        result["ctx"]["flops_per_img"] = solov2.flops_per_image(
            cfg, h, w, per_img)
    moving = check.moving_leaves(ref["grad1"])
    gaps = {"loss_gap": check.loss_gap(losses, ref["losses"]),
            "grad_gap": check.gap_of_norms(grad1, ref["grad1"], moving),
            "change_gap": check.gap_of_norms(
                {k: v for k, v in _sub(p3, p0).items() if k in ref["change"]},
                ref["change"], moving)}
    result["numbers"] = {k: v[0] for k, v in gaps.items()}
    result["where"] = {k: v[1] for k, v in gaps.items()}
    result["losses"] = {"program": losses, "yardstick": ref["losses"]}
    result["diag"] = {
        "grad": check.spread(check.leaf_gaps(grad1, ref["grad1"], moving)),
        "moving": len(moving), "leaves": len(grad1),
        "grad_norm": ref["grad_norm"], "clip": ref["clip"],
        "positives": ref["positives"]}
    return result


def follow(cell, seed: int, device, ring, n_check: int) -> Dict:
    """The yardstick's first ``n_check`` steps on the same weights and
    batches, in f32 with TF32 off."""
    cfg = cell.config["config"]
    res = cfg["dataset"]["depth_resolution"]
    state = make_weights(cfg, cell.config["weights"], seed, device)
    p0 = {k: v.float().cpu().clone() for k, v in state.items()}
    with check.exact_f32():
        ref = solov2.Trainer(cfg, state, device,
                             block=cell.traffic["yardstick_block"])
        del state
        losses, grad1, norms, clips, positives, totals = ([], None, [], [],
                                                          [], [])
        for i in range(n_check):
            batch = dense(ring[i % len(ring)], cfg["max_instances"], res,
                          device)
            out = ref.step(batch)
            del batch
            losses.append({k: float(v) for k, v in out["losses"].items()})
            norms.append(out["grad_norm"])
            clips.append(out["clip"])
            positives.append(out["positives"])
            totals.append(out["positives_total"])
            if i == 0:
                grad1 = {k: g.float().cpu() for k, g in out["grads"].items()}
    p3 = _params(ref.net)
    names = set(ref.names)
    del ref
    gc.collect()
    return {"losses": losses, "grad1": grad1, "grad_norm": norms,
            "clip": clips, "positives": positives, "positives_total": totals,
            "change": {k: p3[k] - p0[k] for k in p3 if k in names}}
