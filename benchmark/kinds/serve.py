"""Serving traffic: ``PlaneRecNetRunner.infer`` as a closed loop.

One client sends one u8 BGR frame a request, the next as soon as the last
one's outputs are ready on the device (synchronised), as the upstream FPS
harness times a frame. Set-up renders the scene pool, makes a ring of
distinct frames (on the host), builds the runner with the seeded weights
and sends ``warmup`` requests, which build and warm every kernel at the
one frame shape. The window sends requests until ``seconds`` have passed;
each is timed from its send to its outputs being ready. The rate is every
frame over the time from the first send to the last completion.

A sample of the window's requests, drawn from the seed over the requests
that the warm-up's pace says the window will hold, keeps its raw outputs
(through a forward hook on the network) and its post-processed outputs,
copied to the host after the request's clock has stopped.

With ``trace``: a few more requests under the profiler, then a few with a
synchronised span around ``ops.postprocess.postprocess_batch``, called as
``infer`` calls it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from benchmark import check, loop, scenes, trace as tracing, work
from benchmark.reference.model import PlaneRecNet, normalise
from benchmark.reference.postprocess import postprocess
from benchmark.weights import make_weights


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, out_dir=None) -> Dict:
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tr, cfg = cell.traffic, cell.config["config"]
    h, w = tr["height"], tr["width"]
    pcfg = apply_overrides(PlaneRecNetConfig(), dict(cfg, **(overrides
                                                          or {})))
    pool = scenes.render_pool(seed, tr["pool"], h, w)
    # Each request is one u8 BGR frame, (1, H, W, 3), on the host.
    ring = [r["image"][None] for r in scenes.make_rows(pool, tr["ring"],
                                                       seed)]
    del pool

    runner = PlaneRecNetRunner(pcfg, seed=seed, device=device)
    weights = make_weights(cfg, cell.config["weights"], seed, device, True)
    runner.model.load_state_dict(weights)
    del weights
    captured = []
    hook = runner.model.register_forward_hook(
        lambda mod, inp, out: captured.append(out) if keep else None)
    keep = False
    for i in range(tr["warmup"]):
        t = time.perf_counter()
        runner.infer(ring[i % len(ring)])
        sync()
        pace = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    expected = max(1, int(0.8 * seconds / pace))
    rng = scenes.rng_for(seed, 2)
    sample = set(rng.choice(expected, min(tr["check_requests"], expected),
                            replace=False).tolist())
    kept, last = [], {}

    def request(i):
        nonlocal keep
        keep = i in sample
        last["out"] = runner.infer(ring[i % len(ring)])

    def copy_kept(i):
        nonlocal keep
        out = last.pop("out")
        if keep:
            keep = False
            kept.append((i, _host(captured.pop()), _host(out)))

    lat, window_s, host = loop.closed_loop(request, seconds, sync,
                                           each=True, after=copy_kept)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rate = loop.rate(len(lat) * tr["batch"], window_s)
    result = {"setup_s": setup_s, "attempted": len(lat), "failed": 0,
              "e2e": {"request_ms_p95": loop.p95_ms(lat),
                      "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
              "memory_peak_bytes": peak, "requests": len(lat),
              "serve_img_per_s": rate,
              "window_s": window_s, "host": host, "checked": len(kept)}
    hook.remove()

    if trace:
        n_tr = tr["trace_requests"]

        def traced():
            for i in range(n_tr):
                runner.infer(ring[(len(lat) + i) % len(ring)])
                sync()

        path = str(out_dir / "trace.json")
        summary = tracing.record(traced, n_tr, path, device)
        summary["idle_gaps"] = tracing.record(traced, n_tr, path, device,
                                              host=True)["idle_gaps"]
        spans = []
        for i in range(tr["span_requests"]):
            x = runner._batch(ring[i % len(ring)])
            with torch.no_grad():
                preds = runner.model(fast_base_transform(x))
                sync()
                t = time.perf_counter()
                postprocess_batch(preds, runner.cfg, x.shape[1:3])
                sync()
            spans.append(time.perf_counter() - t)
        result["ctx"] = {
            "kind": "serve", "trace": summary, "rate_img_per_s": rate,
            "flops_per_img": work.model_flops(cfg, 1, h, w, False),
            "peaks": work.PEAKS,
            "dcn_shapes": work.dcn_shapes(cfg, tr["batch"], h, w),
            "spans": {"postprocess": spans}}

    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["numbers"], result["where"] = judge(cell, seed, device, ring,
                                               kept, (h, w))
    return result


def judge(cell, seed: int, device, ring, kept, size):
    """The worst of each number over the kept requests."""
    cfg = cell.config["config"]
    weights = make_weights(cfg, cell.config["weights"], seed, device, True)
    with torch.device("meta"):
        net = PlaneRecNet(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights)
    net.eval()
    del weights
    numbers = {"raw_gap": 0.0}
    where = {"detections": [], "candidates": []}
    with check.exact_f32(), torch.no_grad():
        for i, raw, out in kept:
            x = normalise(torch.from_numpy(ring[i % len(ring)]).to(device))
            g, at = check.raw_gap(raw, net(x))
            if g >= numbers["raw_gap"]:
                numbers["raw_gap"], where["raw_gap"] = g, at
            raw_dev = {k: ([t.to(device) for t in v] if isinstance(v, list)
                           else v.to(device)) for k, v in raw.items()}
            g, at = check.post_gap(out, postprocess(raw_dev, cfg, size))
            if g >= numbers.get("post_gap", 0.0):
                numbers["post_gap"], where["post_gap"] = g, at
            where["detections"].append(int(out["pred_valid"].sum()))
            where["candidates"].append(int(sum(
                (torch.sigmoid(c.float()) > cfg["solov2"]["score_thr"]).sum()
                for c in raw["cate_preds"])))
    if not kept:
        numbers["raw_gap"] = float("nan")
    return numbers, where
