"""Data-parallel training traffic: ``trainer.train_step`` on one rank a
card, the ranks meeting over NCCL, as the train CLI's all-cards path
runs them.

``run`` (rank 0, the harness's own process) starts ranks 1 .. world - 1
as processes of this module (``--rank``), each on its own card, and
every rank runs ``rank_main``: its own ring of distinct wire batches of
``batch`` rows (rendered rooms from the seed and the rank), the train
state on a one-axis mesh (``trainer.create_train_state(mesh=...)``: DDP,
BatchNorm synced over the global batch), ``check_steps`` steps through
the window's own call, then the window. Rank 0 decides when the window
ends and tells the others over a CPU (gloo) group after each step, so
that every rank runs the same steps. The rate is every image of every
rank over rank 0's window; the peak memory is the largest of the ranks'.
Each rank is given ``os.cpu_count() // world`` host threads.

Traced, every rank runs the traced steps and rank 0 records its card.

The yardstick: ``benchmark/reference/``'s plain model on every rank with
``torch.nn.SyncBatchNorm`` and the rank's own rows, each rank's losses
its share of the global batch's (each term's normaliser summed over the
ranks first, the VNL triplets drawn for the global batch and the rank's
rows kept, as the program draws them), the gradients summed over the
ranks by ``all_reduce``, then Adam; the backbone recomputed in the
backward (memory), the norms' statistics kept as the forward left them.
It uses none of the program's ``parallel/`` code.

Data parallelism promises one thing more: every rank holds the same
model. ``replica_gap`` holds the ranks' parameters and BatchNorm running
statistics after the checked steps against each other (DDP's summed
gradients and synced statistics leave them equal, bit for bit). The
faults a rank can commit alone (``FAULTS``: its gradients left out of
the sum, its norms trained on its own rows) move the yardstick's
numbers little and this one at once. ``run(..., fault=NAME)`` plants a
fault in every rank; the benchmark's runs never do.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from benchmark import check, faults, scenes, trace as tracing, work
from benchmark.kinds.train import _params, _stats, _sub
from benchmark.reference import losses as ref_losses
from benchmark.reference.model import normalise, resize
from benchmark.reference.train import Trainer, learning_rate
from benchmark.weights import make_weights

TIMEOUT_S = 600       # a collective that waits longer fails the run
REPO = Path(__file__).resolve().parents[2]


def no_allreduce():
    """Each rank steps on its own rows' gradients: the model is not put
    under DDP."""
    from planerecnet_tpu_torch import trainer

    return faults._patched(trainer, "replicated",
                           lambda _: lambda model, mesh: model)


def local_batchnorm():
    """BatchNorm trains on each rank's own rows: the norms are not
    synced."""
    from planerecnet_tpu_torch import trainer

    return faults._patched(trainer, "convert_sync_batchnorm",
                           lambda _: lambda module: module)


FAULTS = dict(faults.FAULTS, no_allreduce=no_allreduce,
              local_batchnorm=local_batchnorm)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, out_dir=None, fault: str = None) -> Dict:
    world = cell.traffic["ranks"]
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(threads(world)))
    spec = json.dumps({"name": cell.name, "chips": cell.chips,
                       "config": cell.config, "traffic": cell.traffic,
                       "limits": cell.limits})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.kinds.train_dp", "--cell",
         spec, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(int(trace)), "--rank", str(r), "--world",
         str(world), "--port", str(port), "--device", str(device),
         "--overrides", json.dumps(overrides or {}), "--out", str(out_dir)]
        + (["--fault", fault] if fault else []),
        env=env, cwd=REPO) for r in range(1, world)]
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
    try:
        result = rank_main(cell, seed, seconds, trace, device, 0, world,
                           port, overrides, out_dir, t0, fault)
    finally:
        done.set()
        for p in procs:
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"a rank failed with exit code {bad[0]}")
    return result


def _watch(procs, done: threading.Event) -> None:
    """Rank 0 would wait in a collective for a rank that has died: end the
    run at once instead."""
    while not done.wait(1.0):
        bad = [p.returncode for p in procs if p.poll()]
        if bad and not done.is_set():
            for p in procs:
                if p.poll() is None:
                    p.kill()
            print(f"benchmark: a rank failed with exit code {bad[0]}",
                  file=sys.stderr, flush=True)
            os._exit(1)


def threads(world: int) -> int:
    return max(1, (os.cpu_count() or world) // world)


def make_ring(cell, seed: int, rank: int, world: int) -> List[Dict]:
    """This rank's ring of distinct wire batches."""
    tr, cfg = cell.traffic, cell.config["config"]
    b = tr["batch"]
    pool = scenes.render_pool(seed * world + rank, tr["pool"], tr["height"],
                              tr["width"])
    rows = scenes.make_rows(pool, b * tr["ring_batches"], seed * world + rank)
    return [scenes.collate(rows[i * b:(i + 1) * b], cfg["max_instances"],
                           cfg["dataset"]["depth_resolution"])
            for i in range(tr["ring_batches"])]


def rank_main(cell, seed: int, seconds: float, trace: bool, device,
              rank: int, world: int, port: int, overrides, out_dir,
              t0: float, fault: str = None) -> Dict:
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)
    from planerecnet_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(threads(world))
    tr, cfg = cell.traffic, cell.config["config"]
    pcfg = apply_overrides(PlaneRecNetConfig(), dict(cfg, **(overrides
                                                          or {})))
    cuda = str(device).startswith("cuda")
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    flags = dist.new_group(backend="gloo")
    try:
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            return _rank(cell, seed, seconds, trace, device, rank, world,
                         pcfg, flags, out_dir, t0, trainer, make_mesh)
    finally:
        dist.destroy_process_group()


def _rank(cell, seed, seconds, trace, device, rank, world, pcfg, flags,
          out_dir, t0, trainer, make_mesh) -> Dict:
    tr, cfg = cell.traffic, cell.config["config"]
    cuda = device.type == "cuda"
    b, h, w = tr["batch"], tr["height"], tr["width"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if tr["ring_batches"] < tr["check_steps"]:
        raise ValueError("the checked steps need rows that all differ: "
                         "ring_batches < check_steps")
    ring = make_ring(cell, seed, rank, world)
    state = trainer.create_train_state(pcfg, seed=seed, device=device,
                                       mesh=make_mesh(device))
    state.model.load_state_dict(make_weights(cfg, cell.config["weights"],
                                             seed, device, False))
    p0, s0 = _params(state.model), _stats(state.model)
    names = [n for n, _ in state.model.named_parameters()]
    losses, grad1 = [], None
    n_check = tr["check_steps"]
    for i in range(n_check):
        out = trainer.train_step(state, ring[i % len(ring)])
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            grad1 = {n: (state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / 0.1).float().cpu()
                for n, p in zip(names, state.model.parameters())}
    p3, s3 = _params(state.model), _stats(state.model)
    sync()
    dist.barrier(group=flags)
    setup = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
    dist.all_reduce(setup, op=dist.ReduceOp.MAX, group=flags)
    setup_s = float(setup)

    # The window: rank 0's clock decides, after each step, whether
    # another one runs; every rank learns it over the CPU group.
    updates0, stop = state.updates, torch.zeros(1)
    start = time.perf_counter()
    i = 0
    while True:
        trainer.train_step(state, ring[(n_check + i) % len(ring)])
        i += 1
        stop[0] = float(time.perf_counter() - start >= seconds)
        dist.broadcast(stop, 0, group=flags)
        if stop[0]:
            break
    sync()
    dist.barrier(group=flags)
    window_s = time.perf_counter() - start
    steps = i
    failed = steps - (state.updates - updates0)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(device))
                         if cuda else 0.0], dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=flags)
    peak = int(peak)
    replicas = replica_gap(dict(p3, **s3), flags)
    rate = steps * b * world / window_s
    nxt = n_check + steps
    result = {"setup_s": setup_s, "attempted": steps * world,
              "failed": failed * world,
              "e2e": {"train_img_per_s": rate, "peak_mem_gib": peak / 2 ** 30,
                      "setup_s": setup_s},
              "memory_peak_bytes": peak, "remat": False, "steps": steps,
              "window_s": window_s}

    if trace:
        n_tr = tr["trace_steps"]

        def traced():
            for j in range(n_tr):
                trainer.train_step(state, ring[(nxt + j) % len(ring)])

        path = str(Path(out_dir) / "trace.json")
        if rank == 0:
            summary = tracing.record(traced, n_tr, path, device)
            summary["idle_gaps"] = tracing.record(
                traced, n_tr, path, device, host=True)["idle_gaps"]
        else:
            traced()
            traced()
        sync()
        result["ctx"] = None if rank else {
            "kind": "train_dp", "trace": summary, "rate_img_per_s": rate,
            "world": world,
            "flops_per_img": work.model_flops(cfg, b, h, w, True) / b,
            "peaks": work.PEAKS}

    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = follow(cell, seed, device, ring, n_check, rank, world)
    if rank:
        return result
    moving = check.moving_leaves(ref["grad1"])
    gaps = {"loss_gap": check.loss_gap(losses, ref["losses"]),
            "grad_gap": check.gap_of_norms(grad1, ref["grad1"], moving),
            "change_gap": check.gap_of_norms(_sub(p3, p0), ref["change"],
                                             moving),
            "stats_gap": check.gap_of_norms(_sub(s3, s0), ref["stats"]),
            "replica_gap": replicas}
    result["numbers"] = {k: v[0] for k, v in gaps.items()}
    result["where"] = {k: v[1] for k, v in gaps.items()}
    result["losses"] = {"program": losses, "yardstick": ref["losses"]}
    result["diag"] = {
        "grad": check.spread(check.leaf_gaps(grad1, ref["grad1"], moving)),
        "moving": len(moving), "leaves": len(grad1), "ranks": world}
    return result


def replica_gap(leaves: Dict[str, torch.Tensor], group
                ) -> Tuple[float, str]:
    """(worst gap, its leaf) of the ranks' copies of ``leaves``: the norm
    of each element's largest less its least over the ranks, over the
    larger of the leaf's norm and the median leaf's (``check.leaf_gaps``'
    scale). Every rank takes part; 0 where the copies are equal."""
    names = list(leaves)
    flat = torch.cat([leaves[k].reshape(-1) for k in names])
    hi, lo = flat.clone(), flat
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    sizes = [leaves[k].numel() for k in names]
    spread = dict(zip(names, (hi - lo).split(sizes)))
    norms = {k: float(leaves[k].double().norm()) for k in names}
    med = statistics.median(norms.values())
    gaps = {k: float(spread[k].double().norm()) / max(norms[k], med, 1e-30)
            for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _counts(cfg: Dict, batch: Dict) -> torch.Tensor:
    """This rank's normalisers as the reference's ``losses`` takes them
    (valid positive slots, positive cells, images whose lava term
    counts), to be summed over the ranks."""
    masks, valid = batch["masks"], batch["gt_valid"].bool()
    b, n, h, w = masks.shape
    mf = masks.float()
    sums = mf.sum((2, 3))
    ys = torch.arange(h, dtype=torch.float32, device=mf.device)
    xs = torch.arange(w, dtype=torch.float32, device=mf.device)
    m00 = sums.clamp(min=1e-6)
    cx = (mf * xs).sum((2, 3)) / m00
    cy = (mf * ys[:, None]).sum((2, 3)) / m00
    sv = cfg["solov2"]
    slots = cells = 0.0
    per_image = torch.zeros(b, device=mf.device)
    for lv in range(len(sv["num_grids"])):
        _, ins, _, _, pok = ref_losses.prepare_level(
            batch["boxes"].float(), batch["classes"], valid, sums, cx, cy,
            (h, w), sv["num_grids"][lv], sv["fpn_scale_ranges"][lv],
            sv["sigma"], cfg["num_classes"], cfg["max_positives"])
        slots = slots + pok.float().sum()
        cells = cells + ins.float().sum()
        per_image = per_image + pok.float().sum(1)
    depth = batch["depth"].float()
    res = cfg["dataset"]["depth_resolution"] or 1e-3
    g = ref_losses.gradient_map(depth) / depth.clamp(min=res) ** 2
    g = torch.where(g.clamp(max=1e-2) < 1e-4, 0.0, g.clamp(max=1e-2))
    lava = ((per_image > 0) & (g.sum((1, 2)) > 0)).float().sum()
    return torch.stack([slots, cells, lava]).double()


def _global_rows(t: torch.Tensor, first: int, total: int) -> torch.Tensor:
    """``t``'s rows placed at ``first`` of ``total``, the other rows copies
    of its first row (no gradient): the shape of the global batch, whose
    random draws the program takes."""
    pad = t[:1].detach()
    before = pad.expand(first, *t.shape[1:])
    after = pad.expand(total - first - t.shape[0], *t.shape[1:])
    return torch.cat([before, t, after])


def rank_losses(cfg: Dict, preds: Dict, batch: Dict, gen, rank: int,
                world: int) -> Dict[str, torch.Tensor]:
    """The reference's losses of this rank's rows as its share of the
    global batch's."""
    out = ref_losses.losses(dict(cfg, use_plane_loss=False), preds, batch,
                            gen)
    mine = _counts(cfg, batch)
    total = mine.clone()
    dist.all_reduce(total)
    (c, n, nc), (cg, ng, ncg) = mine.tolist(), total.tolist()
    out["ins"] = out["ins"] * max(c, 1.0) / max(cg, 1.0)
    out["cat"] = out["cat"] * (n + 1.0) / (ng + 1.0)
    out["dpt"] = out["dpt"] / world
    if "lav" in out:
        out["lav"] = out["lav"] * max(nc, 1.0) / max(ncg, 1.0)
    if cfg["use_plane_loss"]:
        masks, valid = batch["masks"], batch["gt_valid"].bool()
        b, n_inst, h, w = masks.shape
        vp = min(cfg["vnl_max_planes"], n_inst)
        order = torch.argsort((~valid).int(), dim=1, stable=True)[:, :vp]
        mb = masks.bool()
        rows = torch.arange(b, device=order.device)[:, None]
        normals = torch.gather(batch["plane_paras"][..., :3].float(), 1,
                               order[..., None].expand(-1, -1, 3))
        nonplanar = ~(mb & valid[:, :, None, None]).any(1)
        up = resize(preds["depth_pred"].float().permute(0, 3, 1, 2),
                    (h, w))[:, 0]
        args = (up, batch["depth"].float(), batch["k_matrix"].float(),
                normals, torch.gather(valid, 1, order), mb[rows, order],
                nonplanar.reshape(b, -1))
        first = rank * b
        pln = ref_losses.vnl_loss(
            *(_global_rows(t, first, b * world) for t in args),
            cfg["vnl_samples"], gen)[first:first + b]
        out["pln"] = cfg["pln_weight"] * pln.sum() / (b * world)
    return out


def follow(cell, seed: int, device, ring, n_check: int, rank: int,
           world: int) -> Dict:
    """The yardstick's first ``n_check`` steps on every rank, in f32 with
    TF32 off."""
    cfg = cell.config["config"]
    res = cfg["dataset"]["depth_resolution"]
    weights = make_weights(cfg, cell.config["weights"], seed, device, False)
    p0 = {k: v.float().cpu().clone() for k, v in weights.items()}
    with check.exact_f32():
        ref = Trainer(cfg, weights, seed, device, remat=True)
        del weights
        ref.net = (torch.nn.SyncBatchNorm.convert_sync_batchnorm(ref.net)
                   if device.type == "cuda" else _cpu_sync(ref.net))
        names = [n for n, _ in ref.net.named_parameters()]
        losses, grad1 = [], None
        for i in range(n_check):
            batch = scenes.dense(ring[i % len(ring)], cfg["max_instances"],
                                 res, device)
            gen = torch.Generator(device).manual_seed(
                seed * 1_000_003 + i)
            for p in ref.params:
                p.grad = None
            preds = ref.net(normalise(batch["image"]), remat=True)
            # The recompute in the backward runs the synced norms again:
            # their statistics are put back as the forward left them.
            kept = [b.clone() for b in _bn_buffers(ref.net)]
            out = rank_losses(cfg, preds, batch, gen, rank, world)
            share = sum(out.values())
            share.backward()
            with torch.no_grad():
                for b, k in zip(_bn_buffers(ref.net), kept):
                    b.copy_(k)
            del preds, batch
            for p in ref.params:
                dist.all_reduce(p.grad)
            summed = torch.stack([v.detach() for v in out.values()]
                                 + [share.detach()])
            dist.all_reduce(summed)
            losses.append(dict(zip(list(out) + ["total"],
                                   summed.tolist())))
            _adam(ref, cfg)
            if i == 0:
                grad1 = {n: (m / 0.1).float().cpu()
                         for n, m in zip(names, ref.m)}
    p3, s3 = _params(ref.net), _stats(ref.net)
    del ref
    gc.collect()
    return {"losses": losses, "grad1": grad1,
            "change": {k: p3[k] - p0[k] for k in p3},
            "stats": {k: s3[k] - p0[k] for k in s3}}


def _bn_buffers(net) -> List[torch.Tensor]:
    return [b for m in net.modules()
            if isinstance(m, (torch.nn.SyncBatchNorm, _CpuSyncBatchNorm))
            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]


class _CpuSyncBatchNorm(torch.nn.BatchNorm2d):
    """``torch.nn.SyncBatchNorm``'s statistics where it does not run (the
    CPU, over gloo): the batch's mean and biased variance over every
    rank's rows, through a differentiable all-reduce; the running
    variance updated with the unbiased one."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        n = x.numel() // c * dist.get_world_size()
        sums = all_reduce(torch.cat([x.sum((0, 2, 3)),
                                     (x * x).sum((0, 2, 3))]))
        mean = sums[:c] / n
        var = sums[c:] / n - mean * mean
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * n / (n - 1), alpha=m)
            self.num_batches_tracked.add_(1)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[
            :, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def _cpu_sync(net: torch.nn.Module) -> torch.nn.Module:
    """Every BatchNorm2d of ``net`` as a ``_CpuSyncBatchNorm`` holding its
    parameters and buffers."""
    for name, child in net.named_children():
        if type(child) is torch.nn.BatchNorm2d:
            sync = _CpuSyncBatchNorm(child.num_features, child.eps,
                                     child.momentum)
            sync.weight, sync.bias = child.weight, child.bias
            sync.running_mean, sync.running_var = (child.running_mean,
                                                   child.running_var)
            sync.num_batches_tracked = child.num_batches_tracked
            setattr(net, name, sync)
        else:
            _cpu_sync(child)
    return net


def _adam(ref: Trainer, cfg: Dict) -> None:
    """``reference/train.py``'s Adam on the summed gradients."""
    lr = learning_rate(cfg, ref.updates)
    ref.updates += 1
    t = ref.updates
    with torch.no_grad():
        for p, m, v in zip(ref.params, ref.m, ref.v):
            g = p.grad
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            mh = m / (1 - 0.9 ** t)
            vh = v / (1 - 0.999 ** t)
            p.sub_(lr * mh / (vh.sqrt() + 1e-8))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of a data-parallel "
                                            "training cell")
    for name in ("--cell", "--device", "--overrides", "--out"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--rank", "--world", "--port", "--trace"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = p.parse_args(argv)
    from benchmark.spec import Cell

    cell = Cell(end_to_end=[], per_layer=[], **json.loads(args.cell))
    rank_main(cell, args.seed, args.seconds,
              bool(args.trace), args.device, args.rank, args.world, args.port,
              json.loads(args.overrides), args.out, time.perf_counter(),
              args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
