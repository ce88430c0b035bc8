"""Latency study of the spatial split of a serving forward.

Counterpart of the root ``tools/profile_spatial.py``. The ``spatial`` mesh
axis (``parallel/halo.py``) shards the image height, so that one frame's
activations span cards: the latency lever for a single large frame.

On one card the split cannot run across cards, so the tool gives the JAX
tool's honest estimate:

1. Measured: the forward at full height (the one-card baseline), and at
   the shard's height plus ``--halo_rows`` (rounded up to a multiple of
   32, as the network needs): the work of one shard, bracketed from above
   (it pays the halo rows at every depth).
2. Counted: ``--shards`` ranks of this tool (``--multihost``) run the
   real split on the same device over gloo, and each counts what one
   forward's exchanges hand it (``parallel/halo.py::traffic``: the halo
   rows of every window, the whole input of every DCN layer, the maps
   that do not split and the outputs gathered, the GroupNorms' sums).
   The bytes of the rank that takes the most, over the one-way NVLink
   rate of an H100 (450 GB/s: 900 GB/s to the other cards of the host,
   both ways, NVIDIA's H100 SXM data sheet), are the exchange term.

Estimated split latency = shard forward (measured) + exchange bytes over
NVLink. The latency of each exchange is left out: over NVLink it has not
been measured apart from the bytes. The number of exchanges a forward
makes is printed beside the estimate, and so is the split's time on the
ranks sharing the one card, which is no latency figure.

Launched as ranks (``--multihost``, through ``tools/run_multihost.py``
with ``--module``), it times the real split: ``jit_forward(spatial=True)``
on a (1, ranks) mesh, and rank 0 prints one JSON line with the exchanges'
count. With one card a rank that time is the split's latency.

Usage:
  python -m planerecnet_tpu_torch.tools.profile_spatial \\
      [--config PlaneRecNet_50_config] [--height 480 --width 640] \\
      [--shards 2] [--batch 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

NVLINK_ONE_WAY_GBPS = 450.0
ITERS, WARMUP = 20, 3
SPLIT_TIMEOUT = 600       # seconds the ranks of the counted split may take
MODULE = "planerecnet_tpu_torch.tools.profile_spatial --multihost"


def _time(fn, device):
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS


def split_run(config: str, h: int, w: int, n: int, batch: int = 1,
              device: str = "cuda") -> dict:
    """Launch ``n`` ranks of this tool (``--multihost``) on ``device``
    over gloo, and return rank 0's JSON line: the split's ms a forward,
    the bytes one forward's exchanges handed the rank that took the most
    (``received_bytes``) and the exchanges of that forward
    (``exchanges``)."""
    from planerecnet_tpu_torch.tools.run_multihost import launch
    logs = launch(n, ["--config", config, "--height", str(h), "--width",
                      str(w), "--batch", str(batch), "--device", device],
                  platform=torch.device(device).type, backend="gloo",
                  timeout=SPLIT_TIMEOUT, module=MODULE)
    with open(logs[0]) as f:
        lines = [line for line in f if line.startswith("{")]
    return json.loads(lines[-1])


def _multihost(cfg, args, frames):
    """One rank of the real split: counts one forward's exchanges, then
    times the forward; rank 0 prints the result. Returns the seconds."""
    from planerecnet_tpu_torch.parallel import halo
    from planerecnet_tpu_torch.parallel.mesh import make_mesh
    from planerecnet_tpu_torch.parallel.spmd import (initialize_distributed,
                                                     jit_forward)
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    world = initialize_distributed(args.device)
    try:
        mesh = make_mesh(world.device, n_data=1, n_spatial=world.size)
        runner = PlaneRecNetRunner(cfg, device=world.device)
        x = frames(args.height).to(world.device)
        fn = jit_forward(cfg, mesh, spatial=True)
        halo.reset_traffic()
        fn(runner.model, x)
        counted = torch.tensor(halo.traffic(), dtype=torch.float64,
                               device=world.device)
        torch.distributed.all_reduce(counted,
                                     op=torch.distributed.ReduceOp.MAX)
        t = _time(lambda: fn(runner.model, x), world.device)
    finally:
        torch.distributed.destroy_process_group()
    if world.rank == 0:
        print(json.dumps({
            "metric": f"spatial-{world.size} forward, {world.size} ranks "
                      f"({cfg.name}, {args.batch}x{args.height}x"
                      f"{args.width})",
            "value": round(t * 1e3, 3), "unit": "ms",
            "received_bytes": int(counted[0]),
            "exchanges": int(counted[1]),
            "device": _device_name(world.device),
            "cards": (torch.cuda.device_count()
                      if world.device.type == "cuda" else 0)}), flush=True)
    return t


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="PlaneRecNet_50_config")
    p.add_argument("--height", default=480, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--shards", default=2, type=int)
    p.add_argument("--batch", default=1, type=int)
    p.add_argument("--halo_rows", default=32, type=int,
                   help="rows added to the shard's forward")
    p.add_argument("--nvlink_gbps", default=NVLINK_ONE_WAY_GBPS, type=float)
    p.add_argument("--device", default="cuda")
    p.add_argument("--multihost", action="store_true",
                   help="time the real split over the launched ranks")
    args = p.parse_args(argv)

    from planerecnet_tpu_torch.config import set_cfg
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner, resolve_device
    cfg = set_cfg(args.config)
    h, w, n = args.height, args.width, args.shards
    rng = np.random.RandomState(0)

    def frames(rows):
        return torch.from_numpy(rng.randn(args.batch, rows, w, 3).astype(
            np.float32))

    if args.multihost:
        return _multihost(cfg, args, frames)

    device = resolve_device(args.device)
    runner = PlaneRecNetRunner(cfg, device=device)

    def forward_at(rows):
        rows = (rows + 31) // 32 * 32
        x = frames(rows).to(device)
        with torch.no_grad():
            return _time(lambda: runner.model(x), device)

    t_full = forward_at(h)
    t_shard = forward_at(h // n + args.halo_rows)
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    split = split_run(args.config, h, w, n, args.batch, args.device)
    nbytes = split["received_bytes"]
    t_exchange = nbytes / (args.nvlink_gbps * 1e9)
    est = t_shard + t_exchange
    for name, t in (("full forward (one card)", t_full),
                    (f"shard forward H/{n} + {args.halo_rows} rows", t_shard),
                    (f"exchange bytes over NVLink ({nbytes / 1e6:.2f} MB)",
                     t_exchange),
                    (f"=> estimated spatial-{n} forward", est)):
        print(f"{name:46s} {t * 1e3:9.3f} ms")
    print(f"{split['exchanges']} exchanges a forward (their latency is "
          f"not in the estimate); the real split on {n} ranks sharing "
          f"this device: {split['value']:.3f} ms, no latency figure")
    print(json.dumps({
        "metric": f"spatial-{n} estimated forward latency ({cfg.name}, "
                  f"{args.batch}x{h}x{w})",
        "value": round(est * 1e3, 3), "unit": "ms",
        "one_card_ms": round(t_full * 1e3, 3),
        "shard_ms": round(t_shard * 1e3, 3),
        "exchange_bytes": nbytes, "exchanges": split["exchanges"],
        "speedup": round(t_full / est, 3),
        "shared_device_split_ms": split["value"],
        "device": _device_name(device)}))
    return est


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    main()
