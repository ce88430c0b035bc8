"""Per-call host overhead of eager PyTorch on a parameter-like list.

    python -m planerecnet_tpu_torch.tools.bench_dispatch [--leaves 477]
        [--total_m 57] [--iters 30] [--device cuda]

Counterpart of ``tools/bench_dispatch.py``, which asked how much of a
jitted call's time went to handling ~500 argument buffers. Here the
same ~57M f32 values as ``--leaves`` tensors are updated (``x += i *
1e-6``) three ways: leaf by leaf (one launch a leaf, as an optimizer
without ``foreach`` steps), with one ``torch._foreach_add_`` over the
list, and as one flat buffer; and one update of a one-element tensor, the
floor of a call. For each: ``host_ms``, the host clock per update before
waiting for the device (what the host spends issuing it), and ``wall_ms``,
per update once the device is waited for. On the CPU the two are the
same work.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--leaves", default=477, type=int)
    p.add_argument("--total_m", default=57.0, type=float,
                   help="values in all, in millions")
    p.add_argument("--iters", default=30, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where there is no card) or "
                        "cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    from planerecnet_tpu_torch.runner import resolve_device
    from planerecnet_tpu_torch.utils.timer import sync

    device = resolve_device(args.device)
    n = args.leaves
    per = int(args.total_m * 1e6 / n)
    leaves = [torch.full((per,), float(i), device=device) for i in range(n)]
    flat = torch.cat(leaves)
    scalar = torch.zeros(1, device=device)

    def per_leaf(s):
        for t in leaves:
            t.add_(s)

    def foreach(s):
        torch._foreach_add_(leaves, s)

    cases = {"scalar": lambda s: scalar.add_(s),
             "flat": lambda s: flat.add_(s),
             f"{n}_leaves_one_by_one": per_leaf,
             f"{n}_leaves_foreach": foreach}
    out = {"leaves": n, "values": per * n,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for name, fn in cases.items():
        fn(0.0)
        sync(device)
        t0 = time.perf_counter()
        for i in range(args.iters):
            fn((i + 1) * 1e-6)
        t1 = time.perf_counter()
        sync(device)
        t2 = time.perf_counter()
        out[name] = {"host_ms": (t1 - t0) * 1e3 / args.iters,
                     "wall_ms": (t2 - t0) * 1e3 / args.iters}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
