"""A measurement on the cards behind PERF.md (its exploratory runs on the
spatial axis): where one split frame's time goes, over NCCL.

    python3 _archive/spatial/trace.py PARENT_TREE

1. The real split of one 1x640x640 frame (``tools/profile_spatial.py
   --multihost``, TF32 on) over 2 cards, from the tree at PARENT_TREE
   (``git archive`` of the commit before) and from this one, in turns:
   parent, this, this, parent.
2. This tree's forward on 1 card and split over 2 (``rank_main``):
   ``torch.profiler`` tables of 5 forwards (host and device time by op),
   and the operations that made the host wait for the card in one forward
   (``torch.cuda.set_sync_debug_mode``).
"""
import os
import subprocess
import sys
import time
import warnings

import torch

HERE = os.getcwd()


def rank_main():
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config as cfg
    from planerecnet_tpu_torch.parallel.mesh import make_mesh
    from planerecnet_tpu_torch.parallel.spmd import (initialize_distributed,
                                                     jit_forward)
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    world = initialize_distributed("cuda")
    mesh = make_mesh(world.device, n_data=1, n_spatial=world.size)
    runner = PlaneRecNetRunner(cfg, device=world.device)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 640, 640, 3).astype(np.float32)).to(world.device)
    fn = jit_forward(cfg, mesh, spatial=True)
    for _ in range(3):
        fn(runner.model, x)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn(runner.model, x)
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            fn(runner.model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    if world.rank == 0:
        print(f"== {world.size} rank(s): {len(caught)} host waits in one "
              f"forward", flush=True)
        seen = {}
        for w in caught:
            key = str(w.message)[:100]
            seen[key] = seen.get(key, 0) + 1
        for key, count in sorted(seen.items(), key=lambda kv: -kv[1])[:8]:
            print(f"   {count} x {key}", flush=True)
        table = prof.key_averages()
        busy = sum(e.self_device_time_total for e in table
                   if e.device_type.name == "CUDA") / 1e3 / 5
        print(f"   wall {wall_ms:.3f} ms a forward (profiled), device "
              f"busy {busy:.3f} ms", flush=True)
        print(table.table(sort_by="self_cpu_time_total", row_limit=18),
              flush=True)
        print(table.table(sort_by="self_device_time_total", row_limit=12),
              flush=True)
    torch.distributed.destroy_process_group()


def tool(tree, ranks):
    env = dict(os.environ, PYTHONPATH=tree)
    subprocess.run([sys.executable, "-m",
                    "planerecnet_tpu_torch.tools.run_multihost", "--nproc",
                    str(ranks), "--timeout", "300", "--module",
                    "planerecnet_tpu_torch.tools.profile_spatial "
                    "--multihost", "--", "--height", "640", "--width",
                    "640"], check=True, env=env, cwd=tree)


def main(parent):
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    "'.'); import chip_smoke as cs; cs.phase_build()"],
                   check=True, cwd=parent)
    for name, tree in (("parent", parent), ("this", HERE), ("this", HERE),
                       ("parent", parent)):
        print(f"== {name}", flush=True)
        tool(tree, 2)
    from planerecnet_tpu_torch.tools.run_multihost import launch
    for ranks in (1, 2):
        logs = launch(ranks, ["--rank"], timeout=300,
                      module="_archive.spatial.trace")
        with open(logs[0]) as f:
            print(f.read(), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        rank_main()
    else:
        main(os.path.abspath(sys.argv[1]))
