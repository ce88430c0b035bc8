"""A measurement on the card behind PERF.md (PR 12): where the
data-parallel step's extra device time goes, on one card.

    python3 _archive/multicard/syncbn_cost.py OUT_DIR

PRN-50's default step (phase 7's settings: 8x640x640, f32, cuDNN TF32 on,
seeded perturbed weights, phase 7's batch) three ways on one card, over a
one-rank NCCL group: without a mesh (as one card trains); on a one-rank
mesh with BatchNorm left local (DDP with the summed-gradient hook and the
losses' global counts, no ``SyncBatchNorm2d``); and on the one-rank mesh
as the ranks train (``SyncBatchNorm2d`` too). Each: 2 warm-up steps, the
median of 10 timed (host clock, synchronised), 3 steps traced
(``tools/parse_trace.py``; the tables go to OUT_DIR, the traces are
removed). Prints each way's ms, device busy ms a step, and the kernels
whose device time a step differs most from the first way's.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from planerecnet_tpu_torch import trainer  # noqa: E402
from planerecnet_tpu_torch.config import PlaneRecNet_50_config  # noqa: E402
from planerecnet_tpu_torch.parallel.spmd import (  # noqa: E402
    initialize_distributed)
from planerecnet_tpu_torch.tools import parse_trace  # noqa: E402
from planerecnet_tpu_torch.tools.run_multihost import _free_port  # noqa

out = sys.argv[1]
os.makedirs(out, exist_ok=True)
card = cs.phase_device()
cs.phase_build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = True
os.environ.update(PRN_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
                  PRN_NUM_PROCESSES="1", PRN_PROCESS_ID="0")
world = initialize_distributed("cuda")
cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0))
batch = cs.synthetic_batch(cs.BATCH, cs.TRAIN_SIZE, cfg.max_instances, seed=3)
sync_bn = trainer.convert_sync_batchnorm
tables = {}
for name, mesh, convert in (("no_mesh", None, sync_bn),
                            ("mesh_local_bn", world, lambda m: m),
                            ("mesh", world, sync_bn)):
    trainer.convert_sync_batchnorm = convert
    state = trainer.create_train_state(cfg, seed=0, device=world.device,
                                       mesh=mesh)
    cs.perturb_(state.model, seed=1)
    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = parse_trace.record(lambda: trainer.train_step(state, batch), 3,
                                 out, name, world.device)
    os.remove(summary["trace"])
    tables[name] = summary
    print(f"[syncbn-cost] {name}: {float(np.median(times)):.3f} ms/step "
          f"(median of 10: {[round(t, 3) for t in times]}), peak "
          f"{peak:.3f} GiB; traced: wall {summary['wall_ms']:.3f} ms, "
          f"device busy {summary['busy_ms']:.3f} ms, device sum "
          f"{summary['device_ms']:.3f} ms, idle share "
          f"{summary['idle_share']:.4f} a step; {card}", flush=True)
    del state
    torch.cuda.empty_cache()
trainer.convert_sync_batchnorm = sync_bn
base = {k["kernel"]: k for k in tables["no_mesh"]["kernels"]}
for name in ("mesh_local_bn", "mesh"):
    got = {k["kernel"]: k for k in tables[name]["kernels"]}
    rows = sorted(((got.get(n, {}).get("ms", 0.0) - base.get(n, {}).get(
        "ms", 0.0), got.get(n, {}).get("calls", 0) - base.get(n, {}).get(
        "calls", 0), n) for n in set(base) | set(got)), reverse=True)
    print(f"[syncbn-cost] {name} against no_mesh, device ms a step by "
          f"kernel (ms, calls, name), largest rises: "
          f"{json.dumps([(round(d, 3), c, n[:90]) for d, c, n in rows[:25]])}"
          f"; largest falls: "
          f"{json.dumps([(round(d, 3), c, n[:90]) for d, c, n in rows[-8:]])}",
          flush=True)
torch.distributed.destroy_process_group()
