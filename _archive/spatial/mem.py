"""A measurement on the card behind PERF.md (its exploratory runs on the
spatial axis): where a spatial rank's peak memory goes.

    python3 _archive/spatial/mem.py OUT_DIR

launches one rank, then two (over gloo, on the one card), of this
script's ``rank_main``. Each rank serves chip_smoke.py's phase 15 shapes
and takes phase 16's first training step under three settings of cuDNN:
TF32 off (phases 15-16), TF32 on (PyTorch's default), and cuDNN off
(PyTorch's own convolutions, no cuDNN workspace). It records the peak
memory allocated, and in training also the memory held after the
forward and the losses (the activations the backward needs), into
``OUT_DIR/mem{ranks}_rank{rank}.json``.
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

SETTINGS = {"tf32_off": (True, False), "tf32_on": (True, True),
            "cudnn_off": (False, False)}


def rank_main(out_dir):
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config as cfg
    from planerecnet_tpu_torch.losses import compute_losses
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.parallel.halo import Rows, gather_rows
    from planerecnet_tpu_torch.parallel.mesh import local_rows, make_mesh
    from planerecnet_tpu_torch.parallel.spmd import (initialize_distributed,
                                                     jit_forward)
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    torch.backends.cuda.matmul.allow_tf32 = False
    world = initialize_distributed("cuda")
    mesh = make_mesh(world.device, n_data=1, n_spatial=world.size)
    gib = 2 ** 30
    out = {}
    for name, (cudnn, tf32) in SETTINGS.items():
        torch.backends.cudnn.enabled = cudnn
        torch.backends.cudnn.allow_tf32 = tf32
        runner = PlaneRecNetRunner(cfg, seed=0, device=world.device)
        cs.perturb_(runner.model, seed=1)
        forward = jit_forward(cfg, mesh, spatial=True)
        for b, h, w in cs.SP_SERVE:
            x = fast_base_transform(torch.from_numpy(cs.frames(
                b, h, w, seed=20)).to(world.device))
            forward(runner.model, x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            forward(runner.model, x)
            torch.cuda.synchronize()
            out[f"{name}_serve_{b}x{h}x{w}"] = dict(
                ms=(time.perf_counter() - t0) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / gib,
                above_weights_gib=(torch.cuda.max_memory_allocated()
                                   - base) / gib)
        del runner, x
        torch.cuda.empty_cache()

        state = trainer.create_train_state(cfg, seed=0, mesh=mesh)
        cs.perturb_(state.model, seed=1)
        batch = trainer.unpack_wire_batch(cfg, local_rows(
            mesh, cs.synthetic_batch(cs.SP_BATCH, cs.TRAIN_SIZE,
                                     cfg.max_instances, seed=3)),
            world.device)
        rows = None
        if mesh.n_spatial > 1:
            rows = Rows(mesh, batch["image"].shape[1] * mesh.n_spatial,
                        batch["image"].shape[2])
            for key, dim in (("depth", 1), ("masks", 2)):
                batch[key] = gather_rows(batch[key], mesh, dim)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        preds = state.replica(batch["image"], spatial=rows)
        losses = compute_losses(cfg, preds, batch,
                                generator=state.generator(),
                                mesh=mesh.data_axis())
        total = sum(losses.values())
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        fwd_peak = torch.cuda.max_memory_allocated() - base
        (total / mesh.n_spatial).backward()
        torch.cuda.synchronize()
        out[f"{name}_train"] = dict(
            held_gib=held / gib, forward_peak_gib=fwd_peak / gib,
            peak_gib=torch.cuda.max_memory_allocated() / gib,
            state_gib=base / gib)
        del state, batch, preds, losses, total
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"mem{world.size}_rank{world.rank}"
                           ".json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def main(out_dir):
    from planerecnet_tpu_torch.tools.run_multihost import launch
    os.makedirs(out_dir, exist_ok=True)
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    for n in (1, 2):
        launch(n, ["--rank", out_dir], backend="gloo", timeout=600,
               log_dir=os.path.join(out_dir, f"logs{n}"),
               module="_archive.spatial.mem")
        for r in range(n):
            with open(os.path.join(out_dir, f"mem{n}_rank{r}.json")) as f:
                print(f"{n} rank(s), rank {r}:", f.read(), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        rank_main(sys.argv[2])
    else:
        main(sys.argv[1])
