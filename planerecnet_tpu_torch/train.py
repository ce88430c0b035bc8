"""The port's training CLI: ``python -m planerecnet_tpu_torch.train``.

Counterpart of the repository's ``train.py``: the dataset on disk
through ``SSDAugmentation``, ``BatchIterator`` and a ``PrefetchIterator``
that uploads each batch from pinned memory on a stream of its own, then
``trainer.train_step`` per batch. Checkpoints keep the
``<name>_<epoch>_<iter>`` codec, ctrl-C writes ``*_interrupt``, resume
parses the start iteration from the file name, and a batch size other
than 8 rescales lr, max_iter and lr_steps. A torchvision ImageNet ResNet
``.pth`` at ``<backbone_folder>/<backbone path>`` initialises the backbone
(``utils/torch_convert.py``); with TensorBoard, seg/depth panels of two
valid images are logged every 5000 iterations. Runs on ``cuda`` unless
``--device cpu`` is passed.

Data parallelism: ``--n_devices`` ranks, by default every visible card
(``torch.cuda.device_count()``, which honours ``CUDA_VISIBLE_DEVICES``),
as the JAX CLI trains on ``len(jax.devices())``; 1 on the CPU. With more
than one, ``main`` starts the ranks itself through
``tools/run_multihost.py``, one process and one card each over NCCL (over
gloo with ``--device cpu``), streams rank 0's output, returns rank 0's
result and fails with the first failing rank's exit code; the others'
logs go to ``<log_folder>/ranks/``. ``--multihost`` instead joins a
process group that the launcher started (``parallel.spmd.
initialize_distributed``), where ``--n_devices``, if given, must be the
number of ranks. ``--batch_size`` is the global batch; each rank loads
its rows of it (``BatchIterator`` shards) and ``trainer.train_step``
takes the global batch's step. A per-rank batch below 6 freezes
BatchNorm; from 6 BatchNorm trains on the global batch's statistics.
Rank 0 alone prints progress and writes checkpoints and TensorBoard; the
seed is rank 0's.

``--reproductablity`` seeds everything from 42 and, before the first CUDA
call, pins the run to deterministic algorithms (``reproducible_mode``):
two runs on the same tree give the same checkpoints, bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.config import (apply_overrides, set_cfg,
                                          set_dataset)
from planerecnet_tpu_torch.data import (BaseTransform, BatchIterator,
                                        PrefetchIterator, SSDAugmentation,
                                        build_dataset)
from planerecnet_tpu_torch.ops import cuda_build, launch_counts
from planerecnet_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from planerecnet_tpu_torch.parallel.spmd import initialize_distributed
from planerecnet_tpu_torch.runner import PlaneRecNetRunner, resolve_device
from planerecnet_tpu_torch.utils import MovingAverage, SavePath, torch_convert
from planerecnet_tpu_torch.utils.checkpoint import (load_train_state,
                                                    save_train_state)

LOSS_TYPES = ["ins", "lav", "cat", "dpt", "pln"]
# Losses stay on the device and are read back together every LOG_EVERY
# steps: a read per step would wait for the device each step.
LOG_EVERY = 50
# Exit code asking a supervisor to relaunch with --resume latest: the
# host-RSS guard saved the state and exited because host memory crossed
# --max_host_rss_gb.
RECYCLE_EXIT_CODE = 75
# Where rank 0 of ranks that ``main`` started writes its result (JSON).
RESULT_FILE_VAR = "PRN_RESULT_FILE"


def host_rss_gb() -> float:
    """Current resident-set size of this process in GiB (Linux)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return 0.0


@contextlib.contextmanager
def reproducible_mode(enabled: bool):
    """``--reproductablity``'s switches, the reference's cuDNN pin and
    more: cuBLAS's fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, without
    which its matmuls raise in this mode), cuDNN deterministic without
    benchmarking, and ``torch.use_deterministic_algorithms(True)``, so
    that an op with no deterministic version raises rather than varies.
    The port's own kernels are not seen by that switch: the train state
    selects their fixed-order variants (``deterministic=True``). Each
    switch is put back on exit, for callers in the same process."""
    if not enabled:
        yield
        return
    cudnn = torch.backends.cudnn
    saved = (os.environ.get("CUBLAS_WORKSPACE_CONFIG"), cudnn.deterministic,
             cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        env, cudnn.deterministic, cudnn.benchmark, mode, warn_only = saved
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def compute_validation_metrics(cfg, state, eval_nums, no_bar=True):
    """mAP and depth metrics of the current weights on the valid split,
    through the eval CLI's ``evaluate``; None where the split is
    missing."""
    from planerecnet_tpu_torch.eval import evaluate

    try:
        dataset = build_dataset(cfg, "valid", transform=BaseTransform(cfg))
    except (FileNotFoundError, AssertionError) as e:
        print(f"Validation skipped: {e}")
        return None
    state.model.eval()
    try:
        return evaluate(PlaneRecNetRunner.around(cfg, state.model), dataset,
                        during_training=True, eval_nums=eval_nums,
                        no_bar=no_bar)
    finally:
        state.model.train()


def log_visual_example(cfg, state, writer, iteration, num_images=2):
    """Predicted seg/depth panels of the first valid images to
    TensorBoard (the JAX CLI's, every 5000 iterations)."""
    from planerecnet_tpu_torch.simple_inference import (_valid_result,
                                                        display_on_frame)
    try:
        dataset = build_dataset(cfg, "valid", transform=BaseTransform(cfg))
    except (FileNotFoundError, AssertionError):
        return
    state.model.eval()
    try:
        net = PlaneRecNetRunner.around(cfg, state.model)
        for i in range(min(num_images, len(dataset))):
            image, _, _ = dataset[i]
            batched = net.infer_normalized(image[None], image.shape[:2])
            result = _valid_result(batched, 0)
            vis = ((image - image.min()) / max(float(np.ptp(image)), 1e-6)
                   * 255)
            seg, depth = display_on_frame(result, vis.astype("float32"), cfg,
                                          mask_alpha=0.35)
            depth = (depth - depth.min()) / max(float(np.ptp(depth)), 1e-6)
            writer.add_image(f"seg/pred/{i}", seg[:, :, ::-1], iteration,
                             dataformats="HWC")
            writer.add_image(f"depth/pred/{i}", (depth * 255).astype("uint8"),
                             iteration, dataformats="HW")
    finally:
        state.model.train()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="PlaneRecNet Training Script")
    parser.add_argument("--dataset", default=None, type=str)
    parser.add_argument("--config", default="PlaneRecNet_50_config")
    parser.add_argument("--save_folder", default="./weights/")
    parser.add_argument("--log_folder", default="./logs/")
    parser.add_argument("--backbone_folder", default="./weights/")
    parser.add_argument("--resume", default=None, type=str,
                        help='"interrupt" | "latest" | checkpoint path')
    parser.add_argument("--start_iter", default=-1, type=int)
    parser.add_argument("--validation_size", default=2000, type=int)
    parser.add_argument("--validation_epoch", default=1, type=int)
    parser.add_argument("--no_tensorboard", action="store_true")
    parser.add_argument("--no_autoscale", dest="autoscale",
                        action="store_false")
    parser.add_argument("--reproductablity", action="store_true",
                        help="Seed 42 for the weights, the data order and "
                             "augmentation, and numpy's, python's and "
                             "torch's global generators; run deterministic "
                             "algorithms only (reproducible_mode).")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--lr", "--learning_rate", default=None, type=float)
    parser.add_argument("--momentum", default=None, type=float,
                        help="No-op, parsed for the JAX CLI's surface: Adam "
                             "does not read it.")
    parser.add_argument("--decay", "--weight_decay", default=None, type=float,
                        help="No-op, parsed for the JAX CLI's surface: Adam "
                             "runs without weight decay.")
    parser.add_argument("--gamma", default=None, type=float)
    parser.add_argument("--num_workers", default=2, type=int,
                        help="Batches the loader keeps ready.")
    parser.add_argument("--save_interval", default=12500, type=int)
    parser.add_argument("--keep_latest", action="store_true")
    parser.add_argument("--keep_latest_interval", default=10000, type=int)
    parser.add_argument("--no_interrupt", dest="interrupt",
                        action="store_false")
    parser.add_argument("--per_module_lr", action="store_true",
                        help="5x learning rate for the backbone, 2x for the "
                             "depth decoder.")
    parser.add_argument("--n_devices", default=None, type=int,
                        help="Data-parallel ranks, one card each (default: "
                             "all visible cards on cuda, 1 on the CPU); "
                             "more than one starts them here through "
                             "tools/run_multihost.py. With --multihost: "
                             "must equal the number of ranks launched "
                             "(default: the process group's).")
    parser.add_argument("--dtype", default=None,
                        choices=[None, "float32", "bfloat16"],
                        help="Training compute dtype (default: the config's, "
                             "'auto' = float32).")
    parser.add_argument("--multihost", action="store_true",
                        help="Join the data-parallel process group: rank, "
                             "world size and rank 0's address from "
                             "PRN_PROCESS_ID / PRN_NUM_PROCESSES / "
                             "PRN_COORDINATOR_ADDRESS, the backend from "
                             "PRN_BACKEND (default NCCL on cuda, gloo on "
                             "the CPU), PRN_PLATFORM=cpu for the CPU; "
                             "tools/run_multihost.py sets them. Each rank "
                             "loads only its rows of every global batch.")
    parser.add_argument("--max_host_rss_gb", default=0.0, type=float,
                        help="When >0 and the process RSS crosses this many "
                             "GiB, save the state and exit with code 75 so "
                             "that a supervisor relaunches with --resume "
                             "latest (0 disables).")
    parser.add_argument("--cfg_overrides", default=None, type=str,
                        help="JSON dict of (possibly nested) config "
                             "overrides applied after --config/--dataset, "
                             'e.g. \'{"max_iter": 100, "solov2": '
                             '{"top_k": 20}}\'.')
    parser.add_argument("--device", default="cuda",
                        help="Where the step runs: cuda (default; raises "
                             "where there is no card) or cpu.")
    parser.set_defaults(autoscale=True, interrupt=True)
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the CLI. Returns ``start_iter`` and the final ``iteration``,
    the loader's mean occupancy, the last checkpoint written
    (``checkpoint``) and the losses of the last drained step: rank 0's
    where there are several ranks."""
    args = parse_args(argv)
    if not args.multihost:
        n = ranks_to_start(args.device, args.n_devices)
        if n > 1:
            return _start_ranks(sys.argv[1:] if argv is None else argv,
                                args, n)
    with reproducible_mode(args.reproductablity):
        if not args.multihost:
            return _train(args, make_mesh(resolve_device(args.device)))
        mesh = initialize_distributed(args.device)
        try:
            make_mesh(mesh.device, args.n_devices)   # checks --n_devices
            result = _train(args, mesh)
        finally:
            torch.distributed.destroy_process_group()
    if mesh.rank == 0 and os.environ.get(RESULT_FILE_VAR):
        with open(os.environ[RESULT_FILE_VAR], "w") as f:
            json.dump(result, f)
    return result


def ranks_to_start(device, n_devices: Optional[int]) -> int:
    """The ranks that ``--n_devices`` asks for without ``--multihost``,
    one card each: by default every visible card on ``cuda``
    (``torch.cuda.device_count()``, which honours ``CUDA_VISIBLE_DEVICES``),
    the JAX CLI's ``len(jax.devices())``, and 1 on the CPU. Raises where
    more cards are asked for than are visible; with none visible, one
    rank is asked for, which raises where it starts."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"--n_devices {n_devices}: at least 1")
    if torch.device(device).type != "cuda":
        return n_devices or 1
    visible = torch.cuda.device_count()
    if n_devices is None:
        return max(visible, 1)
    if n_devices > max(visible, 1):
        raise ValueError(
            f"--n_devices {n_devices} asks for {n_devices} cards, but "
            f"{visible} {'is' if visible == 1 else 'are'} visible "
            f"(torch.cuda.device_count(), CUDA_VISIBLE_DEVICES); ranks on "
            f"several hosts join with --multihost, started by "
            f"planerecnet_tpu_torch.tools.run_multihost")
    return n_devices


def _start_ranks(argv, args, n: int) -> Dict:
    """Run ``argv`` as ``n`` ranks with ``--multihost`` through the
    launcher, on this host's cards (over NCCL; on the CPU over gloo),
    the kernels built once before they start. Rank 0 writes to this
    process's output, the others to ``<log_folder>/ranks/``. Returns rank
    0's result; a failing rank raises ``SystemExit`` with its exit code
    once the others are stopped."""
    from planerecnet_tpu_torch.tools.run_multihost import launch
    platform = torch.device(args.device).type
    if platform == "cuda":
        cuda_build.build()
    with tempfile.TemporaryDirectory(prefix="prn_ranks_") as tmp:
        result = os.path.join(tmp, "rank0.json")
        try:
            launch(n, list(argv) + ["--n_devices", str(n)],
                   platform=platform,
                   log_dir=os.path.join(args.log_folder, "ranks"),
                   extra_env={RESULT_FILE_VAR: result}, stream_rank0=True)
        except subprocess.CalledProcessError as e:
            raise SystemExit(e.returncode) from None
        with open(result) as f:
            return json.load(f)


def _train(args, mesh: Mesh) -> Dict:
    device = mesh.device
    is_main = mesh.rank == 0

    cfg = set_cfg(args.config)
    if args.dataset is not None:
        cfg = set_dataset(cfg, args.dataset)
    if args.cfg_overrides:
        cfg = apply_overrides(cfg, json.loads(args.cfg_overrides))
    if args.dtype:
        cfg = cfg.copy(dict(compute_dtype=args.dtype))

    # Batch-size autoscaling, as the JAX CLI does.
    if args.autoscale and args.batch_size != 8:
        factor = args.batch_size / 8
        print("Scaling parameters by %.2f to account for a batch size of %d."
              % (factor, args.batch_size))
        cfg = cfg.copy(dict(
            lr=cfg.lr * factor,
            max_iter=int(cfg.max_iter // factor),
            lr_steps=tuple(int(x // factor) for x in cfg.lr_steps),
        ))
    if args.lr is not None:
        cfg = cfg.copy(dict(lr=args.lr))
    if args.gamma is not None:
        cfg = cfg.copy(dict(gamma=args.gamma))
    if shard_batch(mesh, args.batch_size) < 6:
        print("Per-device batch size is less than the recommended limit for "
              "batch norm. Disabling batch norm.")
        cfg = cfg.copy(dict(freeze_bn=True))

    os.makedirs(args.save_folder, exist_ok=True)
    seed = 42 if args.reproductablity else int(time.time()) % (2 ** 31)
    if mesh.size > 1 and not args.reproductablity:
        # Every rank needs rank 0's seed: it sets the shared batch order,
        # the augmentation and the initial weights.
        seed_t = torch.tensor([seed], dtype=torch.int64, device=device)
        torch.distributed.broadcast(seed_t, src=0)
        seed = int(seed_t)
    if args.reproductablity:
        np.random.seed(seed)
        random.seed(seed)
        torch.manual_seed(seed)

    dataset = build_dataset(cfg, "train", transform=SSDAugmentation(
        cfg, rng=np.random.RandomState(seed)))
    loader = PrefetchIterator(
        BatchIterator(cfg, dataset, args.batch_size, seed=seed,
                      shard_index=mesh.rank, num_shards=mesh.size),
        buffer_size=max(args.num_workers, 1), to_device=True, device=device)
    state = trainer.create_train_state(cfg, seed=seed, device=device,
                                       per_module_lr=args.per_module_lr,
                                       deterministic=args.reproductablity,
                                       # one rank of --multihost too
                                       mesh=mesh if args.multihost else None)

    start_iter = max(args.start_iter, 0)
    if args.resume is not None:
        path = args.resume
        if path == "interrupt":
            path = SavePath.get_interrupt(args.save_folder)
        elif path == "latest":
            path = SavePath.get_latest(args.save_folder, cfg.name)
        print(f"Resuming training from {path}...")
        load_train_state(path, state)
        if args.start_iter == -1:
            start_iter = SavePath.from_str(path).iteration
    else:
        backbone_path = os.path.join(args.backbone_folder, cfg.backbone.path)
        print("Initializing weights...")
        if os.path.exists(backbone_path):
            print(f"Loading the ImageNet backbone {backbone_path}")
            state.model.load_state_dict(
                torch_convert.convert_backbone_imagenet(
                    torch_convert.load_pth(backbone_path), state.model))

    writer = None
    if not args.no_tensorboard and is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter
            begin = datetime.datetime.now().strftime("%d%m%Y%H%M%S")
            logpath = os.path.join(args.log_folder, begin + "_" + cfg.name)
            os.makedirs(logpath, exist_ok=True)
            writer = SummaryWriter(logpath)
        except ImportError:
            print("TensorBoard unavailable; console logging only.")

    iteration = start_iter
    epoch_size = max(len(dataset) // args.batch_size, 1)
    num_epochs = math.ceil(cfg.max_iter / epoch_size)
    loss_avgs = {k: MovingAverage(100) for k in LOSS_TYPES + ["total"]}
    time_avg = MovingAverage()
    pending_losses = []
    block_start = time.time()
    last_losses: Optional[Dict[str, float]] = None

    def drain_losses():
        """Read the buffered device losses back in one copy; returns the
        last step's."""
        nonlocal block_start
        if not pending_losses:
            return None
        keys = list(pending_losses[0])
        values = torch.stack([d[k].float() for d in pending_losses
                              for k in keys]).cpu().reshape(
                                  len(pending_losses), len(keys)).tolist()
        now = time.time()
        per_step = (now - block_start) / len(pending_losses)
        block_start = now
        pending_losses.clear()
        for row in values:
            time_avg.add(per_step)
            for k, v in zip(keys, row):
                if k in loss_avgs:
                    loss_avgs[k].add(v)
        return dict(zip(keys, values[-1]))

    def save_path(epoch, it):
        return SavePath(cfg.name, epoch, it).get_path(root=args.save_folder)

    latest_saved = None
    delayed = [(it, ov) for it, ov in cfg.delayed_settings]

    # SIGINT sets a flag checked each iteration, and the KeyboardInterrupt
    # handler below writes the interrupt checkpoint.
    stop_requested = {"flag": False}

    def _on_sigint(signum, frame):
        stop_requested["flag"] = True
    prev_handler = signal.signal(signal.SIGINT, _on_sigint)

    if is_main:
        print("Begin training!\n")
    debug_batch_sum = os.environ.get("PRN_DEBUG_BATCH_SUM") == "1"
    epoch = 0  # a pre-loop ctrl-C must still reach the interrupt handler
    try:
        for epoch in range(num_epochs):
            if (epoch + 1) * epoch_size < iteration:
                continue
            for batch in loader:
                if stop_requested["flag"]:
                    raise KeyboardInterrupt
                if iteration == (epoch + 1) * epoch_size:
                    break
                if iteration == cfg.max_iter:
                    break

                # Delayed config settings from their iteration on.
                pending = [c for c in delayed if iteration >= c[0]]
                if pending:
                    drain_losses()
                    for _, overrides in pending:
                        cfg = cfg.copy(dict(overrides))
                    delayed = [c for c in delayed if iteration < c[0]]
                    state.cfg = cfg
                    for avg in loss_avgs.values():
                        avg.reset()

                if debug_batch_sum:
                    # Each rank's share of the batch (disjoint shards),
                    # the wall clock and the kernels' launches so far.
                    image = torch.as_tensor(batch["image"])
                    print(f"[p{mesh.rank}] iter {iteration} t "
                          f"{time.time():.6f} launches "
                          f"{json.dumps(launch_counts())} batch_sum "
                          f"{float(image.double().sum()):.2f}", flush=True)
                pending_losses.append(trainer.train_step(state, batch))
                iteration += 1

                drained = None
                if iteration % LOG_EVERY == 0 or \
                        iteration == cfg.max_iter or \
                        iteration % args.save_interval == 0:
                    drained = last_losses = drain_losses()

                if writer is not None and drained is not None:
                    for k, v in drained.items():
                        writer.add_scalar(f"loss/{k}", v, iteration)

                if iteration % 100 == 0 and is_main:
                    eta = (cfg.max_iter - iteration) * time_avg.get_avg()
                    eta_str = str(int(eta // 3600)) + "h" + str(
                        int(eta % 3600 // 60)) + "m"
                    parts = " | ".join(
                        f"{k}: {loss_avgs[k].get_avg():.3f}"
                        for k in LOSS_TYPES if len(loss_avgs[k]))
                    print(f"[{epoch:3d}] {iteration:7d} || {parts} || "
                          f"T: {loss_avgs['total'].get_avg():.3f} || "
                          f"ETA: {eta_str} || "
                          f"{time_avg.get_avg() * 1000:.0f} ms/it "
                          f"q: {loader.mean_occupancy():.2f}", flush=True)
                if writer is not None and iteration % 5000 == 0:
                    log_visual_example(cfg, state, writer, iteration)

                if iteration % args.save_interval == 0 and iteration > 0 \
                        and is_main:
                    if args.keep_latest and latest_saved is not None:
                        if args.keep_latest_interval <= 0 or \
                                iteration % args.keep_latest_interval \
                                != args.save_interval:
                            try:
                                os.remove(latest_saved)
                            except OSError:
                                pass
                    print(f"Saving state, iter: {iteration}")
                    latest_saved = save_train_state(
                        save_path(epoch, iteration), state)

                # Host-RSS guard (see RECYCLE_EXIT_CODE). With several
                # ranks they decide together, on the largest RSS, every
                # LOG_EVERY iterations: one rank leaving alone would
                # strand the others in the next collective.
                if args.max_host_rss_gb > 0:
                    rss = 0.0
                    if mesh.size == 1:
                        rss = host_rss_gb()
                    elif iteration % LOG_EVERY == 0:
                        rss = mesh.all_max(host_rss_gb())
                    if rss > args.max_host_rss_gb:
                        drain_losses()
                        signal.signal(signal.SIGINT, prev_handler)
                        if is_main:
                            print(f"Host RSS {rss:.1f} GiB > cap "
                                  f"{args.max_host_rss_gb:.1f} GiB: saving "
                                  f"state, iter: {iteration}; exiting "
                                  f"{RECYCLE_EXIT_CODE} for recycle",
                                  flush=True)
                            save_train_state(save_path(epoch, iteration),
                                             state)
                        raise SystemExit(RECYCLE_EXIT_CODE)

            last_losses = drain_losses() or last_losses
            trunc = loader.iterable.truncation_stats
            if any(trunc.values()) and is_main:   # rank 0's shard's
                parts = ", ".join(f"{k}: {v}" for k, v in trunc.items() if v)
                print(f"WARNING: GT truncated this epoch ({parts}) — "
                      f"raise cfg.max_instances / cfg.vnl_max_planes if "
                      f"this is significant for your dataset.", flush=True)
                if writer is not None:
                    for k, v in trunc.items():
                        writer.add_scalar(f"gt_truncation/{k}", v, iteration)
            trunc.clear()
            if iteration == cfg.max_iter:
                break

            if args.validation_epoch > 0 and is_main and \
                    (epoch + 1) % args.validation_epoch == 0:
                compute_validation_metrics(cfg, state, args.validation_size)
    except KeyboardInterrupt:
        signal.signal(signal.SIGINT, prev_handler)
        result = {"start_iter": start_iter, "iteration": iteration,
                  "mean_occupancy": loader.mean_occupancy(),
                  "checkpoint": None, "losses": last_losses}
        if args.interrupt and is_main:
            print("Stopping early. Saving network...")
            SavePath.remove_interrupt(args.save_folder)
            result["checkpoint"] = save_train_state(
                save_path(epoch, repr(iteration) + "_interrupt"), state)
        return result

    signal.signal(signal.SIGINT, prev_handler)
    final = None
    if is_main:
        final = save_train_state(save_path(epoch, iteration), state)
        print("Training complete.")
    return {"start_iter": start_iter, "iteration": iteration,
            "mean_occupancy": loader.mean_occupancy(), "checkpoint": final,
            "losses": last_losses}


if __name__ == "__main__":
    main()
