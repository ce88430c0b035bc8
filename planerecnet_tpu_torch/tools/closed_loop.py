"""Synthetic-scene train-to-eval closed loop, through the port's CLIs.

Counterpart of ``tools/closed_loop.py``: generate a synthetic ScanNet tree
(``tools/synth_scenes.py``), train through ``python -m
planerecnet_tpu_torch.train`` (a subprocess, ``--reproductablity``, so the
kernels' deterministic variants run), evaluate every checkpoint through
``python -m planerecnet_tpu_torch.eval --metrics_json``, and print the
learning curve: mask and box AP and the depth metrics per checkpoint. It
shows that the port's GT assignment, losses and optimizer learn the task
on exact ground truth, with no ScanNet data and no released weights.

``--device`` (default ``cuda``) takes the place of the JAX tool's
``--platform`` and is passed to both CLIs. The train CLI is relaunched
with ``--resume latest`` when it exits 75 (its host-RSS guard saved and
asked for a relaunch) or is killed (-9), so a run can span several
launches. For each checkpoint the tool also logs the spread of its DCN
offsets by layer width on the first eval frames (``offset_spread``), and
writes them to ``closed_loop.json`` beside the curve.

Usage (PRN-50 on one card, from an empty workdir):
  python -m planerecnet_tpu_torch.tools.closed_loop --workdir /tmp/ws \\
      --config PlaneRecNet_50_config --size 640 --batch_size 8 \\
      --train_images 400 --val_images 0 --eval_gen_images 100 \\
      --iters 2000 --ckpt_every 500 --eval_images 100
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import torch

# The directory that holds the package: the CLIs run with the workdir as
# their cwd, so it goes on their PYTHONPATH.
PKG_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
RECYCLE_CODES = (75, -9)


def run_cli_code(module: str, cli_args: List[str], cwd: str,
                 log_path: str) -> int:
    """Runs ``python -m planerecnet_tpu_torch.<module>`` in ``cwd`` with
    its output in ``log_path``; returns its exit code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-u", "-m", f"planerecnet_tpu_torch.{module}"]
    cmd += cli_args
    print(f"$ {' '.join(cmd[1:])}\n  (log: {log_path})", flush=True)
    with open(log_path, "w") as log:
        return subprocess.call(cmd, cwd=cwd, stdout=log,
                               stderr=subprocess.STDOUT, env=env)


def _tail(log_path: str, n: int = 25) -> None:
    with open(log_path) as f:
        sys.stdout.writelines(f.readlines()[-n:])


def run_cli(module: str, cli_args: List[str], cwd: str,
            log_path: str) -> None:
    code = run_cli_code(module, cli_args, cwd, log_path)
    if code != 0:
        _tail(log_path)
        raise SystemExit(f"{module} failed with exit code {code}")


def checkpoints_by_iter(weights_dir: str, cfg_name: str) -> List[tuple]:
    """(iteration, path) of every non-interrupt checkpoint of ``cfg_name``."""
    from planerecnet_tpu_torch.utils import SavePath
    out = []
    for fname in os.listdir(weights_dir):
        if not fname.endswith(".npz") or "interrupt" in fname:
            continue
        sp = SavePath.from_str(osp.join(weights_dir, fname))
        if sp.model_name == cfg_name:
            out.append((sp.iteration, osp.join(weights_dir, fname)))
    return sorted(out)


def offset_spread(model: torch.nn.Module, step: Callable[[], object]
                  ) -> Dict[int, Dict[str, float]]:
    """Runs ``step`` once with a hook on every DCN offset conv of
    ``model``; returns, by the convs' input width, the offsets' std and
    the 50th, 95th and 99th percentiles and the max of |offset| in px, and
    the share of offsets at one pixel or more."""
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if name.endswith("offset_conv"):
            hooks.append(m.register_forward_hook(
                lambda mod, _, out: seen.setdefault(mod.in_channels, []).append(
                    out.detach().float().flatten())))
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for width, parts in sorted(seen.items()):
        o = torch.cat(parts)
        a = o.abs()
        q = torch.quantile(a, torch.tensor([0.5, 0.95, 0.99],
                                           device=a.device))
        out[width] = {"std": round(float(o.std()), 4),
                      "p50": round(float(q[0]), 4),
                      "p95": round(float(q[1]), 4),
                      "p99": round(float(q[2]), 4),
                      "max": round(float(a.max()), 4),
                      "share_ge_1px": round(float((a >= 1).float().mean()), 5)}
    return out


def checkpoint_offsets(cfg, path: str, device, frames: int = 8
                       ) -> Dict[int, Dict[str, float]]:
    """``offset_spread`` of a checkpoint on the first ``frames`` eval
    images, as the eval CLI transforms them."""
    import numpy as np
    from planerecnet_tpu_torch.data import BaseTransform, build_dataset
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    dataset = build_dataset(cfg, "eval", transform=BaseTransform(cfg))
    images = np.stack([dataset[i][0]
                       for i in range(min(frames, len(dataset)))])
    runner = PlaneRecNetRunner(cfg, device=device)
    runner.load_weights(path)
    return offset_spread(runner.model, lambda: runner.forward_raw(images))


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--config", default="PlaneRecNet_50_config")
    p.add_argument("--train_images", type=int, default=1600)
    p.add_argument("--val_images", type=int, default=200)
    p.add_argument("--eval_gen_images", type=int, default=200)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--iters", type=int, default=6000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_images", type=int, default=100,
                   help="images per checkpoint evaluation")
    p.add_argument("--dtype", default=None)
    p.add_argument("--cfg_overrides", default=None, type=str,
                   help="extra JSON config overrides for train AND eval")
    p.add_argument("--device", default="cuda",
                   help="where both CLIs run: cuda (default) or cpu")
    p.add_argument("--n_devices", default=None, type=int,
                   help="forwarded to the train CLI")
    p.add_argument("--skip_train", action="store_true",
                   help="only (re-)evaluate existing checkpoints")
    p.add_argument("--score_threshold", default=None, type=float,
                   help="eval NMS score threshold override")
    p.add_argument("--max_host_rss_gb", default=90.0, type=float,
                   help="forwarded to the train CLI's host-RSS guard: past "
                        "it the CLI saves and exits 75, and the loop "
                        "relaunches it with --resume latest (0 disables)")
    p.add_argument("--max_recycles", default=8, type=int,
                   help="most relaunches of the train CLI after exit 75 "
                        "or -9")
    args = p.parse_args(argv)

    from planerecnet_tpu_torch.config import apply_overrides, set_cfg
    from planerecnet_tpu_torch.runner import resolve_device
    device = resolve_device(args.device)
    workdir = osp.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)

    # 1. The dataset, unless the tree is there already.
    if not osp.exists(osp.join(workdir, "scannet", "scannet_train.json")):
        from planerecnet_tpu_torch.tools.synth_scenes import generate_dataset
        print("Generating synthetic planar-scene dataset...", flush=True)
        generate_dataset(workdir, args.train_images, args.val_images,
                         args.eval_gen_images, h=args.size, w=args.size,
                         min_area=int(600 * (args.size / 640) ** 2) or 60)

    overrides = {"max_iter": args.iters}
    if args.cfg_overrides:
        overrides.update(json.loads(args.cfg_overrides))
    weights = osp.join(workdir, "weights")
    os.makedirs(weights, exist_ok=True)

    # 2. Train through the CLI, relaunched on exit 75 or -9.
    if not args.skip_train:
        train_args = ["--config", args.config,
                      "--cfg_overrides", json.dumps(overrides),
                      "--save_folder", weights + "/",
                      "--batch_size", str(args.batch_size),
                      "--save_interval", str(args.ckpt_every),
                      "--validation_epoch", "0", "--no_tensorboard",
                      "--no_autoscale", "--reproductablity",
                      "--device", args.device]
        if args.dtype:
            train_args += ["--dtype", args.dtype]
        if args.n_devices is not None:
            train_args += ["--n_devices", str(args.n_devices)]
        if args.max_host_rss_gb > 0:
            train_args += ["--max_host_rss_gb", str(args.max_host_rss_gb)]
        for attempt in range(args.max_recycles + 1):
            extra = ["--resume", "latest"] if attempt else []
            log_name = "train.log" if attempt == 0 else f"train_r{attempt}.log"
            log_path = osp.join(workdir, log_name)
            code = run_cli_code("train", train_args + extra, workdir,
                                log_path)
            if code == 0:
                break
            if code in RECYCLE_CODES and attempt < args.max_recycles:
                print(f"train exited {code}; relaunching with --resume "
                      f"latest ({attempt + 1}/{args.max_recycles})",
                      flush=True)
                continue
            _tail(log_path)
            raise SystemExit(f"train failed with exit code {code}")

    # 3. Evaluate every checkpoint, and read its DCN offsets.
    cfg = set_cfg(args.config)
    if args.cfg_overrides:
        cfg = apply_overrides(cfg, json.loads(args.cfg_overrides))
    ckpts = checkpoints_by_iter(weights, cfg.name)
    if not ckpts:
        raise SystemExit(f"no checkpoints found in {weights}")
    curve, offsets = [], {}
    for it, path in ckpts:
        mpath = osp.join(workdir, f"metrics_{it}.json")
        eval_args = ["--config", args.config, "--trained_model", path,
                     "--max_images", str(args.eval_images),
                     "--metrics_json", mpath, "--no_bar", "--seed", "0",
                     "--device", args.device]
        if args.cfg_overrides:
            eval_args += ["--cfg_overrides", args.cfg_overrides]
        if args.score_threshold is not None:
            eval_args += ["--score_threshold", str(args.score_threshold)]
        run_cli("eval", eval_args, workdir,
                osp.join(workdir, f"eval_{it}.log"))
        with open(mpath) as f:
            m = json.load(f)
        curve.append({"iter": it, "mask_ap50": m["mask"]["50"],
                      "mask_ap": m["mask"]["all"],
                      "box_ap50": m["box"]["50"],
                      "abs_rel": m["depth"]["abs_rel"],
                      "rmse": m["depth"]["rmse"], "a1": m["depth"]["a1"]})
        cwd = os.getcwd()
        os.chdir(workdir)   # the configs' dataset paths are relative
        try:
            offsets[it] = checkpoint_offsets(cfg, path, device)
        finally:
            os.chdir(cwd)
        print(f"DCN offsets in px at iteration {it}, by input width: "
              f"{json.dumps(offsets[it])}", flush=True)

    # 4. The learning-curve table.
    print("\n  iter | mask AP50 | mask AP | box AP50 | abs_rel |  rmse |"
          "    a1")
    for row in curve:
        print(f"{row['iter']:6d} | {row['mask_ap50']:9.2f} | "
              f"{row['mask_ap']:7.2f} | {row['box_ap50']:8.2f} | "
              f"{row['abs_rel']:7.4f} | {row['rmse']:5.3f} | "
              f"{row['a1']:5.3f}")
    summary = {"config": args.config, "iters": args.iters, "curve": curve,
               "offset_spread": offsets}
    with open(osp.join(workdir, "closed_loop.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nSummary written to {osp.join(workdir, 'closed_loop.json')}")
    return summary


if __name__ == "__main__":
    main()
