"""One-command +-1% reproduction check against the released weights.

    python -m planerecnet_tpu_torch.tools.verify_released \
        --pth weights/PlaneRecNet_50_9_125000.pth \
        --images /data/scannet/ --annotations /data/scannet_eval.json \
        [--device cuda]

Counterpart of ``tools/verify_released.py``. Converted released
PlaneRecNet_50/101 checkpoints must land within +-1% (relative) of the
published mask mAP and depth RMSE on ScanNet; every other metric of the
published table is reported for information. The tool (1) parses the
config from the checkpoint's name (``utils.SavePath``:
``<model>_<epoch>_<iter>.pth``) unless ``--config`` is given, (2) runs the
port's eval CLI (``python -m planerecnet_tpu_torch.eval``, which converts
the ``.pth`` as it loads it) as a subprocess on ``--device`` (``cuda`` by
default, where it raises without a card), and (3) prints each metric
against the table, and PASS or FAIL for the two that carry the budget.
``--expected`` names another table (same layout as the eval CLI's
``--metrics_json``). The released weights and ScanNet are not in the
repository, so the comparison with the published table waits for them;
the procedure itself is tested on a synthetic checkpoint and tree.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

# The published ScanNet numbers (the upstream paper's Table 2, "Ours
# ADAM", the row its released weights reproduce). Depth errors in metres,
# AP in percent.
PUBLISHED = {
    "mask": {"all": 16.71, "50": 31.91, "75": 15.56},
    "box": {"all": 21.05, "50": 36.45, "75": 20.29},
    "depth": {"abs_rel": 0.075, "log10": 0.031, "rmse": 0.178,
              "a1": 0.951, "a2": 0.992, "a3": 0.998},
}
# The metrics that carry the budget; the others are for information.
BUDGETED = [("mask", "all"), ("depth", "rmse")]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pth", required=True,
                   help="released checkpoint (.pth; .npz also taken); the "
                        "config is parsed from its name unless --config")
    p.add_argument("--config", default=None)
    p.add_argument("--images", required=True,
                   help="eval image root (ScanNet layout)")
    p.add_argument("--annotations", required=True,
                   help="COCO-format eval annotation json")
    p.add_argument("--max_images", default=-1, type=int,
                   help="evaluate a subset (default: all; the published "
                        "numbers are the whole split's)")
    p.add_argument("--budget_pct", default=1.0, type=float,
                   help="relative budget in percent of the budgeted "
                        "metrics")
    p.add_argument("--expected", default=None,
                   help="JSON table to compare with (default: the "
                        "published one)")
    p.add_argument("--metrics_json", default=None,
                   help="where the measured metrics go (default: beside "
                        "the checkpoint)")
    p.add_argument("--eval_args", default="",
                   help="extra arguments for the eval CLI, as one string")
    p.add_argument("--cfg_overrides", default=None,
                   help="JSON config overrides, merged with the dataset "
                        "paths and passed to the eval CLI")
    p.add_argument("--device", default="cuda",
                   help="the eval CLI's device: cuda (default; raises "
                        "where there is no card) or cpu")
    return p.parse_args(argv)


def run_eval(args) -> dict:
    """Run the port's eval CLI on the checkpoint; returns its metrics."""
    from planerecnet_tpu_torch.utils import SavePath

    out_json = args.metrics_json or (
        osp.splitext(args.pth)[0] + "_verify_metrics.json")
    config = args.config or (SavePath.from_str(args.pth).model_name
                             + "_config")
    overrides = dict(json.loads(args.cfg_overrides)
                     if args.cfg_overrides else {})
    overrides["dataset"] = dict(
        overrides.get("dataset", {}),
        eval_images=args.images if args.images.endswith("/")
        else args.images + "/", eval_info=args.annotations)
    cmd = [sys.executable, "-m", "planerecnet_tpu_torch.eval",
           "--trained_model", args.pth, "--config", config,
           "--max_images", str(args.max_images),
           "--metrics_json", out_json, "--no_bar", "--device", args.device,
           "--cfg_overrides", json.dumps(overrides)]
    cmd += [a for a in args.eval_args.split() if a]
    print("$", " ".join(cmd[1:]), flush=True)
    code = subprocess.call(cmd)
    if code != 0:
        raise SystemExit(f"the eval CLI failed with exit code {code}")
    with open(out_json) as f:
        return json.load(f)


def compare(measured: dict, expected: dict, budget_pct: float) -> bool:
    """Print the table of deltas; returns whether every budgeted metric
    lies within ``budget_pct`` percent of its expected value (and no
    expected metric is missing)."""
    ok = True
    budgeted = {(g, str(n)) for g, n in BUDGETED}
    print(f"\n{'metric':<16} {'published':>10} {'measured':>10} "
          f"{'delta%':>8}  verdict")
    print("-" * 56)
    for group, metrics in expected.items():
        for name, want in metrics.items():
            got = measured.get(group, {}).get(str(name))
            if got is None:
                got = measured.get(group, {}).get(name)
            if got is None:
                print(f"{group}/{name:<11} {want:>10} {'-':>10} "
                      f"{'-':>8}  MISSING from the eval output")
                ok = False
                continue
            got = float(got)
            rel = ((got - want) / want * 100 if want
                   else (0.0 if got == want else float("inf")))
            if (group, str(name)) in budgeted:
                verdict = "PASS" if abs(rel) <= budget_pct else "FAIL"
                ok = ok and verdict == "PASS"
                verdict += f" (+-{budget_pct:g}% budget)"
            else:
                verdict = "info"
            print(f"{group + '/' + str(name):<16} {want:>10.3f} "
                  f"{got:>10.3f} {rel:>+8.2f}  {verdict}")
    return ok


def main(argv=None):
    args = parse_args(argv)
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
    else:
        expected = PUBLISHED
    measured = run_eval(args)
    ok = compare(measured, expected, args.budget_pct)
    print(f"\n{'REPRODUCTION PASS' if ok else 'REPRODUCTION FAIL'}: the "
          f"budgeted metrics {'within' if ok else 'outside'} "
          f"+-{args.budget_pct:g}% of "
          f"{args.expected or 'the published table'}")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
