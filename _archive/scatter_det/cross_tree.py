"""Train PRN-50 through the train CLI with --reproductablity from several
trees of the repo, on one card, on the synthetic ScanNet tree of
``chip_smoke.py``'s phase 9 (24/8/8 frames at 480x640, seed 0, 12 steps
at batch 8), and compare the checkpoints in every bit.

    python3 _archive/scatter_det/cross_tree.py [OTHER_TREE ...]

The first tree is the one this script lies in; each other tree is a
directory holding the repo (for example an unpacked ``git archive`` of
another commit). Exits 1 unless every checkpoint equals the first's.
"""

import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from planerecnet_tpu_torch.tools import synth_scenes  # noqa: E402


def train(tree, work, name):
    """One --reproductablity run of the tree's train CLI in ``work``;
    returns its last checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    args = [sys.executable, "-m", "planerecnet_tpu_torch.train",
            "--config", "PlaneRecNet_50_config", "--batch_size",
            str(cs.BATCH), "--dtype", "float32", "--no_tensorboard",
            "--no_autoscale", "--reproductablity", "--save_folder",
            f"{name}/", "--cfg_overrides",
            json.dumps({"max_iter": cs.CLI_ITERS})]
    t0 = time.perf_counter()
    out = subprocess.run(args, cwd=work, env=env, capture_output=True,
                         text=True)
    if out.returncode:
        sys.stdout.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: train CLI exit {out.returncode}")
    ckpts = sorted(glob.glob(os.path.join(work, name, "*.npz")),
                   key=os.path.getmtime)
    print(f"[cross-tree] {tree}: {cs.CLI_ITERS} steps in "
          f"{time.perf_counter() - t0:.1f} s -> {ckpts[-1]}", flush=True)
    return ckpts[-1]


def main():
    trees = [ROOT] + [Path(t).resolve() for t in sys.argv[1:]]
    with tempfile.TemporaryDirectory(prefix="prn_cross_") as work:
        synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT,
                                      w=cs.WIDTH, seed=0, progress=False)
        ckpts = [train(t, work, f"weights_{i}") for i, t in enumerate(trees)]
        bad = 0
        with np.load(ckpts[0]) as a:
            for tree, path in zip(trees[1:], ckpts[1:]):
                with np.load(path) as b:
                    differ = [k for k in a.files if k not in b.files
                              or a[k].dtype != b[k].dtype
                              or a[k].shape != b[k].shape
                              or a[k].tobytes() != b[k].tobytes()]
                    extra = sorted(set(b.files) - set(a.files))
                print(f"[cross-tree] {tree} against {trees[0]}: "
                      f"{len(differ)} of {len(a.files)} arrays differ "
                      f"{differ[:5]}, {len(extra)} extra", flush=True)
                bad += len(differ) + len(extra)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
