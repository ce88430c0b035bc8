"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): 2 ranks (BatchNorm synced) against 1 process
after 1 and after 2 steps: the first step's gradients are taken at equal
parameters."""
import os, sys, json, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
for iters in (1, 2):
    try:
        cs.DP_ITERS = iters
        cs.DP_OVERRIDES = dict(cs.DP_OVERRIDES, max_iter=iters)
        shutil.rmtree(os.path.join(work, "dp1"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "dp2"), ignore_errors=True)
        print(iters, cs.phase_dp(card, work), flush=True)
    except Exception:
        traceback.print_exc()
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
