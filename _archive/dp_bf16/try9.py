"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): phase 13 as it now stands (f64 BatchNorm sums,
one rank of the same program as the twin, TF32 off by a sitecustomize),
at 4 and at 2 steps."""
import os, sys, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
for iters in (4, 2):
    try:
        cs.DP_ITERS = iters
        cs.DP_OVERRIDES = dict(cs.DP_OVERRIDES, max_iter=iters)
        for d in ("dp1", "dp2"):
            shutil.rmtree(os.path.join(work, d), ignore_errors=True)
        print(iters, cs.phase_dp(card, work), flush=True)
    except Exception:
        traceback.print_exc()
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
