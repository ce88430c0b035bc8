"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): phase 13 with TF32 off in both runs."""
import os, sys, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
try:
    print(cs.phase_dp(card, work), flush=True)
except Exception:
    traceback.print_exc()
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
