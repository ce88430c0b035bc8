"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): phase 13 as it now stands (synced, yardstick
with cuDNN off, frozen)."""
import os, sys, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
t0 = time.time()
try:
    print(cs.phase_dp(card, work), flush=True)
except Exception:
    traceback.print_exc()
print("phase 13", time.time() - t0, "s", flush=True)
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
