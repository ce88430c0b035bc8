"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): phases 11, 13 and 14 of chip_smoke.py at full
size, on a 480x640 tree like phase 9's."""
import os, sys, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
torch.backends.cudnn.allow_tf32 = True
try:
    cs.phase_bf16_serve(card)
except Exception:
    traceback.print_exc()
torch.cuda.empty_cache()
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
t0 = time.time()
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
print("tree", time.time() - t0, flush=True)
try:
    print(cs.phase_dp(card, work), flush=True)
except Exception:
    traceback.print_exc()
try:
    cs.phase_check_dataset(work)
except Exception:
    traceback.print_exc()
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
