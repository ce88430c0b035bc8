"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): is the 2-rank/1-process gradient gap of the run before
the f32 gradient's own conditioning? (a) one process, one step on one
batch, the deterministic variants against the atomic kernels (the same
arithmetic summed in other orders), BN in train mode and frozen; (b) 2
ranks against 1 process with BatchNorm frozen in both."""
import os, sys, json, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from planerecnet_tpu_torch import trainer, train as train_cli
from planerecnet_tpu_torch.config import PlaneRecNet_50_config

def grads(freeze, det, batch):
    cfg = PlaneRecNet_50_config.copy(dict(freeze_bn=freeze))
    with train_cli.reproducible_mode(det):
        st = trainer.create_train_state(cfg, seed=42, device="cuda", deterministic=det)
        trainer.grad_step(st, batch)
        out = {n: p.grad.detach().float().cpu().clone() for n, p in st.model.named_parameters() if p.grad is not None}
    del st; torch.cuda.empty_cache()
    return out

batch = cs.synthetic_batch(12, 480, PlaneRecNet_50_config.max_instances, seed=3)
batch["image"] = batch["image"][:, :, :480]
for k in ("depth",):
    batch[k] = batch[k][:, :, :480]
batch["masks"] = batch["masks"][..., :480]
for freeze in (False, True):
    try:
        a, b = grads(freeze, True, batch), grads(freeze, False, batch)
        rows = sorted(((float((a[n] - b[n]).abs().max() / (a[n].abs().max() + 1e-30)), n) for n in a), reverse=True)
        med = float(np.median([r[0] for r in rows]))
        print(f"[cond] freeze_bn={freeze}: deterministic vs atomic step, gradient error over leaf scale: median {med:.3g}, worst {rows[:5]}", flush=True)
    except Exception:
        traceback.print_exc()

from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
try:
    cs.DP_PER_RANK = 4
    cs.DP_OVERRIDES = dict(cs.DP_OVERRIDES, freeze_bn=True)
    print(cs.phase_dp(card, work), flush=True)
except Exception:
    traceback.print_exc()
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
