"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): the bf16 gate per image, bf16 training, 2 ranks
over gloo on one card (tiny preset), before the full smoke run."""
import os, sys, json, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from planerecnet_tpu_torch.config import PlaneRecNet_50_config as cfg
from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
from planerecnet_tpu_torch.runner import PlaneRecNetRunner

card = cs.phase_device()
t0 = time.time(); cs.phase_build(); print("build", time.time() - t0, flush=True)

def gate_images(r32, rbf, what, h=cs.HEIGHT, w=cs.WIDTH):
    x = cs.low_frequency_frames(cs.BATCH, h, w, seed=7).to(r32.device)
    with torch.no_grad():
        p32, pbf = r32.model(x), rbf.model(x)
    def image(preds, i):
        return {k: ([t[i:i + 1] for t in v] if isinstance(v, list) else v[i:i + 1]) for k, v in preds.items()}
    for i in range(cs.BATCH):
        c = cs.gate_cfg(cfg, image(p32, i)["cate_preds"])
        try:
            m, d, r = cs.bf16_gate(postprocess_batch(image(p32, i), c, (h, w)), postprocess_batch(image(pbf, i), c, (h, w)))
            print(what, i, "PASS", np.round(m, 4), d, r, flush=True)
        except AssertionError as e:
            print(what, i, "FAIL", e, flush=True)

try:
    torch.backends.cudnn.allow_tf32 = True
    r32 = PlaneRecNetRunner(cfg, seed=0, device="cuda"); cs.perturb_(r32.model, seed=1)
    with torch.no_grad(): r32.model.inst_head.kernel_pred.weight.mul_(12.0)
    rbf = PlaneRecNetRunner(cfg.copy(dict(compute_dtype="bfloat16")), device="cuda"); rbf.model.load_state_dict(r32.model.state_dict())
    gate_images(r32, rbf, "perturb 480x640")
    gate_images(r32, rbf, "perturb 256x320", 256, 320)
    torch.backends.cudnn.allow_tf32 = False
    gate_images(r32, rbf, "perturb 480x640 tf32off")
    torch.backends.cudnn.allow_tf32 = True
    del r32, rbf; torch.cuda.empty_cache()
except Exception:
    traceback.print_exc()

try:
    l, ms = cs.phase_bf16_serve(card)
except Exception:
    traceback.print_exc()
try:
    cs.phase_bf16_train(card, 0.0, 0.0)
except Exception:
    traceback.print_exc()

try:
    from planerecnet_tpu_torch.tools import synth_scenes
    work = tempfile.mkdtemp(prefix="prn_try_")
    synth_scenes.generate_dataset(work, 24, 8, 8, h=48, w=80, seed=0, progress=False)
    cs.DP_CONFIG = "PlaneRecNet_tiny_config"
    cs.DP_OVERRIDES = dict(cs.DP_OVERRIDES, max_size=64)
    cs.HEIGHT, cs.WIDTH = 48, 80
    print(cs.phase_dp(card, work), flush=True)
    print(cs.phase_check_dataset(work), flush=True)
except Exception:
    traceback.print_exc()
print("done", flush=True)
