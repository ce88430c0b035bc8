"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): the first step's gradients, 2 ranks (BatchNorm
synced) and 1 process (both through the launcher, TF32 off), against the
same step in this process with the deterministic variants and with the
atomic kernels (the one process's own sensitivity to summation order)."""
import os, sys, json, time, tempfile, shutil, traceback
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
from planerecnet_tpu_torch import trainer, train as train_cli
from planerecnet_tpu_torch.config import PlaneRecNet_50_config, apply_overrides
from planerecnet_tpu_torch.data import BatchIterator, SSDAugmentation, build_dataset
from planerecnet_tpu_torch.tools import synth_scenes
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
cs.DP_ITERS = 1
cs.DP_OVERRIDES = dict(cs.DP_OVERRIDES, max_iter=1)
try:
    cs.phase_dp(card, work)
except Exception:
    traceback.print_exc()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cwd = os.getcwd(); os.chdir(work)
cfg = apply_overrides(PlaneRecNet_50_config, {k: v for k, v in cs.DP_OVERRIDES.items()})
ds = build_dataset(cfg, "train", transform=SSDAugmentation(cfg, rng=np.random.RandomState(42)))
batch = next(iter(BatchIterator(cfg, ds, 12, seed=42)))
def grads(det):
    with train_cli.reproducible_mode(det):
        st = trainer.create_train_state(cfg, seed=42, device="cuda", deterministic=det)
        trainer.grad_step(st, batch)
        return {n: p.grad.detach().float().cpu().clone() for n, p in st.model.named_parameters()}
gd, ga = grads(True), grads(False)
ck = {}
for name in ("dp1", "dp2"):
    f = sorted(os.listdir(name))[0]
    with np.load(os.path.join(name, f)) as z:
        ck[name] = {k[len("adam/exp_avg/"):]: torch.from_numpy(z[k] / 0.1) for k in z.files if k.startswith("adam/exp_avg/")}
os.chdir(cwd)
def rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))
names = ["backbone.conv1.weight", "backbone.layers.0.0.conv1.weight", "backbone.layers.0.0.conv2.weight",
         "backbone.layers.1.0.conv2.offset_conv.weight", "backbone.layers.3.2.conv3.weight", "fpn.fpn_convs.0.weight",
         "inst_head.kernel_pred.weight", "inst_head.cate_pred.weight", "mask_head.conv_pred.0.weight", "depth_decoder.depth_pred.1.weight"]
for n in names:
    print(f"[grad] {n}: here det vs 1-proc ckpt {rel(gd[n], ck['dp1'][n]):.3g}; here atomic vs det {rel(ga[n], gd[n]):.3g}; 2 ranks vs 1 proc {rel(ck['dp2'][n], ck['dp1'][n]):.3g}; 2 ranks vs here det {rel(ck['dp2'][n], gd[n]):.3g}", flush=True)
allr = sorted((rel(ga[n], gd[n]), n) for n in gd if "bias" not in n)
print("[grad] atomic vs det, weights only: median", np.median([r[0] for r in allr]), "worst", allr[-5:], flush=True)
allr2 = sorted((rel(ck['dp2'][n], ck['dp1'][n]), n) for n in gd if "bias" not in n)
print("[grad] 2 ranks vs 1 proc, weights only: median", np.median([r[0] for r in allr2]), "worst", allr2[-5:], flush=True)
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
