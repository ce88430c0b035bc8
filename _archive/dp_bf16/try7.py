"""A measurement on the card behind PERF.md (its exploratory runs on data parallelism and bf16): was TF32 on in the launcher's runs despite
NVIDIA_TF32_OVERRIDE=0? The first step's gradients of the CLI runs (env
override, or a sitecustomize that sets torch.backends.cudnn.allow_tf32 =
False) against this process's step with TF32 on and off."""
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
from planerecnet_tpu_torch.tools.run_multihost import launch
work = tempfile.mkdtemp(prefix="prn_try_")
synth_scenes.generate_dataset(work, *cs.CLI_SPLITS, h=cs.HEIGHT, w=cs.WIDTH, seed=0, progress=False)
site = os.path.join(work, "site"); os.makedirs(site)
with open(os.path.join(site, "sitecustomize.py"), "w") as f:
    f.write("import torch\ntorch.backends.cudnn.allow_tf32 = False\ntorch.backends.cuda.matmul.allow_tf32 = False\n")
ov = dict(cs.DP_OVERRIDES, max_iter=1)
args = ["--config", "PlaneRecNet_50_config", "--batch_size", "12", "--dtype", "float32", "--no_tensorboard",
        "--no_autoscale", "--reproductablity", "--validation_epoch", "0", "--cfg_overrides", json.dumps(ov)]
cwd = os.getcwd(); os.chdir(work)
runs = {"1p_env": (1, {"NVIDIA_TF32_OVERRIDE": "0"}), "1p_site": (1, {"PYTHONPATH": site}),
        "2r_site": (2, {"PYTHONPATH": site}), "1p_default": (1, {})}
for name, (n, env) in runs.items():
    try:
        launch(n, args + ["--save_folder", name + "/"], platform="cuda", backend="gloo",
               log_dir=os.path.join(work, name + "_logs"), timeout=150 if name == "1p_default" else 240, extra_env=env)
    except Exception:
        traceback.print_exc()
cfg = apply_overrides(PlaneRecNet_50_config, ov)
ds = build_dataset(cfg, "train", transform=SSDAugmentation(cfg, rng=np.random.RandomState(42)))
batch = next(iter(BatchIterator(cfg, ds, 12, seed=42)))
def grads(tf32):
    torch.backends.cudnn.allow_tf32 = tf32
    with train_cli.reproducible_mode(True):
        st = trainer.create_train_state(cfg, seed=42, device="cuda", deterministic=True)
        trainer.grad_step(st, batch)
        return {n: p.grad.detach().float().cpu().clone() for n, p in st.model.named_parameters()}
here = {"off": grads(False), "on": grads(True)}
ck = {}
for name in runs:
    try:
        f = sorted(os.listdir(name))[0]
        with np.load(os.path.join(name, f)) as z:
            ck[name] = {k[len("adam/exp_avg/"):]: torch.from_numpy(z[k] / 0.1) for k in z.files if k.startswith("adam/exp_avg/")}
    except Exception:
        traceback.print_exc()
os.chdir(cwd)
def rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))
names = [n for n in here["off"] if "bias" not in n]
for name, g in ck.items():
    for mode, h in here.items():
        r = sorted(rel(g[n], h[n]) for n in names)
        print(f"[tf32] {name} vs here tf32 {mode}: median {np.median(r):.3g}, max {r[-1]:.3g}, conv1 {rel(g['backbone.conv1.weight'], h['backbone.conv1.weight']):.3g}", flush=True)
r = sorted(rel(here["on"][n], here["off"][n]) for n in names)
print(f"[tf32] here on vs off: median {np.median(r):.3g}, max {r[-1]:.3g}", flush=True)
shutil.rmtree(work, ignore_errors=True)
print("done", flush=True)
