"""The bf16 gate of ``tests/test_bf16.py`` in both packages, image by image,
on the weights that ``chip_smoke.py`` serves (``chip_smoke.perturb_``).

Not a test: a measurement on the CPU. The port's PRN-50 gets seeded
weights, perturbed as phase 5 of ``chip_smoke.py`` perturbs them, with the
dynamic-kernel head amplified as the gate asks; the same variables go to
the JAX package (``to_jax_variables``). Each low-frequency frame goes
through both packages in f32 and in bf16, and the gate (``chip_smoke.
bf16_gate``) compares each package's bf16 with its own f32. Prints, per
image and package, whether the gate's IoU part passed and the matched
IoUs, the score drift and the depth error.

    JAX_PLATFORMS=cpu python tests/bf16_gate_vs_jax.py \\
        [--height 256 --width 320 --images 8 --gain 12]
"""

import argparse
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as cs  # noqa: E402
from planerecnet_tpu.config import PlaneRecNet_50_config as J50  # noqa: E402
from planerecnet_tpu.models.planerecnet import PlaneRecNet as J  # noqa: E402
from planerecnet_tpu.ops.postprocess import (  # noqa: E402
    postprocess_batch as jax_postprocess)
from planerecnet_tpu_torch.config import (  # noqa: E402
    PlaneRecNet_50_config as T50)
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet  # noqa: E402
from planerecnet_tpu_torch.ops.postprocess import (  # noqa: E402
    postprocess_batch as port_postprocess)
from planerecnet_tpu_torch.utils.weights import (  # noqa: E402
    to_jax_variables)
from test_torch_port_model import nest  # noqa: E402


def _torch(outputs):
    return {k: torch.as_tensor(np.asarray(v, np.float32)
                               if np.asarray(v).dtype.name == "bfloat16"
                               else np.asarray(v))
            for k, v in outputs.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--gain", type=float, default=cs.GATE_KERNEL_GAIN)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    h, w = args.height, args.width

    torch.manual_seed(0)
    m32 = PlaneRecNet(T50).eval()
    cs.perturb_(m32, seed=1)
    with torch.no_grad():
        m32.inst_head.kernel_pred.weight.mul_(args.gain)
    mbf = PlaneRecNet(T50.copy(dict(compute_dtype="bfloat16"))).eval()
    mbf.load_state_dict(m32.state_dict())
    variables = nest({k: np.asarray(v) for k, v in
                      to_jax_variables(m32.state_dict()).items()})
    jax_apply = {dt: jax.jit(functools.partial(
        J(J50.copy(dict(compute_dtype=dt))).apply, train=False))
        for dt in ("float32", "bfloat16")}

    frames = cs.low_frequency_frames(args.images, h, w, seed=7)
    passed = {"port": 0, "jax": 0}
    for i in range(args.images):
        x = frames[i:i + 1]
        with torch.no_grad():
            p32, pbf = m32(x), mbf(x)
        j32 = jax_apply["float32"](variables, jnp.asarray(x.numpy()))
        jbf = jax_apply["bfloat16"](variables, jnp.asarray(x.numpy()))
        cfg = cs.gate_cfg(T50, p32["cate_preds"])
        jcfg = J50.copy(dict(solov2=J50.solov2.copy(dict(
            score_thr=cfg.solov2.score_thr, update_thr=1e-6, top_k=20))))
        outs = {"port": (port_postprocess(p32, cfg, (h, w)),
                         port_postprocess(pbf, cfg, (h, w))),
                "jax": (_torch(jax_postprocess(j32, jcfg, (h, w))),
                        _torch(jax_postprocess(jbf, jcfg, (h, w))))}
        for name, (a, b) in outs.items():
            ious, iou_ok, drift, rel = cs.bf16_gate(a, b)
            passed[name] += iou_ok
            verdict = "passed" if iou_ok else "failed"
            print(f"image {i} {name}: IoU part {verdict}"
                  f", IoUs {np.round(ious, 4).tolist()}, score drift "
                  f"{drift:.3g}, depth error {rel:.3g}", flush=True)
    print(f"{h}x{w}, gain {args.gain}: the IoU part passed on "
          f"{passed['port']} of {args.images} images for the port, "
          f"{passed['jax']} for the JAX package")


if __name__ == "__main__":
    main()
