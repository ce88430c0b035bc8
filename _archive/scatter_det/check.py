"""Build the scatter kernels and hold the deterministic variant against the
CPU plain version at the PRN-50 training shapes, the scatter edge cases and
a pile-up of every row on one patch; time it beside the atomic kernel.

    python3 _archive/scatter_det/check.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402
from planerecnet_tpu_torch.ops import cuda_build, dcn  # noqa: E402
from planerecnet_tpu_torch.ops import dcn_scatter as ds  # noqa: E402


def bits(idx, cw, dcols, h, w, what):
    det = cs.det_twice(lambda: ds.dcn_input_grad(idx, cw, dcols, h, w,
                                                 deterministic=True), what)
    cpu = ds.dcn_input_grad_plain(idx.cpu(), cw.cpu(), dcols.cpu(), h, w)
    differ = int((det.cpu().view(torch.int32) != cpu.view(torch.int32)).sum())
    print(f"[check] {what}: {differ} of {cpu.numel()} differ, plan "
          f"{ds.det_plan(*dcols.shape[:2], h, w, dcols.shape[2])}",
          flush=True)
    return differ


def main():
    t0 = time.perf_counter()
    out = cuda_build.build(["dcn_scatter"], fresh=["dcn_scatter"])
    log = out["dcn_scatter"]["log"]
    print("\n".join(line for line in log.splitlines()
                    if "det_" in line or "Used" in line or "spill" in line))
    print(f"[check] build {time.perf_counter() - t0:.1f} s", flush=True)
    bad = 0
    for i, (h, w, cin, stride, layers) in enumerate(cs.DCN_SHAPES_TRAIN):
        for std in (None, cs.TRAIN_OFFSET_STD[cin]):
            _, off, mask, _, _, ho, wo = cs.dcn_inputs(
                h, w, 8, stride, torch.float32, seed=20 + i, std=std)
            idx, cw = dcn.scatter_inputs(off, mask, h, w, stride=stride)
            g = torch.Generator(device="cuda").manual_seed(40 + i)
            dcols = torch.randn(cs.BATCH, ho * wo * 9, cin, device="cuda",
                                generator=g)
            name = f"{h}x{w}x{cin}/s{stride} std {std}"
            bad += bits(idx, cw, dcols, h, w, name)
            ms = cs.cuda_time_ms(lambda: ds.dcn_input_grad(idx, cw, dcols, h, w))
            det_ms = cs.cuda_time_ms(lambda: ds.dcn_input_grad(
                idx, cw, dcols, h, w, deterministic=True))
            print(f"[check] {name}: atomic {ms:.4f} ms, det {det_ms:.4f} ms "
                  f"x{layers}", flush=True)
    for i, (what, b, h, w, c, stride, spread, drop) in enumerate(
            cs.SCATTER_CASES):
        _, off, mask, _, _, ho, wo = cs.dcn_inputs(
            h, w, 4, stride, torch.float32, seed=80 + i, spread=spread,
            batch=b)
        idx, cw = dcn.scatter_inputs(off, mask, h, w, stride=stride)
        r = ho * wo * 9 - drop
        idx, cw = idx[:, :r].contiguous(), cw[:, :r].contiguous()
        g = torch.Generator(device="cuda").manual_seed(90 + i)
        dcols = torch.randn(b, r, c, device="cuda", generator=g)
        bad += bits(idx, cw, dcols, h, w, what)
    # Every row on one patch: the tiles there overflow a round.
    b, h, w, c = 2, 80, 80, 128
    r = 9 * h * w
    idx = torch.full((b, r, 2), 41, dtype=torch.int32, device="cuda")
    cw = torch.rand(b, r, 4, device="cuda")
    dcols = torch.randn(b, r, c, device="cuda")
    bad += bits(idx, cw, dcols, h, w, "pile-up on one patch")
    print(f"[check] {'FAIL' if bad else 'ok'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
