"""Drive the PyTorch port's inference path on one CUDA card, phase by phase.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi).
2. build: ``nvcc`` builds ``planerecnet_tpu_torch/csrc/dcn_im2col.cu`` for
   sm_90a into ``planerecnet_tpu_torch/_build/``.
3. kernel: the deformable im2col kernel against its plain PyTorch version at
   the six distinct DCN layer shapes of PlaneRecNet-50 at batch 8, 480x640,
   in f32 and bf16; timed beside the plain version, the ``F.grid_sample``
   yardstick and the least time the card could take.
4. main path: ``PlaneRecNetRunner(PlaneRecNet_50_config)`` with seeded,
   perturbed weights answers 5 requests of 8 distinct 480x640 frames; the
   kernel's launch count must rise by 13 per request.
5. CPU against GPU: the same weights on one smaller frame through the CPU
   (plain) path and the card (kernel) path.

6. with ``--profile DIR`` only: host-clocked stages of one request and a
   ``torch.profiler`` trace of two (kernel table and busy share printed,
   trace and table written to DIR).

Exits non-zero if any phase fails, and at once where there is no card.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
BATCH, HEIGHT, WIDTH = 8, 480, 640
REQUESTS = 5
DCN_LAYERS_PRN50 = 13
# (H, W, Cin, stride, layers of PRN-50 with this shape); Cout = Cin.
DCN_SHAPES = [
    (120, 160, 128, 2, 1), (60, 80, 128, 1, 3),
    (60, 80, 256, 2, 1), (30, 40, 256, 1, 5),
    (30, 40, 512, 2, 1), (15, 20, 512, 1, 2),
]
# f32: the kernel and the plain version differ only in FMA contraction and
# the order of the four corner terms. bf16: the plain version rounds each
# product and the sum to bf16, the kernel accumulates in f32.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def log(*args):
    print(*args, flush=True)


def close_err(got, want, tol):
    """Max |got - want|, and whether every element is within
    tol * (max|want| + |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max()
    return float(err.max()), bool((err <= tol * (scale + want.abs())).all())


def cuda_time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(out[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return out[0]


def phase_build(dcn):
    info = dcn.build_kernel()
    log(f"[build] {info['path']} in {info['seconds']:.1f} s")
    log(info["log"].strip())


def dcn_inputs(h, w, cin, stride, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    kw = dict(device="cuda", generator=g)
    x = torch.randn(BATCH, h, w, cin, **kw)
    # Offsets span +-8 px, so some samples fall outside the map.
    off = (torch.rand(BATCH, ho, wo, 18, **kw) - 0.5) * 16
    mask = torch.rand(BATCH, ho, wo, 9, **kw) * 2
    wt = torch.randn(3, 3, cin, cin, **kw) / (3 * cin ** 0.5)
    bias = torch.randn(cin, **kw)
    return x.to(dtype), off, mask, wt.to(dtype), bias, ho, wo


def sample_points(off, stride, ho, wo):
    """(sy, sx), each (B, Ho, Wo, 9): where each tap samples (padding 1)."""
    dev = off.device
    oy = torch.arange(ho, device=dev) * stride - 1
    ox = torch.arange(wo, device=dev) * stride - 1
    t = torch.arange(3, device=dev)
    ty, tx = torch.meshgrid(t, t, indexing="ij")
    o = off.reshape(*off.shape[:3], 9, 2)
    sy = (oy[:, None, None] + ty.reshape(-1)) + o[..., 0]
    sx = (ox[None, :, None] + tx.reshape(-1)) + o[..., 1]
    return sy, sx


def valid_corners(off, h, w, stride, ho, wo):
    """Number of (sample, corner) pairs that fall inside the map."""
    sy, sx = sample_points(off, stride, ho, wo)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    n = 0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            n += int(((yy >= 0) & (yy <= h - 1) & (xx >= 0)
                      & (xx <= w - 1)).sum())
    return n


def grid_for(off, h, w, stride, ho, wo):
    """The same sample points as an ``F.grid_sample`` grid (align_corners
    =True: -1 and 1 are the centres of the edge pixels)."""
    sy, sx = sample_points(off, stride, ho, wo)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)
    return grid.reshape(off.shape[0], ho * wo, 9, 2)


def phase_kernel(dcn):
    """Kernel against plain version at every PRN-50 DCN shape; returns the
    per-shape records and the worst error."""
    records, worst = [], 0.0
    for i, (h, w, cin, stride, layers) in enumerate(DCN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, wt, bias, ho, wo = dcn_inputs(h, w, cin, stride,
                                                        dtype, seed=i)
            kw = dict(stride=stride, padding=1, kernel_size=3)
            cols = dcn.deform_im2col(x, off, mask, **kw)
            plain = dcn.deform_im2col_plain(x, off, mask, **kw)
            out = dcn.deform_conv2d(x, off, mask, wt, bias, **kw)
            out_plain = (plain @ wt.reshape(9 * cin, cin) + bias.to(dtype)
                         ).reshape(out.shape)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            e_cols, ok_cols = close_err(cols, plain, tol)
            e_out, ok_out = close_err(out, out_plain, tol)
            name = f"{h}x{w}x{cin}/s{stride} {str(dtype)[6:]}"
            log(f"[kernel] {name}: cols err {e_cols:.3g}, "
                f"conv err {e_out:.3g} (tol {tol} of scale)")
            if not (ok_cols and ok_out):
                raise AssertionError(f"kernel disagrees with plain at {name}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"non-finite output at {name}")
            if dtype != torch.float32:
                continue
            worst = max(worst, e_cols)
            xc = x.permute(0, 3, 1, 2).contiguous()
            grid = grid_for(off, h, w, stride, ho, wo)
            ms = cuda_time_ms(lambda: dcn.deform_im2col(x, off, mask, **kw))
            plain_ms = cuda_time_ms(
                lambda: dcn.deform_im2col_plain(x, off, mask, **kw), iters=5)
            lib_ms = cuda_time_ms(lambda: F.grid_sample(
                xc, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True))
            k = 9
            nbytes = 4 * (x.numel() + off.numel() + mask.numel()
                          + BATCH * ho * wo * k * cin)
            # Two flops per valid corner and channel, one for the mask.
            flops = (2 * valid_corners(off, h, w, stride, ho, wo) * cin
                     + BATCH * ho * wo * k * cin)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS_PER_S * 1e3
            rec = dict(shape=name, layers=layers, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bytes=nbytes, flops=flops,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", max_abs_err=e_cols)
            log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"grid_sample {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} "
                f"ms ({rec['bound_by']}), "
                f"{nbytes / ms / 1e6:.1f} GB/s achieved")
            records.append(rec)
    log("[kernel] shapes " + json.dumps(records))
    return records, worst


def perturb_(model, seed, offset_std=0.01):
    """Seeded non-trivial weights: DCN offset/modulator convs N(0, std)
    (zero at init: the DCN would sample the integer grid) and BatchNorm
    running stats mean N(0, 0.5), var U(0.5, 2) (0 and 1 at init)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name or "modulator_conv" in name:
                p.copy_(torch.randn(p.shape, generator=g) * offset_std)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.5)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g) * 1.5)


def frames(n, h, w, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, h, w, 3)).astype(
        np.float32)


def check_outputs(out, b, h, w, top_k):
    shapes = {"pred_masks": (b, top_k, h, w), "pred_scores": (b, top_k),
              "pred_classes": (b, top_k), "pred_boxes": (b, top_k, 4),
              "pred_valid": (b, top_k), "pred_depth": (b, h, w),
              "candidates_clipped": (b,)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key} {tuple(out[key].shape)} != {shape}")
    for key in ("pred_scores", "pred_boxes", "pred_depth"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key} is not finite")


def phase_main(dcn, cfg, card):
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    runner = PlaneRecNetRunner(cfg, seed=0, device="cuda")
    perturb_(runner.model, seed=1)
    reqs = [frames(BATCH, HEIGHT, WIDTH, seed=10 + r) for r in range(REQUESTS)]
    runner.infer(frames(BATCH, HEIGHT, WIDTH, seed=9))    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dcn.deform_im2col.launches = 0
    times = []
    for batch in reqs:
        t0 = time.perf_counter()
        out = runner.infer(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_outputs(out, BATCH, HEIGHT, WIDTH, cfg.solov2.top_k)
    launches = dcn.deform_im2col.launches

    if launches != DCN_LAYERS_PRN50 * REQUESTS:
        raise AssertionError(f"{launches} kernel launches for {REQUESTS} "
                             f"requests, expected {DCN_LAYERS_PRN50} each")
    ms = float(np.median(times))
    log(f"[main] PRN-50 {BATCH}x{HEIGHT}x{WIDTH} f32: per request "
        f"{[round(t, 3) for t in times]} ms; median {ms:.3f} ms/request, "
        f"{BATCH / ms * 1e3:.2f} img/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; {card}")
    log(f"[main] {launches} kernel launches over {REQUESTS} requests; "
        f"valid detections {int(out['pred_valid'].sum())}")
    return runner, launches, ms


def phase_cpu_vs_gpu(runner, cfg):
    """One 256x320 frame through the CPU (plain) and card (kernel) paths
    with the same weights, TF32 off; thresholds lowered so that detections
    exist to compare."""
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    low = cfg.copy(dict(solov2=cfg.solov2.copy(dict(score_thr=0.003,
                                                    update_thr=0.003))))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = frames(1, 256, 320, seed=99)
    weights = runner.model.state_dict()
    gpu = PlaneRecNetRunner(low, device="cuda")
    gpu.model.load_state_dict(weights)
    cpu = PlaneRecNetRunner(low, device="cpu")
    cpu.model.load_state_dict(weights)
    t0 = time.perf_counter()
    want = cpu.infer(x)
    cpu_s = time.perf_counter() - t0
    got = {k: v.cpu() for k, v in gpu.infer(x).items()}
    normalised = fast_base_transform(torch.from_numpy(x))
    raw_w = cpu.forward_raw(normalised)
    raw_g = gpu.forward_raw(normalised)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    # Raw predictions: f32 on both, summed in other orders (~1e-5 of scale
    # measured); 1e-3 leaves room for rounding that the 13 DCN layers'
    # offset paths amplify.
    errs = {}
    for key in ("cate_preds", "kernel_preds", "mask_pred", "depth_pred"):
        a = raw_g[key] if isinstance(raw_g[key], list) else [raw_g[key]]
        b = raw_w[key] if isinstance(raw_w[key], list) else [raw_w[key]]
        for i, (g, w) in enumerate(zip(a, b)):
            e, ok = close_err(g.cpu(), w, 1e-3)
            errs[f"{key}[{i}]"] = e
            if not ok:
                raise AssertionError(f"raw {key}[{i}] CPU vs GPU err {e}")
    e_depth, ok = close_err(got["pred_depth"], want["pred_depth"], 1e-3)
    if not ok:
        raise AssertionError(f"pred_depth CPU vs GPU err {e_depth}")
    if not torch.equal(got["pred_valid"], want["pred_valid"]):
        raise AssertionError("pred_valid differs between CPU and GPU")
    valid = want["pred_valid"]
    if int(valid.sum()) == 0:
        raise AssertionError("no valid detection to compare")
    e_scores, ok = close_err(got["pred_scores"], want["pred_scores"], 1e-3)
    if not ok:
        raise AssertionError(f"pred_scores CPU vs GPU err {e_scores}")
    if not torch.equal(got["pred_classes"][valid], want["pred_classes"][valid]):
        raise AssertionError("pred_classes differ between CPU and GPU")
    diff = (got["pred_masks"] != want["pred_masks"])[valid]
    frac = float(diff.float().mean())
    if frac > 1e-3:
        raise AssertionError(f"{frac:.2e} of mask pixels differ")
    log(f"[cpu-vs-gpu] 1x256x320, TF32 off: CPU {cpu_s:.1f} s; "
        f"{int(valid.sum())} valid detections agree; depth err "
        f"{e_depth:.3g}, score err {e_scores:.3g}, mask pixels differing "
        f"{frac:.2e}; raw errs {json.dumps(errs)}")


def phase_profile(runner, out_dir):
    """Where one request's time goes: host-clocked stages, then a
    ``torch.profiler`` trace of two requests (device time by kernel, the
    device's busy share of the wall time)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.ops.postprocess import postprocess_batch

    batch = frames(BATCH, HEIGHT, WIDTH, seed=20)
    stages = {"upload+transform": [], "forward": [], "postprocess": []}
    with torch.no_grad():
        for _ in range(4):
            t0 = time.perf_counter()
            x = fast_base_transform(runner._batch(batch))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            preds = runner.model(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            postprocess_batch(preds, runner.cfg, (HEIGHT, WIDTH))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[key].append(dt * 1e3)
    log("[profile] host-clocked stages, ms (median of 3 after 1 warm-up): "
        + json.dumps({k: float(np.median(v[1:])) for k, v in stages.items()}))

    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            runner.infer(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time; only the "
            "host-clocked stages above are measured")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"kernel": e.key[:90], "calls": e.count // n,
             "ms_per_request": e.self_device_time_total / 1e3 / n,
             "share": e.self_device_time_total / 1e3 / busy_ms}
            for e in kernels]
    log(f"[profile] {n} requests: wall {wall_ms / n:.3f} ms/request, device "
        f"busy {busy_ms / n:.3f} ms/request, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for r in rows[:25]:
        log(f"[profile] {r['ms_per_request']:9.3f} ms {r['share']:6.1%} "
            f"x{r['calls']:<4d} {r['kernel']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_kernels.json"), "w") as f:
        json.dump({"wall_ms_per_request": wall_ms / n,
                   "busy_ms_per_request": busy_ms / n, "kernels": rows}, f,
                  indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_trace.json"))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.ops import dcn

    card = phase_device()
    phase_build(dcn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records, worst = phase_kernel(dcn)
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    runner, launches, _ = phase_main(dcn, PlaneRecNet_50_config, card)
    phase_cpu_vs_gpu(runner, PlaneRecNet_50_config)
    if "--profile" in sys.argv:
        phase_profile(runner, sys.argv[sys.argv.index("--profile") + 1])

    def per_request(key):
        return sum(r[key] * r["layers"] for r in records)

    print(json.dumps({"kernels": [{
        "name": "dcn_im2col",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_im2col.cu",
        "replaces": "planerecnet_tpu/ops/dcn.py:544 (deform_conv2d; "
                    "sampling at :212-242, modulation at :311-316)",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_request("ms"),
        "kernel_ms": per_request("ms"),
        "plain_ms": per_request("plain_ms"),
        "bound_ms": per_request("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in records) else "operations",
        "library_ms": per_request("library_ms"),
        "per": f"one request: the {DCN_LAYERS_PRN50} PRN-50 DCN layers at "
               f"batch {BATCH}, {HEIGHT}x{WIDTH}, f32",
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
