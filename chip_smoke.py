"""Drive the PyTorch port's inference and training paths on one CUDA card.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --dice
    python3 chip_smoke.py --dcn

``--dice`` runs phases 1, 2 and the timed dice/lava shapes of 4 alone and
prints no result line; ``--dcn`` runs phases 1, 2, the im2col's serving
shapes of 3 and the training shapes of 4 (im2col and scatter, timed beside
their bounds and library calls) alone and prints no result line. Both time
the kernels of the package beside the script, so that two trees' kernels
can be compared on one card.

1. device: the card's name and power limit (nvidia-smi).
2. build: one ``nvcc`` per source in ``planerecnet_tpu_torch/csrc/``
   (dcn_im2col, dcn_scatter, dice_lava), all started together, for sm_90a
   into ``planerecnet_tpu_torch/_build/``.
3. kernel: the deformable im2col kernel against its plain PyTorch version at
   the six distinct DCN layer shapes of PlaneRecNet-50 at batch 8, 480x640,
   in f32 and bf16; timed beside the plain version, the ``F.grid_sample``
   yardstick and the least time the card could take.
4. training kernels, each against its plain version at the training shapes
   (batch 8, 640x640) and timed beside it, its bound and, where one exists,
   the one PyTorch call that computes the same function: the DCN
   input-gradient scatter at the six PRN-50 DCN layer shapes with offsets
   of +-8 px (as every earlier run) and with the spread that phase 7's
   training step measures (``TRAIN_OFFSET_STD``; yardstick
   ``grid_sampler_2d_backward``), then at its edge cases
   (offsets of +-64 px, C = 512 on a small map, C = 30 and 7, tiles that
   cut output rows, rows in no 3x3 layout); the im2col at those shapes
   with the real and with a unit mask (timed: the training step's 26
   launches, beside ``F.grid_sample``), then at its edge cases (a ragged
   last tile, C = 30, 36 and 514) in f32 and bf16; the fused dice/lava
   forward and backward (no single PyTorch call computes them) at each K
   of the presets, P = 100, a ragged HW, fractional inputs and N past one
   launch's 63 instances, then timed at the training shape of PRN-50
   (K=128) and of the base preset (K=256), one 10-iteration window each,
   bound at the 3xTF32 tensor-core rate and at the f32 rate; and the DCN
   Function's gradients against autograd of the plain forward at a small
   shape.
5. inference main path: ``PlaneRecNetRunner(PlaneRecNet_50_config)`` with
   seeded, perturbed weights answers 3 requests of 8 distinct 480x640
   frames; the im2col's launch count must rise by 13 per request.
6. inference CPU against GPU: the same weights on three smaller frames
   through the CPU (plain) path and the card (kernel) path. A mask pixel
   may differ only where the CPU's soft mask lies within the margin of
   ``mask_thr`` that the frame's measured raw errors, times 10, allow; the
   near-threshold flips are counted.
7. training main path: ``trainer.train_step`` on PlaneRecNet-50, batch 8,
   640x640, f32, all five losses, seeded perturbed weights, one fixed
   synthetic batch in the JAX package's layout: 1 warm-up step, 6 timed
   steps, 20 in all. The loss must be finite, fall, and move the weights;
   the launch counts must rise per step by 26 (im2col: forward, and the
   backward's unmodulated samples), 13 (scatter), 4 and 4 (dice/lava).
   One untimed step logs the spread of the DCN layers' offsets.
8. training CPU against GPU: one step of the tiny preset on the same
   weights, batch and VNL indices on both devices, TF32 off.

9. with ``--profile DIR`` only: host-clocked stages of one request and a
   ``torch.profiler`` trace of two requests and of two training steps
   (kernel tables and busy shares printed, traces and tables written to
   DIR).

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
# The dice/lava products run as three TF32 products each (3xTF32) on the
# tensor cores, 495 TFLOP/s dense TF32 (H100 SXM data sheet).
TF32X3_FLOPS_PER_S = 495e12 / 3
BATCH, HEIGHT, WIDTH = 8, 480, 640
REQUESTS = 3
DCN_LAYERS_PRN50 = 13
TRAIN_SIZE = 640            # the JAX package's training max_size
TIMED_STEPS, TRAIN_STEPS = 6, 20
# (H, W, Cin, stride, layers) of PRN-50's DCN inputs at 640x640.
DCN_SHAPES_TRAIN = [
    (160, 160, 128, 2, 1), (80, 80, 128, 1, 3),
    (80, 80, 256, 2, 1), (40, 40, 256, 1, 5),
    (40, 40, 512, 2, 1), (20, 20, 512, 1, 2),
]
# The std in px of the offsets that the training main path (phase 7, which
# logs them) gives its DCN layers, by input width: the seeded weights of
# ``perturb_``, not trained ones (0.236-0.241, 0.374-0.385 and 0.567-0.580
# over two runs on an H100). The scatter is timed at offsets drawn
# N(0, std^2) beside its +-8 px case.
TRAIN_OFFSET_STD = {128: 0.24, 256: 0.38, 512: 0.57}
# The fused dice/lava shape of a PRN-50 training step: per level P slots
# (max_positives), K kernel channels, N instances, HW mask pixels (H/4 x
# W/4); one forward and one backward launch per level, 4 levels.
DICE = dict(b=8, p=128, k=128, n=32, hw=(TRAIN_SIZE // 4) ** 2)
DICE_LEVELS = 4
# The same for the base preset (num_masks 256, 5 levels): timed beside
# PRN-50's, not on the main path.
DICE_BASE = dict(DICE, k=256)
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


def phase_build():
    from planerecnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    info = cuda_build.build()
    log(f"[build] {len(info)} sources in parallel, "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        log(f"[build] {rec['path']} in {rec['seconds']:.1f} s")
        log(rec["log"].strip())


def dcn_inputs(h, w, cin, stride, dtype, seed, spread=8.0, batch=None,
               std=None):
    """Seeded DCN inputs. Offsets are uniform in +-``spread`` px, or,
    given ``std``, normal with that std in px. +-8 (the default, as every
    earlier run timed) puts some samples outside the map and spreads a
    row's corners far."""
    batch = batch or BATCH
    g = torch.Generator(device="cuda").manual_seed(seed)
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    kw = dict(device="cuda", generator=g)
    x = torch.randn(batch, h, w, cin, **kw)
    if std is None:
        off = (torch.rand(batch, ho, wo, 18, **kw) - 0.5) * (2 * spread)
    else:
        off = torch.randn(batch, ho, wo, 18, **kw) * std
    mask = torch.rand(batch, ho, wo, 9, **kw) * 2
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


def bound(nbytes, flops, rate=F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``rate``, the peak of the units they run on."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def scatter_record(dcn_input_grad, dcn_input_grad_plain, idx, cw, dcols,
                   h, w, what):
    """The scatter kernel against its plain version (raises past f32 TOL),
    then timed beside it and beside its bound for this data: each row read
    once (corner, weights, channels), dx written once; 2 flops per channel
    for each corner that is in the map and has a non-zero weight."""
    tol = TOL[torch.float32]
    got = dcn_input_grad(idx, cw, dcols, h, w)
    want = dcn_input_grad_plain(idx, cw, dcols, h, w)
    torch.cuda.synchronize()
    err, ok = close_err(got, want, tol)
    log(f"[scatter] {what}: err {err:.3g} (tol {tol} of scale)")
    if not ok:
        raise AssertionError(f"scatter disagrees with plain at {what}")
    b, _, c = dcols.shape
    ms = cuda_time_ms(lambda: dcn_input_grad(idx, cw, dcols, h, w))
    adds = int((cw != 0).sum())   # zero weight: out of map or skipped
    nbytes = (idx.numel() + cw.numel() + dcols.numel() + b * h * w * c) * 4
    b_ms, b_by = bound(nbytes, 2 * adds * c)
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                bytes=nbytes)


def phase_scatter(cases=True):
    """The DCN input-gradient scatter against its plain version at the six
    PRN-50 DCN shapes at 640x640, with offsets of +-8 px (as every earlier
    run timed it) and drawn as phase 7's training step gives them
    (``TRAIN_OFFSET_STD``); the
    yardstick is aten's bilinear grid-sampler input gradient over the same
    points, with the modulation folded into its incoming gradient. At the
    same shapes the im2col kernel against its plain version, as the
    training step launches it: with the real mask (forward) and a unit
    mask (the backward's samples), each launch timed beside its bound and
    beside ``F.grid_sample`` over the same points. With ``cases``, the
    scatter's edge cases too (``scatter_cases``). Returns the scatter's
    records, its worst error, the im2col's worst error and the im2col's
    training records."""
    from planerecnet_tpu_torch.ops import dcn
    from planerecnet_tpu_torch.ops.dcn_scatter import (dcn_input_grad,
                                                       dcn_input_grad_plain)
    records, worst, worst_cols, cols_train = [], 0.0, 0.0, []
    tol = TOL[torch.float32]
    for i, (h, w, cin, stride, layers) in enumerate(DCN_SHAPES_TRAIN):
        x, off, mask, _, _, ho, wo = dcn_inputs(h, w, cin, stride,
                                                torch.float32, seed=20 + i)
        name = f"{h}x{w}x{cin}/s{stride}"
        geom = dict(stride=stride, padding=1, kernel_size=3)
        for which, m in (("mask", mask), ("unit mask", torch.ones_like(mask))):
            cols = dcn.deform_im2col(x, off, m, **geom)
            plain = dcn.deform_im2col_plain(x, off, m, **geom)
            torch.cuda.synchronize()
            err, ok = close_err(cols, plain, tol)
            log(f"[im2col-train] {name} {which}: cols err {err:.3g} (tol "
                f"{tol} of scale)")
            if not ok:
                raise AssertionError(f"im2col disagrees with plain at {name} "
                                     f"({which})")
            worst_cols = max(worst_cols, err)
            del cols, plain
        # The training step's two launches at this shape, and their bound:
        # x, offsets, mask and cols moved once each, two flops per valid
        # corner and channel and one for the mask.
        ms = sum(cuda_time_ms(lambda m=m: dcn.deform_im2col(x, off, m, **geom))
                 for m in (mask, torch.ones_like(mask)))
        xc = x.permute(0, 3, 1, 2).contiguous()
        grid = grid_for(off, h, w, stride, ho, wo)
        lib_ms = 2 * cuda_time_ms(lambda: F.grid_sample(
            xc, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        del xc
        nbytes = 4 * (x.numel() + off.numel() + mask.numel()
                      + BATCH * ho * wo * 9 * cin)
        flops = (2 * valid_corners(off, h, w, stride, ho, wo) * cin
                 + BATCH * ho * wo * 9 * cin)
        b_ms, b_by = bound(nbytes, flops)
        cols_train.append(dict(shape=name, layers=layers, ms=ms,
                               library_ms=lib_ms, bound_ms=2 * b_ms,
                               bound_by=b_by))
        log(f"[im2col-train] {name}: mask + unit mask {ms:.4f} ms, bound "
            f"{2 * b_ms:.4f} ms ({b_by}), grid_sample x2 {lib_ms:.4f} ms")

        idx, cw = dcn.scatter_inputs(off, mask, h, w, stride=stride)
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        dcols = torch.randn(BATCH, ho * wo * 9, cin, device="cuda",
                            generator=g)
        rec = scatter_record(dcn_input_grad, dcn_input_grad_plain, idx, cw,
                             dcols, h, w, f"{name} +-8 px")
        worst = max(worst, rec["max_abs_err"])
        grad_out = (dcols.reshape(BATCH, ho * wo, 9, cin)
                    * mask.reshape(BATCH, ho * wo, 9, 1)).permute(
                        0, 3, 1, 2).contiguous()
        inp = torch.empty(BATCH, cin, h, w, device="cuda")
        plain_ms = cuda_time_ms(
            lambda: dcn_input_grad_plain(idx, cw, dcols, h, w), iters=5)
        lib_ms = cuda_time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad_out, inp, grid, 0, 0, True, [True, False]))
        del grad_out, inp, x
        # The training step's offsets: the window path carries the corners.
        std = TRAIN_OFFSET_STD[cin]
        _, off_t, mask_t, _, _, _, _ = dcn_inputs(
            h, w, 8, stride, torch.float32, seed=60 + i, std=std)
        idx_t, cw_t = dcn.scatter_inputs(off_t, mask_t, h, w, stride=stride)
        tr = scatter_record(dcn_input_grad, dcn_input_grad_plain, idx_t,
                            cw_t, dcols, h, w, f"{name} N(0, {std}^2) px")
        worst = max(worst, tr["max_abs_err"])
        rec.update(shape=name, layers=layers, plain_ms=plain_ms,
                   library_ms=lib_ms, train_offsets_ms=tr["ms"],
                   train_offsets_bound_ms=tr["bound_ms"])
        log(f"[scatter] {name}: +-8 px {rec['ms']:.4f} ms, N(0, {std}^2) px "
            f"{tr['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
            f"grid_sampler_2d_backward {lib_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} / {tr['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {rec['bytes'] / rec['ms'] / 1e6:.1f} / "
            f"{tr['bytes'] / tr['ms'] / 1e6:.1f} GB/s achieved")
        records.append(rec)
        del idx, cw, dcols, idx_t, cw_t
    if cases:
        worst = max(worst, scatter_cases(dcn, dcn_input_grad,
                                         dcn_input_grad_plain))
    return records, worst, worst_cols, cols_train


# (what, batch, H, W, C, stride, offset spread in px, rows dropped from the
# end of each image). Rows dropped: R fits no 3x3 layout, so the plan cuts
# the rows into flat tiles, whose edges cut output rows and pixels.
SCATTER_CASES = [
    ("overflow, +-64 px: most corners leave every window",
     8, 80, 80, 128, 1, 64.0, 0),
    ("C=512 on a small map", 2, 12, 10, 512, 1, 0.5, 0),
    ("C=30, not a multiple of 4: scalar lanes", 2, 17, 23, 30, 1, 2.0, 0),
    ("C=7, stride 2: scalar lanes", 2, 17, 23, 7, 2, 0.5, 0),
    ("Wo=45: tiles across cut output rows", 2, 37, 45, 64, 1, 0.5, 0),
    ("rows in no 3x3 layout: flat tiles cut output rows", 2, 37, 45, 64, 1,
     0.5, 5),
]


def scatter_cases(dcn, dcn_input_grad, dcn_input_grad_plain):
    """The scatter against its plain version where its tiles and windows
    can go wrong (``SCATTER_CASES``); returns the worst error."""
    from planerecnet_tpu_torch.ops.dcn_scatter import scatter_plan
    worst, tol = 0.0, TOL[torch.float32]
    for i, (what, b, h, w, c, stride, spread, drop) in enumerate(
            SCATTER_CASES):
        _, off, mask, _, _, ho, wo = dcn_inputs(
            h, w, 4, stride, torch.float32, seed=80 + i, spread=spread,
            batch=b)
        idx, cw = dcn.scatter_inputs(off, mask, h, w, stride=stride)
        r = ho * wo * 9 - drop
        idx, cw = idx[:, :r].contiguous(), cw[:, :r].contiguous()
        g = torch.Generator(device="cuda").manual_seed(90 + i)
        dcols = torch.randn(b, r, c, device="cuda", generator=g)
        plan = scatter_plan(b, r, h, w, c)
        if drop and plan.period != r:
            raise AssertionError(f"{what}: expected flat tiles, got {plan}")
        got = dcn_input_grad(idx, cw, dcols, h, w)
        want = dcn_input_grad_plain(idx, cw, dcols, h, w)
        torch.cuda.synchronize()
        err, ok = close_err(got, want, tol)
        log(f"[scatter-case] {what} ({b}x{h}x{w}x{c}/s{stride}, R={r}, "
            f"{plan}): err {err:.3g} (tol {tol} of scale)")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"scatter disagrees with plain: {what}")
        worst = max(worst, err)
    return worst


# (what, batch, H, W, C, stride, offset spread in px): where the im2col's
# tiles and vectors can go wrong, each in f32 and bf16.
IM2COL_CASES = [
    ("ragged last tile (3x17x23 pixels)", 3, 17, 23, 128, 1, 2.0),
    ("C=30: no 16-byte vector in f32 or bf16", 2, 17, 23, 30, 2, 2.0),
    ("C=36: vectors in f32, not in bf16", 2, 9, 11, 36, 1, 3.0),
    ("C=514: scalar rows longer than the block", 2, 9, 11, 514, 2, 3.0),
]


def im2col_cases(dcn):
    """The im2col against its plain version at ``IM2COL_CASES``, f32 and
    bf16; returns the worst f32 error."""
    worst = 0.0
    for i, (what, b, h, w, c, stride, spread) in enumerate(IM2COL_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, _, _, _, _ = dcn_inputs(
                h, w, c, stride, dtype, seed=70 + i, spread=spread, batch=b)
            kw = dict(stride=stride, padding=1, kernel_size=3)
            got = dcn.deform_im2col(x, off, mask, **kw)
            want = dcn.deform_im2col_plain(x, off, mask, **kw)
            torch.cuda.synchronize()
            err, ok = close_err(got, want, TOL[dtype])
            log(f"[im2col-case] {what} {str(dtype)[6:]}: err {err:.3g} (tol "
                f"{TOL[dtype]} of scale)")
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"im2col disagrees with plain: {what} "
                                     f"{dtype}")
            if dtype == torch.float32:
                worst = max(worst, err)
    return worst


def dice_inputs(seed, b, p, k, n, hw, kind="onehot"):
    """Inputs of the fused dice/lava kernels. "onehot": a quarter of the
    slots invalid (all-zero one-hot rows), binary targets, as the training
    step gives them. "fractional": the general contract, a fractional
    ``onehot`` with several non-zero entries per row and fractional
    ``targets``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    kernels = torch.randn(b, p, k, **kw) * 0.2
    feat = torch.randn(b, hw, k, **kw) * 0.2
    if kind == "onehot":
        inst = torch.randint(0, n, (b, p), **kw)
        onehot = torch.nn.functional.one_hot(inst, n).float()
        onehot[:, ::4] = 0
        targets = (torch.rand(b, n, hw, **kw) > 0.5).float()
    else:
        onehot = (torch.rand(b, p, n, **kw)
                  * (torch.rand(b, p, n, **kw) > 0.5))
        targets = torch.rand(b, n, hw, **kw)
    grad = torch.rand(b, hw, **kw) * 1e-2
    gs = [torch.randn(b, p, **kw) for _ in range(3)]
    return (kernels, feat, onehot, targets, grad), gs


# Where the tiles can go wrong: each preset's K (pixel tiles 64 wide in the
# forward and 32 in the backward, 16 at K=256; the backward's dk and dm on
# wgmma below K=256, on mma.sync at it), P = 100 (< 128, not a multiple of
# 64), HW = 2381 (not a multiple of any tile), the general contract
# (fractional, multi-entry one-hot rows, fractional targets), N = 63 (the
# most one launch takes), N = 100 and 130 (two and three launches), and
# at K = 256 an HW whose blocks run across an image boundary and past the
# 16-tile dk flush (the training shape does so at K = 128).
DICE_CASES = [
    dict(b=2, p=100, k=32, n=4, hw=2381, kind="fractional"),
    dict(b=2, p=100, k=128, n=32, hw=2381, kind="fractional"),
    dict(b=2, p=100, k=256, n=32, hw=2381, kind="fractional"),
    dict(b=2, p=128, k=256, n=32, hw=1000, kind="onehot"),
    dict(b=2, p=128, k=256, n=32, hw=25600, kind="onehot"),
    dict(b=3, p=16, k=128, n=63, hw=333, kind="fractional"),
    dict(b=2, p=100, k=256, n=63, hw=555, kind="fractional"),
    dict(b=2, p=100, k=32, n=100, hw=2381, kind="fractional"),
    dict(b=2, p=100, k=128, n=130, hw=2381, kind="fractional"),
    dict(b=2, p=100, k=256, n=100, hw=555, kind="fractional"),
]


def dice_errors(dl, ins, gs, what, worst):
    """Both kernels against their plain versions; raises past f32 TOL.
    Folds the largest errors into ``worst`` (by kernel: fwd, bwd)."""
    got = dl.dice_lava_fwd(*ins)
    want = dl.fused_dice_lava_plain(*ins)
    got_b = dl.dice_lava_bwd(*ins, *gs)
    want_b = dl.fused_dice_lava_bwd_plain(*ins, *gs)
    torch.cuda.synchronize()
    tol = TOL[torch.float32]
    errs, used = {}, {}
    for name, g, w in zip(("a", "b", "lava", "dk", "dm"), (*got, *got_b),
                          (*want, *want_b)):
        errs[name], ok = close_err(g, w, tol)
        # The share of its allowance the worst element uses (1 = at TOL).
        used[name] = float(((g - w).abs() / (tol * (w.abs().max() + w.abs())
                                             + 1e-30)).max())
        if not ok or not torch.isfinite(g).all():
            raise AssertionError(f"dice_lava {name} disagrees with plain at "
                                 f"{what}: {errs[name]}")
    log(f"[dice] {what}: errors against plain {json.dumps(errs)} (tol {tol} "
        f"of scale); share of the allowance used "
        f"{json.dumps({k: round(v, 3) for k, v in used.items()})}")
    worst["fwd"] = max(worst["fwd"], errs["a"], errs["b"], errs["lava"])
    worst["bwd"] = max(worst["bwd"], errs["dk"], errs["dm"])


def phase_dice(cases=DICE_CASES):
    """The fused dice/lava forward and backward kernels against their plain
    versions at every case of ``cases`` and at the training shapes of
    PRN-50 and of the base preset, where they are timed. Returns PRN-50's
    records, with the worst error of every case."""
    from planerecnet_tpu_torch.ops import dice_lava as dl
    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, case in enumerate(cases):
        ins, gs = dice_inputs(51 + i, **case)
        dice_errors(dl, ins, gs, f"{case}", worst)
    time_dice(dl, DICE_BASE, seed=49, worst=worst)
    return time_dice(dl, DICE, seed=50, worst=worst)


def time_dice(dl, d, seed, worst):
    """Both kernels at shape ``d`` against their plain versions, then
    timed beside them. No single PyTorch call computes either function, so
    there is no library yardstick. Two bounds: the products at the 3xTF32
    tensor-core rate (the units they run on) and at the f32 rate."""
    ins, gs = dice_inputs(seed, **d)
    dice_errors(dl, ins, gs, f"training shape {d}", worst)
    pq = d["b"] * d["p"] * d["hw"]
    in_bytes = 4 * sum(t.numel() for t in ins)
    out = {}
    for name, fn, plain, flops, out_bytes in (
            ("fwd", lambda: dl.dice_lava_fwd(*ins),
             lambda: dl.fused_dice_lava_plain(*ins),
             2 * pq * (d["k"] + d["n"]), 4 * 3 * d["b"] * d["p"]),
            ("bwd", lambda: dl.dice_lava_bwd(*ins, *gs),
             lambda: dl.fused_dice_lava_bwd_plain(*ins, *gs),
             2 * pq * (d["k"] + d["n"]) + 2 * 2 * pq * d["k"],
             4 * (d["b"] * d["p"] * d["k"] + d["b"] * d["hw"] * d["k"]))):
        ms = cuda_time_ms(fn, iters=10)
        plain_ms = cuda_time_ms(plain, iters=5)
        extra = 4 * 3 * d["b"] * d["p"] if name == "bwd" else 0
        nbytes = in_bytes + extra + out_bytes
        b_ms, b_by = bound(nbytes, flops, TF32X3_FLOPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                         bound_f32_by=f32_by, flops=flops,
                         max_abs_err=worst[name])
        log(f"[dice] {name} {d}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms at 3xTF32 ({b_by}), {f32_ms:.4f} ms at "
            f"f32 ({f32_by}); {flops / 1e9:.2f} GFLOP, "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved; "
            f"max err {out[name]['max_abs_err']:.3g}")
    return out


def phase_dcn_grads():
    """The DCN Function's gradients on the card against torch.autograd of
    the plain forward: offsets crossing the border, and at integer sample
    positions (corners of weight 0 with a non-zero offset derivative)."""
    from planerecnet_tpu_torch.ops import dcn
    worst = 0.0
    for stride in (1, 2):
        for kind in ("fractional", "integer"):
            g = torch.Generator(device="cuda").manual_seed(60 + stride)
            kw = dict(device="cuda", generator=g)
            x = torch.randn(2, 9, 11, 16, **kw)
            ho, wo = (9 - 1) // stride + 1, (11 - 1) // stride + 1
            off = (torch.rand(2, ho, wo, 18, **kw) - 0.5) * 6
            if kind == "integer":
                off = off.round()
            mask = torch.rand(2, ho, wo, 9, **kw) * 2
            wt = torch.randn(3, 3, 16, 8, **kw) * 0.2
            bias = torch.randn(8, **kw)
            cot = torch.randn(2, ho, wo, 8, **kw)
            geom = dict(stride=stride, padding=1, kernel_size=3)

            def grads(fn):
                args = [t.clone().requires_grad_(True)
                        for t in (x, off, mask, wt, bias)]
                (fn(*args) * cot).sum().backward()
                return [a.grad for a in args]

            got = grads(lambda *a: dcn.deform_conv2d(*a, **geom))
            want = grads(lambda xx, o, m, ww, bb: (
                dcn.deform_im2col_plain(xx, o, m, **geom)
                @ ww.reshape(-1, 8) + bb).reshape(2, ho, wo, 8))
            for name, a, b in zip(("x", "offset", "mask", "weight", "bias"),
                                  got, want):
                e, ok = close_err(a, b, 1e-5)
                if not ok or float(a.abs().max()) == 0:
                    raise AssertionError(f"DCN d{name} on the card: err {e}, "
                                         f"max {float(a.abs().max())}")
                worst = max(worst, e)
    log(f"[dcn-grad] x, offset, mask, weight, bias gradients agree with "
        f"autograd of the plain forward, stride 1 and 2, fractional and "
        f"integer offsets: worst err {worst:.3g} (tol 1e-5 of scale)")
    return worst


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


# Raw predictions, CPU against card: f32 on both, summed in other orders
# (~1e-5 of scale measured); 1e-3 leaves room for rounding that the 13 DCN
# layers' offset paths amplify.
RAW_TOL = 1e-3
CPU_VS_GPU_FRAMES = (99, 100, 101)   # frame seeds
# The soft masks' margin carries this frame's measured raw errors times
# this factor: the card's ``infer`` normalises the frame itself, so its raw
# outputs differ from the measured ones by that rounding too, and its mask
# product, sigmoid and resize round on their own.
MARGIN_FACTOR = 10


def soft_change_bound(kernels, feat, kernel_err, feat_err):
    """How far sigmoid(kernels @ feat^T) can move, per (detection, pixel),
    when every element of kernels moves by at most ``kernel_err`` (per
    detection) and every element of feat by at most ``feat_err``: the
    logit by at most sum (|k| + a)(|f| + b) - |k||f| with a and b those
    errors, the sigmoid by a quarter of that. Float64."""
    k = kernels.double().abs()
    f = feat.double().abs()
    a = kernel_err.double()[:, None]
    b = float(feat_err)
    return ((k + a) @ (f + b).T - k @ f.T) / 4


def near_threshold_flips(got, want, soft, margin, thr):
    """Pixels where the card's and the CPU's binary masks differ, told apart
    by the CPU's soft value: within ``margin`` of ``thr`` rounding may flip
    the pixel, outside it only a fault can. Returns the counts and the
    largest distance from ``thr`` of a differing pixel."""
    diff = got != want
    dist = (soft - thr).abs()
    near = dist <= margin
    return {"differing": int(diff.sum()),
            "near_threshold": int((diff & near).sum()),
            "outside_margin": int((diff & ~near).sum()),
            "pixels_within_margin": int(near.sum()),
            "max_distance": float(dist[diff].max()) if diff.any() else 0.0,
            "max_margin": float(margin.max()) if margin.numel() else 0.0}


def soft_masks_and_margin(raw, cfg, size, errs):
    """Image 0 of a CPU raw-pred dict: the resized soft masks of the
    detections the post-processing keeps (the port's ``select_masks``, as
    ``infer`` runs it) and, per pixel, the margin within which the raw
    errors ``errs`` ({"kernel_preds[i]": max abs error of level i,
    "mask_pred[0]": that of the mask features}) times MARGIN_FACTOR can
    move them (``soft_change_bound`` resized the same way, its weights
    being non-negative, plus 1e-6 for the two devices' own f32 rounding of
    the sigmoid and the resize)."""
    from planerecnet_tpu_torch.ops.image import resize_bilinear
    from planerecnet_tpu_torch.ops.postprocess import (flatten_level_preds,
                                                       select_masks)
    sv = cfg.solov2
    nk = sv.num_kernels
    cates, kernels = flatten_level_preds(raw["cate_preds"],
                                         raw["kernel_preds"],
                                         cfg.num_classes, nk)
    feat = raw["mask_pred"][0]
    hm, wm, _ = feat.shape
    _, _, cells, seg_sig, valid, _ = select_masks(
        cates[0], kernels[0], feat, cfg, len(raw["cate_preds"]))
    level_err = MARGIN_FACTOR * torch.cat([
        torch.full((kp[0].numel() // nk,), errs[f"kernel_preds[{i}]"])
        for i, kp in enumerate(raw["kernel_preds"])])
    bound = soft_change_bound(kernels[0][cells], feat.reshape(-1, nk),
                              level_err[cells],
                              MARGIN_FACTOR * errs["mask_pred[0]"])
    soft = resize_bilinear(seg_sig.reshape(-1, 1, hm, wm), size)[:, 0]
    margin = resize_bilinear(bound.float().reshape(-1, 1, hm, wm),
                             size)[:, 0] + 1e-6
    return soft, margin, valid


def phase_cpu_vs_gpu(runner, cfg):
    """Three 256x320 frames through the CPU (plain) and card (kernel) paths
    with the same weights, TF32 off; thresholds lowered so that detections
    exist to compare. A mask pixel may differ only where the CPU's soft
    value lies within the margin of ``mask_thr`` that this frame's raw
    errors, times MARGIN_FACTOR, allow (``soft_masks_and_margin``); any
    other differing pixel fails."""
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    low = cfg.copy(dict(solov2=cfg.solov2.copy(dict(score_thr=0.003,
                                                    update_thr=0.003))))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = runner.model.state_dict()
    gpu = PlaneRecNetRunner(low, device="cuda")
    gpu.model.load_state_dict(weights)
    cpu = PlaneRecNetRunner(low, device="cpu")
    cpu.model.load_state_dict(weights)
    for seed in CPU_VS_GPU_FRAMES:
        x = frames(1, 256, 320, seed=seed)
        t0 = time.perf_counter()
        want = cpu.infer(x)
        cpu_s = time.perf_counter() - t0
        got = {k: v.cpu() for k, v in gpu.infer(x).items()}
        normalised = fast_base_transform(torch.from_numpy(x))
        raw_w = cpu.forward_raw(normalised)
        raw_g = gpu.forward_raw(normalised)
        errs = {}
        for key in ("cate_preds", "kernel_preds", "mask_pred", "depth_pred"):
            a = raw_g[key] if isinstance(raw_g[key], list) else [raw_g[key]]
            b = raw_w[key] if isinstance(raw_w[key], list) else [raw_w[key]]
            for i, (g, w) in enumerate(zip(a, b)):
                e, ok = close_err(g.cpu(), w, RAW_TOL)
                errs[f"{key}[{i}]"] = e
                if not ok:
                    raise AssertionError(f"frame {seed}: raw {key}[{i}] CPU "
                                         f"vs GPU err {e}")
        e_depth, ok = close_err(got["pred_depth"], want["pred_depth"], 1e-3)
        if not ok:
            raise AssertionError(f"frame {seed}: pred_depth CPU vs GPU err "
                                 f"{e_depth}")
        if not torch.equal(got["pred_valid"], want["pred_valid"]):
            raise AssertionError(f"frame {seed}: pred_valid differs between "
                                 f"CPU and GPU")
        valid = want["pred_valid"]
        if int(valid.sum()) == 0:
            raise AssertionError(f"frame {seed}: no valid detection to "
                                 f"compare")
        e_scores, ok = close_err(got["pred_scores"], want["pred_scores"],
                                 1e-3)
        if not ok:
            raise AssertionError(f"frame {seed}: pred_scores CPU vs GPU err "
                                 f"{e_scores}")
        if not torch.equal(got["pred_classes"][valid],
                           want["pred_classes"][valid]):
            raise AssertionError(f"frame {seed}: pred_classes differ between "
                                 f"CPU and GPU")
        soft, margin, kept = soft_masks_and_margin(raw_w, low, (256, 320),
                                                   errs)
        if not torch.equal(kept, valid[0]):
            raise AssertionError(f"frame {seed}: the recomputed detections "
                                 f"are not the CPU's")
        v = valid[0]
        count = near_threshold_flips(got["pred_masks"][0][v],
                                     want["pred_masks"][0][v], soft[v],
                                     margin[v], low.solov2.mask_thr)
        frac = count["differing"] / max(1, int(v.sum()) * 256 * 320)
        log(f"[cpu-vs-gpu] frame {seed}, 1x256x320, TF32 off: CPU "
            f"{cpu_s:.1f} s; {int(valid.sum())} valid detections agree; "
            f"depth err {e_depth:.3g}, score err {e_scores:.3g}; mask pixels "
            f"differing {count['differing']} ({frac:.2e}), near-threshold "
            f"flips (within the margin of mask_thr) "
            f"{count['near_threshold']}, outside the margin "
            f"{count['outside_margin']}; largest distance of a differing "
            f"pixel's CPU soft value from mask_thr "
            f"{count['max_distance']:.3g} (margin up to "
            f"{count['max_margin']:.3g}; {count['pixels_within_margin']} "
            f"pixels within it); raw errs {json.dumps(errs)}")
        if count["outside_margin"]:
            raise AssertionError(f"frame {seed}: {count['outside_margin']} "
                                 f"mask pixels differ outside the rounding "
                                 f"margin of mask_thr")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


def synthetic_batch(b, size, n_cap, seed):
    """A fixed training batch in the JAX package's layout, made with numpy
    from ``seed``: per image 3 to 5 axis-aligned rectangles as plane masks
    (later ones drawn over earlier ones), their boxes, unit plane normals
    facing the camera, and the depth of those planes (a tilted background
    plane elsewhere) under a pinhole camera with f = size * 0.8."""
    rng = np.random.RandomState(seed)
    f, c = size * 0.8, size / 2
    k = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)
    vv, uu = np.mgrid[0:size, 0:size].astype(np.float64)
    rays = np.stack([(uu - c) / f, (vv - c) / f, np.ones_like(uu)], -1)
    batch = {"image": rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8),
             "depth": np.zeros((b, size, size, 1), np.float32),
             "masks": np.zeros((b, n_cap, size, size), np.uint8),
             "boxes": np.zeros((b, n_cap, 4), np.float32),
             "classes": np.zeros((b, n_cap), np.int32),
             "gt_valid": np.zeros((b, n_cap), bool),
             "plane_paras": np.zeros((b, n_cap, 4), np.float32),
             "k_matrix": np.tile(k, (b, 1, 1))}
    for i in range(b):
        depth = 4.0 + 0.5 * rays[..., 0]             # background
        for j in range(min(rng.randint(3, 6), n_cap)):
            y0, x0 = rng.randint(0, size * 3 // 4, 2)
            hh, ww = rng.randint(size // 8, size // 3, 2)
            y1, x1 = min(size, y0 + hh), min(size, x0 + ww)
            normal = rng.randn(3) * [0.3, 0.3, 0.0] + [0.0, 0.0, -1.0]
            normal /= np.linalg.norm(normal)
            dist = rng.uniform(1.0, 3.0)
            region = np.zeros((size, size), bool)
            region[y0:y1, x0:x1] = True
            # n . X = -dist with X = depth * ray, on the rectangle.
            depth[region] = -dist / (rays[region] @ normal)
            batch["masks"][i, :j][:, region] = 0
            batch["masks"][i, j][region] = 1
            batch["boxes"][i, j] = [x0, y0, x1, y1]
            batch["classes"][i, j] = 1
            batch["gt_valid"][i, j] = True
            batch["plane_paras"][i, j] = [*normal, dist]
        batch["depth"][i, ..., 0] = np.clip(depth, 0.3, 20.0)
    return batch


def offset_spread(model, step):
    """Runs ``step`` once with a hook on every DCN offset conv of
    ``model``; returns, by the convs' input width, the offsets' std and
    the 50th, 95th and 99th percentiles and the max of |offset| in px, and
    the share of offsets at one pixel or more."""
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if name.endswith("offset_conv"):
            hooks.append(m.register_forward_hook(
                lambda mod, _, out: seen.setdefault(mod.in_channels, []).append(
                    out.detach().float().flatten())))
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for width, parts in sorted(seen.items()):
        o = torch.cat(parts)
        a = o.abs()
        q = torch.quantile(a, torch.tensor([0.5, 0.95, 0.99],
                                           device=a.device))
        out[width] = {"std": round(float(o.std()), 4),
                      "p50": round(float(q[0]), 4),
                      "p95": round(float(q[1]), 4),
                      "p99": round(float(q[2]), 4),
                      "max": round(float(a.max()), 4),
                      "share_ge_1px": round(float((a >= 1).float().mean()), 5)}
    return out


def phase_train(cfg, card):
    """The training main path: PRN-50 at batch 8, 640x640, f32, all five
    losses, seeded perturbed weights, one fixed batch. Returns the state,
    the batch and the launch counts of the timed steps."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.ops import dcn, dcn_scatter, dice_lava
    counters = {"dcn_im2col": dcn.deform_im2col,
                "dcn_scatter": dcn_scatter.dcn_input_grad,
                "dice_lava_fwd": dice_lava.dice_lava_fwd,
                "dice_lava_bwd": dice_lava.dice_lava_bwd}
    per_step = {"dcn_im2col": 2 * DCN_LAYERS_PRN50,
                "dcn_scatter": DCN_LAYERS_PRN50,
                "dice_lava_fwd": DICE_LEVELS, "dice_lava_bwd": DICE_LEVELS}
    state = trainer.create_train_state(cfg, seed=0, device="cuda")
    perturb_(state.model, seed=1)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    batch = synthetic_batch(BATCH, TRAIN_SIZE, cfg.max_instances, seed=3)
    first = trainer.train_step(state, batch)                     # warm-up
    totals = [float(first["total"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(losses["total"]))
        for key, v in losses.items():
            if not torch.isfinite(v):
                raise AssertionError(f"training loss {key} is {float(v)}")
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, n in launches.items():
        if n != per_step[k] * TIMED_STEPS:
            raise AssertionError(f"{k}: {n} launches in {TIMED_STEPS} steps, "
                                 f"expected {per_step[k]} per step")
    spread = offset_spread(state.model, lambda: totals.append(
        float(trainer.train_step(state, batch)["total"])))
    log(f"[train] DCN offsets of one step in px, by input width: "
        f"{json.dumps(spread)}; the scatter's training-offsets case draws "
        f"N(0, std^2) with std {json.dumps(TRAIN_OFFSET_STD)}")
    for _ in range(TRAIN_STEPS - 2 - TIMED_STEPS):
        totals.append(float(trainer.train_step(state, batch)["total"]))
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(state.model.parameters(), p0))
    if not all(np.isfinite(totals)) or moved == 0:
        raise AssertionError(f"training: totals {totals}, moved {moved}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the loss did not fall: {totals}")
    ms = float(np.median(times))
    log(f"[train] PRN-50 {BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE} f32, all five "
        f"losses: per step {[round(t, 3) for t in times]} ms; median "
        f"{ms:.3f} ms/step, {BATCH / ms * 1e3:.2f} img/s; peak memory "
        f"{peak:.2f} GiB; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32},"
        f" matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; {card}")
    for when, ls in (("first", first), ("last timed", losses)):
        log(f"[train] losses of the {when} step "
            f"{json.dumps({k: float(v) for k, v in ls.items()})}")
    log(f"[train] total loss over {len(totals)} steps "
        f"{[round(t, 4) for t in totals]}; largest weight change {moved:.3g}")
    log(f"[train] launches over {TIMED_STEPS} steps {json.dumps(launches)}")
    return state, batch, launches, ms, peak


def phase_train_cpu_vs_gpu():
    """One step of the tiny preset on the same weights, batch and VNL
    indices, on the CPU (plain versions) and on the card (kernels), TF32
    off: the losses and the gradients in the JAX layout."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config
    from planerecnet_tpu_torch.losses import sample_vnl_indices
    from planerecnet_tpu_torch.utils.weights import to_jax_variables
    cfg = PlaneRecNet_tiny_config.copy(dict(freeze_bn=True))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(2, 128, cfg.max_instances, seed=5)
    masks = torch.from_numpy(batch["masks"]).bool()
    valid = torch.from_numpy(batch["gt_valid"])
    order = torch.argsort((~valid).int(), dim=1, stable=True)
    idx = sample_vnl_indices(
        torch.Generator().manual_seed(6),
        masks[torch.arange(2)[:, None], order[:, :cfg.vnl_max_planes]],
        (~(masks & valid[:, :, None, None]).any(1)).reshape(2, -1),
        cfg.vnl_samples)
    out = {}
    for device in ("cpu", "cuda"):
        state = trainer.create_train_state(cfg, seed=7, device=device)
        perturb_(state.model, seed=8, offset_std=0.1)
        losses, _ = trainer.grad_step(
            state, batch, {k: v.to(device) for k, v in idx.items()})
        out[device] = ({k: float(v) for k, v in losses.items()},
                       to_jax_variables({n: p.grad for n, p in
                                         state.model.named_parameters()}))
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    for key in lc:
        if abs(lc[key] - lg[key]) > 1e-4 * abs(lc[key]) + 1e-6:
            raise AssertionError(f"training loss {key}: CPU {lc[key]}, "
                                 f"GPU {lg[key]}")
    errs = sorted(float(np.abs(gg[k] - v).max() / max(np.abs(v).max(), 1e-12))
                  for k, v in gc.items() if np.abs(v).max() > 1e-6)
    # f32 on both, summed in other orders (cuDNN against oneDNN
    # convolutions, atomics in the scatter and dice kernels). The leaves'
    # errors spread (1.3e-3 the largest measured on an H100): a ReLU input
    # within rounding of 0 may flip on one device. Every leaf, the DCN
    # offset and modulator convs among them, is held at 1e-2 of its scale.
    med, p95 = float(np.median(errs)), float(np.quantile(errs, 0.95))
    if med > 1e-4 or p95 > 1e-3 or errs[-1] > 1e-2:
        raise AssertionError(f"gradients CPU vs GPU: median {med}, 95th "
                             f"percentile {p95}, max {errs[-1]} of the leaf "
                             f"scale")
    log(f"[train-cpu-vs-gpu] tiny preset, 2x128x128, TF32 off: losses "
        f"agree {json.dumps({k: [lc[k], lg[k]] for k in lc})}; gradients "
        f"of {len(errs)} leaves: median err {med:.3g}, 95th percentile "
        f"{p95:.3g}, max {errs[-1]:.3g} of the leaf scale")


def phase_profile(runner, out_dir):
    """Where one request's time goes: host-clocked stages, then a
    ``torch.profiler`` trace of two requests (device time by kernel, the
    device's busy share of the wall time)."""
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
    profile_table(prof, n, "requests", out_dir, "request", wall_ms)


def profile_table(prof, n, what, out_dir, stem, wall_ms):
    """Print and save the device time by kernel of ``n`` profiled runs."""
    import os
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log(f"[profile] the profiler recorded no device time for {what}")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"kernel": e.key[:90], "calls": e.count // n,
             f"ms_per_{stem}": e.self_device_time_total / 1e3 / n,
             "share": e.self_device_time_total / 1e3 / busy_ms}
            for e in kernels]
    log(f"[profile] {n} {what}: wall {wall_ms / n:.3f} ms/{stem}, device "
        f"busy {busy_ms / n:.3f} ms/{stem}, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for r in rows[:30]:
        log(f"[profile] {r[f'ms_per_{stem}']:9.3f} ms {r['share']:6.1%} "
            f"x{r['calls']:<4d} {r['kernel']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{stem}_kernels.json"), "w") as f:
        json.dump({f"wall_ms_per_{stem}": wall_ms / n,
                   f"busy_ms_per_{stem}": busy_ms / n, "kernels": rows}, f,
                  indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{stem}.json"))


def phase_profile_train(state, batch, out_dir):
    """Host-clocked stages of one training step, then a ``torch.profiler``
    trace of two steps."""
    from torch.profiler import ProfilerActivity, profile
    from planerecnet_tpu_torch import trainer
    stages = {"unpack": [], "forward+loss": [], "backward": [], "adam": []}
    for _ in range(3):
        t0 = time.perf_counter()
        dense = trainer.unpack_wire_batch(state.cfg, batch, state.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        saved = [b.clone() for b in trainer._bn_buffers(state.model)]
        state.optimizer.zero_grad(set_to_none=True)
        preds = state.model(dense["image"])
        losses = trainer.compute_losses(state.cfg, preds, dense,
                                        generator=state.generator())
        total = sum(losses.values())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trainer.apply_grads(state, total.detach(), saved)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    log("[profile] training step, host-clocked stages, ms (median of 3): "
        + json.dumps({k: float(np.median(v)) for k, v in stages.items()}))
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_table(prof, n, "training steps", out_dir, "step", wall_ms)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.ops import dcn

    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--dice" in sys.argv:
        phase_dice(cases=())
        return 0
    cases = "--dcn" not in sys.argv
    records, worst = phase_kernel(dcn)
    scatter, scatter_err, cols_err_train, cols_train = phase_scatter(cases)

    def total(recs, key):
        return sum(r[key] * r["layers"] for r in recs)

    log(f"[dcn] {card}: im2col {total(records, 'ms'):.4f} ms/request "
        f"(bound {total(records, 'bound_ms'):.4f}, grid_sample "
        f"{total(records, 'library_ms'):.4f}), "
        f"{total(cols_train, 'ms'):.4f} ms/step (bound "
        f"{total(cols_train, 'bound_ms'):.4f}, grid_sample "
        f"{total(cols_train, 'library_ms'):.4f}); scatter "
        f"{total(scatter, 'ms'):.4f} ms/step at +-8 px (bound "
        f"{total(scatter, 'bound_ms'):.4f}, grid_sampler_2d_backward "
        f"{total(scatter, 'library_ms'):.4f}), "
        f"{total(scatter, 'train_offsets_ms'):.4f} at the training step's "
        f"offsets (bound {total(scatter, 'train_offsets_bound_ms'):.4f})")
    if not cases:
        return 0
    worst = max(worst, im2col_cases(dcn))
    dice = phase_dice()
    phase_dcn_grads()
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    runner, infer_launches, _ = phase_main(dcn, PlaneRecNet_50_config, card)
    phase_cpu_vs_gpu(runner, PlaneRecNet_50_config)
    del runner
    # The preset's schedule without its 2000-update warm-up, so that 20
    # steps on one batch show the loss falling.
    train_cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0))
    state, batch, launches, _, _ = phase_train(train_cfg, card)
    phase_train_cpu_vs_gpu()
    if "--profile" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--profile") + 1]
        phase_profile_train(state, batch, out_dir)
        from planerecnet_tpu_torch.runner import PlaneRecNetRunner
        runner = PlaneRecNetRunner(PlaneRecNet_50_config, device="cuda")
        perturb_(runner.model, seed=1)
        phase_profile(runner, out_dir)

    def bound_by(recs):
        return ("bytes" if all(r["bound_by"] == "bytes" for r in recs)
                else "operations")

    train_per = (f"one training step of PRN-50 at batch {BATCH}, "
                 f"{TRAIN_SIZE}x{TRAIN_SIZE}, f32")
    dice_rows = [{
        "name": f"dice_lava_{d}",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dice_lava.cu",
        "replaces": ("planerecnet_tpu/ops/pallas/dice_lava.py:158 "
                     "(_fused_fwd_impl, kernel _fwd_kernel :49)"
                     if d == "fwd" else
                     "planerecnet_tpu/ops/pallas/dice_lava.py:203 "
                     "(_fused_bwd, kernel _bwd_kernel :80)"),
        "launches": launches[f"dice_lava_{d}"],
        "max_abs_err": dice[d]["max_abs_err"],
        "ms": DICE_LEVELS * dice[d]["ms"],
        "plain_ms": DICE_LEVELS * dice[d]["plain_ms"],
        "bound_ms": DICE_LEVELS * dice[d]["bound_ms"],
        "bound_by": dice[d]["bound_by"],
        "bound_f32_ms": DICE_LEVELS * dice[d]["bound_f32_ms"],
        "bound_rates": "bound_ms: the products at the 3xTF32 tensor-core "
                       "rate (495/3 TFLOP/s), the units they run on; "
                       "bound_f32_ms: at the f32 rate (67 TFLOP/s)",
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "per": f"{train_per}: {DICE_LEVELS} launches at {DICE}",
        "card": card,
    } for d in ("fwd", "bwd")]
    print(json.dumps({"kernels": [{
        "name": "dcn_im2col",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_im2col.cu",
        "replaces": "planerecnet_tpu/ops/dcn.py:544 (deform_conv2d; "
                    "sampling at :212-242, modulation at :311-316)",
        "launches": launches["dcn_im2col"],
        "launches_by_path": {"infer": infer_launches,
                             "train": launches["dcn_im2col"]},
        "max_abs_err": max(worst, cols_err_train),
        "ms": total(records, "ms"),
        "plain_ms": total(records, "plain_ms"),
        "bound_ms": total(records, "bound_ms"),
        "bound_by": bound_by(records),
        "library_ms": total(records, "library_ms"),
        "train_step_ms": total(cols_train, "ms"),
        "train_step_bound_ms": total(cols_train, "bound_ms"),
        "train_step_library_ms": total(cols_train, "library_ms"),
        "per": f"times: one request, the {DCN_LAYERS_PRN50} PRN-50 DCN "
               f"layers at batch {BATCH}, {HEIGHT}x{WIDTH}, f32; train_step_*: "
               f"the {2 * DCN_LAYERS_PRN50} launches of {train_per}; launches: "
               f"{TIMED_STEPS} training steps (and {REQUESTS} requests)",
        "card": card,
    }, {
        "name": "dcn_scatter",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_scatter.cu",
        "replaces": "planerecnet_tpu/ops/pallas/dcn_scatter.py:117 "
                    "(dcn_input_grad_pallas, kernel _make_kernel :43)",
        "launches": launches["dcn_scatter"],
        "max_abs_err": scatter_err,
        "ms": total(scatter, "ms"),
        "plain_ms": total(scatter, "plain_ms"),
        "bound_ms": total(scatter, "bound_ms"),
        "bound_by": bound_by(scatter),
        "library_ms": total(scatter, "library_ms"),
        "library": "torch.ops.aten.grid_sampler_2d_backward (bilinear, "
                   "zeros, align_corners=True, input gradient only)",
        "train_offsets_ms": total(scatter, "train_offsets_ms"),
        "train_offsets_bound_ms": total(scatter, "train_offsets_bound_ms"),
        "per": f"{train_per}: its {DCN_LAYERS_PRN50} DCN layers; ms, "
               f"bound_ms at offsets of +-8 px, train_offsets_* at "
               f"N(0, std^2) px, std {TRAIN_OFFSET_STD} by input width",
        "card": card,
    }, *dice_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
