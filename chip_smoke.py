"""Drive the PyTorch port's inference and training paths on one CUDA card
(and, with ``--nccl``, on the 4 cards of one host).

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --dice
    python3 chip_smoke.py --dcn
    python3 chip_smoke.py --paths
    python3 chip_smoke.py --spatial
    python3 chip_smoke.py --tools
    python3 chip_smoke.py --nccl            # on a host with 4 cards

``--dice`` runs phases 1, 2 and the timed dice/lava shapes of 4 alone and
prints no result line; ``--dcn`` runs phases 1, 2, the im2col's serving
shapes of 3 and the training shapes of 4 (im2col and scatter, timed beside
their bounds and library calls) alone and prints no result line; both
time each deterministic variant beside its atomic kernel. They time the
kernels of the package beside the script, so that two trees' kernels can
be compared on one card. ``--paths`` times phase 5's request and phase 7's
default training step alone (no build phase, no launch checks: it calls
only ``PlaneRecNetRunner.infer`` and ``trainer.train_step``, so it runs on
the trees of earlier slices too) and prints no result line.
``--spatial`` runs phases 1, 2, the spatial windows of 4, 15 and 16
alone and prints no result line. ``--spatial_rank DIR [SPEC]`` is one
rank of phases 15-16, which launch it (SPEC: ``SP_SPEC``'s fields as
JSON). ``--nccl`` runs phases 1, 2 and the data and spatial axes over
NCCL, one rank a card, on a host with 4 cards (``phase_nccl``; it
fails on fewer) and prints ``[nccl]`` lines and no result line;
``--step_rank DIR`` is one rank of its timed steps. ``--tools`` runs
phases 1, 2, 5 (for the
request times that phase 18 checks against) and 18, on a tree of 8
training frames of its own, and prints no result line.

1. device: each visible card's name and power limit (nvidia-smi).
2. build: one ``nvcc`` per source in ``planerecnet_tpu_torch/csrc/``
   (dcn_im2col, dcn_scatter, dice_lava), all started together, for sm_90a
   into ``planerecnet_tpu_torch/_build/`` (dice_lava afresh even where it
   is built, for ptxas's report); fails if that report lacks one of the 12
   dice/lava kernels or gives one more bytes of spill stores than
   ``DICE_SPILL_LIMITS`` records.
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
   shape. Every scatter and dice/lava check also runs the kernel's
   deterministic variant (``deterministic=True``, what
   ``--reproductablity`` trains with): two launches on the same inputs
   must give the same bits and agree with the plain version at the same
   tolerance, the dice/lava variants' also with their persistent grid
   sized for a card of 114 SMs (``OTHER_SMS``), the scatter's with the
   CPU plain version in every bit at the six training shapes (both
   offsets), every edge case, a pile-up of every row on one patch (its
   tiles summed in rounds) and the spatial windows; each is timed beside
   its atomic kernel. Last,
   ``ops/image.py::reflect_pad`` under ``--reproductablity``'s switches
   against ``F.pad(mode="reflect")`` on the CPU: values and gradients in
   every bit. Then the im2col (f32 and bf16) and the scatter (atomic and
   deterministic) at the windows that phases 15-16 give them on 2 ranks:
   each rank's output rows of every DCN layer whose output splits, from
   its first row ``row0``, over the whole input, at the requests' and the
   step's shapes (``spatial_window_cases``).
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
   backward's unmodulated samples), 13 (scatter), 4 and 4 (dice/lava),
   and the deterministic variants' not at all.
   One untimed step logs the spread of the DCN layers' offsets.
8. training CPU against GPU: one step of the tiny preset on the same
   weights, batch and VNL indices on both devices, TF32 off.
9. the CLI path: a synthetic ScanNet tree (24 train, 8 valid, 8 eval
   images at 480x640, seed 0) written by the port's ``synth_scenes``;
   ``planerecnet_tpu_torch.train.main`` trains PRN-50 on it on one card
   (``--n_devices 1``, whatever the host has; batch 8,
   max_size 640, f32, ``--reproductablity``) for 12 steps and saves, then
   trains the same 12 steps again from scratch into another folder, then
   resumes the first run from ``latest`` for 4 more without the flag, as
   users train by default; every step must launch the im2col 26 times,
   each step with the flag the deterministic variants 13/4/4 (the atomic
   kernels never), each resumed step the atomic kernels 13/4/4 (the
   variants never), every loss be finite, the resume start at 12,
   the first 3 batches reach the card with their host checksums, and the
   two 12-step runs give the same losses and checkpoints whose arrays
   agree in every bit. Logged: ms/step through the CLI beside the same
   batch stepped in memory, by default and with ``--reproductablity``'s
   switches and variants, and phase 7's step, the loader's occupancy, the
   host's ms a batch to read, augment and collate.
   ``planerecnet_tpu_torch.eval.main`` then scores the resumed checkpoint
   on the 8 eval images at batch 8 three times: device metrics (its first
   calls), host metrics, device metrics (timed), and each of the two
   12-step checkpoints: 13 im2col launches a request, identical tables and
   depth metrics, the two reproducible runs' too. Last, the checkpoint's
   DCN offsets by layer width.
10. entry points, PRN-50 at 480x640: ``torch.save`` of seeded weights
   loaded back through ``runner.load_weights(".pth")`` gives a
   bit-identical ``infer``; ``python -m
   planerecnet_tpu_torch.simple_inference --image`` on a PNG frame writes
   a seg PNG equal to ``runner.infer``'s masks drawn and a 16-bit depth PNG
   equal to its depth; ``planerecnet_tpu_torch.bench`` prints its JSON line.
11. bf16 request: phase 5's seeded weights with the dynamic-kernel head
   amplified 12x, in f32 and in bf16 (``compute_dtype="bfloat16"``) on
   8 low-frequency 480x640 frames: the raw outputs within 3e-2 of each
   one's largest magnitude, and on each image the bf16 gate of
   ``tests/test_bf16.py`` (a threshold admitting ~100 candidates, the top
   5 f32 detections matched to bf16 ones by mask IoU, equal classes,
   scores within 2e-2, depth within 1% mean relative error), its IoU
   part (each >= 0.97, mean >= 0.98) reported, not required: on seeded
   random weights the JAX package's own bf16 fails it too (see
   ``GATE_CANDIDATES``); then the f32 and bf16 requests on phase 5's
   frames, alternated, median of 10 each; a bf16 request must launch the
   bf16 im2col 13 times.
12. bf16 training: phase 7 with ``compute_dtype="bfloat16"`` (the same
   batch and seeded weights, 20 steps): every loss finite, the last total
   below 0.95 of the first, the parameters f32, launches a step 26
   (im2col, 13 of them the bf16 instance), 13, 4 and 4; ms/step and peak
   memory beside phase 7's.
13. data parallelism on one card: ``tools/run_multihost.py`` launches 2
   ranks of the train CLI over gloo (NCCL refuses two ranks on one
   device) on phase 9's tree, PRN-50, a global batch of 12 (6 a rank, so
   BatchNorm trains synced), 6 steps with ``--reproductablity``, no
   random augmentation and TF32 off; then one rank of the same program
   on the same global batches, and for 2 steps again with cuDNN off (the
   yardstick). Each rank's batch checksums differ from the other's at
   every step and add up to the one rank's, each rank launches 26/13/4/4
   (the variants) a step, rank 0 alone writes, and the checkpoints after
   2 steps agree (``phase_dp``). Logged: the step time of two ranks
   sharing one card (no scaling figure).
14. ``tools/check_dataset.py`` on phase 9's valid split on the card: a
   finite point-to-plane error for every frame.
15. the spatial mesh axis, serving: ``tools/run_multihost.py`` launches 2
   ranks of this script (``--spatial_rank``) over gloo on the one card,
   a (1, 2) data x spatial mesh: PRN-50 with phase 5's weights answers 3
   requests of 1x640x640 and of 8x480x640 (C5 gathered) through
   ``parallel.spmd.jit_forward(spatial=True)``, then one rank of the same
   program (a (1, 1) mesh) the same requests, TF32 off in both: every
   output of the split within 1e-4 of its scale of the unsplit rank's, 13
   im2col launches a request on every rank; request times and each
   rank's peak memory beside the unsplit rank's (two ranks sharing one
   card: no latency or scaling figure).
16. the spatial mesh axis, training, in the same launches: 2 steps of
   ``trainer.train_step`` on the (1, 2) mesh, PRN-50, phase 7's batch at
   6x640x640 (BatchNorm synced), against the one rank, which also takes
   them with cuDNN off (phase 13's yardstick): the losses of step 1
   within rel 2e-4 / abs 1e-5; after each step the parameters within
   phase 13's tolerance, after step 1 the BatchNorm statistics too, and
   the Adam moments (and after step 2 the statistics) within its
   yardstick rule; after each step each module's norm of the Adam
   moments within 25% of the one rank's, or within twice the yardstick's
   drift where that is larger (a gradient counted twice moves it by
   100%, one counted half by 50%); 26/13/4/4 launches a step on every
   rank; per-rank peak memory.

17. with ``--profile DIR`` only, last of all, with phase 5's weights:
   ``tools/profile_inference.py``'s stages of a request,
   ``tools/profile_train.py``'s stages of a training step, and ``torch.profiler`` traces of two requests and of
   two training steps, by default and with ``--reproductablity``'s
   switches and variants (``tools/parse_trace.py``: kernel tables and
   busy shares printed, traces and tables written to DIR; the traces are
   large, the ``*_kernels.json`` tables small).
18. the port's tools (``planerecnet_tpu_torch/tools/``) on the card: the
   1x1 repair (the tiny preset's request and one step at 2x32x32, where
   C5 is 1x1, and ``reflect_pad`` with an axis of one under the
   deterministic switches against its CPU result in every bit); the C RLE
   codec on every annotation of phase 9's tree (list and compressed
   counts) against the numpy codec, the decode ms of both and its share
   of the loader's read stage; with phase 5's weights (``perturb_``
   seed 1, through the tools' ``set_weights``), ``profile_inference`` at
   PRN-50 1x and
   8x480x640 (the whole request within phase 5's requests
   +-``TOOLS_SERVE_BAND``); ``profile_train`` at PRN-50 8x640x640 for 5
   steps with ``--split_timing`` and ``--trace``, then ``parse_trace`` on
   that trace, which must show the im2col, scatter and dice/lava kernels
   26/13/4/4 times a step; ``roofline`` on phase 5's and phase 7's
   measured times (FLOPs, bytes and ``mfu`` of a request and a step);
   ``bench_dice_kernel``, ``bench_optimizer`` (PRN-50) and
   ``bench_dispatch`` at 5 iterations.

Exits non-zero if any phase fails, and at once where there is no card.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import itertools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from planerecnet_tpu_torch.tools.roofline import PEAKS

# The card's published peaks, the roofline tool's (H100 SXM data sheet).
H100 = PEAKS["NVIDIA H100"]
HBM_BYTES_PER_S = H100["hbm_bytes_per_s"]
F32_FLOPS_PER_S = H100["float32"]
# The dice/lava products run as three TF32 products each (3xTF32) on the
# tensor cores.
TF32X3_FLOPS_PER_S = H100["tf32"] / 3
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


def same_bits(a, b) -> bool:
    """Whether two f32 tensors hold the same bits."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def det_twice(run, what):
    """Two launches of a deterministic variant on the same inputs; raises
    unless every output is bit-identical. Returns the first's outputs."""
    first, second = run(), run()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    for i, (a, b) in enumerate(zip(firsts, seconds)):
        if not same_bits(a, b):
            raise AssertionError(
                f"{what}: two launches differ in output {i} at "
                f"{int((a.view(torch.int32) != b.view(torch.int32)).sum())} "
                f"elements")
    return first


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
    for line in out:
        log(line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return out[0]


# The most bytes of spill stores that ptxas may report for each dice/lava
# kernel, by (pass, K, deterministic variant): the figures of each one's
# first build (PERF.md; the deterministic variants' of their one-launch
# design). The K=256 backward holds its 128 dk accumulators in registers;
# ``phase_fence`` keeps its spill at 88 bytes of stores (without it ~1 KB,
# which cost a quarter of its time).
DICE_SPILL_LIMITS = {
    **{(d, k, det): 0 for d in ("fwd", "bwd") for k in (32, 128, 256)
       for det in (False, True)},
    ("bwd", 256, False): 88, ("bwd", 256, True): 128}


def dice_spills(ptxas_log):
    """{(pass, K, deterministic): bytes of spill stores} of every dice/lava
    kernel in ptxas's report (its mangled names carry the template's K
    and DET)."""
    out, fn = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        k = fn and re.search(r"dice_lava_(fwd|bwd)_kernelILi(\d+)ELb([01])E",
                             fn)
        if m and k:
            out[(k.group(1), int(k.group(2)), k.group(3) == "1")] = int(
                m.group(1))
        if m:
            fn = None
    return out


def phase_build():
    from planerecnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    # dice_lava always afresh, so that its spill gate has ptxas's report.
    info = cuda_build.build(fresh=("dice_lava",))
    log(f"[build] {len(info)} sources in parallel, "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        log(f"[build] {rec['path']} in {rec['seconds']:.1f} s")
        log(rec["log"].strip())
    spills = dice_spills(info["dice_lava"]["log"])
    if len(spills) != 12:
        raise AssertionError(f"ptxas reported {len(spills)} dice/lava "
                             f"kernels, expected 12: {spills}")
    log(f"[build] dice/lava spill stores in bytes by (pass, K, "
        f"deterministic): {sorted(spills.items())}; limits "
        f"{sorted(DICE_SPILL_LIMITS.items())}")
    for key, nbytes in spills.items():
        limit = DICE_SPILL_LIMITS[key]
        if nbytes > limit:
            raise AssertionError(f"dice_lava kernel {key} spills {nbytes} "
                                 f"bytes, above its recorded {limit}")


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


def det_cpu_bits(det, idx, cw, dcols, h, w, what):
    """The elements of the deterministic scatter's dx whose bits differ
    from the plain version's on the CPU (four index_add_ in key order, the
    order the variant sums in); raises unless there are none."""
    from planerecnet_tpu_torch.ops.dcn_scatter import dcn_input_grad_plain
    cpu = dcn_input_grad_plain(idx.cpu(), cw.cpu(), dcols.cpu(), h, w)
    differ = int((det.cpu().view(torch.int32) != cpu.view(torch.int32)).sum())
    log(f"[scatter-det] {what}: {differ} of {cpu.numel()} elements differ "
        f"in their bits from the plain version on the CPU")
    if differ:
        raise AssertionError(f"scatter_det at {what} is not the CPU plain "
                             f"version's sum")
    return differ


def scatter_record(dcn_input_grad, dcn_input_grad_plain, idx, cw, dcols,
                   h, w, what):
    """The scatter kernel against its plain version (raises past f32 TOL),
    its deterministic variant against the CPU plain version in every bit,
    then both timed beside the bound for this data: each row read once
    (corner, weights, channels), dx written once; 2 flops per channel for
    each corner that is in the map and has a non-zero weight."""
    tol = TOL[torch.float32]
    got = dcn_input_grad(idx, cw, dcols, h, w)
    want = dcn_input_grad_plain(idx, cw, dcols, h, w)
    torch.cuda.synchronize()
    err, ok = close_err(got, want, tol)
    log(f"[scatter] {what}: err {err:.3g} (tol {tol} of scale)")
    if not ok:
        raise AssertionError(f"scatter disagrees with plain at {what}")
    det = det_twice(lambda: dcn_input_grad(idx, cw, dcols, h, w,
                                           deterministic=True),
                    f"scatter_det at {what}")
    det_err, ok = close_err(det, want, tol)
    log(f"[scatter-det] {what}: two launches bit-identical; err "
        f"{det_err:.3g} against the plain version on the card (tol {tol} of "
        f"scale)")
    if not ok or not torch.isfinite(det).all():
        raise AssertionError(f"scatter_det disagrees with plain at {what}")
    bits = det_cpu_bits(det, idx, cw, dcols, h, w, what)
    del det
    b, _, c = dcols.shape
    ms = cuda_time_ms(lambda: dcn_input_grad(idx, cw, dcols, h, w))
    det_ms = cuda_time_ms(lambda: dcn_input_grad(idx, cw, dcols, h, w,
                                                 deterministic=True))
    adds = int((cw != 0).sum())   # zero weight: out of map or skipped
    nbytes = (idx.numel() + cw.numel() + dcols.numel() + b * h * w * c) * 4
    b_ms, b_by = bound(nbytes, 2 * adds * c)
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                bytes=nbytes, det_ms=det_ms, det_err=det_err,
                det_cpu_bits_differ=bits)


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
                   train_offsets_bound_ms=tr["bound_ms"],
                   det_train_offsets_ms=tr["det_ms"],
                   det_err=max(rec["det_err"], tr["det_err"]),
                   det_cpu_bits_differ=(rec["det_cpu_bits_differ"]
                                        + tr["det_cpu_bits_differ"]))
        log(f"[scatter] {name}: +-8 px {rec['ms']:.4f} ms (deterministic "
            f"{rec['det_ms']:.4f}), N(0, {std}^2) px {tr['ms']:.4f} ms "
            f"(deterministic {tr['det_ms']:.4f}), plain {plain_ms:.4f} ms, "
            f"grid_sampler_2d_backward {lib_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} / {tr['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {rec['bytes'] / rec['ms'] / 1e6:.1f} / "
            f"{tr['bytes'] / tr['ms'] / 1e6:.1f} GB/s achieved, "
            f"deterministic {rec['bytes'] / rec['det_ms'] / 1e6:.1f} / "
            f"{tr['bytes'] / tr['det_ms'] / 1e6:.1f} GB/s")
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
# (what, batch, H, W, C): every row's top-left corner on one pixel, so that
# the tiles there hold far more rows than the deterministic variant's
# rounds take (``DET_ROW_CAP``): it sums them in rounds of key ranges. Only
# the variant: its bits against the CPU's; the atomic kernel's sum of
# 57600 terms a pixel in another order is no test of its tolerance.
PILE_UP = ("every row on one patch: the deterministic variant's rounds",
           2, 80, 80, 128)


def scatter_cases(dcn, dcn_input_grad, dcn_input_grad_plain):
    """The scatter against its plain version where its tiles and windows
    can go wrong (``SCATTER_CASES``), its deterministic variant against
    the CPU plain version in every bit there and at ``PILE_UP``; returns
    the worst error."""
    from planerecnet_tpu_torch.ops.dcn_scatter import det_plan, scatter_plan
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
        det = det_twice(lambda: dcn_input_grad(idx, cw, dcols, h, w,
                                               deterministic=True),
                        f"scatter_det: {what}")
        torch.cuda.synchronize()
        err, ok = close_err(got, want, tol)
        det_err, det_ok = close_err(det, want, tol)
        log(f"[scatter-case] {what} ({b}x{h}x{w}x{c}/s{stride}, R={r}, "
            f"{plan}, {det_plan(b, r, h, w, c)}): err {err:.3g}, "
            f"deterministic variant {det_err:.3g} (two launches "
            f"bit-identical) (tol {tol} of scale)")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"scatter disagrees with plain: {what}")
        if not det_ok or not torch.isfinite(det).all():
            raise AssertionError(f"scatter_det disagrees with plain: {what}")
        det_cpu_bits(det, idx, cw, dcols, h, w, what)
        worst = max(worst, err, det_err)
    what, b, h, w, c = PILE_UP
    r = 9 * h * w
    g = torch.Generator(device="cuda").manual_seed(99)
    idx = torch.full((b, r, 2), h // 2, dtype=torch.int32, device="cuda")
    cw = torch.rand(b, r, 4, device="cuda", generator=g)
    dcols = torch.randn(b, r, c, device="cuda", generator=g)
    det = det_twice(lambda: dcn_input_grad(idx, cw, dcols, h, w,
                                           deterministic=True),
                    f"scatter_det: {what}")
    det_cpu_bits(det, idx, cw, dcols, h, w,
                 f"{what} ({b}x{h}x{w}x{c}, R={r}, {det_plan(b, r, h, w, c)})")
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


def spatial_windows():
    """(what, batch, DCN input shapes, training) of phases 15-16: the two
    requests (8x480x640 has ``DCN_SHAPES``, 640x640 ``DCN_SHAPES_TRAIN``)
    and the training step."""
    shapes = {(HEIGHT, WIDTH): DCN_SHAPES,
              (TRAIN_SIZE, TRAIN_SIZE): DCN_SHAPES_TRAIN}
    return ([(f"serve {b}x{h}x{w}", b, shapes[h, w], False)
             for b, h, w in SP_SERVE]
            + [(f"train {SP_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}", SP_BATCH,
                DCN_SHAPES_TRAIN, True)])


def spatial_window_cases(dcn):
    """The im2col and the scatter against their plain versions at the
    windows that phases 15-16 give them on SP_RANKS ranks: at every DCN
    layer whose output rows split, each rank's window, its first output
    row ``row0``, its offset and mask rows (+-8 px) and the whole input
    (``deform_conv2d(row0=)``). The im2col in f32 and bf16 at the
    requests' and the step's shapes, the scatter (atomic and
    deterministic) at the step's, each rank's rows of dcols added into the
    whole height. Layers whose output does not split run whole (phases
    3-4). Returns the im2col's worst f32 error and the scatter's."""
    from planerecnet_tpu_torch.ops.dcn_scatter import (dcn_input_grad,
                                                       dcn_input_grad_plain)
    worst_cols = worst_scatter = 0.0
    tol32 = TOL[torch.float32]
    n_cases = 0
    for j, (what, b, shapes, train) in enumerate(spatial_windows()):
        for i, (h, w, cin, stride, _) in enumerate(shapes):
            ho = (h + 2 - 3) // stride + 1
            wo = (w + 2 - 3) // stride + 1
            if ho % SP_RANKS:
                continue
            rows = ho // SP_RANKS
            for dtype in ((torch.float32,) if train else
                          (torch.float32, torch.bfloat16)):
                x, off, mask, _, _, _, _ = dcn_inputs(
                    h, w, cin, stride, dtype, seed=100 + 10 * j + i, batch=b)
                for rank in range(SP_RANKS):
                    row0 = rank * rows
                    o = off[:, row0:row0 + rows].contiguous()
                    m = mask[:, row0:row0 + rows].contiguous()
                    kw = dict(stride=stride, padding=1, kernel_size=3,
                              row0=row0)
                    name = (f"{what} {h}x{w}x{cin}/s{stride} rank {rank} "
                            f"(row0 {row0}, {rows} of {ho} rows) "
                            f"{str(dtype)[6:]}")
                    got = dcn.deform_im2col(x, o, m, **kw)
                    want = dcn.deform_im2col_plain(x, o, m, **kw)
                    torch.cuda.synchronize()
                    err, ok = close_err(got, want, TOL[dtype])
                    n_cases += 1
                    if not ok or not torch.isfinite(got).all():
                        raise AssertionError(f"im2col disagrees with plain "
                                             f"at {name}: err {err:.3g}")
                    if dtype == torch.float32:
                        worst_cols = max(worst_cols, err)
                    del got, want
                    if not train:
                        continue
                    idx, cw = dcn.scatter_inputs(o, m, h, w, stride=stride,
                                                 row0=row0)
                    g = torch.Generator(device="cuda").manual_seed(
                        200 + 10 * i + rank)
                    dcols = torch.randn(b, rows * wo * 9, cin,
                                        device="cuda", generator=g)
                    got = dcn_input_grad(idx, cw, dcols, h, w)
                    want = dcn_input_grad_plain(idx, cw, dcols, h, w)
                    det = det_twice(lambda: dcn_input_grad(
                        idx, cw, dcols, h, w, deterministic=True),
                        f"scatter_det at {name}")
                    torch.cuda.synchronize()
                    err, ok = close_err(got, want, tol32)
                    det_err, det_ok = close_err(det, want, tol32)
                    n_cases += 1
                    if not (ok and det_ok and torch.isfinite(got).all()):
                        raise AssertionError(
                            f"scatter disagrees with plain at {name}: err "
                            f"{err:.3g}, deterministic {det_err:.3g}")
                    det_cpu_bits(det, idx, cw, dcols, h, w, name)
                    worst_scatter = max(worst_scatter, err, det_err)
                    del idx, cw, dcols, got, want, det
                del x, off, mask
    log(f"[spatial-window] im2col (f32, bf16) and scatter (atomic, "
        f"deterministic, its bits against the CPU's) against their plain "
        f"versions at {n_cases} windows "
        f"of {SP_RANKS} ranks (row0 > 0 on every rank but the first; "
        f"offsets +-8 px; the whole input, the window's offset rows): worst "
        f"f32 error im2col {worst_cols:.3g}, scatter {worst_scatter:.3g} "
        f"(tol {tol32} of scale; bf16 {TOL[torch.bfloat16]})")
    return worst_cols, worst_scatter


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


# A grid for the deterministic dice/lava variants other than the card's SM
# count: the SMs of an H100 PCIe. Their sums follow from the shape alone,
# so a card of 114 SMs must give the same bits.
OTHER_SMS = 114


def on_other_card(dl, run, sms=OTHER_SMS):
    """``run()`` with the dice/lava wrappers sizing their persistent grids
    for a card of ``sms`` SMs (the C entry's ``grid_x``)."""
    real = dl._launch_geometry
    dl._launch_geometry = lambda *args: sms
    try:
        return run()
    finally:
        dl._launch_geometry = real


def dice_errors(dl, ins, gs, what, worst):
    """Both kernels against their plain versions; raises past f32 TOL.
    Folds the largest errors into ``worst`` (by kernel: fwd, bwd). The
    deterministic variants must give the same bits twice, and with the
    grid of a card of ``OTHER_SMS`` SMs."""
    got = dl.dice_lava_fwd(*ins)
    want = dl.fused_dice_lava_plain(*ins)
    got_b = dl.dice_lava_bwd(*ins, *gs)
    want_b = dl.fused_dice_lava_bwd_plain(*ins, *gs)

    def run_det():
        return dl.dice_lava_fwd(*ins, deterministic=True)

    def run_det_b():
        return dl.dice_lava_bwd(*ins, *gs, deterministic=True)

    det = det_twice(run_det, f"dice_lava_fwd_det at {what}")
    det_b = det_twice(run_det_b, f"dice_lava_bwd_det at {what}")
    other = on_other_card(dl, lambda: (*run_det(), *run_det_b()))
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, x, y in zip(("a", "b", "lava", "dk", "dm"), (*det, *det_b),
                          other):
        if not same_bits(x, y):
            raise AssertionError(
                f"dice_lava {name}_det at {what}: grid_x {sms} and "
                f"{OTHER_SMS} differ at "
                f"{int((x.view(torch.int32) != y.view(torch.int32)).sum())}"
                f" elements")
    tol = TOL[torch.float32]
    errs, used = {}, {}
    names = ("a", "b", "lava", "dk", "dm")
    names = names + tuple(f"{n}_det" for n in names)
    for name, g, w in zip(names, (*got, *got_b, *det, *det_b),
                          (*want, *want_b) * 2):
        errs[name], ok = close_err(g, w, tol)
        # The share of its allowance the worst element uses (1 = at TOL).
        used[name] = float(((g - w).abs() / (tol * (w.abs().max() + w.abs())
                                             + 1e-30)).max())
        if not ok or not torch.isfinite(g).all():
            raise AssertionError(f"dice_lava {name} disagrees with plain at "
                                 f"{what}: {errs[name]}")
    log(f"[dice] {what}: errors against plain {json.dumps(errs)} (tol {tol} "
        f"of scale); share of the allowance used "
        f"{json.dumps({k: round(v, 3) for k, v in used.items()})}; the "
        f"deterministic variants' two launches bit-identical, and at "
        f"grid_x {sms} and {OTHER_SMS}")
    worst["fwd"] = max(worst["fwd"], errs["a"], errs["b"], errs["lava"])
    worst["bwd"] = max(worst["bwd"], errs["dk"], errs["dm"])
    worst["fwd_det"] = max(worst["fwd_det"], errs["a_det"], errs["b_det"],
                           errs["lava_det"])
    worst["bwd_det"] = max(worst["bwd_det"], errs["dk_det"], errs["dm_det"])


def phase_dice(cases=DICE_CASES):
    """The fused dice/lava forward and backward kernels against their plain
    versions at every case of ``cases`` and at the training shapes of
    PRN-50 and of the base preset, where they are timed. Returns PRN-50's
    records, with the worst error of every case."""
    from planerecnet_tpu_torch.ops import dice_lava as dl
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_det": 0.0, "bwd_det": 0.0}
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
        det_fn = (lambda: dl.dice_lava_fwd(*ins, deterministic=True)) \
            if name == "fwd" else \
            (lambda: dl.dice_lava_bwd(*ins, *gs, deterministic=True))
        det_ms = cuda_time_ms(det_fn, iters=10)
        plain_ms = cuda_time_ms(plain, iters=5)
        extra = 4 * 3 * d["b"] * d["p"] if name == "bwd" else 0
        nbytes = in_bytes + extra + out_bytes
        b_ms, b_by = bound(nbytes, flops, TF32X3_FLOPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                         bound_f32_by=f32_by, flops=flops,
                         max_abs_err=worst[name], det_ms=det_ms,
                         det_err=worst[f"{name}_det"])
        log(f"[dice] {name} {d}: {ms:.4f} ms (deterministic variant "
            f"{det_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms at 3xTF32 ({b_by}), {f32_ms:.4f} ms at "
            f"f32 ({f32_by}); {flops / 1e9:.2f} GFLOP, "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved; "
            f"max err {out[name]['max_abs_err']:.3g}")
    return out


# (shape, channels-last) of reflect-pad inputs: decoder-like maps in both
# layouts, the depth map of the gradient loss, a map smaller than a tile.
REFLECT_PAD_CASES = (((8, 64, 160, 160), True), ((8, 256, 40, 40), False),
                     ((8, 1, 640, 640), False), ((2, 3, 5, 7), False))


def check_reflect_pad():
    """``ops/image.py::reflect_pad`` on the card under
    ``--reproductablity``'s switches (where ``F.pad``'s CUDA backward
    raises) against ``F.pad(mode="reflect")`` on the CPU: values and
    gradients in every bit (the layouts follow each device's ``F.pad``;
    the CPU tests hold them)."""
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch.ops.image import reflect_pad
    g = torch.Generator().manual_seed(5)
    with train_cli.reproducible_mode(True):
        for shape, cl in REFLECT_PAD_CASES:
            fmt = torch.channels_last if cl else torch.contiguous_format
            x = torch.randn(shape, generator=g).contiguous(memory_format=fmt)
            dy = torch.randn(*shape[:2], shape[2] + 2, shape[3] + 2,
                             generator=g)
            a = x.cuda().requires_grad_()
            b = x.clone().requires_grad_()
            ya, yb = reflect_pad(a), F.pad(b, (1,) * 4, mode="reflect")
            ya.backward(dy.cuda())
            yb.backward(dy)
            for what, u, v in (("values", ya, yb), ("gradient", a.grad,
                                                     b.grad)):
                if not torch.equal(
                        u.detach().cpu().contiguous().view(torch.int32),
                        v.detach().contiguous().view(torch.int32)):
                    raise AssertionError(f"reflect_pad {what} at {shape} "
                                         f"(channels-last {cl}) differ from "
                                         f"F.pad's on the CPU")
    log(f"[reflect-pad] deterministic mode on the card: values and "
        f"gradients equal F.pad's on the CPU in every bit at "
        f"{[s for s, _ in REFLECT_PAD_CASES]}")


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


def phase5_weights(model):
    """The perturbation of phases 5 and 7's models (``perturb_`` seed 1),
    for the tools that build their own from seed 0."""
    perturb_(model, seed=1)


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
    return runner, launches, times


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
    """The DCN offsets' spread by layer width over one ``step`` (the
    closed-loop tool's ``offset_spread``)."""
    from planerecnet_tpu_torch.tools.closed_loop import offset_spread as f
    return f(model, step)


def kernel_counters():
    """{name: (wrapper, attribute)} of every kernel's launch count
    (``planerecnet_tpu_torch.ops.kernel_counters``): the atomic kernels'
    ``launches``, the deterministic variants' ``det_launches`` on the same
    wrappers, the im2col's bf16 instance's ``bf16_launches``."""
    from planerecnet_tpu_torch.ops import kernel_counters as counters
    return counters()


def read_counts():
    return {k: getattr(fn, a) for k, (fn, a) in kernel_counters().items()}


def zero_counts():
    for fn, a in kernel_counters().values():
        setattr(fn, a, 0)


def launches_per_step(deterministic):
    """A PRN-50 training step's launches: the im2col twice a DCN layer,
    then the scatter once a layer and dice/lava once a level, atomic or
    deterministic."""
    per = {k: 0 for k in kernel_counters()}
    per["dcn_im2col"] = 2 * DCN_LAYERS_PRN50
    sfx = "_det" if deterministic else ""
    per["dcn_scatter" + sfx] = DCN_LAYERS_PRN50
    per["dice_lava_fwd" + sfx] = per["dice_lava_bwd" + sfx] = DICE_LEVELS
    return per


def phase_train(cfg, card):
    """The training main path: PRN-50 at batch 8, 640x640, f32, all five
    losses, seeded perturbed weights, one fixed batch. Returns the state,
    the batch and the launch counts of the timed steps."""
    from planerecnet_tpu_torch import trainer
    per_step = launches_per_step(deterministic=False)
    state = trainer.create_train_state(cfg, seed=0, device="cuda")
    perturb_(state.model, seed=1)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    batch = synthetic_batch(BATCH, TRAIN_SIZE, cfg.max_instances, seed=3)
    first = trainer.train_step(state, batch)                     # warm-up
    totals = [float(first["total"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
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
    launches = read_counts()
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


# The CLI path (phase 9): a synthetic ScanNet tree on disk, PRN-50 trained
# through ``planerecnet_tpu_torch.train`` for CLI_ITERS steps, resumed for
# CLI_RESUME more, then evaluated through ``planerecnet_tpu_torch.eval``.
CLI_SPLITS = (24, 8, 8)           # train, valid, eval images
CLI_ITERS, CLI_RESUME = 12, 4
CLI_SUM_BATCHES = 3               # batches whose upload is checked
# Low enough for seeded weights after 16 steps to give detections.
CLI_EVAL_THR = "0.001"


def wire_checksum(x) -> int:
    """An order-free checksum of a wire field, the same on the host and on
    the card: the sum of its values as integers, f32 by their bits."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    from planerecnet_tpu_torch.trainer import widen_u16
    x = widen_u16(x)
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return int(x.to(torch.int64).sum())


def host_stages(cfg, n_batches=3):
    """Host ms a batch of BATCH for reading (files, masks), augmenting and
    collating the CLI's train split, one thread; augment is the
    difference of a pull with and without ``SSDAugmentation``."""
    from planerecnet_tpu_torch.data import (SSDAugmentation, build_dataset,
                                            collate_batch)
    raw = build_dataset(cfg, "train")
    aug = build_dataset(cfg, "train", transform=SSDAugmentation(
        cfg, rng=np.random.RandomState(0)))
    out = {"read": [], "augment": [], "collate": []}
    for b in range(n_batches):
        idx = range(b * BATCH, (b + 1) * BATCH)
        t0 = time.perf_counter()
        for i in idx:
            raw.pull_item(i)
        t1 = time.perf_counter()
        samples = [aug.pull_item(i) for i in idx]
        t2 = time.perf_counter()
        collate_batch(cfg, samples)
        t3 = time.perf_counter()
        out["read"].append((t1 - t0) * 1e3)
        out["augment"].append(((t2 - t1) - (t1 - t0)) * 1e3)
        out["collate"].append((t3 - t2) * 1e3)
    return {k: float(np.median(v)) for k, v in out.items()}


def phase_cli(card, train_ms, work):
    """The CLI path. Generates the tree in ``work`` (which phases 13 and
    14 read after it), trains PRN-50 twice through the
    train CLI (batch 8, max_size 640, f32, --reproductablity), resumes the
    first run from ``latest`` without the flag, as users train by default,
    evaluates the checkpoints through the eval CLI with device and with
    host metrics. Checks the launches of every step, the losses, the
    resume's start, the upload of the first batches, that the two
    reproducible runs agree in every bit and that the eval runs agree.
    Returns the launches of the path by kernel."""
    import os
    from planerecnet_tpu_torch import eval as eval_cli
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.data import datasets
    from planerecnet_tpu_torch.ops import dcn
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.tools import synth_scenes
    # --reproductablity: the deterministic variants, never the atomics;
    # the default (the resumed run): the atomics, never the variants.
    det_step = launches_per_step(deterministic=True)
    default_step = launches_per_step(deterministic=False)
    cwd = os.getcwd()
    collate, train_step = datasets.collate_batch, trainer.train_step
    host_sums, steps, first_batch = [], [], []

    def collate_probe(*args, **kwargs):
        batch = collate(*args, **kwargs)
        if len(host_sums) < CLI_SUM_BATCHES:
            host_sums.append({k: wire_checksum(v) for k, v in batch.items()})
        if not first_batch:
            first_batch.append(batch)
        return batch

    def step_probe(state, batch):
        rec = {"t": time.perf_counter()}
        if len(steps) < CLI_SUM_BATCHES:
            rec["on_card"] = all(isinstance(v, torch.Tensor) and v.is_cuda
                                 for v in batch.values())
            rec["sums"] = {k: wire_checksum(v) for k, v in batch.items()}
        before = read_counts()
        losses = train_step(state, batch)
        rec["launches"] = {k: n - before[k] for k, n in read_counts().items()}
        rec["losses"] = losses
        steps.append(rec)
        return losses

    try:
        t0 = time.perf_counter()
        synth_scenes.generate_dataset(work, *CLI_SPLITS, h=HEIGHT, w=WIDTH,
                                      seed=0, progress=False)
        log(f"[cli] synthetic ScanNet tree, {CLI_SPLITS} train/valid/eval "
            f"images at {HEIGHT}x{WIDTH}, seed 0: "
            f"{time.perf_counter() - t0:.1f} s")
        os.chdir(work)
        datasets.collate_batch, trainer.train_step = collate_probe, step_probe
        zero_counts()
        # One card, whatever the host has (the CLI's default is all).
        common = ["--config", "PlaneRecNet_50_config", "--batch_size",
                  str(BATCH), "--dtype", "float32", "--no_tensorboard",
                  "--no_autoscale", "--n_devices", "1"]
        first_args = common + ["--reproductablity", "--cfg_overrides",
                               json.dumps({"max_iter": CLI_ITERS})]
        t0 = time.perf_counter()
        first = train_cli.main(first_args + ["--save_folder", "weights/"])
        t1 = time.perf_counter()
        # The same run again from scratch: --reproductablity must give the
        # same checkpoint, bit for bit.
        again = train_cli.main(first_args + ["--save_folder", "weights_b/"])
        t2 = time.perf_counter()
        resumed = train_cli.main(common + [
            "--save_folder", "weights/", "--cfg_overrides",
            json.dumps({"max_iter": CLI_ITERS + CLI_RESUME}),
            "--resume", "latest"])
        t3 = time.perf_counter()
        launches = read_counts()
        datasets.collate_batch, trainer.train_step = collate, train_step
        log(f"[cli] train CLI: {CLI_ITERS} steps in {t1 - t0:.1f} s, again "
            f"from scratch in {t2 - t1:.1f} s, resumed "
            f"{json.dumps({k: resumed[k] for k in ('start_iter', 'iteration')})}"
            f" in {t3 - t2:.1f} s (model build, per-epoch validation and "
            f"checkpoints included); checkpoint {resumed['checkpoint']}")
        if resumed["start_iter"] != CLI_ITERS or \
                resumed["iteration"] != CLI_ITERS + CLI_RESUME:
            raise AssertionError(f"resume: {resumed}, expected start at "
                                 f"{CLI_ITERS}")
        if len(steps) != 2 * CLI_ITERS + CLI_RESUME:
            raise AssertionError(f"{len(steps)} steps through the CLI")
        differ, n_arrays = differing_arrays(first["checkpoint"],
                                           again["checkpoint"])
        if differ:
            raise AssertionError(f"--reproductablity: {len(differ)} of "
                                 f"{n_arrays} checkpoint arrays differ "
                                 f"between two runs, e.g. {differ[:5]}")
        log(f"[cli] --reproductablity: the two {CLI_ITERS}-step runs' "
            f"checkpoints agree in every bit of all {n_arrays} arrays")
        for i, rec in enumerate(steps):
            want = det_step if i < 2 * CLI_ITERS else default_step
            if rec["launches"] != want:
                raise AssertionError(f"CLI step {i}: launches "
                                     f"{rec['launches']}, expected {want}")
        totals = torch.stack([v for rec in steps
                              for v in rec["losses"].values()])
        rep_a, rep_b = steps[:CLI_ITERS], steps[CLI_ITERS:2 * CLI_ITERS]
        if any(float(x["losses"][k]) != float(y["losses"][k])
               for x, y in zip(rep_a, rep_b) for k in x["losses"]):
            raise AssertionError("--reproductablity: the two runs' losses "
                                 "differ")
        if not torch.isfinite(totals).all():
            raise AssertionError("a loss through the CLI is not finite: "
                                 + json.dumps([{k: float(v) for k, v in
                                                rec["losses"].items()}
                                               for rec in steps]))
        for i, (want, rec) in enumerate(zip(host_sums, steps)):
            if not rec["on_card"] or rec["sums"] != want:
                raise AssertionError(f"batch {i} on the card {rec['sums']} "
                                     f"(all on the card: {rec['on_card']})"
                                     f", on the host {want}")
        log(f"[cli] launches per step as expected: "
            f"{json.dumps(det_step)} at each of the {2 * CLI_ITERS} steps "
            f"with --reproductablity, {json.dumps(default_step)} at each of "
            f"the {CLI_RESUME} resumed without it; every loss finite; the first "
            f"{len(host_sums)} batches arrived on the card with the host's "
            f"checksums of {sorted(host_sums[0])}")
        # Within an epoch (3 steps of 8 of 24 images), after the first.
        t = [rec["t"] for rec in steps[:CLI_ITERS]]
        per = CLI_SPLITS[0] // BATCH
        gaps = [(t[i + 1] - t[i]) * 1e3 for i in range(per, CLI_ITERS - 1)
                if (i + 1) % per]
        cli_ms = float(np.median(gaps))
        shape = tuple(first_batch[0]["image"].shape)
        state = trainer.create_train_state(PlaneRecNet_50_config, seed=0,
                                           device="cuda")
        trainer.train_step(state, first_batch[0])
        mem = []
        for _ in range(4):
            t0 = time.perf_counter()
            trainer.train_step(state, first_batch[0])
            torch.cuda.synchronize()
            mem.append((time.perf_counter() - t0) * 1e3)
        del state
        # The same batch, stepped with --reproductablity's switches and the
        # kernels' deterministic variants.
        with train_cli.reproducible_mode(True):
            state = trainer.create_train_state(
                PlaneRecNet_50_config, seed=0, device="cuda",
                deterministic=True)
            trainer.train_step(state, first_batch[0])
            det = []
            for _ in range(4):
                t0 = time.perf_counter()
                trainer.train_step(state, first_batch[0])
                torch.cuda.synchronize()
                det.append((time.perf_counter() - t0) * 1e3)
            del state
        det_ms = float(np.median(det))
        mem_ms = float(np.median(mem))
        log(f"[cli] ms/step through the train CLI {cli_ms:.3f} (median of "
            f"{len(gaps)} steps within epochs 2-{CLI_ITERS // per}: "
            f"{[round(g, 3) for g in gaps]}), batch {shape} u8; the same "
            f"batch in memory, pageable upload each step: {mem_ms:.3f} "
            f"(median of {len(mem)}); with --reproductablity's switches and "
            f"the deterministic variants {det_ms:.3f} "
            f"({[round(t, 3) for t in det]}); phase 7's in-memory step at "
            f"{BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}: {train_ms:.3f}; loader "
            f"mean occupancy {first['mean_occupancy']:.3f} and "
            f"{resumed['mean_occupancy']:.3f} (of 2); {card}")
        stages = host_stages(PlaneRecNet_50_config)
        log(f"[cli] host ms a batch of {BATCH}, one thread, median of 3: "
            f"{json.dumps(stages)}")

        # The first run also pays the eval shapes' first calls (cuDNN's
        # choices); the third, device metrics again, is the timed one.
        # Then each of the two reproducible runs' checkpoints, which must
        # give identical tables.
        results = {}
        for mode, ckpt in (("first", resumed["checkpoint"]),
                           ("host", resumed["checkpoint"]),
                           ("device", resumed["checkpoint"]),
                           ("run A", first["checkpoint"]),
                           ("run B", again["checkpoint"])):
            dcn.deform_im2col.launches = 0
            res = eval_cli.main([
                "--trained_model", ckpt, "--config",
                "PlaneRecNet_50_config", "--max_images", str(CLI_SPLITS[2]),
                "--batch_size", str(BATCH), "--score_threshold",
                CLI_EVAL_THR, "--update_threshold", CLI_EVAL_THR,
                "--no_bar", "--seed", "0", "--device", "cuda"]
                + (["--host_metrics"] if mode == "host" else []))
            n = dcn.deform_im2col.launches
            launches["dcn_im2col"] += n
            requests = -(-CLI_SPLITS[2] // BATCH)
            if n != DCN_LAYERS_PRN50 * requests:
                raise AssertionError(f"eval CLI ({mode} run): {n} im2col "
                                     f"launches for {requests} request(s)")
            results[mode] = res
            log(f"[cli] eval CLI, {mode} run: {CLI_SPLITS[2]} images at "
                f"batch {BATCH}, {res['detections']} detections at "
                f"score and update thresholds {CLI_EVAL_THR}; "
                f"{1e3 / res['ms_per_image']:.2f} img/s "
                f"({res['ms_per_image']:.3f} ms an image, read and "
                f"transform included); box {json.dumps(res['box'])}, mask "
                f"{json.dumps(res['mask'])}, depth {json.dumps(res['depth'])}")
        dev = results["device"]
        for mode in ("first", "host"):
            for key in ("box", "mask", "depth", "detections"):
                if results[mode][key] != dev[key]:
                    raise AssertionError(
                        f"eval CLI: {key} differs between the {mode} run and "
                        f"device metrics: {results[mode][key]} against "
                        f"{dev[key]}")
        if dev["detections"] == 0:
            raise AssertionError("eval CLI: no detections")
        for key in ("box", "mask", "depth", "detections"):
            if results["run A"][key] != results["run B"][key]:
                raise AssertionError(
                    f"--reproductablity: the two runs' eval {key} differ: "
                    f"{results['run A'][key]} against "
                    f"{results['run B'][key]}")
        log("[cli] --reproductablity: the two runs' checkpoints give "
            "identical eval tables and depth metrics")

        runner = PlaneRecNetRunner(PlaneRecNet_50_config, device="cuda")
        runner.load_weights(resumed["checkpoint"])
        batch = first_batch[0]["image"]
        spread = offset_spread(runner.model, lambda: runner.infer(batch))
        log(f"[cli] DCN offsets in px of the checkpoint after "
            f"{CLI_ITERS + CLI_RESUME} steps (seeded weights, not a trained "
            f"model), by input width, on the first training batch: "
            f"{json.dumps(spread)}")
    finally:
        datasets.collate_batch, trainer.train_step = collate, train_step
        os.chdir(cwd)
    log(f"[cli] launches over the CLI path (the three train runs with their "
        f"validation, the five eval runs) {json.dumps(launches)}")
    for k, n in launches.items():
        if (det_step[k] or default_step[k]) and n == 0:
            raise AssertionError(f"{k} never launched on the CLI path")
    return launches


BENCH_KEYS = ["metric", "value", "unit", "baseline", "vs_baseline",
              "sync_roundtrip_ms"]


def phase_entry_points(card):
    """The user entry points beside the runner, on the card at PRN-50
    480x640: a ``.pth`` written with ``torch.save`` from seeded weights and
    loaded through ``runner.load_weights`` gives a bit-identical
    ``infer``; ``simple_inference`` on a PNG frame writes a seg and a
    16-bit depth PNG equal to what ``runner.infer`` of that frame draws
    and holds; ``bench`` prints its JSON line. Returns the im2col's
    launches over the phase."""
    import os
    import shutil
    import tempfile
    from planerecnet_tpu_torch import bench
    from planerecnet_tpu_torch import simple_inference as si
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.data.image_io import imread, imwrite
    from planerecnet_tpu_torch.ops import dcn
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    work = tempfile.mkdtemp(prefix="prn_entry_")
    dcn.deform_im2col.launches = 0
    try:
        a = PlaneRecNetRunner(PlaneRecNet_50_config, seed=0, device="cuda")
        perturb_(a.model, seed=1)
        with torch.no_grad():
            # Every cell scores above score_thr, so that masks are drawn.
            a.model.inst_head.cate_pred.bias.fill_(2.0)
        pth = os.path.join(work, "seeded.pth")
        torch.save(a.model.state_dict(), pth)
        b = PlaneRecNetRunner(PlaneRecNet_50_config, seed=7, device="cuda")
        b.load_weights(pth)
        x = frames(BATCH, HEIGHT, WIDTH, seed=11)
        want, got = a.infer(x), b.infer(x)
        torch.cuda.synchronize()
        for key in want:
            if not torch.equal(want[key], got[key]) or (
                    want[key].is_floating_point()
                    and not same_bits(want[key].float(), got[key].float())):
                raise AssertionError(f".pth round trip: infer's {key} "
                                     f"differs")
        log(f"[entry] torch.save of the seeded state_dict, loaded through "
            f"runner.load_weights(.pth): infer bit-identical on "
            f"{BATCH}x{HEIGHT}x{WIDTH} ({int(want['pred_valid'].sum())} "
            f"detections)")

        png = os.path.join(work, "frame.png")
        imwrite(png, frames(1, HEIGHT, WIDTH, seed=12)[0].astype(np.uint8))
        out = os.path.join(work, "frame_seg.png")
        argv = ["--image", f"{png}:{out}", "--trained_model", pth,
                "--config", "PlaneRecNet_50_config", "--depth_mode", "gray",
                "--score_threshold", "0.3"]
        t0 = time.perf_counter()
        si.main(argv)
        cli_s = time.perf_counter() - t0
        net = si.build_runner(si.parse_args(argv))
        frame = imread(png).astype(np.float32)   # 480x640: no resize, pad
        result = si._valid_result(net.infer(frame[None]), 0)
        seg, depth = si.display_on_frame(result, frame, net.cfg)
        n_det = 0 if result["pred_scores"] is None else len(
            result["pred_scores"])
        if not np.array_equal(imread(out), seg):
            raise AssertionError("simple_inference: the seg PNG differs from "
                                 "runner.infer's masks drawn")
        dep = imread(os.path.join(work, "frame_seg_dep.png"), color=False)
        if not np.array_equal(dep, (depth * 512.0).astype(np.uint16)):
            raise AssertionError("simple_inference: the depth PNG differs "
                                 "from runner.infer's depth")
        if n_det == 0:
            raise AssertionError("simple_inference: no detection drawn")
        log(f"[entry] simple_inference --image on a {HEIGHT}x{WIDTH} PNG "
            f"({cli_s:.1f} s, model build included): seg PNG equal to "
            f"runner.infer's {n_det} masks drawn, 16-bit depth PNG equal to "
            f"its depth x 512")

        res = bench.main(["--iters", "5", "--warmup", "2", "--sync_iters",
                          "3"])
        if list(res) != BENCH_KEYS or not res["value"] > 0:
            raise AssertionError(f"bench: {res}")
        log(f"[entry] bench: {json.dumps(res)}; {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dcn.deform_im2col.launches


def phase_profile(out_dir):
    """Where one request's time goes: ``tools/profile_inference.py`` at
    PRN-50, 8x480x640 (each stage timed with CUDA events, then a
    ``torch.profiler`` trace of two requests, device time by kernel)."""
    from planerecnet_tpu_torch.tools import parse_trace, profile_inference
    res = profile_inference.main([
        "--config", "PlaneRecNet_50_config", "--batch_size", str(BATCH),
        "--height", str(HEIGHT), "--width", str(WIDTH), "--iters", "3",
        "--trace", out_dir], set_weights=phase5_weights)
    log("[profile] request stages, ms: " + json.dumps(res["stages_ms"]))
    profile_log(parse_trace.summarize(parse_trace.load(res["trace"]), 2),
                "requests", "request")


def profile_log(summary, what, stem):
    """Print a ``parse_trace`` summary of the runs of ``what``."""
    from planerecnet_tpu_torch.tools import parse_trace
    if summary["busy_ms"] == 0:
        log(f"[profile] the profiler recorded no device time for {what}")
        return
    for line in parse_trace.lines(summary, 30):
        log(f"[profile] {stem}: {line}")


def phase_profile_train(cfg, batch, out_dir, stem="step",
                        deterministic=False):
    """One training step of ``cfg`` on ``batch`` through
    ``tools/profile_train.py``: its stages each timed alone
    (``split_timing``), then a ``torch.profiler`` trace of two steps
    (``parse_trace.record``: tables and trace named by ``stem``), by
    default or with the kernels' deterministic variants."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.tools import parse_trace, profile_train
    state = trainer.create_train_state(cfg, seed=0, device="cuda",
                                       deterministic=deterministic)
    perturb_(state.model, seed=1)
    dense = trainer.unpack_wire_batch(cfg, batch, state.device)
    trainer.train_step(state, dense)
    log(f"[profile] training {stem}, stages each alone, ms (mean of 3): "
        + json.dumps(profile_train.split_timing(state, [dense], 3)))
    summary = parse_trace.record(lambda: trainer.train_step(state, dense), 2,
                                 out_dir, stem, "cuda")
    log(f"[profile] {stem}: wall {summary['wall_ms']:.3f} ms a step")
    profile_log(summary, f"training steps ({stem})", stem)


def profile_det_step(cfg, batch, out_dir):
    """``phase_profile_train`` of the same step with
    ``--reproductablity``'s switches and the kernels' variants."""
    from planerecnet_tpu_torch import train as train_cli
    with train_cli.reproducible_mode(True):
        phase_profile_train(cfg, batch, out_dir, stem="step_det",
                            deterministic=True)


# The bf16 gate of ``tests/test_bf16.py`` (the port's copy is in
# ``tests/test_torch_port_bf16.py``): a low-frequency input (8x10 noise
# upsampled), the dynamic-kernel head amplified 12x so that mask logits
# are confident, a score threshold that admits ~100 candidates, the top 5
# f32 detections matched to bf16 ones by mask IoU (each >= 0.97, mean >=
# 0.98), equal classes, scores within 2e-2, depth within 1%. Its IoU part
# is a property of the weights as much as of the arithmetic: on seeded
# random weights both packages' bf16 fail it (``perturb_`` weights at
# 256x320 on the CPU: the JAX package's on 7 of 8 images, the port's on
# 8, with IoUs of the same size; PERF.md §6), so phase 11 reports it
# by image and holds the other parts, and the raw outputs within
# RAW_BF16_TOL, on every image.
GATE_CANDIDATES, GATE_TOP_K, GATE_KERNEL_GAIN = 100, 5, 12.0
# Of each raw output's largest magnitude: each package's bf16 lies
# 0.9e-2 to 2.3e-2 from its own f32 (tests/test_torch_port_bf16.py).
RAW_BF16_TOL = 3e-2
BF16_REPEATS = 10         # timed requests of each type, alternated


def low_frequency_frames(n, h, w, seed):
    """(n, h, w, 3) normalised frames: 8x10 noise upsampled, spatially
    coherent like a real image (the gate's input)."""
    from planerecnet_tpu_torch.ops.image import resize_bilinear
    lo = np.random.RandomState(seed).randn(n, 3, 8, 10) * 2
    return resize_bilinear(torch.tensor(lo, dtype=torch.float32),
                           (h, w)).permute(0, 2, 3, 1).contiguous()


def gate_cfg(cfg, cate_preds, candidates=GATE_CANDIDATES):
    """``cfg`` with a score threshold that admits about ``candidates``
    cells of ``cate_preds`` (random weights sit near the focal prior,
    where the preset's threshold admits none)."""
    flat = torch.cat([torch.sigmoid(c.float()).reshape(-1)
                      for c in cate_preds]).cpu().numpy()
    thr = float(np.quantile(flat, 1 - candidates / flat.size))
    return cfg.copy(dict(solov2=cfg.solov2.copy(dict(
        score_thr=thr, update_thr=1e-6, top_k=20))))


def bf16_gate(o32, obf, k=GATE_TOP_K):
    """The gate on two one-image ``postprocess_batch`` outputs: the top-k
    f32 detections matched to bf16 ones by mask IoU. Raises AssertionError
    unless the depth lies within 1% mean relative error, the top k are
    valid in both, the matched classes are equal and the scores within
    2e-2; returns (IoUs, whether they pass the IoU part, score drift,
    depth error)."""
    d32 = o32["pred_depth"][0].float().cpu().numpy()
    dbf = obf["pred_depth"][0].float().cpu().numpy()
    rel = float(np.abs(d32 - dbf).mean() / (np.abs(d32).mean() + 1e-9))
    v32 = o32["pred_valid"][0].cpu().numpy()
    vbf = obf["pred_valid"][0].cpu().numpy()
    if rel > 0.01 or not (v32[:k].all() and vbf[:k].all()):
        raise AssertionError(f"bf16 gate: depth error {rel}, valid "
                             f"{v32[:k]} / {vbf[:k]}")
    m32 = o32["pred_masks"][0][:k].cpu().numpy().astype(np.float32)
    nbf = int(vbf.sum())
    mbf = obf["pred_masks"][0][:nbf].cpu().numpy().astype(np.float32)
    inter = np.einsum("ahw,bhw->ab", m32, mbf)
    union = m32.sum((1, 2))[:, None] + mbf.sum((1, 2))[None, :] - inter
    iou = inter / np.maximum(union, 1)
    best = iou.argmax(1)
    matched = iou[np.arange(k), best]
    classes_equal = np.array_equal(
        o32["pred_classes"][0][:k].cpu().numpy(),
        obf["pred_classes"][0][:nbf].cpu().numpy()[best])
    drift = float(np.abs(
        o32["pred_scores"][0][:k].cpu().numpy()
        - obf["pred_scores"][0][:nbf].cpu().numpy()[best]).max())
    if not (classes_equal and drift < 2e-2):
        raise AssertionError(f"bf16 gate: classes equal {classes_equal}, "
                             f"score drift {drift} (IoUs {matched})")
    iou_ok = bool((matched >= 0.97).all() and matched.mean() >= 0.98)
    return matched, iou_ok, drift, rel


def phase_bf16_serve(card):
    """The bf16 request: PRN-50 at 8x480x640 on phase 5's seeded weights
    with the dynamic-kernel head amplified, against the f32 request on the
    same weights: the raw outputs within RAW_BF16_TOL, and the bf16 gate
    image by image (its IoU part reported); then both requests timed,
    alternated, on phase 5's frames. Returns the launches of one bf16
    request by kernel, and the two times."""
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config as cfg
    from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    r32 = PlaneRecNetRunner(cfg, seed=0, device="cuda")
    perturb_(r32.model, seed=1)
    with torch.no_grad():
        r32.model.inst_head.kernel_pred.weight.mul_(GATE_KERNEL_GAIN)
    rbf = PlaneRecNetRunner(cfg.copy(dict(compute_dtype="bfloat16")),
                            device=r32.device)
    rbf.model.load_state_dict(r32.model.state_dict())
    x = low_frequency_frames(BATCH, HEIGHT, WIDTH, seed=7).to(r32.device)
    with torch.no_grad():
        p32, pbf = r32.model(x), rbf.model(x)
    if p32["cate_preds"][0].dtype != torch.float32 or \
            pbf["cate_preds"][0].dtype != torch.bfloat16:
        raise AssertionError("bf16 request: the forward is not in bf16")
    raw = {}
    for key in ("cate_preds", "kernel_preds", "mask_pred", "depth_pred"):
        a = p32[key] if isinstance(p32[key], list) else [p32[key]]
        b = pbf[key] if isinstance(pbf[key], list) else [pbf[key]]
        for i, (w, g) in enumerate(zip(a, b)):
            raw[f"{key}[{i}]"] = float((g.float() - w).abs().max()
                                       / w.abs().max())
    if max(raw.values()) > RAW_BF16_TOL:
        raise AssertionError(f"bf16 request: raw outputs off f32 by "
                             f"{raw} of their largest magnitude")

    def image(preds, i):
        return {k: ([t[i:i + 1] for t in v] if isinstance(v, list)
                    else v[i:i + 1]) for k, v in preds.items()}

    gates = []
    for i in range(BATCH):
        c = gate_cfg(cfg, image(p32, i)["cate_preds"])
        gates.append(bf16_gate(
            postprocess_batch(image(p32, i), c, (HEIGHT, WIDTH)),
            postprocess_batch(image(pbf, i), c, (HEIGHT, WIDTH))))
    ious = np.stack([g[0] for g in gates])
    log(f"[bf16-serve] raw bf16 against f32, max error over the largest "
        f"magnitude (tol {RAW_BF16_TOL}): "
        f"{json.dumps({k: round(v, 5) for k, v in raw.items()})}")
    log(f"[bf16-serve] gate by image at {HEIGHT}x{WIDTH}, top "
        f"{GATE_TOP_K}: classes equal and depth within 1% on all "
        f"{BATCH}; score drift max {max(g[2] for g in gates):.3g}; depth "
        f"mean relative error max {max(g[3] for g in gates):.3g}; IoU part "
        f"(each >= 0.97, mean >= 0.98) passed on "
        f"{sum(g[1] for g in gates)} of {BATCH} images; matched IoUs min "
        f"by image {[round(float(m), 4) for m in ious.min(1)]}, mean by "
        f"image {[round(float(m), 4) for m in ious.mean(1)]}")

    reqs = [frames(BATCH, HEIGHT, WIDTH, seed=10 + r) for r in range(REQUESTS)]
    for r in (r32, rbf):
        r.infer(reqs[0])                                   # warm-up
    times = {"f32": [], "bf16": []}
    for i in range(BF16_REPEATS):
        order = (("f32", r32), ("bf16", rbf))
        for name, r in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = r.infer(reqs[i % REQUESTS])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            check_outputs(out, BATCH, HEIGHT, WIDTH, cfg.solov2.top_k)
    before = read_counts()
    rbf.infer(reqs[0])
    launches = {k: n - before[k] for k, n in read_counts().items()}
    if launches["dcn_im2col"] != DCN_LAYERS_PRN50 or \
            launches["dcn_im2col_bf16"] != DCN_LAYERS_PRN50:
        raise AssertionError(f"bf16 request: launches {launches}, expected "
                             f"{DCN_LAYERS_PRN50} of the bf16 im2col")
    ms = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[bf16-serve] PRN-50 {BATCH}x{HEIGHT}x{WIDTH} ms/request, median "
        f"of {BF16_REPEATS} each, alternated: f32 {ms['f32']:.3f} "
        f"({[round(t, 3) for t in times['f32']]}), bf16 {ms['bf16']:.3f} "
        f"({[round(t, 3) for t in times['bf16']]}); one bf16 request "
        f"launches the bf16 im2col (prn_dcn_im2col_bf16) "
        f"{launches['dcn_im2col_bf16']} times; {card}")
    return launches, ms


def phase_bf16_train(card, train_ms, train_peak):
    """Phase 7 in bf16: PRN-50 at 8x640x640, the same batch and seeded
    weights, 20 steps; every loss finite, the last total below 0.95 of the
    first. Returns the launches of the timed steps, ms/step and peak."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0,
                                          compute_dtype="bfloat16"))
    per_step = launches_per_step(deterministic=False)
    # The forward's im2col reads bf16 x, the backward's the f32 copy.
    per_step["dcn_im2col_bf16"] = DCN_LAYERS_PRN50
    state = trainer.create_train_state(cfg, seed=0, device="cuda")
    perturb_(state.model, seed=1)
    batch = synthetic_batch(BATCH, TRAIN_SIZE, cfg.max_instances, seed=3)
    totals = [float(trainer.train_step(state, batch)["total"])]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for i in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        losses = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(losses["total"]))
        bad = [k for k, v in losses.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"bf16 training step {i + 1}: {bad} not "
                                 f"finite")
        if i + 1 == TIMED_STEPS:
            launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, n in launches.items():
        if n != per_step[k] * TIMED_STEPS:
            raise AssertionError(f"bf16 training: {k} {n} launches in "
                                 f"{TIMED_STEPS} steps, expected "
                                 f"{per_step[k]} a step")
    if not totals[-1] < 0.95 * totals[0]:
        raise AssertionError(f"bf16 training: the loss fell less than 5%: "
                             f"{totals}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("bf16 training: a parameter is not f32")
    ms = float(np.median(times[:TIMED_STEPS]))
    log(f"[bf16-train] PRN-50 {BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE} bf16 "
        f"(f32 parameters, losses and Adam), all five losses: per step "
        f"{[round(t, 3) for t in times[:TIMED_STEPS]]} ms; median "
        f"{ms:.3f} ms/step, {BATCH / ms * 1e3:.2f} img/s, peak memory "
        f"{peak:.2f} GiB, against phase 7's f32 {train_ms:.3f} ms/step and "
        f"{train_peak:.2f} GiB; {card}")
    log(f"[bf16-train] total loss over {len(totals)} steps "
        f"{[round(t, 4) for t in totals]}; launches a step "
        f"{json.dumps({k: n // TIMED_STEPS for k, n in launches.items()})}")
    return launches, ms, peak


# Data parallelism on one card: 2 ranks of the train CLI through the
# launcher, over gloo (NCCL refuses two ranks on one device), on phase 9's
# tree, with --reproductablity and no random augmentation (its generator is
# drawn in each rank's shard order), against one rank of the same program
# over the same global batches: the checkpoints written after DP_STEPS
# steps are compared, as the CPU test compares them (over more steps the
# runs part: rounding noise that Adam turns into +-lr steps moves the DCN
# offsets off the integer sample points on either side; PERF.md §6);
# the steps after them, to DP_ITERS, are timed.
DP_RANKS, DP_STEPS, DP_ITERS = 2, 2, 6
DP_CONFIG = "PlaneRecNet_50_config"
DP_OVERRIDES = {"augment": {"photometric_distort": False,
                            "random_mirror": False, "random_flip": False}}
DP_TIMEOUT = 240          # seconds a launch may take (~30 s measured)
# The JAX multihost test's tolerance (tests/test_multihost.py:106-111).
DP_TOL = dict(rtol=2e-4, atol=2e-5)
# With BatchNorm training, the step at random init turns f32 rounding
# anywhere into gradient differences of up to ~20% of a leaf's scale. The
# one rank's own, with its convolutions summed in another order (cuDNN
# off), is the yardstick: the Adam moments of 2 ranks may differ from 1
# rank's by at most this many times the yardstick's difference.
DP_YARDSTICK_FACTOR = 2.0


def dp_probe(log_path):
    """A rank's probe lines (``PRN_DEBUG_BATCH_SUM``): [(iter, wall time,
    launches so far, batch checksum)]."""
    rows = []
    with open(log_path) as f:
        for line in f:
            m = re.search(r"iter (\d+) t ([\d.]+) launches (\{.*\}) "
                          r"batch_sum ([-\d.]+)", line)
            if m:
                rows.append((int(m.group(1)), float(m.group(2)),
                             json.loads(m.group(3)), float(m.group(4))))
    return rows


def dp_args(name, batch, iters):
    """Phase 13's train CLI arguments: a global ``batch``, ``iters``
    steps, a checkpoint every DP_STEPS into ``name/``."""
    return ["--config", DP_CONFIG, "--batch_size", str(batch), "--dtype",
            "float32", "--no_tensorboard", "--no_autoscale",
            "--reproductablity", "--validation_epoch", "0",
            "--cfg_overrides", json.dumps(dict(DP_OVERRIDES, max_iter=iters)),
            "--save_interval", str(DP_STEPS), "--save_folder", name + "/"]


def dp_run(work, name, nproc, iters, site, batch=12, backend="gloo",
           cards=None, timeout=DP_TIMEOUT):
    """Launch ``nproc`` ranks of the train CLI from ``work`` (the site
    directory ``site`` on PYTHONPATH; ``cards`` the visible cards, all by
    default) for ``iters`` steps of a global ``batch``, a checkpoint
    every DP_STEPS; returns (the rank logs, the checkpoints written)."""
    import os
    from planerecnet_tpu_torch.tools.run_multihost import launch
    env = {"PRN_DEBUG_BATCH_SUM": "1", "PYTHONPATH": site}
    if cards is not None:
        env["CUDA_VISIBLE_DEVICES"] = cards
    logs = launch(nproc, dp_args(name, batch, iters)
                  + ["--n_devices", str(nproc)], platform="cuda",
                  backend=backend, log_dir=os.path.join(work, name + "_logs"),
                  timeout=timeout, extra_env=env)
    folder = os.path.join(work, name)
    return logs, [os.path.join(folder, f) for f in sorted(os.listdir(folder))]


def differing_arrays(path_a, path_b):
    """The arrays of two checkpoints that differ in any bit (or are
    missing from one), and how many there are."""
    with np.load(path_a) as a, np.load(path_b) as b:
        keys = sorted(set(a.files) | set(b.files))
        return [k for k in keys if k not in a.files or k not in b.files
                or a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                or a[k].tobytes() != b[k].tobytes()], len(keys)


def dp_shares(path_a, path_b):
    """Each float array of two checkpoints: its largest error over the JAX
    tolerance (1 = at the tolerance), by group (params, batch_stats,
    adam), and the leaves furthest off; the integer arrays must be
    equal."""
    worst = {"params": 0.0, "batch_stats": 0.0, "adam": 0.0}
    leaves = []
    with np.load(path_a) as a, np.load(path_b) as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("data parallel: the checkpoints hold other "
                                 "arrays")
        for key in a.files:
            x, y = a[key], b[key]
            if x.dtype.kind != "f":
                if not np.array_equal(x, y):
                    raise AssertionError(f"data parallel: {key} {x} != {y}")
            elif x.size:
                share = float((np.abs(x - y) / (DP_TOL["atol"] + DP_TOL[
                    "rtol"] * np.abs(x))).max())
                group = key.split("/", 1)[0]
                worst[group] = max(worst[group], share)
                leaves.append((round(share, 3), key))
    return worst, sorted(leaves, reverse=True)[:4]


def phase_dp(card, work):
    """Data parallelism on the one card, BatchNorm synced (6 images a rank,
    global batch 12), TF32 off in every run (a ``sitecustomize`` that sets
    ``torch.backends.cudnn.allow_tf32 = False`` at start-up: the ranks
    convolve 6 images a call and the one rank 12, and TF32's rounding,
    ~1e-3, moves the step's gradients at random init by a median 66%,
    PERF.md §6): 2 ranks against 1 rank, and 1 rank against itself
    with cuDNN off (its convolutions summed in another order: the
    yardstick). Each rank's checksums differ from the other's at every
    step and add up to the one rank's, each rank launches the im2col 26
    times and the deterministic variants 13/4/4 a step, rank 0 alone
    writes, and after DP_STEPS steps the parameters and BatchNorm
    statistics agree within ``DP_TOL`` and the Adam moments within
    ``DP_YARDSTICK_FACTOR`` times the yardstick's difference (their
    largest share of ``DP_TOL``). Returns the launches by rank and of the
    one rank over their probed steps."""
    import os
    sites = dp_sites(work)
    cwd = os.getcwd()
    os.chdir(work)
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        logs, written = dp_run(work, "dp2", DP_RANKS, DP_ITERS,
                               sites["tf32_off"])
        launch_s = time.perf_counter() - t0
        (one_log,), one = dp_run(work, "dp1", 1, DP_ITERS, sites["tf32_off"])
        _, yard = dp_run(work, "dp1_cudnn_off", 1, DP_STEPS,
                         sites["cudnn_off"])
    finally:
        os.chdir(cwd)
    probes, one_probe, _ = dp_verify("data parallel", logs, one_log,
                                     written, one, yard)

    def step_ms(rows):
        return [round((rows[i + 1][1] - rows[i][1]) * 1e3, 1)
                for i in range(DP_STEPS, DP_ITERS - 1)]

    timed = [step_ms(rows) for rows in probes]
    ms = float(np.median(sum(timed, [])))
    log(f"[dp] {DP_RANKS} ranks of the train CLI on ONE card over gloo "
        f"(two ranks sharing one card: not a scaling figure), {DP_CONFIG}, "
        f"{HEIGHT}x{WIDTH}, global batch 12, 6 images a rank, BatchNorm "
        f"synced, --reproductablity, TF32 off: launch to exit "
        f"{launch_s:.1f} s for {DP_ITERS} steps; ms/step {ms:.1f} (median "
        f"of steps {DP_STEPS + 1}-{DP_ITERS - 1} of both ranks: {timed}); "
        f"one rank, 12 images a step: {step_ms(one_probe)}; {card}")
    return [rows[-1][2] for rows in probes], one_probe[-1][2]


def dp_sites(work):
    """{"tf32_off", "cudnn_off"}: site directories under ``work`` whose
    ``sitecustomize`` turns cuDNN's TF32 off at start-up (a process
    with it on PYTHONPATH), the second cuDNN as a whole too (the
    yardstick)."""
    import os
    sites = {}
    cudnn_off = "torch.backends.cudnn.enabled = False\n"
    for name, body in (("tf32_off", ""), ("cudnn_off", cudnn_off)):
        sites[name] = os.path.join(work, name)
        os.makedirs(sites[name], exist_ok=True)
        with open(os.path.join(sites[name], "sitecustomize.py"), "w") as f:
            f.write("import torch\ntorch.backends.cudnn.allow_tf32 = False\n"
                    + body)
    return sites


def dp_verify(what, logs, one_log, written, one, yard):
    """Phase 13's rules for the ranks of one data-parallel run (rank
    logs ``logs``, rank 0's checkpoints ``written``) against one rank of
    the same program on the same global batches (``one_log``, ``one``)
    and its cuDNN-off twin (``yard``): rank 0 alone writes and prints;
    every rank probes each step; the ranks' batch checksums differ from
    each other at every step and add up to the one rank's; every rank
    launches the im2col 26 times and the deterministic variants 13/4/4 a
    step; after DP_STEPS steps the parameters and BatchNorm statistics
    agree within ``DP_TOL`` and the Adam moments within
    ``DP_YARDSTICK_FACTOR`` times the yardstick's difference. Logs the
    agreement; returns (the ranks' probes, the one rank's, the
    checksums)."""
    import os
    det_step = launches_per_step(deterministic=True)
    if len(written) != DP_ITERS // DP_STEPS:
        raise AssertionError(f"{what}: {written} written, expected "
                             f"{DP_ITERS // DP_STEPS} checkpoints from rank 0")
    for rank, path in enumerate(logs[1:], 1):
        with open(path) as f:
            text = f.read()
        if any(s in text for s in ("Begin training!", "Saving state",
                                   "Training complete.")):
            raise AssertionError(f"{what}: rank {rank} printed rank 0's "
                                 f"lines")
    probes = [dp_probe(p) for p in logs]
    one_probe = dp_probe(one_log)
    if any([r[0] for r in rows] != list(range(DP_ITERS))
           for rows in probes + [one_probe]):
        raise AssertionError(f"{what}: probe lines "
                             f"{[[r[0] for r in rows] for rows in probes]}")
    sums = [[r[3] for r in rows] for rows in probes]
    if any(len(set(step)) < len(step) for step in zip(*sums)):
        raise AssertionError(f"{what}: a step's shards coincide {sums}")
    if [sum(step) for step in zip(*sums)] != [r[3] for r in one_probe]:
        raise AssertionError(f"{what}: the shards {sums} do not add up to "
                             f"the global batches "
                             f"{[r[3] for r in one_probe]}")
    for rank, rows in enumerate(probes + [one_probe]):
        if any(rows[0][2].values()):
            raise AssertionError(f"{what}, rank {rank}: launches before the "
                                 f"first step {rows[0][2]}")
        for i in range(DP_ITERS - 1):
            step = {k: rows[i + 1][2][k] - rows[i][2][k] for k in det_step}
            if step != det_step:
                raise AssertionError(f"{what}, rank {rank} step {i}: "
                                     f"launches {step}, expected {det_step}")
    # The checkpoints after DP_STEPS steps (the first of each run).
    synced, synced_leaves = dp_shares(one[0], written[0])
    yardstick, yard_leaves = dp_shares(one[0], yard[0])
    log(f"[dp] {what}, {len(logs)} ranks: shards disjoint at every step "
        f"and adding up to the one rank's (checksums {sums}); rank 0 alone "
        f"wrote ({[os.path.basename(w) for w in written]}); each rank "
        f"launched {json.dumps(det_step)} a step. After {DP_STEPS} steps, "
        f"largest error over the JAX tolerance (rtol {DP_TOL['rtol']}, "
        f"atol {DP_TOL['atol']}) by group: {len(logs)} ranks against 1 "
        f"{json.dumps(synced)} {synced_leaves}; the yardstick, 1 rank "
        f"against itself with cuDNN off, {json.dumps(yardstick)} "
        f"{yard_leaves}")
    bad = [f"{g} {synced[g]:.3g}" for g in ("params", "batch_stats")
           if synced[g] > 1]
    if synced["adam"] > DP_YARDSTICK_FACTOR * max(yardstick["adam"], 1.0):
        bad.append(f"adam {synced['adam']:.3g} against the yardstick's "
                   f"{yardstick['adam']:.3g}")
    if bad:
        raise AssertionError(f"{what}: the {len(logs)}-rank checkpoint is "
                             f"off the 1-rank one: {bad}")
    return probes, one_probe, sums


def phase_check_dataset(work):
    """``tools/check_dataset.py`` on phase 9's valid split, on the card:
    a finite point-to-plane error for every frame."""
    import contextlib
    import io
    import os
    from planerecnet_tpu_torch.tools import check_dataset
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            errors = check_dataset.main(["--config", "PlaneRecNet_50_config",
                                         "--split", "valid"])
    finally:
        os.chdir(cwd)
    if len(errors) != CLI_SPLITS[1] or not np.isfinite(errors).all():
        raise AssertionError(f"check_dataset: errors {errors}")
    log(f"[check_dataset] {len(errors)} valid frames at {HEIGHT}x{WIDTH} "
        f"on cuda: mean point-to-plane error by frame "
        f"{[round(e, 5) for e in errors]}")
    return errors


# Phases 15-16, the spatial mesh axis on one card: ranks of this script
# (``--spatial_rank DIR``, launched through ``tools/run_multihost.py``)
# over gloo, since NCCL refuses two ranks on one device; SP_RANKS split
# the image height (a (1, SP_RANKS) data x spatial mesh), one rank of the
# same program runs it unsplit (a (1, 1) mesh). Two ranks sharing one
# card check that the split runs and computes the unsplit result; their
# times are no latency or scaling figure. Serving: PRN-50 with phase 5's
# seeded weights, SP_REQUESTS timed requests of each SP_SERVE shape
# (images, height, width): 1x640x640, the latency case that the JAX
# package's jit_forward names, and 8x480x640, where C5 (15 rows) does
# not split and is gathered. Training: SP_STEPS steps of the trainer API,
# PRN-50 with the preset's schedule, a global batch of SP_BATCH at
# 640x640 (6 images a data index: BatchNorm trains synced), phase 7's
# synthetic batch; the one rank also takes the steps with cuDNN off, the
# yardstick of phase 13.
SP_RANKS = 2
SP_SERVE = ((1, TRAIN_SIZE, TRAIN_SIZE), (BATCH, HEIGHT, WIDTH))
SP_REQUESTS = 3
SP_BATCH, SP_STEPS = 6, 2
SP_TIMEOUT = 300          # seconds a launch may take
# Every output of the split within SP_TOL of its scale (the largest
# magnitude) of the unsplit rank's (tests/test_spmd.py's 1e-4); the
# losses after step 1 within the JAX 2-D step test's tolerance.
SP_TOL = 1e-4
SP_LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
# The gradient's scale, which the Adam steps hide from the parameters:
# after step 1 exp_avg is (1 - beta1) g and exp_avg_sq (1 - beta2) g^2, so
# a module's gradient counted twice moves its exp_avg's norm by 1.0 of
# itself (3.0 for exp_avg_sq), and one counted half by 0.5 (0.75). Leaf
# by leaf the norms drift up to ~0.6 from rounding alone (the yardstick's,
# PERF.md section 6), so the check takes each moment's norm over a module
# (``moment_norms``): the split's within SP_NORM_TOL of the one rank's, or
# within DP_YARDSTICK_FACTOR times the yardstick's drift where that is
# larger; and at least SP_NORM_SEEN of the modules must have a bar under
# SP_NORM_BLIND, so that the check sees a gradient off by 2x either way.
SP_NORM_TOL = 0.25
SP_NORM_BLIND = 0.5
SP_NORM_SEEN = 0.9


def moment_norms(path):
    """{"moment/module": norm} of the Adam moments in a checkpoint, in
    f64, over each module of the model: the first two parts of a
    parameter's name, three under ``backbone.layers`` (29 modules of
    PRN-50: backbone.conv1, backbone.layers.0, ..., fpn.fpn_convs,
    inst_head.kernel_tower, ..., depth_decoder.depth_pred)."""
    sums = {}
    with np.load(path) as a:
        for key in a.files:
            if not key.startswith(("adam/exp_avg/", "adam/exp_avg_sq/")):
                continue
            _, moment, name = key.split("/", 2)
            parts = name.split(".")
            module = ".".join(parts[:3] if parts[1:2] == ["layers"]
                              else parts[:2])
            k = f"{moment}/{module}"
            sums[k] = sums.get(k, 0.0) + float(np.square(
                a[key].astype(np.float64)).sum())
    return {k: v ** 0.5 for k, v in sums.items()}


def norm_drifts(want, got):
    """{key: |got's norm / want's - 1|} (0 where both are 0)."""
    return {k: (abs(got[k] / v - 1.0) if v else
                (0.0 if not got[k] else float("inf")))
            for k, v in want.items()}


# What one launch of ``spatial_rank`` runs, unless its SPEC (JSON) says
# otherwise: phases 15-16 on a (1, world) mesh. ``n_data`` data indices;
# ``serve``: the request shapes; ``dtype``: the config's compute dtype
# (None: the preset's, f32); ``train``: SP_STEPS steps (and, on one rank,
# the cuDNN-off yardstick); ``det_twice``: the same steps twice more
# under ``--reproductablity``'s switches and variants; ``tag``: added to
# the files' stem.
SP_SPEC = {"n_data": 1, "serve": SP_SERVE, "dtype": None, "train": True,
           "det_twice": False, "tag": ""}


def spatial_rank(out_dir, spec=None):
    """One rank of phases 15-16 (and of ``--nccl``'s spatial checks): serve
    and train on a (n_data, world / n_data) mesh with TF32 off, as the
    JSON ``spec`` over ``SP_SPEC`` says; writes
    ``spatial{world}{tag}_rank{rank}.json`` (times, launches, peak memory,
    losses) and, on rank 0, the first request's outputs of each shape and
    the checkpoint after each training step (with cuDNN off too, where
    the world is one rank; ``_det1_``/``_det2_`` for the reproducible
    runs) into ``out_dir``."""
    import os
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.parallel.mesh import local_rows, make_mesh
    from planerecnet_tpu_torch.parallel.spmd import (initialize_distributed,
                                                     jit_forward)
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.utils.checkpoint import save_train_state
    spec = dict(SP_SPEC, **json.loads(spec or "{}"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = initialize_distributed("cuda")
    try:
        mesh = make_mesh(world.device, n_data=spec["n_data"],
                         n_spatial=world.size // spec["n_data"])
        stem = os.path.join(out_dir, f"spatial{world.size}{spec['tag']}")
        first = world.rank == 0
        cfg = PlaneRecNet_50_config
        if spec["dtype"]:
            cfg = cfg.copy(dict(compute_dtype=spec["dtype"]))
        out = {"serve": {}, "train": {}}

        runner = PlaneRecNetRunner(cfg, seed=0, device=world.device)
        perturb_(runner.model, seed=1)
        forward = jit_forward(cfg, mesh, spatial=True)
        for b, h, w in spec["serve"]:
            reqs = [fast_base_transform(torch.from_numpy(frames(
                b, h, w, seed=20 + r)).to(world.device))
                for r in range(SP_REQUESTS + 1)]
            forward(runner.model, reqs[0])                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, times = read_counts(), []
            for r, x in enumerate(reqs[1:]):
                t0 = time.perf_counter()
                preds = forward(runner.model, x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if r == 0 and first:
                    torch.save({k: ([t.cpu() for t in v] if isinstance(
                        v, list) else v.cpu()) for k, v in preds.items()},
                        f"{stem}_serve_{b}x{h}x{w}.pt")
            out["serve"][f"{b}x{h}x{w}"] = dict(
                ms=times, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: n - before[k] for k, n in read_counts().items()})
            del reqs, preds
        del runner
        torch.cuda.empty_cache()

        batch = local_rows(mesh, synthetic_batch(
            SP_BATCH, TRAIN_SIZE, cfg.max_instances, seed=3))
        runs = []
        if spec["train"]:
            runs += [("", True, False)] + (
                [("_cudnn_off", False, False)] if world.size == 1 else [])
        if spec["det_twice"]:
            runs += [("_det1", True, True), ("_det2", True, True)]
        for suffix, cudnn, det in runs:
            torch.backends.cudnn.enabled = cudnn
            with train_cli.reproducible_mode(det):
                state = trainer.create_train_state(cfg, seed=0, mesh=mesh,
                                                   deterministic=det)
                perturb_(state.model, seed=1)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                steps = []
                for i in range(SP_STEPS):
                    before = read_counts()
                    t0 = time.perf_counter()
                    losses = trainer.train_step(state, batch)
                    torch.cuda.synchronize()
                    steps.append(dict(
                        ms=(time.perf_counter() - t0) * 1e3,
                        losses={k: float(v) for k, v in losses.items()},
                        launches={k: n - before[k]
                                  for k, n in read_counts().items()}))
                    if first:
                        save_train_state(f"{stem}_train{suffix}_step{i + 1}",
                                         state)
            out["train" + suffix] = dict(
                steps=steps,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del state
            torch.cuda.empty_cache()
        with open(f"{stem}_rank{world.rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def spatial_launch(work, nproc, backend, spec=None, cards=None):
    """Phases 15-16's ranks of one world (``spec``: ``spatial_rank``'s;
    ``cards``: the visible cards, all by default): (each rank's results,
    the launch's seconds)."""
    import os
    from planerecnet_tpu_torch.tools.run_multihost import launch
    tag = json.loads(spec or "{}").get("tag", "")
    t0 = time.perf_counter()
    launch(nproc, ["--spatial_rank", work] + ([spec] if spec else []),
           platform="cuda", backend=backend,
           log_dir=os.path.join(work, f"spatial{nproc}{tag}_logs"),
           timeout=SP_TIMEOUT, module="chip_smoke",
           extra_env=None if cards is None else {
               "CUDA_VISIBLE_DEVICES": cards})
    seconds = time.perf_counter() - t0
    results = []
    for r in range(nproc):
        with open(os.path.join(work, f"spatial{nproc}{tag}_rank{r}.json")) \
                as f:
            results.append(json.load(f))
    return results, seconds


def phase_spatial(card, work, backend="gloo"):
    """Phases 15-16: the spatial axis on the one card, SP_RANKS ranks
    against one unsplit rank of the same program (``spatial_rank``);
    with ``backend="nccl"`` one card a rank, on a host with SP_RANKS.
    Checked by ``spatial_verify``; returns each rank's launches and the
    unsplit rank's, by path."""
    torch.cuda.empty_cache()
    one, one_s = spatial_launch(work, 1, backend)
    split, split_s = spatial_launch(work, SP_RANKS, backend)
    where = (f"{SP_RANKS} ranks sharing one card over gloo: no latency or "
             f"scaling figure" if backend == "gloo" else
             f"{SP_RANKS} ranks, one card each over {backend}")
    return spatial_verify(card, work, one[0], split, one_s, split_s, where)


def spatial_verify(card, work, one, split, one_s, split_s, where, tag="",
                   one_tag="", shapes=SP_SERVE, tol=SP_TOL, bf16=False,
                   train=True):
    """The split ranks' results ``split`` (files ``spatial{n}{tag}_*``)
    against the unsplit rank's ``one`` (``spatial1{one_tag}_*``).
    Serving: every output of each request shape in ``shapes`` within
    ``tol`` of its scale of the unsplit rank's, 13 im2col launches a
    request on every rank (all of the bf16 instance, with ``bf16``).
    Training (``train``): the losses of step 1 within SP_LOSS_TOL; after
    each step the
    parameters within phase 13's ``DP_TOL``, after step 1 the BatchNorm
    statistics too, and every other group (the Adam moments; after step 2
    the statistics, which the one rank's own yardstick puts past
    ``DP_TOL`` at 6x640x640, PERF.md section 6) within phase 13's
    yardstick rule; after each step each module's norm of the Adam moments
    within SP_NORM_TOL of the one rank's or DP_YARDSTICK_FACTOR times the
    yardstick's drift; each rank launching 26/13/4/4 a step. Returns each
    rank's launches and the unsplit rank's, by path."""
    import os
    n = len(split)
    dtype = "bf16" if bf16 else "f32"
    per_request = {k: 0 for k in kernel_counters()}
    per_request["dcn_im2col"] = DCN_LAYERS_PRN50
    if bf16:
        per_request["dcn_im2col_bf16"] = DCN_LAYERS_PRN50
    per_step = launches_per_step(deterministic=False)

    def stem(k):
        return os.path.join(work, f"spatial{k}{tag if k == n else one_tag}")

    for b, h, w in shapes:
        shape = f"{b}x{h}x{w}"
        want = torch.load(f"{stem(1)}_serve_{shape}.pt")
        got = torch.load(f"{stem(n)}_serve_{shape}.pt")
        errs = {}
        for key, value in want.items():
            for i, (a, g) in enumerate(zip(
                    value if isinstance(value, list) else [value],
                    got[key] if isinstance(got[key], list) else [got[key]])):
                scale = float(a.abs().max())
                errs[f"{key}{i}"] = float((g - a).abs().max()) / max(scale,
                                                                     1e-30)
        worst = max(errs.values())
        for r, res in enumerate(split + [one]):
            counts = res["serve"][shape]["launches"]
            if counts != {k: v * SP_REQUESTS for k, v in per_request.items()}:
                raise AssertionError(f"spatial serve {shape}, rank {r}: "
                                     f"launches {counts}")
        ms = [[round(t, 3) for t in res["serve"][shape]["ms"]]
              for res in split + [one]]
        peaks = [round(res["serve"][shape]["peak_gib"], 3) for res in split]
        log(f"[spatial-serve] PRN-50 {shape} {dtype}, TF32 off, {n} "
            f"ranks splitting the height ({where}): ms/request by rank "
            f"{ms[:-1]} (medians {[float(np.median(m)) for m in ms[:-1]]}) "
            f"against one unsplit rank's {ms[-1]} (median "
            f"{float(np.median(ms[-1])):.3f}); peak "
            f"memory by rank {peaks} "
            f"GiB against {one['serve'][shape]['peak_gib']:.3f} GiB; "
            f"largest error over scale {worst:.3g} (tol {tol}) "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
            f"{DCN_LAYERS_PRN50} {dtype} im2col launches a request on "
            f"every rank; "
            f"{card}")
        if not worst <= tol:
            raise AssertionError(f"spatial serve {shape}: outputs off the "
                                 f"unsplit rank's by {worst:.3g} of scale")

    if train:
        for r, res in enumerate(split + [one]):
            for i, step in enumerate(res["train"]["steps"]):
                if step["launches"] != per_step:
                    raise AssertionError(f"spatial train, rank {r} step {i}: "
                                         f"launches {step['launches']}")
        want = one["train"]["steps"][0]["losses"]
        for r, res in enumerate(split):
            got = res["train"]["steps"][0]["losses"]
            bad = {k: (got[k], v) for k, v in want.items()
                   if not abs(got[k] - v) <= SP_LOSS_TOL["atol"]
                   + SP_LOSS_TOL["rtol"] * abs(v)}
            if bad or not all(np.isfinite(list(got.values()))):
                raise AssertionError(f"spatial train, rank {r}: step-1 losses "
                                     f"off the unsplit rank's: {bad}")
        bad = []
        for step in range(1, SP_STEPS + 1):
            one_ckpt = f"{stem(1)}_train_step{step}.npz"
            shares, leaves = dp_shares(one_ckpt,
                                       f"{stem(n)}_train_step{step}.npz")
            yardstick, yard_leaves = dp_shares(
                one_ckpt, f"{stem(1)}_train_cudnn_off_step{step}.npz")
            log(f"[spatial-train] after step {step}, largest error over the "
                f"JAX tolerance (rtol {DP_TOL['rtol']}, atol "
                f"{DP_TOL['atol']}) "
                f"by group: {n} ranks against 1 {json.dumps(shares)} "
                f"{leaves}; the yardstick, 1 rank against itself with cuDNN "
                f"off, {json.dumps(yardstick)} {yard_leaves}")
            # The parameters within the tolerance; after step 1 (the
            # gradients taken at equal parameters) the statistics too; else
            # within the yardstick rule of phase 13's Adam moments.
            strict = ("params", "batch_stats") if step == 1 else ("params",)
            for group, share in shares.items():
                bar = 1.0 if group in strict else DP_YARDSTICK_FACTOR * max(
                    yardstick[group], 1.0)
                if share > bar:
                    bad.append(f"step {step} {group} {share:.3g} > {bar:.3g}")
            norms = moment_norms(one_ckpt)
            drift = norm_drifts(norms, moment_norms(
                f"{stem(n)}_train_step{step}.npz"))
            yard = norm_drifts(norms, moment_norms(
                f"{stem(1)}_train_cudnn_off_step{step}.npz"))
            bars = {k: max(SP_NORM_TOL, DP_YARDSTICK_FACTOR * yard[k])
                    for k in drift}
            off = sorted((drift[k] / bars[k], k) for k in drift
                         if drift[k] > bars[k])
            seen = sum(b < SP_NORM_BLIND for b in bars.values())
            worst = sorted(((round(drift[k], 4), round(yard[k], 4), k)
                            for k in drift), reverse=True)[:6]
            log(f"[spatial-train] after step {step}, the Adam moments' norm "
                f"by module, {n} ranks against 1: largest drift "
                f"{max(drift.values()):.3g}, the yardstick's "
                f"{max(yard.values()):.3g}; median "
                f"{np.median(list(drift.values())):.3g} against "
                f"{np.median(list(yard.values())):.3g}; furthest off (drift, "
                f"the yardstick's, moment/module) {worst}; {len(off)} of "
                f"{len(drift)} past their bar (max({SP_NORM_TOL}, "
                f"{DP_YARDSTICK_FACTOR}x the yardstick's)); {seen} have a bar "
                f"under {SP_NORM_BLIND} (they would see a gradient off by 2x)")
            if off:
                bad.append(f"step {step} moment norms off on {len(off)} "
                           f"modules, worst {off[-1][1]} at {off[-1][0]:.3g}x "
                           f"its bar")
            if seen < SP_NORM_SEEN * len(bars):
                bad.append(f"step {step}: the yardstick leaves only {seen} of "
                           f"{len(bars)} modules a bar under {SP_NORM_BLIND}")
        step_ms = [[round(s["ms"], 1) for s in res["train"]["steps"]]
                   for res in split]
        log(f"[spatial-train] PRN-50 {SP_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE} "
            f"f32, "
            f"TF32 off, BatchNorm synced, {n} ranks splitting the height "
            f"({where}): ms/step by rank "
            f"{step_ms} against one unsplit rank's "
            f"{[round(s['ms'], 1) for s in one['train']['steps']]}; peak "
            f"memory "
            f"by rank "
            f"{[round(res['train']['peak_gib'], 3) for res in split]} GiB "
            f"against {one['train']['peak_gib']:.3f} GiB; launch to exit: "
            f"{n} ranks {split_s:.1f} s, 1 rank {one_s:.1f} s; step-1 "
            f"losses "
            f"{json.dumps(split[0]['train']['steps'][0]['losses'])} against "
            f"{json.dumps(want)}; {card}")
        if bad:
            raise AssertionError(f"spatial train: the split checkpoint is off "
                                 f"the unsplit one: {bad}")

    def total(res, path):
        runs = [res[path]] if path == "train" else list(res[path].values())
        counts = [s["launches"] for run in runs
                  for s in (run["steps"] if path == "train" else [run])]
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    paths = ("serve", "train") if train else ("serve",)
    return ({f"spatial_{p}_rank{r}": total(res, p)
             for p in paths for r, res in enumerate(split)}
            | {f"spatial_{p}_one_process": total(one, p) for p in paths})


# Phase 18. The whole request that ``profile_inference`` times (CUDA
# events, phase 5's weights) must lie within phase 5's requests (host
# clock) widened by this share each way: phase 5's three requests span a
# few ms, and requests of one tree have moved by 10-25% between calls of
# one card (PERF.md).
TOOLS_SERVE_BAND = 0.25
TOOLS_ITERS = 5
TOOLS_TRACE_STEPS = 3           # the steps ``profile_train --trace`` traces
# The kernels that phase 18's traced step must show, by trace name, with
# their counters' names.
TOOLS_TRACE_KERNELS = {"dcn_im2col_kernel": "dcn_im2col",
                       "dcn_scatter_kernel": "dcn_scatter",
                       "dice_lava_fwd_kernel": "dice_lava_fwd",
                       "dice_lava_bwd_kernel": "dice_lava_bwd"}
ONE_BY_ONE = 32                 # the tiny preset's C5 is 1x1 at 32x32
ONE_BY_ONE_PADS = ((2, 3, 1, 1), (1, 2, 1, 6), (1, 2, 5, 1))


def check_one_by_one():
    """The 1x1 repair on the card: the tiny preset's request and one
    training step at 2x32x32, where C5 is 1x1 (the depth decoder's
    reflection pad and the mask head's GroupNorm of one value a group),
    then ``reflect_pad`` with an axis of one under ``--reproductablity``'s
    switches against its own CPU result, values and gradients in every
    bit."""
    from planerecnet_tpu_torch import train as train_cli
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config
    from planerecnet_tpu_torch.ops.image import reflect_pad
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.tools.profile_train import synth_batch
    cfg = PlaneRecNet_tiny_config.copy(dict(max_size=ONE_BY_ONE))
    runner = PlaneRecNetRunner(cfg, seed=0, device="cuda")
    out = runner.infer(frames(2, ONE_BY_ONE, ONE_BY_ONE, seed=30))
    check_outputs(out, 2, ONE_BY_ONE, ONE_BY_ONE, cfg.solov2.top_k)
    state = trainer.create_train_state(cfg, seed=0, device="cuda")
    losses = trainer.train_step(state, synth_batch(cfg, 2, ONE_BY_ONE,
                                                   ONE_BY_ONE))
    if not all(torch.isfinite(v) for v in losses.values()):
        raise AssertionError(f"1x1: step losses {losses}")
    g = torch.Generator().manual_seed(6)
    with train_cli.reproducible_mode(True):
        for shape in ONE_BY_ONE_PADS:
            x = torch.randn(shape, generator=g)
            dy = torch.randn(*shape[:2], shape[2] + 2, shape[3] + 2,
                             generator=g)
            got = []
            for dev in ("cuda", "cpu"):
                t = x.to(dev).requires_grad_()
                y = reflect_pad(t)
                y.backward(dy.to(dev))
                got.append((y.detach().cpu(), t.grad.cpu()))
            for what, i in (("values", 0), ("gradient", 1)):
                if not same_bits(got[0][i].contiguous(),
                                 got[1][i].contiguous()):
                    raise AssertionError(f"reflect_pad {what} at {shape} "
                                         f"differ from the CPU's")
    log(f"[tools] 1x1: the tiny preset's 2x{ONE_BY_ONE}x{ONE_BY_ONE} "
        f"request and step on the card (losses "
        f"{json.dumps({k: round(float(v), 4) for k, v in losses.items()})}"
        f"); reflect_pad at {list(ONE_BY_ONE_PADS)} equals its CPU result "
        f"in every bit under the deterministic switches")


def check_rle(work):
    """The C RLE codec on every annotation of the tree under ``work``
    against the numpy codec, each annotation decoded from its list counts
    and from the compressed string; the decode ms of both; and the C
    decode's share of the loader's read stage (``host_stages``) for the
    train split's batches."""
    import os
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.data import coco
    root = os.path.join(work, "scannet")
    anns = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".json"):
            with open(os.path.join(root, name)) as f:
                anns += [(name, a) for a in json.load(f)["annotations"]]
    segs = [a["segmentation"] for _, a in anns]
    segs += [{"size": s["size"], "counts": coco._encode_rle_counts(
        s["counts"])} for s in segs]
    times = {}
    for codec, fn in (("c", coco.rle_to_mask),
                      ("numpy", coco.rle_to_mask_plain)):
        t0 = time.perf_counter()
        masks = [fn(s) for s in segs]
        times[codec] = (time.perf_counter() - t0) * 1e3
        if codec == "c":
            c_masks = masks
    differ = sum(not np.array_equal(a, b) for a, b in zip(c_masks, masks))
    if differ:
        raise AssertionError(f"RLE: {differ} of {len(segs)} masks differ "
                             f"between the C and the numpy codec")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        stages = host_stages(PlaneRecNet_50_config, n_batches=1)
        train = [a for n, a in anns if n == "scannet_train.json"]
        by_image = {}
        for a in train:
            by_image.setdefault(a["image_id"], []).append(a["segmentation"])
        batch = [s for i in sorted(by_image)[:BATCH] for s in by_image[i]]
        t0 = time.perf_counter()
        for s in batch:
            coco.rle_to_mask(s)
        decode_ms = (time.perf_counter() - t0) * 1e3
    finally:
        os.chdir(cwd)
    log(f"[tools] RLE: {len(segs)} masks ({len(anns)} annotations, list "
        f"and compressed counts) equal between the codecs; decode "
        f"{times['c']:.3f} ms (C) against {times['numpy']:.3f} ms (numpy) "
        f"in all; one batch of {BATCH} train images: {len(batch)} masks "
        f"decoded in {decode_ms:.3f} ms, {decode_ms / stages['read']:.4f} "
        f"of its {stages['read']:.3f} ms read stage")
    return dict(times, read_ms=stages["read"], batch_decode_ms=decode_ms)


def phase_tools(card, work, request_ms, train_ms=None):
    """Phase 18: the port's tools on the card (module docstring). Returns
    the launches of the phase by kernel."""
    import os
    from planerecnet_tpu_torch.tools import (bench_dice_kernel,
                                             bench_dispatch, bench_optimizer,
                                             parse_trace, profile_inference,
                                             profile_train, roofline)
    t0 = time.perf_counter()
    zero_counts()
    check_one_by_one()
    check_rle(work)
    prn50 = ["--config", "PlaneRecNet_50_config"]
    serve = {}
    for b in (1, BATCH):
        serve[b] = profile_inference.main(prn50 + [
            "--batch_size", str(b), "--height", str(HEIGHT), "--width",
            str(WIDTH), "--iters", str(TOOLS_ITERS)],
            set_weights=phase5_weights)
        log(f"[tools] profile_inference {b}x{HEIGHT}x{WIDTH}: "
            f"{json.dumps(serve[b]['stages_ms'])}")
    lo = min(request_ms) * (1 - TOOLS_SERVE_BAND)
    hi = max(request_ms) * (1 + TOOLS_SERVE_BAND)
    infer_ms = serve[BATCH]["stages_ms"]["infer"]
    if not lo <= infer_ms <= hi:
        raise AssertionError(f"profile_inference: a request {infer_ms:.3f} "
                             f"ms, outside {lo:.3f}-{hi:.3f} (phase 5's "
                             f"{request_ms} +-{TOOLS_SERVE_BAND:.0%})")
    trace_dir = os.path.join(work, "tools_trace")
    step = profile_train.main(prn50 + [
        "--batch_size", str(BATCH), "--size", str(TRAIN_SIZE), "--iters",
        str(TOOLS_ITERS), "--warmup", "1", "--split_timing", "--trace",
        trace_dir], set_weights=phase5_weights)
    log(f"[tools] profile_train: {step['value']:.3f} ms/step, stages "
        f"{json.dumps(step['split_ms'])}, peak {step['peak_gib']} GiB")
    summary = parse_trace.main([trace_dir, "--runs", str(TOOLS_TRACE_STEPS),
                                "--top", "30"])
    per_step = launches_per_step(deterministic=False)
    names = [k["kernel"] for k in summary["kernels"]]
    for kernel, counter in TOOLS_TRACE_KERNELS.items():
        calls = parse_trace.calls_of(summary, kernel)
        rank = next((i for i, n in enumerate(names) if kernel in n), None)
        log(f"[tools] parse_trace: {kernel} x{calls:g} a step, rank "
            f"{rank} of {len(names)} by device time")
        if calls != per_step[counter]:
            raise AssertionError(f"parse_trace: {kernel} {calls} calls a "
                                 f"step, expected {per_step[counter]}")
    roof = roofline.main(prn50 + [
        "--imgs_per_s", str(BATCH / float(np.median(request_ms)) * 1e3),
        "--train", "--train_ms", str(train_ms or step["value"])],
        set_weights=phase5_weights)
    log("[tools] roofline: " + "; ".join(
        f"{what} {roof[what]['flops'] / 1e9:.2f} GFLOP and "
        f"{roof[what]['bytes'] / 1e6:.1f} MB a{'n image' if what == 'request' else ' step'}"
        f", mfu {roof[what].get('mfu')}, hbm_share "
        f"{roof[what].get('hbm_share')}" for what in ("request", "step"))
        + f"; {card}")
    bench_dice_kernel.main(["--iters", str(TOOLS_ITERS)])
    bench_optimizer.main(prn50 + ["--iters", str(TOOLS_ITERS)])
    bench_dispatch.main(["--iters", str(TOOLS_ITERS)])
    launches = read_counts()
    log(f"[tools] phase 18 in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(launches)}")
    return launches


def tools_alone(card):
    """``--tools``: phase 18 on its own, with phase 5's requests and a
    synthetic tree of 8 training frames."""
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.ops import dcn
    from planerecnet_tpu_torch.tools import synth_scenes
    torch.backends.cudnn.allow_tf32 = True      # as in phases 5 and 7
    runner, _, request_ms = phase_main(dcn, PlaneRecNet_50_config, card)
    del runner
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="prn_tools_")
    try:
        synth_scenes.generate_dataset(work, BATCH, 0, 0, h=HEIGHT, w=WIDTH,
                                      seed=0, progress=False)
        phase_tools(card, work, request_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ``--nccl``: the data and spatial axes over NCCL on one host, one rank a
# card, on NCCL_CARDS cards (fewer: the mode fails). Phase 13's check
# through the train CLI as users start it (``--n_devices N`` starts the
# ranks) on 2 and on 4 cards, against one rank on the same global
# batches; the 4-card run twice, bit for bit; phases 15-16 on a (2, 2)
# mesh, and its steps twice under ``--reproductablity``'s switches and
# variants; phase 15's serving in bf16 on a (1, 2) mesh; then PRN-50's
# default step (phase 7's settings) on 1, 2 and 4 cards, the 4-card step
# through the CLI and its loaders, and a trace of rank 0 on 4 cards.
# Jobs that need fewer cards than the host has run side by side, each on
# its own (``CUDA_VISIBLE_DEVICES``); the timed runs run alone.
NCCL_CARDS = 4
NCCL_TIMEOUT = 420      # seconds a launch or CLI run may take
NCCL_WARMUP, NCCL_TIMED, NCCL_TRACED = 2, 10, 3
# The 4-card CLI run: its tree of 640x640 frames (3 global batches of 32)
# and its steps; the steps within an epoch after the first are timed.
NCCL_CLI_FRAMES, NCCL_CLI_ITERS = 96, 12
# Phase 15's request that splits over 2 data indices, and the (2, 2)
# mesh's runs (``spatial_rank``'s SPEC).
NCCL_2D = {"n_data": 2, "serve": [[BATCH, HEIGHT, WIDTH]],
           "det_twice": True, "tag": "_2x2"}
NCCL_BF16 = {"dtype": "bfloat16", "train": False, "tag": "_bf16"}


def run_logged(cmd, log_path, timeout, env=None, cwd=None):
    """Run ``cmd`` in a session of its own, its output into ``log_path``;
    returns its exit code. At ``timeout`` seconds, or if this process is
    interrupted, its whole process group (the ranks it started with it)
    is killed."""
    import os
    import signal
    with open(log_path, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                             env=env, cwd=cwd, start_new_session=True)
        try:
            return p.wait(timeout=timeout)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def tail(path, lines=20):
    with open(path) as f:
        return "".join(f.readlines()[-lines:])


def side_by_side(*jobs):
    """Run the callables ``jobs`` at once (each on cards of its own);
    their results in order, or the first one's error once all ended."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(job) for job in jobs]
    return [f.result() for f in futures]


def repo_env(**extra):
    """This process's environment with the repository first on
    PYTHONPATH (``PYTHONPATH`` in ``extra`` goes in front of it)."""
    import os
    paths = [extra.pop("PYTHONPATH", None),
             os.path.dirname(os.path.abspath(__file__)),
             os.environ.get("PYTHONPATH")]
    return dict(os.environ, **extra,
                PYTHONPATH=os.pathsep.join(p for p in paths if p))


def nccl_cli(work, name, n, batch, site, cards):
    """Phase 13's run through the train CLI as users start it on ``n``
    cards (``--n_devices n``; ``cards`` visible): (the rank logs, rank 0's
    checkpoints)."""
    import os
    logs = os.path.join(work, name + "_logs")
    os.makedirs(logs, exist_ok=True)
    rank0 = os.path.join(logs, "rank0.log")
    code = run_logged(
        [sys.executable, "-m", "planerecnet_tpu_torch.train",
         *dp_args(name, batch, DP_ITERS), "--n_devices", str(n),
         "--log_folder", name + "_logs/"], rank0, NCCL_TIMEOUT,
        env=repo_env(PYTHONPATH=site, PRN_DEBUG_BATCH_SUM="1",
                     CUDA_VISIBLE_DEVICES=cards), cwd=work)
    if code:
        raise AssertionError(f"{name}: the train CLI exited {code}:\n"
                             f"{tail(rank0)}")
    folder = os.path.join(work, name)
    return ([rank0] + [os.path.join(logs, "ranks", f"worker{r}.log")
                       for r in range(1, n)],
            [os.path.join(folder, f) for f in sorted(os.listdir(folder))])


def nccl_dp(card, work):
    """Item 1-2 of ``--nccl``: phase 13 over NCCL through the train CLI on
    2 and 4 cards, each against one rank at the same global batch (6
    images a rank) with ``dp_verify``'s rules; the 4-card run twice, its
    checkpoints equal in every bit of every array; its last checkpoint
    loaded in one process. Returns the launches by rank and path."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.utils.checkpoint import load_train_state
    sites = dp_sites(work)
    tf32, yard = sites["tf32_off"], sites["cudnn_off"]
    one = {}

    def one_rank(tag, batch, iters, site, card_index):
        return dp_run(work, f"nccl_{tag}{batch}", 1, iters, site,
                      batch=batch, backend="nccl", cards=card_index,
                      timeout=NCCL_TIMEOUT)

    t0 = time.perf_counter()
    (logs2, ckpt2), one[12], one[24] = side_by_side(
        lambda: nccl_cli(work, "nccl2", 2, 12, tf32, "0,1"),
        lambda: one_rank("one", 12, DP_ITERS, tf32, "2"),
        lambda: one_rank("one", 24, DP_ITERS, tf32, "3"))
    t1 = time.perf_counter()
    (_, yard12), (_, yard24) = side_by_side(
        lambda: one_rank("yard", 12, DP_STEPS, yard, "0"),
        lambda: one_rank("yard", 24, DP_STEPS, yard, "1"))
    t2 = time.perf_counter()
    logs4, ckpt4 = nccl_cli(work, "nccl4", NCCL_CARDS, 24, tf32, "0,1,2,3")
    t3 = time.perf_counter()
    _, ckpt4b = nccl_cli(work, "nccl4b", NCCL_CARDS, 24, tf32, "0,1,2,3")
    t4 = time.perf_counter()
    log(f"[nccl-dp] launch to exit: 2-card CLI with the one-rank runs at "
        f"12 and 24 beside it {t1 - t0:.1f} s; the yardsticks "
        f"{t2 - t1:.1f} s; 4-card CLI {t3 - t2:.1f} s, again "
        f"{t4 - t3:.1f} s; {card}")
    probes2, _, _ = dp_verify("NCCL through the CLI, 2 cards", logs2,
                              one[12][0][0], ckpt2, one[12][1], yard12)
    probes4, _, _ = dp_verify("NCCL through the CLI, 4 cards", logs4,
                              one[24][0][0], ckpt4, one[24][1], yard24)
    if len(ckpt4b) != len(ckpt4):
        raise AssertionError(f"4 cards twice: {ckpt4} and {ckpt4b}")
    n_arrays = 0
    for a, b in zip(ckpt4, ckpt4b):
        differ, n_arrays = differing_arrays(a, b)
        if differ:
            raise AssertionError(f"4 cards twice with --reproductablity: "
                                 f"{len(differ)} of {n_arrays} arrays of "
                                 f"{a} differ, e.g. {differ[:5]}")
    state = trainer.create_train_state(PlaneRecNet_50_config, seed=0,
                                       device="cuda")
    load_train_state(ckpt4[-1], state)
    if state.step != DP_ITERS:
        raise AssertionError(f"the 4-card checkpoint loads at step "
                             f"{state.step}")
    del state
    torch.cuda.empty_cache()
    log(f"[nccl-dp] 4 cards twice with --reproductablity: all "
        f"{len(ckpt4)} checkpoints agree in every bit of all {n_arrays} "
        f"arrays; the last loads in one process at step {DP_ITERS}")
    return ({f"nccl_dp2_rank{r}": rows[-1][2]
             for r, rows in enumerate(probes2)}
            | {f"nccl_dp4_rank{r}": rows[-1][2]
               for r, rows in enumerate(probes4)})


def nccl_spatial(card, work):
    """Items 3-4 of ``--nccl``: phases 15-16 on a (2, 2) mesh of 4 cards
    (phase 15's 8x480x640 requests, 4 images a data index, 240 rows a
    rank; phase 16's steps at 6x640x640) against one unsplit rank, and
    the same steps twice under ``--reproductablity``'s switches and
    variants, equal in every bit of every array; phase 15's serving in
    bf16 on a (1, 2) mesh against one unsplit bf16 rank, within phase
    11's RAW_BF16_TOL of each output's scale. Returns the launches by
    rank and path."""
    import os
    bf16 = json.dumps(NCCL_BF16)
    (split_bf16, split_bf16_s), (one, one_s), (one_bf16, one_bf16_s) = \
        side_by_side(
            lambda: spatial_launch(work, 2, "nccl", bf16, cards="0,1"),
            lambda: spatial_launch(work, 1, "nccl", cards="2"),
            lambda: spatial_launch(work, 1, "nccl", bf16, cards="3"))
    split, split_s = spatial_launch(work, NCCL_CARDS, "nccl",
                                    json.dumps(NCCL_2D))
    launches = spatial_verify(
        card, work, one[0], split, one_s, split_s,
        "4 ranks on a (2, 2) data x spatial mesh, one card each over nccl",
        tag=NCCL_2D["tag"], shapes=[tuple(s) for s in NCCL_2D["serve"]])
    det_step = launches_per_step(deterministic=True)
    for r, res in enumerate(split):
        for run in ("train_det1", "train_det2"):
            for i, step in enumerate(res[run]["steps"]):
                if step["launches"] != det_step:
                    raise AssertionError(f"(2, 2) {run}, rank {r} step {i}:"
                                         f" launches {step['launches']}")
    stem = os.path.join(work, f"spatial{NCCL_CARDS}{NCCL_2D['tag']}")
    n_arrays = 0
    for step in range(1, SP_STEPS + 1):
        differ, n_arrays = differing_arrays(
            f"{stem}_train_det1_step{step}.npz",
            f"{stem}_train_det2_step{step}.npz")
        if differ:
            raise AssertionError(f"(2, 2) with --reproductablity's switches "
                                 f"twice: {len(differ)} of {n_arrays} arrays "
                                 f"differ after step {step}, e.g. "
                                 f"{differ[:5]}")
    log(f"[nccl-spatial] (2, 2) mesh, {SP_STEPS} steps twice under "
        f"--reproductablity's switches and variants: every array of the "
        f"checkpoints ({n_arrays}) equal in every bit after each step; "
        f"each rank launched {json.dumps(det_step)} a step")
    launches |= {k.replace("spatial_", "spatial_bf16_"): v for k, v in
                 spatial_verify(
                     card, work, one_bf16[0], split_bf16, one_bf16_s,
                     split_bf16_s, "2 ranks, one card each over nccl",
                     tag=NCCL_BF16["tag"], one_tag=NCCL_BF16["tag"],
                     tol=RAW_BF16_TOL, bf16=True, train=False).items()}
    for r, res in enumerate(split):
        launches[f"spatial_det_rank{r}"] = {
            k: sum(s["launches"][k] for run in ("train_det1", "train_det2")
                   for s in res[run]["steps"]) for k in det_step}
    return {"nccl_" + k: v for k, v in launches.items()}


def label_collectives():
    """Wrap each of the port's collectives in a ``torch.profiler`` range
    named by what issues it: ``prn:syncbn`` (``SyncBatchNorm2d``'s sums),
    ``prn:losses`` (the losses' global counts), ``prn:gradients`` (DDP's
    buckets). Measurement only; before the train state is made."""
    import functools
    from torch.profiler import record_function
    from planerecnet_tpu_torch.parallel import mesh as pmesh
    from planerecnet_tpu_torch.parallel import spmd

    def labelled(fn, name):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    spmd._all_sum = labelled(spmd._all_sum, "prn:syncbn")
    pmesh.Mesh.all_sum = labelled(pmesh.Mesh.all_sum, "prn:losses")
    pmesh._sum_hook = labelled(pmesh._sum_hook, "prn:gradients")


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, starts, a, b):
    """The length of [a, b] that the sorted disjoint ``merged`` covers."""
    import bisect
    total, i = 0.0, max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return total


def nccl_split(events, runs):
    """A rank's NCCL kernels in a trace, by what issued them. Each
    ``prn:*`` range of ``label_collectives`` issues one collective, and
    one communicator runs its kernels on one stream in issue order, so
    the k-th range by start issued the k-th NCCL kernel (where the counts
    differ, every kernel is counted under ``all`` alone). Per run: by
    class, ``calls``, ``ms`` (the kernels' device time, their wait for
    the other ranks included), ``exposed_ms`` (the part of it when no
    other device work ran) and ``overlap_share`` (1 - exposed / ms); and
    the share of the traced window in which no device work but NCCL's
    ran (``compute_idle_share``)."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    device = [e for e in complete if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    nccl = sorted((e for e in device if e.get("cat") == "kernel"
                   and "nccl" in e.get("name", "").lower()),
                  key=lambda e: span(e))
    labels = sorted((e for e in complete if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("prn:")),
                    key=lambda e: span(e))
    skip = {id(e) for e in nccl}
    compute = _merged(span(e) for e in device if id(e) not in skip)
    starts = [a for a, _ in compute]
    paired = len(labels) == len(nccl)
    classes = {}
    for i, e in enumerate(nccl):
        a, b = span(e)
        for cls in {"all", labels[i]["name"][4:] if paired else "all"}:
            row = classes.setdefault(cls, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += b - a
            row[2] += (b - a) - _covered(compute, starts, a, b)
    spans = [span(e) for e in complete]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"nccl_kernels": len(nccl) / runs, "ranges": len(labels) / runs,
            "paired": paired,
            "names": sorted({e["name"][:60] for e in nccl})[:6],
            "classes": {cls: {"calls": n / runs, "ms": us / 1e3 / runs,
                              "exposed_ms": ex / 1e3 / runs,
                              "overlap_share": 1 - ex / us if us else 0.0}
                        for cls, (n, us, ex) in classes.items()},
            "compute_idle_share": 1 - sum(b - a for a, b in compute)
            / window if window else 0.0}


def step_rank(out_dir):
    """One rank of ``--nccl``'s timing: PRN-50's default step at phase 7's
    settings (f32, cuDNN TF32 on, seeded perturbed weights, phase 7's
    synthetic batch on rank 0, seeds 3 + rank), 8x640x640 a rank;
    NCCL_WARMUP steps, then NCCL_TIMED timed (host clock, synchronised),
    their peak memory and launches; on NCCL_CARDS ranks rank 0 traces
    NCCL_TRACED more (``nccl_split``). One rank trains without a mesh, as
    phase 7. Writes ``step{world}_rank{rank}.json`` into ``out_dir``."""
    import os
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.parallel.spmd import initialize_distributed
    from planerecnet_tpu_torch.tools import parse_trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    label_collectives()
    world = initialize_distributed("cuda")
    try:
        cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0))
        state = trainer.create_train_state(
            cfg, seed=0, device=world.device,
            mesh=world if world.size > 1 else None)
        perturb_(state.model, seed=1)
        batch = synthetic_batch(BATCH, TRAIN_SIZE, cfg.max_instances,
                                seed=3 + world.rank)
        for _ in range(NCCL_WARMUP):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, times = read_counts(), []
        for _ in range(NCCL_TIMED):
            t0 = time.perf_counter()
            trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out = {"ms": times,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {k: n - before[k]
                            for k, n in read_counts().items()}}
        if world.size == NCCL_CARDS:
            if world.rank == 0:
                summary = parse_trace.record(
                    lambda: trainer.train_step(state, batch), NCCL_TRACED,
                    out_dir, f"step{world.size}", world.device)
                out["trace"] = dict(
                    nccl_split(parse_trace.load(summary["trace"]),
                               NCCL_TRACED),
                    **{k: summary[k] for k in ("wall_ms", "window_ms",
                                               "busy_ms", "idle_share")})
            else:
                for _ in range(NCCL_TRACED):
                    trainer.train_step(state, batch)
                torch.cuda.synchronize()
        with open(os.path.join(out_dir, f"step{world.size}_rank"
                               f"{world.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def nccl_timing(card, work, tree):
    """Item 5 of ``--nccl``: ``step_rank`` on 1, 2 and 4 cards, one run at
    a time (rank 0's median ms, images/s over the ranks, t1 / tN, peak
    memory a card, launches a step), then the train CLI with no
    ``--n_devices`` on the host's 4 cards from the 640x640 ``tree``
    (global batch 32, 8 a card, TF32 on, its loaders; ms a step from rank
    0's probe, which reads each batch's checksum back once a step).
    Returns the numbers and the launches by rank and path."""
    import os
    from planerecnet_tpu_torch.tools.run_multihost import launch
    per_step = launches_per_step(deterministic=False)
    steps, launches = {}, {}
    for n in (1, 2, NCCL_CARDS):
        t0 = time.perf_counter()
        launch(n, ["--step_rank", work], platform="cuda",
               log_dir=os.path.join(work, f"step{n}_logs"),
               timeout=NCCL_TIMEOUT, module="chip_smoke",
               extra_env={"CUDA_VISIBLE_DEVICES": ",".join(
                   map(str, range(n)))})
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"step{n}_rank{r}.json")) as f:
                ranks.append(json.load(f))
            got = ranks[-1]["launches"]
            if got != {k: v * NCCL_TIMED for k, v in per_step.items()}:
                raise AssertionError(f"{n} cards, rank {r}: launches {got} "
                                     f"in {NCCL_TIMED} steps")
            launches[f"nccl_step{n}_rank{r}"] = got
        ms = float(np.median(ranks[0]["ms"]))
        steps[n] = {"ms": ms, "img_s": n * BATCH / ms * 1e3,
                    "rank_medians": [float(np.median(x["ms"]))
                                     for x in ranks],
                    "peak_gib": [x["peak_gib"] for x in ranks],
                    "launch_s": seconds, "trace": ranks[0].get("trace")}
        if not np.isfinite(ms):
            raise AssertionError(f"{n} cards: step times {ranks[0]['ms']}")
    for n, row in steps.items():
        row["efficiency"] = steps[1]["ms"] / row["ms"]
        log(f"[nccl-step] PRN-50 {BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE} a card, "
            f"f32, cuDNN TF32 on, {n} card(s): rank 0 {row['ms']:.3f} "
            f"ms/step (median of {NCCL_TIMED}; each rank's "
            f"{[round(m, 3) for m in row['rank_medians']]}), "
            f"{row['img_s']:.2f} img/s over the ranks, t1/tN "
            f"{row['efficiency']:.4f}, peak memory by rank "
            f"{[round(p, 3) for p in row['peak_gib']]} GiB, launch to exit "
            f"{row['launch_s']:.1f} s; {card}")
    trace = steps[NCCL_CARDS]["trace"]
    log(f"[nccl-trace] rank 0 of {NCCL_CARDS}, {NCCL_TRACED} steps under "
        f"torch.profiler, per step: {json.dumps(trace)}; {card}")

    log_path = os.path.join(tree, "cli_rank0.log")
    t0 = time.perf_counter()
    code = run_logged(
        [sys.executable, "-m", "planerecnet_tpu_torch.train", "--config",
         "PlaneRecNet_50_config", "--batch_size", str(NCCL_CARDS * BATCH),
         "--no_autoscale", "--no_tensorboard", "--validation_epoch", "0",
         "--cfg_overrides", json.dumps({"max_iter": NCCL_CLI_ITERS}),
         "--save_interval", str(10 * NCCL_CLI_ITERS), "--save_folder",
         "cli4/", "--log_folder", "cli4_logs/"], log_path, NCCL_TIMEOUT,
        env=repo_env(PRN_DEBUG_BATCH_SUM="1"), cwd=tree)
    seconds = time.perf_counter() - t0
    if code:
        raise AssertionError(f"the 4-card train CLI exited {code}:\n"
                             f"{tail(log_path)}")
    logs = [log_path] + [os.path.join(tree, "cli4_logs", "ranks",
                                      f"worker{r}.log")
                         for r in range(1, NCCL_CARDS)]
    probes = [dp_probe(p) for p in logs]
    for r, rows in enumerate(probes):
        if [row[0] for row in rows] != list(range(NCCL_CLI_ITERS)):
            raise AssertionError(f"4-card CLI, rank {r}: probes "
                                 f"{[row[0] for row in rows]}")
        for i in range(NCCL_CLI_ITERS - 1):
            step = {k: rows[i + 1][2][k] - rows[i][2][k] for k in per_step}
            if step != per_step:
                raise AssertionError(f"4-card CLI, rank {r} step {i}: "
                                     f"launches {step}")
        launches[f"nccl_cli4_rank{r}"] = rows[-1][2]
    t = [row[1] for row in probes[0]]
    per = NCCL_CLI_FRAMES // (NCCL_CARDS * BATCH)
    gaps = [(t[i + 1] - t[i]) * 1e3 for i in range(per, NCCL_CLI_ITERS - 1)
            if (i + 1) % per]
    cli_ms = float(np.median(gaps))
    log(f"[nccl-cli] python -m planerecnet_tpu_torch.train with no "
        f"--n_devices on {NCCL_CARDS} cards: global batch "
        f"{NCCL_CARDS * BATCH} at {TRAIN_SIZE}x{TRAIN_SIZE} (8 a card, "
        f"BatchNorm synced), f32, TF32 on, its loaders: {cli_ms:.1f} "
        f"ms/step (median of steps within an epoch after the first, "
        f"{[round(g, 1) for g in gaps]}), "
        f"{NCCL_CARDS * BATCH / cli_ms * 1e3:.2f} img/s; launch to exit "
        f"{seconds:.1f} s for {NCCL_CLI_ITERS} steps; every rank launched "
        f"{json.dumps(per_step)} a step; {card}")
    return ({"steps": {n: {k: v for k, v in row.items() if k != "trace"}
                       for n, row in steps.items()},
             "trace": trace, "cli4_ms": cli_ms,
             "cli4_img_s": NCCL_CARDS * BATCH / cli_ms * 1e3}, launches)


def phase_nccl(card):
    """``--nccl``: items 1-5 above on one host's NCCL_CARDS cards, from a
    work directory that holds phase 9's tree of 480x640 frames (its 24
    train frames) and, generated meanwhile in a process of its own, the
    4-card CLI's tree of 640x640 ones. Prints the numbers and the
    launches by path as one ``[nccl]`` JSON line."""
    import os
    from planerecnet_tpu_torch.tools import synth_scenes
    work = tempfile.mkdtemp(prefix="prn_nccl_")
    tree = os.path.join(work, "tree640")
    os.makedirs(tree)
    synth = subprocess.Popen(
        [sys.executable, "-m", "planerecnet_tpu_torch.tools.synth_scenes",
         "--out", tree, "--train", str(NCCL_CLI_FRAMES), "--val", "0",
         "--eval", "0", "--height", str(TRAIN_SIZE), "--width",
         str(TRAIN_SIZE)], env=repo_env(), stdout=subprocess.DEVNULL)
    cwd = os.getcwd()
    try:
        synth_scenes.generate_dataset(work, CLI_SPLITS[0], 0, 0, h=HEIGHT,
                                      w=WIDTH, seed=0, progress=False)
        os.chdir(work)
        launches = nccl_dp(card, work)
        launches |= nccl_spatial(card, work)
        if synth.wait(timeout=NCCL_TIMEOUT):
            raise AssertionError(f"synth_scenes exited {synth.returncode}")
        numbers, timing = nccl_timing(card, work, tree)
        launches |= timing
    finally:
        os.chdir(cwd)
        if synth.poll() is None:
            synth.kill()
            synth.wait()
        shutil.rmtree(work, ignore_errors=True)
    print("[nccl] " + json.dumps({"numbers": numbers, "launches": launches,
                                  "card": card}), flush=True)


PATHS_REPEATS = 10


def time_paths(card):
    """``--paths``: phase 5's request (PRN-50, 8x480x640, f32) and phase
    7's default training step (8x640x640, f32, all five losses), each with
    seeded perturbed weights, warmed up twice, then timed
    ``PATHS_REPEATS`` times on the host's clock around a synchronize."""
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner

    def median_ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(PATHS_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), [round(t, 3) for t in times]

    torch.backends.cudnn.allow_tf32 = True      # as in phases 5 and 7
    runner = PlaneRecNetRunner(PlaneRecNet_50_config, seed=0, device="cuda")
    perturb_(runner.model, seed=1)
    reqs = [frames(BATCH, HEIGHT, WIDTH, seed=10 + r) for r in range(3)]
    cycle = itertools.cycle(reqs)
    req_ms, req_all = median_ms(lambda: runner.infer(next(cycle)))
    del runner
    torch.cuda.empty_cache()
    cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0))
    state = trainer.create_train_state(cfg, seed=0, device="cuda")
    perturb_(state.model, seed=1)
    batch = synthetic_batch(BATCH, TRAIN_SIZE, cfg.max_instances, seed=3)
    step_ms, step_all = median_ms(lambda: trainer.train_step(state, batch))
    log(f"[paths] request {req_ms:.3f} ms (median of {PATHS_REPEATS}: "
        f"{req_all}); default training step {step_ms:.3f} ms ({step_all}); "
        f"{card}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if "--spatial_rank" in sys.argv:
        return spatial_rank(*sys.argv[sys.argv.index("--spatial_rank") + 1:])
    if "--step_rank" in sys.argv:
        return step_rank(sys.argv[sys.argv.index("--step_rank") + 1])
    if "--nccl" in sys.argv and torch.cuda.device_count() < NCCL_CARDS:
        print(f"chip_smoke --nccl: {torch.cuda.device_count()} card(s) "
              f"visible, {NCCL_CARDS} needed", file=sys.stderr)
        return 1
    from planerecnet_tpu_torch.config import PlaneRecNet_50_config
    from planerecnet_tpu_torch.ops import dcn

    card = phase_device()
    if "--paths" in sys.argv:
        time_paths(card)
        return 0
    phase_build()
    if "--tools" in sys.argv:
        tools_alone(card)
        return 0
    if "--nccl" in sys.argv:
        phase_nccl(card)
        return 0
    if "--spatial" in sys.argv:
        spatial_window_cases(dcn)
        work = tempfile.mkdtemp(prefix="prn_spatial_")
        try:
            phase_spatial(card, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--dice" in sys.argv:
        phase_dice(cases=())
        return 0
    # The preset's schedule without its 2000-update warm-up, so that 20
    # steps on one batch show the loss falling.
    train_cfg = PlaneRecNet_50_config.copy(dict(lr_warmup_until=0))
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
    cols_err_window, scatter_err_window = spatial_window_cases(dcn)
    worst = max(worst, cols_err_window)
    scatter_err = max(scatter_err, scatter_err_window)
    dice = phase_dice()
    phase_dcn_grads()
    check_reflect_pad()
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    runner, infer_launches, request_ms = phase_main(
        dcn, PlaneRecNet_50_config, card)
    phase_cpu_vs_gpu(runner, PlaneRecNet_50_config)
    del runner
    state, batch, launches, train_ms, train_peak = phase_train(train_cfg,
                                                               card)
    phase_train_cpu_vs_gpu()
    work = tempfile.mkdtemp(prefix="prn_cli_")
    try:
        cli_launches = phase_cli(card, train_ms, work)
        entry_launches = phase_entry_points(card)
        torch.cuda.empty_cache()
        serve_bf16, _ = phase_bf16_serve(card)
        train_bf16, _, _ = phase_bf16_train(card, train_ms, train_peak)
        torch.cuda.empty_cache()
        dp_ranks, dp_one = phase_dp(card, work)
        phase_check_dataset(work)
        spatial = phase_spatial(card, work)
        torch.cuda.empty_cache()
        tools = phase_tools(card, work, request_ms, train_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "--profile" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--profile") + 1]
        phase_profile_train(train_cfg, batch, out_dir)
        profile_det_step(train_cfg, batch, out_dir)
        phase_profile(out_dir)

    def bound_by(recs):
        return ("bytes" if all(r["bound_by"] == "bytes" for r in recs)
                else "operations")

    train_per = (f"one training step of PRN-50 at batch {BATCH}, "
                 f"{TRAIN_SIZE}x{TRAIN_SIZE}, f32")

    def new_paths(name):
        """This kernel's launches on the paths of phases 11-13, 15-16 and
        18: one bf16 request, the bf16 training phase's timed steps, each
        data-parallel rank's run and the one-process twin's, each spatial
        rank's timed requests and steps and the unsplit rank's, and the
        tools' runs."""
        return {"serve_bf16": serve_bf16[name], "train_bf16": train_bf16[name],
                **{f"dp_rank{r}": n[name] for r, n in enumerate(dp_ranks)},
                "dp_one_process": dp_one[name],
                **{path: n[name] for path, n in spatial.items()},
                "tools": tools[name]}
    def dice_row(d, det):
        name = f"dice_lava_{d}" + ("_det" if det else "")
        key = "det_" if det else ""
        return {
            "name": name,
            "route": "cuda",
            "source": "planerecnet_tpu_torch/csrc/dice_lava.cu",
            "replaces": ("planerecnet_tpu/ops/pallas/dice_lava.py:158 "
                         "(_fused_fwd_impl, kernel _fwd_kernel :49)"
                         if d == "fwd" else
                         "planerecnet_tpu/ops/pallas/dice_lava.py:203 "
                         "(_fused_bwd, kernel _bwd_kernel :80)"),
            # Each kernel's main path: the atomic one's phase 7, the
            # deterministic variant's phase 9 (--reproductablity).
            "launches": cli_launches[name] if det else launches[name],
            "launches_by_path": {"train": launches[name],
                                 "cli": cli_launches[name],
                                 **new_paths(name)},
            "max_abs_err": dice[d][("det_err" if det else "max_abs_err")],
            "ms": DICE_LEVELS * dice[d][key + "ms"],
            "plain_ms": DICE_LEVELS * dice[d]["plain_ms"],
            "bound_ms": DICE_LEVELS * dice[d]["bound_ms"],
            "bound_by": dice[d]["bound_by"],
            "bound_f32_ms": DICE_LEVELS * dice[d]["bound_f32_ms"],
            "bound_rates": "bound_ms: the products at the 3xTF32 "
                           "tensor-core rate (495/3 TFLOP/s), the units they "
                           "run on; bound_f32_ms: at the f32 rate (67 "
                           "TFLOP/s)",
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "per": f"{train_per}: {DICE_LEVELS} launches at {DICE}",
            "card": card,
        }

    dice_rows = [dice_row(d, det) for d in ("fwd", "bwd")
                 for det in (False, True)]
    print(json.dumps({"kernels": [{
        "name": "dcn_im2col",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_im2col.cu",
        "replaces": "planerecnet_tpu/ops/dcn.py:544 (deform_conv2d; "
                    "sampling at :212-242, modulation at :311-316)",
        "launches": launches["dcn_im2col"],
        "launches_by_path": {"infer": infer_launches,
                             "train": launches["dcn_im2col"],
                             "cli": cli_launches["dcn_im2col"],
                             "entry_points": entry_launches,
                             **new_paths("dcn_im2col")},
        "bf16_instance_launches": {
            "serve_bf16": serve_bf16["dcn_im2col_bf16"],
            "train_bf16": train_bf16["dcn_im2col_bf16"]},
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
               f"{TIMED_STEPS} training steps (and {REQUESTS} requests; cli: "
               f"the train and eval CLIs' runs of phase 9)",
        "card": card,
    }, {
        "name": "dcn_scatter",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_scatter.cu",
        "replaces": "planerecnet_tpu/ops/pallas/dcn_scatter.py:117 "
                    "(dcn_input_grad_pallas, kernel _make_kernel :43)",
        "launches": launches["dcn_scatter"],
        "launches_by_path": {"train": launches["dcn_scatter"],
                             "cli": cli_launches["dcn_scatter"],
                             **new_paths("dcn_scatter")},
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
    }, {
        "name": "dcn_scatter_det",
        "route": "cuda",
        "source": "planerecnet_tpu_torch/csrc/dcn_scatter.cu",
        "replaces": "planerecnet_tpu/ops/pallas/dcn_scatter.py:117 "
                    "(dcn_input_grad_pallas, kernel _make_kernel :43)",
        "launches": cli_launches["dcn_scatter_det"],
        "launches_by_path": {"train": launches["dcn_scatter_det"],
                             "cli": cli_launches["dcn_scatter_det"],
                             **new_paths("dcn_scatter_det")},
        "max_abs_err": max(scatter_err, max(r["det_err"] for r in scatter)),
        "ms": total(scatter, "det_ms"),
        "plain_ms": total(scatter, "plain_ms"),
        "bound_ms": total(scatter, "bound_ms"),
        "bound_by": bound_by(scatter),
        "library_ms": total(scatter, "library_ms"),
        "library": "torch.ops.aten.grid_sampler_2d_backward (bilinear, "
                   "zeros, align_corners=True, input gradient only)",
        "train_offsets_ms": total(scatter, "det_train_offsets_ms"),
        "train_offsets_bound_ms": total(scatter, "train_offsets_bound_ms"),
        "cpu_plain_bits_differ": sum(r["det_cpu_bits_differ"]
                                     for r in scatter),
        "cpu_plain_bits": "elements of dx whose bits differ from the CPU "
                          "plain version's at the six shapes, +-8 px and "
                          "training offsets (every edge case, the pile-up "
                          "and the spatial windows must give 0 too, or the "
                          "run fails)",
        "per": f"{train_per}: its {DCN_LAYERS_PRN50} DCN layers, as the "
               f"dcn_scatter row; launches: phase 9's train CLI runs with "
               f"--reproductablity",
        "card": card,
    }, *dice_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
