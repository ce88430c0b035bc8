"""Host-side plans of the port's DCN kernels, and the inference CPU-vs-card
check's near-threshold accounting, on the CPU.

``scatter_plan`` lays out the launch of ``csrc/dcn_scatter.cu``; these tests
hold it at every DCN layer shape of the presets, at the training (640x640)
and serving (480x640) sizes, to the card's shared memory and to covering
every row and channel once, mirroring the kernel's block-to-rows map. The
accounting of ``chip_smoke.py``'s phase 6 (which pixels may differ between
the CPU's and the card's binary masks) is held on constructed tensors and
on the tiny preset's post-processing, and its phase 7's log of the DCN
offsets' spread on the tiny preset.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from planerecnet_tpu_torch.config import (PlaneRecNet_50_config,
                                          PlaneRecNet_101_config,
                                          PlaneRecNet_base_config,
                                          PlaneRecNet_tiny_config)
from planerecnet_tpu_torch.models.backbone import _stage_plan
from planerecnet_tpu_torch.ops import dcn
from planerecnet_tpu_torch.ops import dcn_scatter as ds

torch.set_num_threads(2)
PRESETS = {"PRN-50": PlaneRecNet_50_config, "PRN-101": PlaneRecNet_101_config,
           "base": PlaneRecNet_base_config, "tiny": PlaneRecNet_tiny_config}
# The kernel's tile: two rows a thread of 256 (csrc/dcn_scatter.cu).
KERNEL_MAX_TILE_ROWS = 2 * ds.THREADS


def dcn_shapes(cfg, h, w):
    """(H, W, Cin, stride) of every deformable conv of ``cfg``'s backbone on
    an HxW image: conv1 and the max-pool each halve the map, a stage's first
    block carries its stride."""
    bb = cfg.backbone
    hh, ww = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    hh, ww = (hh - 1) // 2 + 1, (ww - 1) // 2 + 1
    shapes = set()
    for planes, _, stride, _, flags in _stage_plan(
            bb.layers, bb.dcn_layers, bb.dcn_interval, bb.atrous_layers):
        for i, has_dcn in enumerate(flags):
            s = stride if i == 0 else 1
            if has_dcn:
                shapes.add((hh, ww, planes, s))
            if i == 0:
                hh, ww = (hh - 1) // s + 1, (ww - 1) // s + 1
    return sorted(shapes)


PLAN_SHAPES = sorted({shape for cfg in PRESETS.values()
                      for size in ((640, 640), (480, 640))
                      for shape in dcn_shapes(cfg, *size)})


def test_dcn_shapes_match_the_smoke_run():
    """The shape list is the one ``chip_smoke.py`` times (PRN-50 at
    640x640; PRN-101, a DCN every third block, has a subset of it), and the
    base preset has no deformable conv."""
    want = {(h, w, c, s) for h, w, c, s, _ in chip_smoke.DCN_SHAPES_TRAIN}
    assert set(dcn_shapes(PlaneRecNet_50_config, 640, 640)) == want
    assert set(dcn_shapes(PlaneRecNet_101_config, 640, 640)) < want
    assert dcn_shapes(PlaneRecNet_base_config, 640, 640) == []


def kernel_rows(plan, r):
    """Per block of one image and slice, the rows the kernel takes: the
    map of ``dcn_scatter_kernel`` (tile row i * tile_rows + j is row
    (line0 + i) * period + col0 + j while j < the line's length)."""
    out = []
    for ty, tx in itertools.product(range(plan.tiles_down),
                                    range(plan.tiles_across)):
        line0, col0 = ty * plan.tile_lines, tx * plan.tile_rows
        rows = []
        for i in range(min(plan.tile_lines, plan.lines - line0)):
            start = (line0 + i) * plan.period + col0
            n = min(plan.tile_rows, plan.period - col0, r - start)
            rows.append(np.arange(start, start + max(n, 0)))
        out.append(np.concatenate(rows))
    return out


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "%dx%dx%d/s%d" % s)
def test_scatter_plan_fits_and_covers(shape, b):
    """Every DCN shape of the presets gets a plan whose shared memory fits
    a block (227 KB) with at least two blocks an SM, whose tiles the kernel
    takes, whose blocks cover every row of an image once, whose slices
    cover every channel and whose slice groups every slice once."""
    h, w, c, stride = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    r = 9 * ho * wo
    plan = ds.scatter_plan(b, r, h, w, c)
    assert ds.row_geometry(r, h, w) == (ho, wo, stride)
    assert plan.period * plan.lines == r
    assert plan.tile_lines * plan.tile_rows <= KERNEL_MAX_TILE_ROWS
    assert plan.smem_bytes + ds.STATIC_SMEM <= ds.SMEM_PER_BLOCK
    assert plan.blocks_per_sm >= 2
    assert 0 < plan.window_px <= min(ds.WINDOW_PX, h * w)
    rows = np.concatenate(kernel_rows(plan, r))
    np.testing.assert_array_equal(np.sort(rows), np.arange(r))
    assert plan.slices * ds.SLICE >= c > (plan.slices - 1) * ds.SLICE
    assert 1 <= plan.group <= min(plan.slices, ds.MAX_GROUP)
    slices = [g * plan.group + k for g in range(plan.groups)
              for k in range(min(plan.group, plan.slices - g * plan.group))]
    assert slices == list(range(plan.slices))
    assert plan.blocks(b) == b * len(kernel_rows(plan, r)) * plan.groups


@pytest.mark.parametrize("r", [1, 5, 1000, 9 * 80 * 80 - 5])
def test_scatter_plan_flat_rows(r):
    """Rows in no 3x3 layout: flat tiles of consecutive rows, which still
    cover every row once."""
    plan = ds.scatter_plan(2, r, 80, 80, 30)
    assert ds.row_geometry(r, 80, 80) is None
    assert (plan.period, plan.lines, plan.tile_lines) == (r, 1, 1)
    rows = np.concatenate(kernel_rows(plan, r))
    np.testing.assert_array_equal(np.sort(rows), np.arange(r))
    assert plan.smem_bytes + ds.STATIC_SMEM <= ds.SMEM_PER_BLOCK


def test_near_threshold_flips_counts():
    """Flips where the CPU's soft value lies within the margin of the
    threshold are rounding; a flip outside it is counted as a fault."""
    thr = 0.1
    soft = torch.tensor([[[0.1000004, 0.0999990, 0.5, 0.02],
                          [0.1003, 0.0, 0.1, 0.7]]])
    margin = torch.full_like(soft, 1e-5)
    want = soft > thr
    got = want.clone()
    got[0, 0, 0] = ~got[0, 0, 0]          # 4e-7 above thr: rounding
    got[0, 0, 1] = ~got[0, 0, 1]          # 1e-6 below thr: rounding
    count = chip_smoke.near_threshold_flips(got, want, soft, margin, thr)
    assert count["differing"] == 2
    assert count["near_threshold"] == 2
    assert count["outside_margin"] == 0
    assert count["pixels_within_margin"] == 3     # 0.1 itself too
    assert count["max_distance"] == pytest.approx(1e-6, rel=1e-2)
    got[0, 1, 0] = ~got[0, 1, 0]          # 3e-4 from thr: a fault
    count = chip_smoke.near_threshold_flips(got, want, soft, margin, thr)
    assert (count["differing"], count["outside_margin"]) == (3, 1)
    none = chip_smoke.near_threshold_flips(want, want, soft, margin, thr)
    assert (none["differing"], none["max_distance"]) == (0, 0.0)


def test_soft_change_bound_holds():
    """Every element of kernels and features moved by up to its error
    (per detection for the kernels): the soft masks move by no more than
    the bound."""
    rng = np.random.RandomState(0)
    k = torch.from_numpy(rng.randn(6, 32).astype(np.float32)) * 0.3
    f = torch.from_numpy(rng.randn(50, 32).astype(np.float32))
    kerr = torch.tensor([1e-3, 1e-3, 2e-3, 2e-3, 5e-4, 1e-4])
    ferr = 3e-3
    bound = chip_smoke.soft_change_bound(k, f, kerr, ferr)
    base = torch.sigmoid(k.double() @ f.double().T)
    worst = 0.0
    for trial in range(20):
        dk = torch.from_numpy(rng.uniform(-1, 1, k.shape)) * kerr.double()[
            :, None]
        df = torch.from_numpy(rng.uniform(-1, 1, f.shape)) * ferr
        moved = torch.sigmoid((k.double() + dk) @ (f.double() + df).T)
        ratio = float(((moved - base).abs() / bound).max())
        assert ratio <= 1.0
        worst = max(worst, ratio)
    assert worst > 0.01            # the bound is not vacuous


def test_soft_masks_recomputed_from_raw_match_infer():
    """On the tiny preset: the soft masks that phase 6 recomputes from
    ``forward_raw``'s outputs binarise to exactly ``infer``'s masks for
    the detections it keeps, and the margin is positive and finite."""
    from planerecnet_tpu_torch.ops.image import fast_base_transform
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    cfg = PlaneRecNet_tiny_config
    low = cfg.copy(dict(solov2=cfg.solov2.copy(dict(score_thr=0.003,
                                                    update_thr=0.003))))
    runner = PlaneRecNetRunner(low, seed=0, device="cpu")
    chip_smoke.perturb_(runner.model, seed=1, offset_std=0.1)
    x = chip_smoke.frames(1, 64, 96, seed=3)
    out = runner.infer(x)
    raw = runner.forward_raw(fast_base_transform(torch.from_numpy(x)))
    errs = {f"kernel_preds[{i}]": 1e-5
            for i in range(len(raw["kernel_preds"]))}
    errs["mask_pred[0]"] = 2e-5
    soft, margin, kept = chip_smoke.soft_masks_and_margin(raw, low, (64, 96),
                                                          errs)
    torch.testing.assert_close(kept, out["pred_valid"][0])
    v = kept
    assert int(v.sum()) > 0
    torch.testing.assert_close(soft[v] > low.solov2.mask_thr,
                               out["pred_masks"][0][v])
    assert bool((margin[v] > 0).all()) and bool(torch.isfinite(margin).all())


def test_offset_spread_reads_every_dcn_layer():
    """The offsets' spread that the training main path logs: one entry per
    DCN input width of the tiny preset, ordered percentiles, zero for
    offset convs of zero weight, and no hook left behind."""
    from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
    cfg = PlaneRecNet_tiny_config
    model = PlaneRecNet(cfg).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 64, 64, 3).astype(np.float32))
    widths = {c for _, _, c, _ in dcn_shapes(cfg, 64, 64)}
    for std in (0.0, 0.1):
        chip_smoke.perturb_(model, seed=1, offset_std=std)
        with torch.no_grad():
            spread = chip_smoke.offset_spread(model, lambda: model(x))
        assert set(spread) == widths
        for s in spread.values():
            assert 0 <= s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
            assert (s["std"] > 0) == (std > 0)
            assert (s["max"] == 0) == (std == 0)
    assert not any(m._forward_hooks for m in model.modules())


def test_scatter_inputs_rows_fit_the_plan_geometry():
    """The backward's corner rows are pixel-major, tap-minor: the layout
    ``row_geometry`` assumes, for both strides."""
    for stride in (1, 2):
        off = torch.zeros(1, (9 - 1) // stride + 1, (11 - 1) // stride + 1,
                          18)
        mask = torch.ones(*off.shape[:3], 9)
        idx, _ = dcn.scatter_inputs(off, mask, 9, 11, stride=stride)
        assert ds.row_geometry(idx.shape[1], 9, 11)[2] == stride
        # Zero offsets: tap k of pixel p has its top-left corner at the
        # pixel's centre plus (ky, kx) in padded coordinates, clamped to
        # the padded map.
        ho, wo = off.shape[1:3]
        want = [(min(oy * stride + ky, 9), min(ox * stride + kx, 11))
                for oy in range(ho) for ox in range(wo)
                for ky in range(3) for kx in range(3)]
        assert [tuple(t) for t in idx[0].tolist()] == want
