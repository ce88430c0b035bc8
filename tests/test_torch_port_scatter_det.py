"""The deterministic DCN scatter's host plan and its order, on the CPU.

``csrc/dcn_scatter.cu``'s deterministic variant sums every dx element in
key order (key = corner * R + row, the plain version's four ``index_add_``
passes) by tiles of dx: a block per tile bins the rows whose corners land
there, orders them by top-left corner and row, and sums each pixel's
entries, in rounds of key ranges where a tile holds more rows than a round
stages. The card is not here, so ``kernel_order`` below does the same in
plain PyTorch (tiles, shuffled bin places, rounds, buckets, products and
sums each rounded in f32) and must equal ``dcn_input_grad_plain`` in every
bit; the plain version is held against the JAX package's XLA oracle. The
plan (``det_plan``) must fit the H100's shared memory and cover every dx
pixel once at every DCN shape of every preset, spatial windows included.
"""

import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planerecnet_tpu.ops.pallas.dcn_scatter import dcn_input_grad_xla
from planerecnet_tpu_torch.ops import dcn
from planerecnet_tpu_torch.ops import dcn_scatter as ds
from test_torch_port_dcn_plan import PLAN_SHAPES

torch.set_num_threads(2)
SOURCE = (Path(ds.__file__).resolve().parent.parent / "csrc"
          / "dcn_scatter.cu").read_text()


def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_constants_mirror_the_kernel():
    """The plan's constants are the kernel's."""
    assert _source_int("kDetSlice") == ds.DET_SLICE
    assert _source_int("kDetRowCap") == ds.DET_ROW_CAP
    assert _source_int("kDetMaxBuckets") == ds.DET_MAX_BUCKETS
    assert _source_int("kDetBins") == ds.DET_BINS
    assert _source_int("kDetThreads") == ds.THREADS
    assert f"__launch_bounds__(kDetThreads, {ds.DET_BLOCKS_PER_SM})" in SOURCE


def plan_blocks(plan, b, h, w, c):
    """Per block, (image, its tile's pixels, its slices): the map of
    ``det_tile_kernel`` (groups fastest, then tiles across, down, images)."""
    _, td, ta = plan.grid(b, h, w)
    slices = -(-c // ds.DET_SLICE)
    groups = plan.groups(c)
    out = []
    for blk in range(plan.blocks(b, h, w, c)):
        slice0 = (blk % groups) * plan.group
        tile = blk // groups
        tx, ty, bi = tile % ta, (tile // ta) % td, tile // (ta * td)
        ys = range(ty * plan.tile_h, min(h, (ty + 1) * plan.tile_h))
        xs = range(tx * plan.tile_w, min(w, (tx + 1) * plan.tile_w))
        out.append((bi, [(y, x) for y in ys for x in xs],
                    list(range(slice0, min(slices, slice0 + plan.group)))))
    return out


def check_plan(b, r, h, w, c, stride=None):
    plan = ds.det_plan(b, r, h, w, c, stride)
    th, tw = plan.tile_h, plan.tile_w
    # Shared memory: a block's, and DET_BLOCKS_PER_SM of them on an SM.
    assert ds.DET_SMEM + ds.DET_STATIC_SMEM <= ds.SMEM_PER_BLOCK
    assert ds.DET_BLOCKS_PER_SM * (ds.DET_SMEM + ds.DET_STATIC_SMEM
                                   + ds.SMEM_RESERVED) <= ds.SMEM_PER_SM
    assert (th + 1) * (tw + 1) <= ds.DET_MAX_BUCKETS
    assert 4 * th * tw <= ds.DET_MAX_BUCKETS
    if stride is None:
        geom = ds.row_geometry(r, h, w)
        stride = geom[2] if geom else 1
    assert ds.det_rows(ds.TAPS / stride ** 2, th, tw) <= ds.DET_ROW_CAP
    tiles = plan.tiles(b, h, w)
    assert plan.blocks(b, h, w, c) < 2 ** 31
    assert tiles * ds.DET_ROW_CAP < 2 ** 31 and 4 * b * r < 2 ** 31
    # Every pixel of every image once, every slice once a tile.
    seen = np.zeros((b, h, w), np.int64)
    slices_of = {}
    for bi, pixels, slices in plan_blocks(plan, b, h, w, c):
        key = (bi, tuple(pixels))
        slices_of.setdefault(key, []).extend(slices)
        if slices and slices[0] == 0:
            for y, x in pixels:
                seen[bi, y, x] += 1
    assert (seen == 1).all()
    n_slices = -(-c // ds.DET_SLICE)
    assert all(sorted(s) == list(range(n_slices))
               for s in slices_of.values())
    return plan


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "%dx%dx%d/s%d" % s)
def test_det_plan_fits_and_covers(shape, b):
    """Every DCN shape of the presets (training and serving sizes)."""
    h, w, c, stride = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    r = 9 * ho * wo
    assert ds.det_plan(b, r, h, w, c) == check_plan(b, r, h, w, c, stride)


# (H, W, C, stride, ranks) where the output rows split over the ranks.
WINDOW_SHAPES = [(*s, n) for s in PLAN_SHAPES for n in (2, 4)
                 if ((s[0] - 1) // s[3] + 1) % n == 0]


@pytest.mark.parametrize("shape", WINDOW_SHAPES,
                         ids=lambda s: "%dx%dx%d/s%d/%d-ranks" % s)
def test_det_plan_fits_spatial_windows(shape):
    """A spatial rank's rows: its share of the output rows over the whole
    input (``deform_conv2d(row0=)``), at the conv's density in its part of
    the map, which the backward's stride gives the plan (four ranks of
    stride-1 rows have a whole stride-2 layer's count)."""
    h, w, c, stride, ranks = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    check_plan(6, 9 * (ho // ranks) * wo, h, w, c, stride)


def overflow_rounds(keep, rows, keys, row_cap, bins):
    """The kernel's rounds for a tile with more rows than a round stages:
    greedy ranges of histogram bins of at most ``row_cap`` corners, the
    histogram refined to its first bin while that bin alone holds more."""
    rounds, lo = [], 0
    while lo < keys:
        end = keys
        while True:
            width = -(-(end - lo) // bins)
            hist = np.zeros(bins, np.int64)
            for ri in rows:
                for key in keep(ri, lo, end):
                    hist[(key - lo) // width] += 1
            if hist[0] <= row_cap:
                break
            end = lo + width
        origin, nbin = lo, 0
        while lo < end:
            take = total = 0
            while nbin + take < bins and total + hist[nbin + take] <= row_cap:
                total += hist[nbin + take]
                take += 1
            if take == 0:
                break
            nbin += take
            hi = min(end, origin + nbin * width)
            rounds.append((lo, hi))
            lo = hi
    return rounds


def kernel_order(idx, cw, dcols, h, w, plan, row_cap=ds.DET_ROW_CAP,
                 bins=ds.DET_BINS, seed=0):
    """dx summed as the deterministic kernel sums it, in plain PyTorch."""
    b, r, c = dcols.shape
    _, td, ta = plan.grid(b, h, w)
    th, tw = plan.tile_h, plan.tile_w
    idx_n, cw_n = idx.numpy(), cw.numpy()
    rng = np.random.RandomState(seed)
    # Bin: each (row, tile) pair once, in an order that varies (atomics).
    rows_of = [[] for _ in range(b * td * ta)]
    for bi in range(b):
        for ri in range(r):
            tiles = []
            for k in range(4):
                y = idx_n[bi, ri, 0] - 1 + k // 2
                x = idx_n[bi, ri, 1] - 1 + k % 2
                if cw_n[bi, ri, k] == 0 or not (0 <= y < h and 0 <= x < w):
                    continue
                t = (bi * td + y // th) * ta + x // tw
                if t not in tiles:
                    tiles.append(t)
                    rows_of[t].append(ri)
    dx = torch.empty(b, h, w, c)
    for t, rows in enumerate(rows_of):
        rows = [rows[i] for i in rng.permutation(len(rows))]
        bi, ty, tx = t // (td * ta), (t // ta) % td, t % ta
        y0, x0 = ty * th, tx * tw

        def weights(ri, lo, hi):
            """Row ri's weights, zeroed unless the corner lands in the tile
            and the map with a non-zero weight and a key in [lo, hi)."""
            out = np.zeros(4, np.float32)
            for k in range(4):
                py = idx_n[bi, ri, 0] - 1 + k // 2 - y0
                px = idx_n[bi, ri, 1] - 1 + k % 2 - x0
                if (cw_n[bi, ri, k] != 0 and 0 <= py < th and 0 <= px < tw
                        and y0 + py < h and x0 + px < w
                        and lo <= k * r + ri < hi):
                    out[k] = cw_n[bi, ri, k]
            return out

        def keep(ri, lo, hi):
            return [k * r + ri for k, wk in enumerate(weights(ri, lo, hi))
                    if wk != 0]

        keys = 4 * r
        rounds = ([(0, keys)] if len(rows) <= row_cap
                  else overflow_rounds(keep, rows, keys, row_cap, bins))
        for n_round, (lo, hi) in enumerate(rounds):
            # The round's rows by top-left corner, each bucket by row.
            bucket = {}
            staged = [ri for ri in rows if keep(ri, lo, hi)]
            assert len(staged) <= row_cap
            for ri in staged:
                q = (idx_n[bi, ri, 0] - y0, idx_n[bi, ri, 1] - x0)
                bucket.setdefault(q, []).append(ri)
            for y in range(y0, min(h, y0 + th)):
                for x in range(x0, min(w, x0 + tw)):
                    acc = (torch.zeros(c) if n_round == 0
                           else dx[bi, y, x].clone())
                    for k in range(4):
                        q = (y - y0 + 1 - k // 2, x - x0 + 1 - k % 2)
                        for ri in sorted(bucket.get(q, [])):
                            wk = weights(ri, lo, hi)[k]
                            if wk != 0:
                                acc = acc + torch.tensor(wk) * dcols[bi, ri]
                    dx[bi, y, x] = acc
    return dx


def _conv_corners(seed, h, w, stride, std, b=2):
    """A DCN backward's rows: offsets N(0, std^2) px from numpy."""
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = torch.from_numpy(rng.randn(b, ho, wo, 18).astype(np.float32) * std)
    mask = torch.from_numpy(rng.rand(b, ho, wo, 9).astype(np.float32) * 2)
    return dcn.scatter_inputs(off, mask, h, w, stride=stride)


def _random_corners(seed, h, w, r, b=2):
    """Corners anywhere on the padded map, a fifth of the weights 0."""
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.randint(0, h + 1, (b, r)),
                    rng.randint(0, w + 1, (b, r))], -1).astype(np.int32)
    cw = rng.rand(b, r, 4).astype(np.float32)
    cw[rng.rand(b, r, 4) < 0.2] = 0
    return torch.from_numpy(idx), torch.from_numpy(cw)


ORDER_CASES = {
    # (corners, H, W, C, plan or None for det_plan, row_cap, bins)
    "stride1-offsets-0.5px": ("conv1", 12, 10, 8, None, ds.DET_ROW_CAP,
                              ds.DET_BINS),
    "stride2-offsets-0.5px": ("conv2", 13, 11, 6, None, ds.DET_ROW_CAP,
                              ds.DET_BINS),
    "stride1-offsets-8px-small-tiles": ("spread", 12, 10, 5,
                                        ds.DetPlan(3, 4, 1), ds.DET_ROW_CAP,
                                        ds.DET_BINS),
    "random-rows-no-3x3-layout": ("random", 9, 11, 7, None, ds.DET_ROW_CAP,
                                  ds.DET_BINS),
    "random-rows-overflowing-rounds": ("random", 9, 11, 4,
                                       ds.DetPlan(4, 5, 1), 24, 4),
    "pile-up-refined-rounds": ("pile", 8, 9, 3, None, 16, 8),
}


def _order_inputs(corners, h, w, c, seed=3):
    if corners in ("conv1", "conv2"):
        idx, cw = _conv_corners(seed, h, w, int(corners[-1]), 0.5)
    elif corners == "spread":
        idx, cw = _conv_corners(seed, h, w, 1, 8.0)
    elif corners == "random":
        idx, cw = _random_corners(seed, h, w, 200)
    else:
        r = 9 * h * w // 4
        idx = torch.full((1, r, 2), h // 2, dtype=torch.int32)
        cw = torch.from_numpy(np.random.RandomState(seed).rand(
            1, r, 4).astype(np.float32))
    b, r = idx.shape[:2]
    dcols = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        b, r, c).astype(np.float32))
    return idx, cw.contiguous(), dcols


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_kernel_order_is_the_plain_version_in_every_bit(case):
    """The kernel's order (tiles, shuffled bin places, rounds, top-left
    buckets ordered by row, corners 0..3 a pixel) gives the plain
    version's bits; the plain version agrees with JAX's XLA oracle."""
    corners, h, w, c, plan, row_cap, bins = ORDER_CASES[case]
    idx, cw, dcols = _order_inputs(corners, h, w, c)
    b, r, _ = dcols.shape
    plan = plan or ds.det_plan(b, r, h, w, c)
    want = ds.dcn_input_grad_plain(idx, cw, dcols, h, w)
    for seed in (0, 1):
        got = kernel_order(idx, cw, dcols, h, w, plan, row_cap, bins, seed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = np.asarray(dcn_input_grad_xla(jnp.asarray(idx.numpy()),
                                        jnp.asarray(cw.numpy()),
                                        jnp.asarray(dcols.numpy()), h, w))
    np.testing.assert_allclose(want.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_overflow_rounds_cover_the_keys_within_the_cap():
    """Rounds are consecutive key ranges from 0 to 4R, each holding at most
    ``row_cap`` corners, refined below a bin's width where one bin
    overflows (all rows on one patch)."""
    idx, cw, dcols = _order_inputs("pile", 8, 9, 3)
    r = idx.shape[1]
    keys = 4 * r

    def keep(ri, lo, hi):
        return [k * r + ri for k in range(4)
                if cw[0, ri, k] != 0 and lo <= k * r + ri < hi]

    rounds = overflow_rounds(keep, range(r), keys, 16, 8)
    assert rounds[0][0] == 0 and rounds[-1][1] == keys
    assert all(a[1] == b[0] for a, b in zip(rounds, rounds[1:]))
    assert all(len([1 for ri in range(r) for _ in keep(ri, lo, hi)]) <= 16
               for lo, hi in rounds)
    assert min(hi - lo for lo, hi in rounds) < math.ceil(keys / 8)


def test_unfilled_restores_the_fill_switch():
    """``torch.empty`` in ``_unfilled`` is not filled under the
    deterministic switches, and the switch comes back, after an error
    too."""
    det = torch.utils.deterministic
    assert det.fill_uninitialized_memory
    with ds._unfilled():
        assert not det.fill_uninitialized_memory
    assert det.fill_uninitialized_memory
    with pytest.raises(RuntimeError):
        with ds._unfilled():
            raise RuntimeError("boom")
    assert det.fill_uninitialized_memory
