"""Input gradient of the deformable convolution: a scatter-add.

Counterpart of ``planerecnet_tpu/ops/pallas/dcn_scatter.py`` with the same
contract. Every contribution row ``r`` of image ``b`` adds
``corner_w[b, r, i] * dcols[b, r, :]`` at the four corners of its 2x2 patch,
whose top-left corner ``corner_idx[b, r]`` is given in coordinates padded by
one pixel; what lands in the margin is dropped.

``dcn_input_grad`` sends a CPU tensor to ``dcn_input_grad_plain`` (four
``index_add_`` on the flat padded map, the JAX package's
``dcn_input_grad_xla``) and a CUDA tensor to the kernel
``csrc/dcn_scatter.cu``, launched as ``scatter_plan`` lays it out (see the
note there on the design and on ordering), or, with ``deterministic=True``,
to its variant there that sums each dx element in the plain version's
order, so that a run can be reproduced bit for bit, launched in tiles of
dx as ``det_plan`` lays them out.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from planerecnet_tpu_torch.ops import cuda_build

# The four corners of the 2x2 patch, in the order of ``corner_w``.
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))

# The kernel's fixed shape: threads a block, channels a slice (one 128-byte
# line of an f32 row), and the most rows a tile may hold (the kernel takes
# two a thread; the plan stops at 32 pixels' worth so that two blocks fit
# on an SM). A block takes up to MAX_GROUP slices, one after another.
THREADS = 256
SLICE = 32
MAX_TILE_ROWS = 288
MAX_GROUP = 4
# An H100: SMs, and the shared memory an SM holds for its blocks (228 KB;
# the runtime keeps 1 KB of it a block, and the kernel's static arrays take
# STATIC_SMEM), of which one block may take 227 KB.
NUM_SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
STATIC_SMEM = 1300
# The most pixels of dx a block's window may span: each costs 8 bytes (a
# count and a start).
WINDOW_PX = 1024
# Output pixels across a tile: the candidates the plan weighs.
TILE_WIDTHS = (4, 8, 16, 32)
TAPS = 9
# The deterministic variant's fixed shape (csrc/dcn_scatter.cu): channels a
# slice (64 bytes of an f32 row), rows a round stages, the most buckets of
# top-left corners ((tile_h + 1) x (tile_w + 1)) and of (pixel, corner)
# pairs, histogram bins, and the dynamic shared memory they take
# (``kDetSmem``): a slice buffer, four 8-byte entries, a float4 and five
# int32 a row, the bins, the buckets' counts and starts. Two blocks an SM.
DET_SLICE = 16
DET_ROW_CAP = 768
DET_MAX_BUCKETS = 1024
DET_BINS = 1024
DET_SMEM = (DET_ROW_CAP * (DET_SLICE * 4 + 4 * 8 + 16 + 5 * 4)
            + (DET_BINS + 2 * DET_MAX_BUCKETS + 1) * 4)
DET_STATIC_SMEM = 48          # s_n, s_take and the scan's eight warps
DET_BLOCKS_PER_SM = 2
# Tiles the deterministic plan weighs (pixels down, across).
DET_TILES = ((6, 8), (7, 8), (8, 8), (8, 16), (16, 8), (16, 16))


class ScatterPlan(NamedTuple):
    """How ``csrc/dcn_scatter.cu`` cuts one call into blocks.

    The kernel views an image's R rows as ``lines`` lines of ``period`` rows
    (the last possibly short). A block takes ``tile_lines`` lines by
    ``tile_rows`` rows of that grid, of one image, sorts their corners over
    a window of at most ``window_px`` pixels of dx, and then sums ``group``
    of the ``slices`` slices of ``SLICE`` channels, one after another."""
    period: int
    lines: int
    tile_lines: int
    tile_rows: int
    slices: int
    group: int
    window_px: int

    @property
    def tiles_across(self) -> int:
        return -(-self.period // self.tile_rows)

    @property
    def tiles_down(self) -> int:
        return -(-self.lines // self.tile_lines)

    @property
    def groups(self) -> int:
        return -(-self.slices // self.group)

    def blocks(self, b: int) -> int:
        return b * self.tiles_down * self.tiles_across * self.groups

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: two buffers of the tile's dcols (SLICE f32
        a row) and its sorted corners (four 8-byte entries a row), the
        window's counts and starts (``csrc/dcn_scatter.cu::smem_bytes``)."""
        rows = self.tile_lines * self.tile_rows
        return rows * (2 * SLICE * 4 + 4 * 8) + self.window_px * 8

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory (registers allow two)."""
        return min(2, SMEM_PER_SM // (self.smem_bytes + STATIC_SMEM
                                      + SMEM_RESERVED))


def row_geometry(r: int, h: int, w: int) -> Optional[Tuple[int, int, int]]:
    """(Ho, Wo, stride) of a 3x3, padding-1 deformable conv on an HxW map
    whose backward gives R rows (pixel-major, tap-minor), or None when no
    stride explains R. The plan uses it only to pick tiles that keep their
    corners together; the kernel is right for any rows."""
    for stride in (1, 2):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        if r == TAPS * ho * wo:
            return ho, wo, stride
    return None


def _window(lines: int, px: int, stride: int, h: int, w: int) -> int:
    """Pixels of dx that the corners of ``lines`` output rows of ``px``
    output pixels reach with offsets under one pixel: taps at -1..1 about
    the centre, the corner's +1, the offset's floor -1. Only the choice of
    tile rests on it. The offsets of ``chip_smoke.py``'s training main path
    (seeded weights, not trained ones; its phase 7 logs them) were under a
    pixel for 99% of the samples of the 128- and 256-wide layers and 92% of
    the 512-wide ones on an H100; a reach of two pixels would change the
    tile of one PRN-50 shape (20x20x512), where the two tie."""
    return (min(h, (lines - 1) * stride + 5)
            * min(w, (px - 1) * stride + 5))


@functools.lru_cache(maxsize=None)
def scatter_plan(b: int, r: int, h: int, w: int, c: int) -> ScatterPlan:
    """Tiles for the scatter kernel, cached per shape (the search would
    otherwise cost each launch more host time than the kernel takes).

    Where ``row_geometry`` finds the conv's layout, a tile is ``L`` output
    rows of ``n`` output pixels (9 rows a pixel, at most ``MAX_TILE_ROWS``
    rows), and a block takes ``group`` of the tile's channel slices. Among
    the (tile, group) that give at least four blocks a SM, the plan takes
    the largest group (the block sorts its corners once for all of them),
    then the tile whose corners, with offsets under one pixel (``_window``),
    reach the fewest dx pixels for each output pixel it owns (the halo it
    flushes); if none gives four, the one with the most blocks. Otherwise a
    tile is
    ``MAX_TILE_ROWS`` consecutive rows. The window's budget is
    ``WINDOW_PX`` pixels (at most the map): at run time the window is the
    tile's corner bounding box, clipped to the budget about the corners'
    mean, and corners outside it go to global memory, so any
    ``corner_idx`` is right.
    """
    slices = -(-c // SLICE)
    window_px = min(WINDOW_PX, h * w)
    geom = row_geometry(r, h, w)
    if geom is None:
        return ScatterPlan(period=r, lines=1, tile_lines=1,
                           tile_rows=min(r, MAX_TILE_ROWS), slices=slices,
                           group=min(slices, MAX_GROUP), window_px=window_px)
    ho, wo, stride = geom
    best = None
    # Widest first: among tiles of equal halo the widest, whose rows lie in
    # longer contiguous runs, wins.
    for n in sorted({min(wo, n) for n in TILE_WIDTHS}, reverse=True):
        for lines in range(1, min(ho, MAX_TILE_ROWS // (TAPS * n)) + 1):
            for group in range(min(slices, MAX_GROUP), 0, -1):
                plan = ScatterPlan(period=TAPS * wo, lines=ho,
                                   tile_lines=lines, tile_rows=TAPS * n,
                                   slices=slices, group=group,
                                   window_px=window_px)
                blocks = plan.blocks(b)
                enough = blocks >= 4 * NUM_SMS
                halo = _window(lines, n, stride, h, w) / (lines * n)
                key = ((enough, group, -halo) if enough
                       else (enough, blocks, 0.0))
                if best is None or key > best[0]:
                    best = (key, plan)
    return best[1]


class DetPlan(NamedTuple):
    """How ``csrc/dcn_scatter.cu``'s deterministic variant cuts one call:
    tiles of ``tile_h`` x ``tile_w`` dx pixels of one image, and a block
    per tile and ``group`` of its channel slices (``DET_SLICE`` each)."""
    tile_h: int
    tile_w: int
    group: int

    def grid(self, b: int, h: int, w: int) -> Tuple[int, int, int]:
        """(images, tiles down, tiles across)."""
        return b, -(-h // self.tile_h), -(-w // self.tile_w)

    def tiles(self, b: int, h: int, w: int) -> int:
        return math.prod(self.grid(b, h, w))

    def groups(self, c: int) -> int:
        slices = -(-c // DET_SLICE)
        return -(-slices // self.group)

    def blocks(self, b: int, h: int, w: int, c: int) -> int:
        return self.tiles(b, h, w) * self.groups(c)


def det_rows(density: float, tile_h: int, tile_w: int) -> float:
    """Rows a tile's block expects to stage: those whose top-left corner
    is one of the (tile_h + 1) x (tile_w + 1) pixels whose patch reaches
    the tile, at ``density`` rows a pixel, plus four standard deviations
    of a count of independent rows."""
    mean = density * (tile_h + 1) * (tile_w + 1)
    return mean + 4 * math.sqrt(mean)


@functools.lru_cache(maxsize=None)
def det_plan(b: int, r: int, h: int, w: int, c: int,
             stride: Optional[int] = None) -> DetPlan:
    """Tiles for the deterministic variant, cached per shape.

    A 3x3 conv's rows put 9 / stride^2 top-left corners on each pixel of
    the part of the map its output rows read: ``stride`` where the caller
    knows it (a spatial rank's window of stride-1 rows can have the count
    of a whole stride-2 layer's), else ``row_geometry``'s, else 9. Among
    the tiles of ``DET_TILES`` (clipped to the map) whose expected rows
    fit a round (``det_rows`` <= ``DET_ROW_CAP``; more take the overflow
    rounds, still right), and each group of slices, the plan takes the
    least cost: waves of blocks (``DET_BLOCKS_PER_SM`` an SM) times a
    block's expected rows times its slices plus one for the rows' corners
    and their order; ties go to the tile that reads the fewest rows a
    pixel, then to the larger group.
    """
    if stride is None:
        geom = row_geometry(r, h, w)
        stride = geom[2] if geom else 1
    density = TAPS / stride ** 2
    slices = -(-c // DET_SLICE)
    best = None
    for th, tw in DET_TILES:
        th, tw = min(th, h), min(tw, w)
        rows = det_rows(density, th, tw)
        if rows > DET_ROW_CAP:
            continue
        for group in range(slices, 0, -1):
            plan = DetPlan(th, tw, group)
            waves = -(-plan.blocks(b, h, w, c)
                      // (NUM_SMS * DET_BLOCKS_PER_SM))
            cost = waves * rows * (group + 1)
            read = (th + 1) * (tw + 1) / (th * tw)
            key = (cost, read, -group)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def dcn_input_grad_plain(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                         dcols: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch scatter-add: (B, H, W, C) f32."""
    _check_args(corner_idx, corner_w, dcols)
    b, r, c = dcols.shape
    hp, wp = h + 2, w + 2
    flat = torch.zeros((b * hp * wp, c), dtype=torch.float32,
                       device=dcols.device)
    base = torch.arange(b, device=dcols.device)[:, None] * (hp * wp)
    cy = corner_idx[..., 0].long()
    cx = corner_idx[..., 1].long()
    rows = dcols.float().reshape(b * r, c)
    for i, (dy, dx) in enumerate(CORNERS):
        idx = (base + (cy + dy) * wp + (cx + dx)).reshape(-1)
        flat.index_add_(0, idx, corner_w[..., i].float().reshape(-1, 1) * rows)
    return flat.reshape(b, hp, wp, c)[:, 1:h + 1, 1:w + 1, :]


def _check_args(corner_idx, corner_w, dcols):
    if dcols.dim() != 3:
        raise ValueError(f"dcols must be (B, R, C), not {tuple(dcols.shape)}")
    b, r, _ = dcols.shape
    if tuple(corner_idx.shape) != (b, r, 2):
        raise ValueError(f"corner_idx {tuple(corner_idx.shape)} != {(b, r, 2)}")
    if tuple(corner_w.shape) != (b, r, 4):
        raise ValueError(f"corner_w {tuple(corner_w.shape)} != {(b, r, 4)}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("dcn_scatter")
    lib.prn_dcn_scatter_f32.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
    lib.prn_dcn_scatter_f32.restype = ctypes.c_int
    lib.prn_dcn_scatter_det_f32.argtypes = ([ctypes.c_void_p] * 7
                                            + [ctypes.c_int] * 8
                                            + [ctypes.c_void_p])
    lib.prn_dcn_scatter_det_f32.restype = ctypes.c_int
    return lib


def dcn_input_grad(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                   dcols: torch.Tensor, h: int, w: int,
                   deterministic: bool = False,
                   stride: Optional[int] = None) -> torch.Tensor:
    """Accumulate the deformable-sampling gradient into the input map.

    corner_idx: (B, R, 2) int32, the top-left corner (y0 + 1, x0 + 1) of
      each row's patch in padded coordinates, clamped to [0, H] x [0, W];
    corner_w: (B, R, 4) f32 weights of the corners (00, 01, 10, 11), zero
      where a corner lies outside the map;
    dcols: (B, R, C) f32 upstream gradient rows.
    Returns dx (B, H, W, C) f32. ``deterministic`` takes the kernel's
    variant that sums in a fixed order (the plain version's, with its
    roundings), tiled for the conv's ``stride`` where it is given (see
    ``det_plan``). ``dcn_input_grad.launches`` counts the kernel's launches,
    ``dcn_input_grad.det_launches`` those of the variant.
    """
    if dcols.device.type == "cpu":
        return dcn_input_grad_plain(corner_idx, corner_w, dcols, h, w)
    if dcols.device.type != "cuda":
        raise ValueError(f"dcn_input_grad: unsupported device {dcols.device}")
    _check_args(corner_idx, corner_w, dcols)
    for name, t, dtype in (("corner_idx", corner_idx, torch.int32),
                           ("corner_w", corner_w, torch.float32),
                           ("dcols", dcols, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"dcn_input_grad: {name} must be {dtype}, "
                            f"not {t.dtype}")
        if t.device != dcols.device:
            raise ValueError(f"dcn_input_grad: {name} on {t.device}, "
                             f"dcols on {dcols.device}")
        if not t.is_contiguous():
            raise ValueError(f"dcn_input_grad: {name} is not contiguous")
    # The kernel reads a row's corner as one int2 and its weights as one
    # float4; a view may start off those boundaries.
    if corner_idx.data_ptr() % 8:
        corner_idx = corner_idx.clone()
    if corner_w.data_ptr() % 16:
        corner_w = corner_w.clone()
    b, r, c = dcols.shape
    if deterministic:
        return _input_grad_det(corner_idx, corner_w, dcols, h, w, stride)
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dcols.device)
    plan = scatter_plan(b, r, h, w, c)
    with torch.cuda.device(dcols.device):
        stream = torch.cuda.current_stream(dcols.device).cuda_stream
        err = _library().prn_dcn_scatter_f32(
            corner_idx.data_ptr(), corner_w.data_ptr(), dcols.data_ptr(),
            dx.data_ptr(), b, r, h, w, c, *plan, stream)
    cuda_build.check_launch(err, "dcn_scatter")
    dcn_input_grad.launches += 1
    return dx


@contextlib.contextmanager
def _unfilled():
    """``torch.empty`` without the fill that
    ``torch.use_deterministic_algorithms(True)`` adds (NaN, or an integer's
    largest value), for buffers a kernel writes before it reads them."""
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill


def _input_grad_det(corner_idx, corner_w, dcols, h, w, stride):
    """The deterministic variant's launch, tiled by ``det_plan``: its
    workspace is a count a tile (and one of the spilled pairs), a bucket of
    ``DET_ROW_CAP`` rows a tile and a list of the (tile, row) pairs that
    overflow their bucket (at most four a row)."""
    b, r, c = dcols.shape
    dev = dcols.device
    plan = det_plan(b, r, h, w, c, stride)
    tiles = plan.tiles(b, h, w)
    count = torch.zeros(tiles + 1, dtype=torch.int32, device=dev)
    # The kernel stores every element of dx, and uses of the buckets and
    # the spill list only what it has filed: under --reproductablity's
    # switches torch.empty would first fill all three (dx is up to 105 MB
    # at the training shapes), only for the kernel to overwrite them.
    with _unfilled():
        dx = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
        bucket = torch.empty(tiles * DET_ROW_CAP, dtype=torch.int32,
                             device=dev)
        spill = torch.empty((4 * b * r, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().prn_dcn_scatter_det_f32(
            corner_idx.data_ptr(), corner_w.data_ptr(), dcols.data_ptr(),
            dx.data_ptr(), count.data_ptr(), bucket.data_ptr(),
            spill.data_ptr(), b, r, h, w, c, *plan, stream)
    cuda_build.check_launch(err, "dcn_scatter_det")
    dcn_input_grad.det_launches += 1
    return dx


dcn_input_grad.launches = 0
dcn_input_grad.det_launches = 0
