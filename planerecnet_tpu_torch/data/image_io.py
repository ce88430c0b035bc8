"""Image files and the host-side image operations of the data pipeline.

The JAX package's pipeline calls OpenCV; the machines the port runs on
have none, so this module does the same work with numpy and zlib, each
function matching the OpenCV call it stands in for:

* ``imread`` / ``imwrite``: PNG, 8-bit BGR or grey and 16-bit grey, not
  interlaced, every row filter (``cv2.imread`` / ``cv2.imwrite``). Any
  other PNG raises. A JPEG is read through ``cv2`` or ``PIL`` where one
  of them imports, an optional dependency for users' JPEG datasets, and
  raises ``ImportError`` naming the file where neither does.
* ``resize_linear``: ``cv2.resize(INTER_LINEAR)`` (half-pixel centres,
  clamped edges, no antialiasing), bit-exact: u8 through OpenCV's 11-bit
  fixed-point weights and its rounding, f32 as its fused lerp.
* ``bgr_to_hsv`` / ``hsv_to_bgr``: ``cv2.cvtColor`` on f32 (H in [0, 360)),
  bit-exact with OpenCV's AVX2 code path (x86-64 hosts).
* ``motion_blur_kernel``, ``filter2d``, ``normalize_minmax``: the motion
  blur's ``getRotationMatrix2D`` + ``warpAffine`` (1/32-pixel positions,
  as OpenCV quantises them), ``filter2D`` (border REFLECT_101) and
  ``normalize(NORM_MINMAX)``.
* ``fill_poly``: ``cv2.fillPoly`` with 8-connected edges.
"""

from __future__ import annotations

import importlib
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> channels: grey 8 and 16 bit, RGB 8 bit.
_PNG_KINDS = {(0, 8): 1, (0, 16): 1, (2, 8): 3}
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


# --------------------------------------------------------------- files


def imread(path: str, color: bool = True) -> np.ndarray:
    """Read an image file. ``color``: (H, W, 3) u8 BGR, a grey PNG's
    channel repeated (``cv2.IMREAD_COLOR``); else the PNG as stored,
    (H, W) u8 or u16 grey or (H, W, 3) u8 BGR (``cv2.IMREAD_UNCHANGED``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        img = decode_png(data, path)
        if color and img.ndim == 2:
            if img.dtype != np.uint8:
                raise ValueError(f"{path}: a 16-bit PNG has no 8-bit colour "
                                 f"reading")
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img
    if data[:2] == b"\xff\xd8":
        return _read_jpeg(data, path, color)
    raise ValueError(f"{path}: neither a PNG nor a JPEG")


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` as a PNG: (H, W, 3) u8 BGR, (H, W) u8 or (H, W)
    u16 (``cv2.imwrite`` of a ``.png`` path)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG files are written")
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _read_jpeg(data: bytes, path: str, color: bool) -> np.ndarray:
    try:
        cv2 = importlib.import_module("cv2")
    except ImportError:
        cv2 = None
    if cv2 is not None:
        flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED
        return cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    try:
        image_mod = importlib.import_module("PIL.Image")
    except ImportError:
        raise ImportError(f"{path}: reading a JPEG needs cv2 or PIL, and "
                          f"neither imports") from None
    import io
    with image_mod.open(io.BytesIO(data)) as im:
        if color or im.mode != "L":
            return np.asarray(im.convert("RGB"))[:, :, ::-1].copy()
        return np.asarray(im).copy()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W, 3) u8 BGR, (H, W) u8 or (H, W) u16; every row
    carries the Up filter."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        kind, data = (2, 8), img[:, :, ::-1]
    elif img.dtype == np.uint8 and img.ndim == 2:
        kind, data = (0, 8), img
    elif img.dtype == np.uint16 and img.ndim == 2:
        kind, data = (0, 16), img.astype(">u2")
    else:
        raise ValueError(f"no PNG form for a {img.dtype} array of shape "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]                      # wraps modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, kind[1], kind[0], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """The image in PNG ``data`` as stored: (H, W) u8 or u16 grey, or
    (H, W, 3) u8 BGR. Raises on any other kind of PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:             # a critical chunk (PLTE)
            raise ValueError(f"{name}: PNG chunk {kind!r} is not supported")
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if (ctype, depth) not in _PNG_KINDS or comp or filt or interlace:
        raise ValueError(
            f"{name}: PNG of colour type {ctype}, bit depth {depth}, "
            f"interlace {interlace} is not supported (8-bit grey or RGB, "
            f"16-bit grey, not interlaced)")
    channels = _PNG_KINDS[(ctype, depth)]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{name}: PNG data holds {raw.size} bytes, "
                         f"expected {h * (w * bpp + 1)}")
    rows = _unfilter(raw.reshape(h, w * bpp + 1), w, bpp, name)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    if channels == 3:
        return np.ascontiguousarray(rows.reshape(h, w, 3)[:, :, ::-1])
    return rows.reshape(h, w)


def _unfilter(rows: np.ndarray, w: int, bpp: int, name: str) -> np.ndarray:
    """Undo the PNG row filters: (H, 1 + W*bpp) filtered -> (H, W*bpp)."""
    h = rows.shape[0]
    ftype = rows[:, 0]
    filt = rows[:, 1:].reshape(h, w, bpp)
    if h and int(ftype.max()) > 4:
        raise ValueError(f"{name}: unknown PNG row filter {int(ftype.max())}")
    if np.isin(ftype, (3, 4)).any():
        return _unfilter_wavefront(filt, ftype).reshape(h, w * bpp)
    out = np.empty_like(filt)
    prev = np.zeros((w, bpp), np.uint8)
    for r in range(h):                        # None, Sub, Up: whole rows
        if ftype[r] == 0:
            prev = filt[r]
        elif ftype[r] == 1:
            prev = np.cumsum(filt[r], axis=0, dtype=np.uint8)
        else:
            prev = filt[r] + prev
        out[r] = prev
    return out.reshape(h, w * bpp)


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """All five filters along anti-diagonals: pixel (r, x) needs only its
    left, upper and upper-left neighbours, which the diagonal before
    holds, so each diagonal is one vector step."""
    h, w, bpp = filt.shape
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)   # row and column 0: 0
    f = filt.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (f[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


# -------------------------------------------------------------- resize


def _taps(n_in: int, n_out: int, clamp: bool, legacy: bool):
    """OpenCV's linear taps along one axis: the two source indices and the
    f32 fraction of the second. OpenCV's older code (``legacy``: u8, and
    f32 of other than 1, 3 or 4 channels) scales by 1 / (out / in) and
    rounds the source position to f32; its f32 code scales by in / out in
    double. Columns (``clamp``) pin the fraction to 0 at the edges, rows
    keep it and read the edge row twice."""
    scale = 1.0 / (n_out / n_in) if legacy else n_in / n_out
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    if legacy:
        pos = pos.astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    if clamp:
        frac = np.where((lo < 0) | (lo >= n_in - 1), np.float32(0), frac)
    return np.clip(lo, 0, n_in - 1), np.clip(lo + 1, 0, n_in - 1), frac


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add: the f32
    product is exact in f64."""
    return (a.double() * b.double() + c).float()


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_LINEAR)``: ``size`` is
    (width, height); ``img`` (H, W) or (H, W, C), f32 or u8 (any C; one
    channel comes back 2-D, as from OpenCV). Computed with torch on the
    CPU (its kernels run on several threads and release the interpreter
    lock); returns numpy."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    w_out, h_out = size
    h_in, w_in = img.shape[:2]
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear takes u8 or f32, not {img.dtype}")
    if (h_in, w_in) == (h_out, w_out):
        return img.copy()
    u8 = img.dtype == np.uint8
    legacy = u8 or (img.ndim == 3 and img.shape[2] not in (1, 3, 4))
    src = torch.from_numpy(np.ascontiguousarray(img))
    if u8:
        src = src.to(torch.int32)
    if legacy and w_in == 2 * w_out and h_in == 2 * h_out:
        return _halve(src, u8).numpy()
    x0, x1, fx = _taps(w_in, w_out, clamp=True, legacy=legacy)
    y0, y1, fy = _taps(h_in, h_out, clamp=False, legacy=legacy)
    extra = (1,) * (img.ndim - 2)
    x0, x1, y0, y1 = (torch.from_numpy(i) for i in (x0, x1, y0, y1))
    if not legacy:
        # OpenCV's f32 lerp, a0 + (a1 - a0) * f as one fused
        # multiply-add, along the rows and then the columns.
        fx = torch.from_numpy(fx).reshape((1, -1) + extra)
        fy = torch.from_numpy(fy).reshape((-1, 1) + extra)
        s0 = src.index_select(1, x0)
        d = _fma(src.index_select(1, x1) - s0, fx, s0)
        d0 = d.index_select(0, y0)
        return _fma(d.index_select(0, y1) - d0, fy, d0).numpy()
    a0, a1, b0, b1 = (np.float32(1) - fx, fx, np.float32(1) - fy, fy)
    if u8:
        # 11-bit weights; rows of 2048-scaled sums, then OpenCV's
        # ((b0 * (d0 >> 4)) >> 16) + ((b1 * (d1 >> 4)) >> 16) + 2 >> 2.
        a0, a1, b0, b1 = (np.rint(v * np.float32(2048)).astype(np.int32)
                          for v in (a0, a1, b0, b1))
    a0, a1 = (torch.from_numpy(v).reshape((1, -1) + extra) for v in (a0, a1))
    b0, b1 = (torch.from_numpy(v).reshape((-1, 1) + extra) for v in (b0, b1))
    d = src.index_select(1, x0) * a0 + src.index_select(1, x1) * a1
    if not u8:
        return (d.index_select(0, y0) * b0
                + d.index_select(0, y1) * b1).numpy()
    d >>= 4
    out = (((d.index_select(0, y0) * b0) >> 16)
           + ((d.index_select(0, y1) * b1) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8).numpy()


def _halve(src: torch.Tensor, u8: bool) -> torch.Tensor:
    """OpenCV's exact 2x reduction on its older code: the mean of each 2x2
    block. u8 (given as int32) rounds half up, (sum + 2) >> 2, for 1, 3 or
    4 channels, and half to even for any other count."""
    total = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
             + src[1::2, 1::2])
    if not u8:
        return total * 0.25
    if src.dim() == 2 or src.shape[2] in (1, 3, 4):
        return ((total + 2) >> 2).to(torch.uint8)
    return torch.round(total * 0.25).to(torch.uint8)


# ----------------------------------------------------------------- HSV


# OpenCV converts colour 8 pixels at a time (AVX2) with fused
# multiply-adds and leaves each row's last W % 8 pixels to scalar code;
# the two round some hues differently, and reproducing both keeps the
# photometric distortion's u8 output bit-exact.
_HSV_LANES = 8


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` on f32: H in [0, 360), S in
    [0, 1], V the max channel. Computed with torch on the CPU."""
    img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    b, g, r = img.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    s = diff / (v.abs() + _FLT_EPSILON)
    # A tensor quotient: torch takes ``60.0 / t`` as 60 * (1 / t).
    rev = torch.full_like(diff, 60.0) / (diff + _FLT_EPSILON)
    r_max, g_max = v == r, v == g
    hd = torch.where(r_max, g - b, torch.where(g_max, b - r, r - g))
    base = torch.where(r_max, 0.0, torch.where(g_max, 120.0, 240.0))
    # The vector code adds 360 inside the fused step, the scalar after it.
    vector = torch.zeros(img.shape[-2], dtype=torch.bool)
    vector[:img.shape[-2] // _HSV_LANES * _HSV_LANES] = True
    wrap = vector & r_max & (hd < 0)
    h = _fma(hd, rev, torch.where(wrap, 360.0, base).double())
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], dim=-1).numpy()


# OpenCV's sector table: which of (v, p, q, t) each of b, g, r takes.
_HSV_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                             [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` on f32 (H in degrees).
    Computed with torch on the CPU."""
    hsv = torch.from_numpy(np.ascontiguousarray(hsv, np.float32))
    h, s, v = hsv.unbind(-1)
    h = torch.fmod(h * float(np.float32(6.0 / 360.0)), 6.0)
    h = torch.where(h < 0, h + 6.0, h)
    sector = torch.floor(h)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, 0, sector.long())
    h = torch.where(bad, 0.0, h)
    tab = torch.stack([v, v * (1 - s), v * _fma(-s, h, 1.0),
                       v * _fma(-s, 1 - h, 1.0)], dim=-1)
    out = torch.gather(tab, -1, _HSV_SECTORS[sector])
    return torch.where((s == 0)[..., None], v[..., None], out).numpy()


# --------------------------------------------------------- motion blur


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) f64, ``angle`` in degrees
    counter-clockwise."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine_linear(src: np.ndarray, m: np.ndarray,
                       dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize)`` of a 2-D f64 array: bilinear,
    border 0. As OpenCV does, the inverse map is stepped in 1/1024 pixel
    fixed point and each source position rounded to 1/32 pixel, whose
    f32 weights sum in f64."""
    w, h = dsize
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    i00, i11 = m[1, 1] * det, m[0, 0] * det
    i01, i10 = -m[0, 1] * det, -m[1, 0] * det
    i02 = -i00 * m[0, 2] - i01 * m[1, 2]
    i12 = -i10 * m[0, 2] - i11 * m[1, 2]
    xs, ys = np.arange(w), np.arange(h)
    x_fix = (np.rint((i01 * ys + i02) * 1024).astype(np.int64)[:, None] + 16
             + np.rint(i00 * xs * 1024).astype(np.int64)[None]) >> 5
    y_fix = (np.rint((i11 * ys + i12) * 1024).astype(np.int64)[:, None] + 16
             + np.rint(i10 * xs * 1024).astype(np.int64)[None]) >> 5
    sx, sy = x_fix >> 5, y_fix >> 5
    ax = (x_fix & 31).astype(np.float32) * np.float32(1 / 32)
    ay = (y_fix & 31).astype(np.float32) * np.float32(1 / 32)
    one = np.float32(1)
    weights = [(one - ay) * (one - ax), (one - ay) * ax,
               ay * (one - ax), ay * ax]
    out = np.zeros((h, w), np.float64)
    sh, sw = src.shape
    for (dy, dx), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        yy, xx = sy + dy, sx + dx
        inside = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        val = np.where(inside, src[np.clip(yy, 0, sh - 1),
                                   np.clip(xx, 0, sw - 1)], 0.0)
        out = out + val * wt.astype(np.float64)
    return out


def motion_blur_kernel(degree: int, angle: float) -> np.ndarray:
    """The (degree, degree) f64 kernel of the motion blur: the diagonal
    rotated by ``angle`` degrees about the kernel's centre, over
    ``degree``."""
    m = rotation_matrix_2d((degree / 2, degree / 2), angle, 1)
    return warp_affine_linear(np.diag(np.ones(degree)), m,
                              (degree, degree)) / degree


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)``: correlation with the anchor at
    the kernel's centre (``k // 2``), border REFLECT_101, in f64 and cast
    back to ``img``'s dtype."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = ((ay, kh - 1 - ay), (ax, kw - 1 - ax)) + ((0, 0),) * (img.ndim - 2)
    src = np.pad(img.astype(np.float64), pad, mode="reflect")
    h, w = img.shape[:2]
    out = np.zeros(src[:h, :w].shape, np.float64)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                out += kernel[i, j] * src[i:i + h, j:j + w]
    return out.astype(img.dtype)


def normalize_minmax(img: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """``cv2.normalize(img, None, lo, hi, NORM_MINMAX)``: an affine map
    of [min, max] onto [lo, hi] (a constant image maps to ``lo``)."""
    smin, smax = float(img.min()), float(img.max())
    scale = (hi - lo) / (smax - smin) if smax - smin > np.finfo(
        np.float64).eps else 0.0
    return (img * scale + (lo - smin * scale)).astype(img.dtype)


# ----------------------------------------------------------- polygons


def _clip_line(w: int, h: int, p0, p1):
    """OpenCV's ``clipLine`` on integer points: the part of the segment
    inside [0, w-1] x [0, h-1] and whether any is."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _line8(mask: np.ndarray, p0, p1, value) -> None:
    """OpenCV's 8-connected ``line`` (``LineIterator``, left to right)."""
    h, w = mask.shape[:2]
    if not all(0 <= x < w and 0 <= y < h for x, y in (p0, p1)):
        p0, p1, visible = _clip_line(w, h, p0, p1)
        if not visible:
            return
    if p1[0] < p0[0]:
        p0, p1 = p1, p0
    (x, y), (x1, y1) = p0, p1
    dx, dy = x1 - x, y1 - y
    step_y = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    for _ in range(major + 1):
        mask[y, x] = value
        diag = err < 0
        err += 2 * major - 2 * minor if diag else -2 * minor
        if vert:
            y += step_y
            x += diag
        else:
            x += 1
            y += step_y if diag else 0


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(mask: np.ndarray, polygons: Sequence[np.ndarray],
              value) -> np.ndarray:
    """``cv2.fillPoly(mask, polygons, value)`` with integer vertices
    (lineType 8, shift 0): every edge drawn as an 8-connected line, then
    each row filled between pairs of edge crossings (even-odd over all
    polygons), from the left crossing rounded up to the right one rounded
    down, in 16-bit fixed point; an edge leaving the image runs between
    its clipped ends. Fills ``mask`` in place and returns it."""
    h, w = mask.shape[:2]
    one = 1 << 16
    edges = []
    for poly in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        prev = pts[-1]
        for cur in pts:
            _line8(mask, prev, cur, value)
            (x0, y0), (x1, y1) = prev, cur
            c0x, c0y, c1x, c1y = x0 * one, y0, x1 * one, y1
            if not all(0 <= x < w and 0 <= y < h for x, y in (prev, cur)):
                t0, t1, _ = _clip_line(w, h, prev, cur)
                if t0[1] != t1[1]:
                    c0x, c0y, c1x, c1y = t0[0] * one, t0[1], t1[0] * one, t1[1]
            if y0 != y1:
                dx = _trunc_div(c1x - c0x, c1y - c0y)
                if y0 < y1:
                    edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
                else:
                    edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))
            prev = cur
    if len(edges) < 2:
        return mask
    for y in range(max(min(e[0] for e in edges), 0),
                   min(max(e[1] for e in edges), h)):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges
                    if y0 <= y < y1)
        for left, right in zip(xs[0::2], xs[1::2]):
            x1, x2 = (left + one - 1) >> 16, right >> 16
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = value
    return mask
