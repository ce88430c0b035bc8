"""The port's data pipeline against OpenCV and the JAX package on the CPU.

``data/image_io.py`` stands in for the OpenCV calls of the JAX pipeline;
each function is held against the call it replaces:
* PNG read and write: exact, both ways, against ``cv2.imread`` and
  ``cv2.imwrite`` (8-bit BGR and grey, 16-bit grey, every row filter).
* ``resize_linear``: f32 within 1e-4 of the image's scale, u8 (the mask
  stack) exact, up and down, odd sizes, the exact 2x reduction.
* HSV both ways: within 1e-4 absolute (H in degrees, BGR on 0-255).
  (On an x86-64 host with AVX2 the port reproduces OpenCV's f32
  arithmetic bit for bit in both; the u8 wire image of ``SSDAugmentation``
  depends on it, since it rounds.)
* the motion blur: kernel within 1e-12, the blurred, min-max normalised
  image within 1e-3 on its 0-255 scale (OpenCV filters in f32, the port in
  f64).
* ``fill_poly``: exact for polygons inside the image; where an edge leaves
  it, a pixel may differ only in the first or last column (OpenCV clips
  such edges in a way the port follows only approximately).

Then the pipeline on a small ScanNet tree (64x96, PNG colour) against the
JAX package's: ``pull_item`` under ``BaseTransform`` and under
``SSDAugmentation`` from the same ``RandomState`` seed (images and depth
within 1e-4, masks exact, boxes and plane params within 1e-5), the wire
batch of ``collate_batch`` (exact, sparse and packed), the order and
sharding of ``BatchIterator`` (exact), and the port's ``synth_scenes``
(same scenes from a seed, the JSON equal apart from the extension).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from planerecnet_tpu import config as jconfig
from planerecnet_tpu import data as jdata
from planerecnet_tpu.data import coco as jcoco
from planerecnet_tpu_torch import config as tconfig
from planerecnet_tpu_torch import data as tdata
from planerecnet_tpu_torch.data import coco as tcoco
from planerecnet_tpu_torch.data import image_io
from planerecnet_tpu_torch.tools import synth_scenes as tsynth
from test_torch_port_model import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import synth_scenes as jsynth  # noqa: E402

H, W = 64, 96
SCENE = "scene0000_00"


# ------------------------------------------------------------- config


def _fields_equal(a, b, path):
    """Every field of the port's ``b`` equals the JAX ``a``'s; a field the
    JAX package lacks holds the port's default (which reproduces the JAX
    package's behaviour)."""
    for f in dataclasses.fields(b):
        if not hasattr(a, f.name):
            assert getattr(b, f.name) == getattr(type(b)(), f.name), \
                f"{path}.{f.name}: not the default of a port-only field"
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _fields_equal(va, vb, f"{path}.{f.name}")
        else:
            assert va == vb, f"{path}.{f.name}: JAX {va!r}, port {vb!r}"


@pytest.mark.parametrize("name", sorted(set(tconfig._CONFIGS)
                                        & set(jconfig._CONFIGS)))
def test_config_presets_match_jax(name):
    """Every field the port's preset has equals the JAX preset's."""
    _fields_equal(jconfig.get_cfg(name), tconfig.get_cfg(name), name)


@pytest.mark.parametrize("name", sorted(tconfig._DATASETS))
def test_dataset_presets_match_jax(name):
    jcfg = jconfig.set_dataset(jconfig.PlaneRecNet_50_config, name)
    tcfg = tconfig.set_dataset(tconfig.PlaneRecNet_50_config, name)
    _fields_equal(jcfg.dataset, tcfg.dataset, name)


def test_apply_overrides_matches_jax():
    ov = {"max_iter": 7, "solov2": {"top_k": 3, "num_grids": [4, 4, 2, 2]},
          "dataset": {"max_depth": 9.0}}
    _fields_equal(jconfig.apply_overrides(jconfig.PlaneRecNet_50_config, ov),
                  tconfig.apply_overrides(tconfig.PlaneRecNet_50_config, ov),
                  "overridden")
    with pytest.raises(KeyError):
        tconfig.apply_overrides(tconfig.PlaneRecNet_50_config, {"nope": 1})


# ------------------------------------------------------------ PNG


def _images(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    return {
        "bgr8": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
        "grey8": rng.randint(0, 256, (37, 53)).astype(np.uint8),
        "grey16": rng.randint(0, 65536, (37, 53)).astype(np.uint16),
        # Gradients, on which OpenCV's encoder picks Paeth and Average.
        "smooth_bgr8": np.stack([smooth, smooth[::-1], smooth // 2], -1),
        "smooth_grey16": (xx * 700 + yy * 300).astype(np.uint16),
    }


@pytest.mark.parametrize("kind", sorted(_images()))
def test_png_matches_cv2(kind, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    got = image_io.imread(path, color=False)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    image_io.imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    if img.dtype == np.uint8:
        np.testing.assert_array_equal(image_io.imread(path),
                                      cv2.imread(path, cv2.IMREAD_COLOR))


def _png_with_filters(img, filters):
    """A PNG of (H, W, 3) u8 BGR whose row r carries filter
    ``filters[r % 5]``, filtered by a plain per-byte reference."""
    h, w, _ = img.shape
    rows = img[:, :, ::-1].reshape(h, w * 3).astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r % len(filters)]
        prev = rows[r - 1] if r else np.zeros(w * 3, np.int64)
        out.append(f)
        for i in range(w * 3):
            a = rows[r, i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else c)][f]
            out.append((rows[r, i] - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_row_filters(filters, tmp_path):
    img = _images()["smooth_bgr8"][:9, :11]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img, filters))
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(image_io.imread(path), img)


@pytest.mark.parametrize("kind", ["rgba", "palette", "rgb16"])
def test_png_rejects_other_kinds(kind, tmp_path):
    path = str(tmp_path / "x.png")
    if kind == "rgba":
        cv2.imwrite(path, np.zeros((4, 5, 4), np.uint8))
    elif kind == "rgb16":
        cv2.imwrite(path, np.zeros((4, 5, 3), np.uint16))
    else:
        from PIL import Image
        Image.new("P", (5, 4)).save(path)
    with pytest.raises(ValueError, match="not supported"):
        image_io.imread(path, color=False)


def test_jpeg_needs_cv2_or_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "c.jpg")
    img = _images()["bgr8"]
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = image_io.imread(path)            # through PIL
    assert got.shape == img.shape and got.dtype == np.uint8
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="c.jpg"):
        image_io.imread(path)


# ---------------------------------------------------------- resize


RESIZES = [((48, 64), (64, 64)), ((37, 53), (71, 29)), ((37, 53), (17, 13)),
           ((37, 53), (54, 34)), ((48, 64), (32, 24)), ((64, 96), (80, 80)),
           ((480, 640), (641, 477))]


@pytest.mark.parametrize("src,size", RESIZES)
def test_resize_linear_matches_cv2(src, size):
    h, w = src
    rng = np.random.RandomState(h * w)
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    depth = (rng.rand(h, w) * 5).astype(np.float32)
    for f in (img, depth):
        want = cv2.resize(f, size, interpolation=cv2.INTER_LINEAR)
        got = image_io.resize_linear(f, size)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for u8 in ((rng.rand(h, w, 7) > 0.5).astype(np.uint8),
               (rng.rand(h, w, 3) > 0.5).astype(np.uint8),
               (rng.rand(h, w) > 0.5).astype(np.uint8),
               rng.randint(0, 256, (h, w, 4)).astype(np.uint8)):
        want = cv2.resize(u8, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(image_io.resize_linear(u8, size), want)


# ------------------------------------------------------- HSV, blur


def test_hsv_matches_cv2():
    rng = np.random.RandomState(1)
    img = (rng.rand(50, 70, 3) * 300 - 20).astype(np.float32)
    img[0, :5] = 100.0                         # grey: S = 0
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hsv = image_io.bgr_to_hsv(img)
    np.testing.assert_allclose(hsv, want, rtol=0, atol=1e-4)
    want[..., 1] *= 1.3                        # as photometric_distort does
    want[..., 0] = (want[..., 0] + 17) % 360
    np.testing.assert_allclose(image_io.hsv_to_bgr(want),
                               cv2.cvtColor(want, cv2.COLOR_HSV2BGR),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("degree,angle", [(3, 0), (5, 45), (7, 90),
                                          (11, 179), (4, 33), (8, 120)])
def test_motion_blur_matches_cv2(degree, angle):
    m = cv2.getRotationMatrix2D((degree / 2, degree / 2), angle, 1)
    np.testing.assert_array_equal(
        image_io.rotation_matrix_2d((degree / 2, degree / 2), angle, 1), m)
    want_k = cv2.warpAffine(np.diag(np.ones(degree)), m,
                            (degree, degree)) / degree
    got_k = image_io.motion_blur_kernel(degree, angle)
    np.testing.assert_allclose(got_k, want_k, rtol=0, atol=1e-12)
    img = (np.random.RandomState(degree).rand(40, 50, 3) * 255).astype(
        np.float32)
    want = cv2.filter2D(img, -1, want_k)
    cv2.normalize(want, want, 0, 255, cv2.NORM_MINMAX)
    got = image_io.normalize_minmax(image_io.filter2d(img, got_k), 0, 255)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


POLYS_INSIDE = [
    [[[5, 5], [40, 8], [30, 35], [8, 30]]],
    [[[0, 0], [63, 0], [63, 47], [0, 47]]],
    [[[10, 3], [50, 20], [12, 44], [30, 22]]],          # self-crossing
    [[[5, 5], [20, 5], [20, 20], [5, 20]], [[10, 10], [30, 10], [30, 30]]],
    [[[3, 40], [60, 2], [61, 45]]],
    [[[4, 42], [43, 3], [51, 5], [42, 33], [38, 38]]],
]
POLYS_CROSSING = [
    [[[-5, 10], [70, 12], [60, 60], [3, 40]]],
    [[[0, 5], [-7, -5], [1, 17], [51, 31]]],
]


@pytest.mark.parametrize("polys", POLYS_INSIDE + POLYS_CROSSING)
def test_fill_poly_matches_cv2(polys):
    polys = [np.asarray(p) for p in polys]
    want = np.zeros((48, 64), np.uint8)
    cv2.fillPoly(want, [p.astype(np.int32) for p in polys], 1)
    got = image_io.fill_poly(np.zeros((48, 64), np.uint8), polys, 1)
    differ = got != want
    inside = all(((p >= 0) & (p < [64, 48])).all() for p in polys)
    if inside:
        np.testing.assert_array_equal(got, want)
    else:
        assert not differ[:, 1:-1].any()
    assert want.sum() > 0


def test_polygons_to_mask_matches_jax():
    poly = [[5.2, 5.6, 40.4, 8.1, 30.0, 35.5, 8.0, 30.2]]
    np.testing.assert_array_equal(tcoco.polygons_to_mask(poly, 48, 64),
                                  jcoco.polygons_to_mask(poly, 48, 64))


# ------------------------------------------------------------- RLE


def test_rle_codec_matches_jax():
    rng = np.random.RandomState(3)
    for shape in ((23, 17), (64, 96), (1, 5)):
        mask = (rng.rand(*shape) > 0.6).astype(np.uint8)
        mask[0, 0] = 1
        rle = tcoco.mask_to_rle(mask)
        assert rle == jcoco.mask_to_rle(mask)
        comp = tcoco.mask_to_compressed_rle(mask)
        assert comp == jcoco.mask_to_compressed_rle(mask)
        for r in (rle, comp):
            np.testing.assert_array_equal(tcoco.rle_to_mask(r), mask)
            np.testing.assert_array_equal(tcoco.rle_to_mask(r),
                                          jcoco.rle_to_mask(r))


# ------------------------------------------------------ the pipeline


def _write_tree(root):
    """4 images of one ScanNet scene, 64x96, PNG colour
    and 16-bit depth written by cv2, 2-4 rectangular planes each."""
    for d in ("color", "depth", os.path.join("frame", "intrinsic")):
        os.makedirs(os.path.join(root, SCENE, d))
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W]
    images, anns = [], []
    for i in range(4):
        img = np.clip(np.stack([xx * 2 + 9 * i, yy * 3, xx + yy], -1)
                      + rng.randint(0, 40, (H, W, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, SCENE, "color", f"{i}.png"), img)
        cv2.imwrite(os.path.join(root, SCENE, "depth", f"{i}.png"),
                    (rng.rand(H, W) * 3000 + 500).astype(np.uint16))
        images.append({"id": i, "file_name": f"{SCENE}/color/{i}.png",
                       "height": H, "width": W})
        for _ in range(2 + i % 3):
            m = np.zeros((H, W), np.uint8)
            y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 30)
            hh, ww = rng.randint(8, 20), rng.randint(10, 30)
            m[y0:y0 + hh, x0:x0 + ww] = 1
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 1,
                         "segmentation": jcoco.mask_to_rle(m),
                         "bbox": [x0, y0, ww, hh], "area": int(m.sum()),
                         "iscrowd": 0,
                         "plane_paras": [float(v) for v in rng.randn(4)]})
    lines = ["x\n"] * 9 + ["K = 500 0 48 0 0 500 32 0 0 0 1 0 0 0 0 1\n"]
    with open(os.path.join(root, SCENE, "frame", "intrinsic",
                           SCENE + ".txt"), "w") as f:
        f.writelines(lines)
    anno = os.path.join(root, "train.json")
    with open(anno, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "plane"}]}, f)
    return anno


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scans"))
    anno = _write_tree(root)
    # max_size 80: the 64x96 frames are resized up in one axis and down
    # in the other (a frame with a side equal to max_size is not resized).
    jcfg = jconfig.PlaneRecNet_50_config.copy(dict(
        max_size=80, max_instances=4, dataset=jconfig.PlaneRecNet_50_config
        .dataset.copy(dict(train_images=root + "/", train_info=anno))))
    return jcfg, port_cfg(jcfg)


def _compare_items(a, b):
    (ai, ainst, ad), (bi, binst, bd) = a, b
    assert ai.dtype == bi.dtype and ai.shape == bi.shape
    np.testing.assert_allclose(bi.astype(np.float64), ai, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ai).max()))
    np.testing.assert_allclose(bd, ad, rtol=0, atol=1e-4)
    assert set(ainst) == set(binst)
    np.testing.assert_array_equal(binst["masks"], ainst["masks"])
    np.testing.assert_array_equal(binst["classes"], ainst["classes"])
    for k in ("boxes", "plane_paras", "k_matrix"):
        np.testing.assert_allclose(binst[k], ainst[k], rtol=0, atol=1e-5)


def test_pull_item_base_transform_matches_jax(tree):
    jcfg, tcfg = tree
    jds = jdata.build_dataset(jcfg, "train",
                              transform=jdata.BaseTransform(jcfg))
    tds = tdata.build_dataset(tcfg, "train",
                              transform=tdata.BaseTransform(tcfg))
    assert jds.ids == tds.ids
    for i in range(len(jds)):
        a, b = jds.pull_item(i), tds.pull_item(i)
        assert a[0].shape == (80, 80, 3)
        _compare_items(a, b)
    np.testing.assert_array_equal(tds.pull_image(1), jds.pull_image(1))
    np.testing.assert_array_equal(tds.pull_depth(1), jds.pull_depth(1))


@pytest.mark.parametrize("device_normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pull_item_ssd_augmentation_matches_jax(tree, seed,
                                                device_normalize):
    """Photometric distortion, mirror and flip drawn from the same
    ``RandomState``: u8 wire images (clipped, rounded) and f32 ones."""
    jcfg, tcfg = tree
    jds = jdata.build_dataset(jcfg, "train", transform=jdata.SSDAugmentation(
        jcfg, rng=np.random.RandomState(seed),
        device_normalize=device_normalize))
    tds = tdata.build_dataset(tcfg, "train", transform=tdata.SSDAugmentation(
        tcfg, rng=np.random.RandomState(seed),
        device_normalize=device_normalize))
    for i in range(len(jds)):
        _compare_items(jds.pull_item(i), tds.pull_item(i))


def test_augmentation_extras_match_jax(tree):
    """rot90, motion blur and gaussian noise (off in every preset) on one
    frame, drawn from the same ``RandomState``."""
    jcfg, tcfg = tree
    augment = dict(random_rot90=True, motion_blur=True, gaussian_noise=True)
    jcfg = jcfg.copy(dict(augment=jcfg.augment.copy(augment)))
    tcfg = tcfg.copy(dict(augment=tcfg.augment.copy(augment)))
    for seed in range(6):
        jds = jdata.build_dataset(jcfg, "train", transform=jdata
                                  .SSDAugmentation(jcfg, rng=np.random
                                                   .RandomState(seed),
                                                   device_normalize=False))
        tds = tdata.build_dataset(tcfg, "train", transform=tdata
                                  .SSDAugmentation(tcfg, rng=np.random
                                                   .RandomState(seed),
                                                   device_normalize=False))
        a, b = jds.pull_item(seed % 4), tds.pull_item(seed % 4)
        # The blur's normalisation spreads OpenCV's f32 filtering error
        # over the image's range: 1e-3 on the 0-255 scale, normalised.
        np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-3 / 57.0)
        np.testing.assert_array_equal(b[1]["masks"], a[1]["masks"])
        np.testing.assert_allclose(b[2], a[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [(64, 96), (96, 64)])
def test_resize_and_pad_and_pad_match_jax(tree, size):
    """``ResizeAndPad`` (long side to max_size, mean fill) and ``Pad`` on
    one raw frame, landscape and portrait."""
    jcfg, tcfg = tree
    img, inst, depth = jdata.build_dataset(jcfg, "train").pull_item(1)
    if size != img.shape[:2]:
        img, depth = img.transpose(1, 0, 2), depth.transpose(1, 0, 2)
        inst = dict(inst, masks=inst["masks"].transpose(0, 2, 1))
    args = (img, depth[..., 0], inst["masks"].astype(np.uint8),
            inst["boxes"], inst["classes"], inst["plane_paras"])
    for jt, tt in ((jdata.ResizeAndPad(jcfg), tdata.ResizeAndPad(tcfg)),
                   (jdata.Pad(100, 110), tdata.Pad(100, 110))):
        want, got = jt(*args), tt(*args)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("sparse", [True, False])
def test_collate_batch_matches_jax(tree, sparse):
    jcfg, tcfg = tree
    jds = jdata.build_dataset(jcfg, "train", transform=jdata.SSDAugmentation(
        jcfg, rng=np.random.RandomState(5)))
    tds = tdata.build_dataset(tcfg, "train", transform=tdata.SSDAugmentation(
        tcfg, rng=np.random.RandomState(5)))
    jstats, tstats = {}, {}
    want = jdata.collate_batch(jcfg, [jds[i] for i in range(4)], jstats,
                               sparse_masks=sparse)
    got = tdata.collate_batch(tcfg, [tds[i] for i in range(4)], tstats,
                              sparse_masks=sparse)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tstats == jstats


@pytest.mark.parametrize("num_shards", [1, 2])
def test_batch_iterator_matches_jax(tree, num_shards):
    jcfg, tcfg = tree
    for shard in range(num_shards):
        jds = jdata.build_dataset(jcfg, "train",
                                  transform=jdata.BaseTransform(jcfg))
        tds = tdata.build_dataset(tcfg, "train",
                                  transform=tdata.BaseTransform(tcfg))
        jit = jdata.BatchIterator(jcfg, jds, 2, seed=7, shard_index=shard,
                                  num_shards=num_shards)
        tit = tdata.BatchIterator(tcfg, tds, 2, seed=7, shard_index=shard,
                                  num_shards=num_shards)
        for _ in range(2):                     # two epochs
            want, got = list(jit), list(tit)
            assert len(got) == len(want) == 2
            for a, b in zip(want, got):
                assert set(a) == set(b)
                np.testing.assert_array_equal(b["boxes"], a["boxes"])
                np.testing.assert_allclose(b["image"], a["image"], rtol=0,
                                           atol=1e-4)
        assert tit.truncation_stats == jit.truncation_stats


def test_prefetch_iterator_order_errors_and_stop():
    """On the CPU the batches pass as they are, in order; an error in the
    worker reaches the consumer; leaving the loop early stops the
    worker."""
    batches = [{"x": np.full(3, i)} for i in range(6)]
    pf = tdata.PrefetchIterator(iter(batches), buffer_size=2, device="cpu")
    assert [int(b["x"][0]) for b in pf] == list(range(6))
    assert 0 <= pf.mean_occupancy() <= 2

    def failing():
        yield {"x": np.zeros(1)}
        raise RuntimeError("bad frame")
    with pytest.raises(RuntimeError, match="bad frame"):
        list(tdata.PrefetchIterator(failing(), device="cpu"))

    def endless():
        while True:
            yield {"x": np.zeros(1)}
    before = threading.active_count()
    it = iter(tdata.PrefetchIterator(endless(), buffer_size=1, device="cpu"))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_prefetch_iterator_under_thread_switching():
    """A thread switch every microsecond: every batch arrives once and in
    order through a one-slot queue, and loops left early leave no worker
    behind."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = threading.active_count()
        pf = tdata.PrefetchIterator(({"x": np.full(1, i)} for i in
                                     range(2000)), buffer_size=1,
                                    device="cpu")
        assert [int(b["x"][0]) for b in pf] == list(range(2000))
        for stop_at in (0, 1, 7):
            it = iter(tdata.PrefetchIterator(
                ({"x": np.zeros(1)} for _ in range(100)), buffer_size=1,
                device="cpu"))
            for _ in range(stop_at + 1):
                next(it)
            it.close()
        deadline = time.monotonic() + 10
        while threading.active_count() > before and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert threading.active_count() == before
    finally:
        sys.setswitchinterval(interval)


def test_enforce_size_matches_jax(tree):
    jcfg, tcfg = tree
    jds = jdata.build_dataset(jcfg, "train")
    tds = tdata.build_dataset(tcfg, "train")
    img, inst, depth = jds.pull_item(2)
    want = jdata.enforce_size(jcfg, img, depth[..., 0], inst, 70, 50)
    got = tdata.enforce_size(tcfg, img, depth[..., 0], tds.pull_item(2)[1],
                             70, 50)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * 255)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2]["masks"], want[2]["masks"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[2]["boxes"], want[2]["boxes"], rtol=0,
                               atol=1e-5)


# ----------------------------------------------------- synth_scenes


def test_synth_scenes_render_matches_jax():
    k = tsynth._intrinsics(40, 56)
    for seed in (3, 4):
        want = jsynth.render(jsynth.build_scene(np.random.RandomState(seed)),
                             k, 40, 56)
        got = tsynth.render(tsynth.build_scene(np.random.RandomState(seed)),
                            k, 40, 56)
        for a, b in zip(want[:3], got[:3]):      # colour, depth, plane ids
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_synth_scenes_split_matches_jax(tmp_path):
    """The same JSON apart from the colour files' extension, and colour
    and depth PNGs holding the rendered arrays (the JAX tool's JPEG is
    lossy, so the port's PNG is compared with the JAX tool's arrays)."""
    want = jsynth.generate_split(str(tmp_path / "j"), SCENE, 3, 40, 56, 5,
                                 min_area=40, progress=False)
    got = tsynth.generate_split(str(tmp_path / "t"), SCENE, 3, 40, 56, 5,
                                min_area=40, progress=False)
    assert json.dumps(got) == json.dumps(want).replace(".jpg", ".png")
    rng = np.random.RandomState(5)
    k = tsynth._intrinsics(40, 56)
    scene = jsynth.build_scene(rng)
    rgb, depth, _, _ = jsynth.render(scene, k, 40, 56)
    rgb = np.clip(rgb + rng.normal(0, 4.0, rgb.shape), 0, 255)
    scans = str(tmp_path / "t" / "scans" / SCENE)
    np.testing.assert_array_equal(
        image_io.imread(os.path.join(scans, "color", "0.png")),
        rgb[..., ::-1].astype(np.uint8))
    np.testing.assert_array_equal(
        image_io.imread(os.path.join(scans, "depth", "0.png"), color=False),
        np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16))


def test_port_imports_no_opencv_pil_or_torchvision():
    """Every module of the port imports, in a fresh interpreter, without
    cv2, PIL or torchvision."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import planerecnet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('cv2', 'PIL', 'torchvision')]\n"
        "assert not bad, bad\n"
        "new = ['simple_inference', 'bench', 'tools.closed_loop',"
        " 'utils.torch_convert']\n"
        "missing = [m for m in new if pkg.__name__ + '.' + m not in"
        " sys.modules]\n"
        "assert not missing, missing\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=False)
    assert out.returncode == 0, out.stderr
