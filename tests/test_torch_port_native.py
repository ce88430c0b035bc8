"""The port's C RLE codec (``planerecnet_tpu_torch/native/``) against the
JAX package's C codec and Python decoder, and the port's numpy codec.

The cases of ``tests/test_native.py`` (build, decode, fill, the
compressed-string path, encode), each against both packages; then
``data/coco.py``'s ``rle_to_mask``/``mask_to_rle`` against the JAX
package's on random masks, and the ways the port's codec refuses
(malformed strings, runs that do not fill the mask, a source that does
not compile), where nothing falls back to Python. Masks and runs are
integers: every comparison is exact.
"""

import os

import numpy as np
import pytest

from planerecnet_tpu.data import coco as jcoco
from planerecnet_tpu.native import (rle_decode_counts_native as jdecode,
                                    rle_encode_mask_native as jencode,
                                    rle_fill_native as jfill)
from planerecnet_tpu_torch.data import coco
from planerecnet_tpu_torch.native import (rle_decode_counts_native,
                                          rle_encode_mask_native,
                                          rle_fill_native, rle_native)
from test_native import _encode_counts


def _masks():
    rng = np.random.RandomState(6)
    cases = [np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8),
             np.eye(6, dtype=np.uint8), np.ones((1, 1), np.uint8),
             np.zeros((1, 1), np.uint8)]
    cases += [(rng.rand(*rng.randint(1, 60, 2)) > rng.rand()).astype(
        np.uint8) for _ in range(20)]
    return cases


def test_native_builds_into_build_dir():
    """Built from the port's own ``rle.c`` into ``_build/librle_<hash>.so``
    (hash of the source and flags), not beside the source."""
    path = rle_native.build()
    assert path.parent == rle_native.BUILD_DIR
    assert path.name.startswith("librle_") and path.suffix == ".so"
    assert rle_native.SOURCE.parent.name == "native"
    assert not any(f.endswith(".so")
                   for f in os.listdir(rle_native.SOURCE.parent))
    assert rle_native.library() is rle_native.library()


def test_native_decode_matches_jax():
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 2000, size=101).tolist()
    s = _encode_counts(counts)
    got = rle_decode_counts_native(s).tolist()
    assert got == counts == jdecode(s) == jcoco._decode_rle_counts(s)
    assert rle_decode_counts_native(s.encode("ascii")).tolist() == counts


def test_native_fill_matches_jax_roundtrip():
    rng = np.random.RandomState(1)
    mask = (rng.rand(37, 53) > 0.7).astype(np.uint8)
    rle = jcoco.mask_to_rle(mask)
    got = rle_fill_native(rle["counts"], 37, 53)
    np.testing.assert_array_equal(got, jfill(rle["counts"], 37, 53))
    np.testing.assert_array_equal(got, mask)
    np.testing.assert_array_equal(coco.rle_to_mask(rle), mask)


def test_compressed_string_full_path():
    rng = np.random.RandomState(2)
    mask = (rng.rand(29, 31) > 0.5).astype(np.uint8)
    rle = {"size": [29, 31],
           "counts": _encode_counts(coco.mask_to_rle(mask)["counts"])}
    np.testing.assert_array_equal(coco.rle_to_mask(rle), mask)
    np.testing.assert_array_equal(jcoco.rle_to_mask(rle), mask)


@pytest.mark.parametrize("case", range(len(_masks())))
def test_native_encode_matches_jax_and_numpy(case):
    mask = _masks()[case]
    got = rle_encode_mask_native(mask)
    assert got == jencode(mask) == coco.mask_to_rle_plain(mask)["counts"]
    if mask.size and mask.flat[0]:
        assert got[0] == 0      # runs start with a run of zeros


@pytest.mark.parametrize("compressed", [False, True])
def test_rle_to_mask_and_mask_to_rle_match_jax(compressed):
    """The port's coco codec (C) against the JAX package's and the port's
    numpy codec, on random masks, list and compressed counts."""
    for mask in _masks():
        rle = coco.mask_to_rle(mask)
        assert rle == jcoco.mask_to_rle(mask) == coco.mask_to_rle_plain(mask)
        if compressed:
            rle = coco.mask_to_compressed_rle(mask)
            assert rle == jcoco.mask_to_compressed_rle(mask)
        got = coco.rle_to_mask(rle)
        assert got.dtype == np.uint8 and got.shape == mask.shape
        np.testing.assert_array_equal(got, jcoco.rle_to_mask(rle))
        np.testing.assert_array_equal(got, coco.rle_to_mask_plain(rle))
        np.testing.assert_array_equal(got, mask)


def test_refuses_malformed_input():
    """A string that ends inside a varint, and runs that overflow or do
    not fill the mask, raise in the C codec as in the numpy one."""
    with pytest.raises(ValueError, match="malformed"):
        rle_decode_counts_native("1o")           # 'o' continues the varint
    for counts in ([1, 2], [3, 3], [-1, 5]):
        rle = {"size": [2, 2], "counts": counts}
        with pytest.raises(ValueError):
            coco.rle_to_mask(rle)
        with pytest.raises(ValueError):
            coco.rle_to_mask_plain(rle)


def test_build_failure_raises_with_the_compiler_error(tmp_path,
                                                      monkeypatch):
    """No Python fallback: a source that does not compile raises with the
    compiler's message, and so does the codec that needs it."""
    bad = tmp_path / "rle.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(rle_native, "SOURCE", bad)
    rle_native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build") as err:
            rle_native.library()
        assert "error" in str(err.value)
        with pytest.raises(RuntimeError, match="failed to build"):
            coco.rle_to_mask({"size": [1, 1], "counts": [0, 1]})
    finally:
        monkeypatch.undo()
        rle_native.library.cache_clear()
    assert coco.rle_to_mask({"size": [1, 1], "counts": [0, 1]})[0, 0] == 1
