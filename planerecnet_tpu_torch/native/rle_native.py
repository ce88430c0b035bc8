"""ctypes binding of the C RLE codec (``rle.c``).

Counterpart of ``planerecnet_tpu/native/rle_native.py``. The library is
built with the system C compiler (``cc``, else ``gcc``) at first use into
``planerecnet_tpu_torch/_build/librle_<hash>.so``, keyed by a hash of the
source and the flags as ``ops/cuda_build.py`` keys its libraries, and never
written next to the source. Where no compiler builds it, ``library``
raises with the compiler's error: nothing falls back to Python. The numpy
codec in ``data/coco.py`` (``rle_to_mask_plain``, ``mask_to_rle_plain``) is
the plain version the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import numpy as np

from planerecnet_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "rle.c"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
_LL = ctypes.POINTER(ctypes.c_longlong)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librle_{digest[:16]}.so"


def build() -> Path:
    """The built library's path, compiled now if it is not built yet."""
    lib = _target()
    if lib.exists():
        return lib
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc or gcc) on PATH to build "
                           f"{SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed to build {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded codec, built at first use."""
    lib = ctypes.CDLL(str(build()))
    lib.rle_decode_counts.restype = ctypes.c_longlong
    lib.rle_decode_counts.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                      _LL, ctypes.c_longlong]
    lib.rle_fill.restype = ctypes.c_int
    lib.rle_fill.argtypes = [_LL, ctypes.c_longlong, _U8, ctypes.c_longlong]
    lib.rle_encode_mask.restype = ctypes.c_longlong
    lib.rle_encode_mask.argtypes = [_U8, ctypes.c_longlong, _LL,
                                    ctypes.c_longlong]
    return lib


def rle_decode_counts_native(s) -> np.ndarray:
    """The int64 runs of a COCO compressed counts string (str or bytes)."""
    raw = s.encode("ascii") if isinstance(s, str) else bytes(s)
    cap = len(raw) + 1          # each run takes at least one character
    out = np.empty(cap, dtype=np.int64)
    m = library().rle_decode_counts(raw, len(raw), out.ctypes.data_as(_LL),
                                    cap)
    if m < 0:
        raise ValueError(f"malformed RLE counts string (code {m})")
    return out[:m]


def rle_fill_native(counts, h: int, w: int) -> np.ndarray:
    """Column-major runs -> an (H, W) uint8 mask; raises unless the runs
    fill the mask exactly."""
    c = np.ascontiguousarray(counts, dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    rc = library().rle_fill(c.ctypes.data_as(_LL), c.size,
                            flat.ctypes.data_as(_U8), h * w)
    if rc != 0:
        raise ValueError(f"RLE counts sum to {int(c.sum())}, not "
                         f"{h} x {w}")
    return flat.reshape(w, h).T


def rle_encode_mask_native(mask: np.ndarray) -> List[int]:
    """An (H, W) binary mask -> its column-major runs, starting with a
    run of zeros (of length 0 where the mask's first pixel is set)."""
    flat = np.ascontiguousarray((np.asarray(mask) != 0).T.reshape(-1),
                                dtype=np.uint8)
    cap = flat.size + 1         # at most one run a pixel, and the leading 0
    out = np.empty(cap, dtype=np.int64)
    m = library().rle_encode_mask(flat.ctypes.data_as(_U8), flat.size,
                                  out.ctypes.data_as(_LL), cap)
    if m < 0:
        raise ValueError("RLE encode capacity overflow")
    return out[:m].tolist()
