"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone, for
sm_90a, into ``_build/<name>_<hash>.so``, keyed by a hash of the source and
the flags: a second call finds the library and returns at once. ``build``
starts one ``nvcc`` per source that is not built yet, all together, and
waits for them; ``library`` builds one source at its first use and loads
it. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("dcn_im2col", "dcn_scatter", "dice_lava")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          fresh: Iterable[str] = ()) -> Dict[str, dict]:
    """Compile the named sources that are not built yet, and those named in
    ``fresh`` in any case, in parallel. Returns {name: {"path", "seconds",
    "log"}}; ``log`` holds ptxas's register and spill report of a fresh
    build, ``seconds`` 0.0 for a library found built."""
    out, running = {}, {}
    for name in names:
        lib = _target(name)
        if lib.exists() and name not in fresh:
            out[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(build([name])[name]["path"])


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a cudaError other than 0."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
