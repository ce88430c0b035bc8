"""Local N-rank launcher for the port's train CLI.

Counterpart of ``tools/run_multihost.py``: starts ``--nproc`` processes,
each ``python -m planerecnet_tpu_torch.train --multihost`` with its own
rank, joined through a TCP store on a free localhost port
(``parallel/spmd.py::initialize_distributed`` reads the ``PRN_*``
variables set here). Each rank writes its own log; if one fails, the
others are stopped, and the launch raises.

On a host with several cards each rank takes one (NCCL). ``--platform
cpu`` runs the ranks on the CPU over gloo; ``--backend gloo`` runs several
ranks on one card, which NCCL refuses (a check of the data-parallel path,
not a way to train faster).

Usage:
  python -m planerecnet_tpu_torch.tools.run_multihost --nproc 2 -- \\
      --config PlaneRecNet_50_config --batch_size 16 ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, timeout: Optional[float]) -> List[int]:
    """Exit codes of ``procs``; the others are killed as soon as one fails
    (they would wait for it in their next collective) or at ``timeout``."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or \
                    any(c not in (None, 0) for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("run_multihost", timeout)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def launch(nproc: int, train_args: List[str], platform: str = "cuda",
           backend: Optional[str] = None, log_dir: Optional[str] = None,
           timeout: Optional[float] = None,
           extra_env: Optional[dict] = None) -> List[str]:
    """Run the N-rank job; returns the per-rank log paths. ``extra_env``
    is added to each rank's environment (the repository root goes in front
    of its ``PYTHONPATH``). Raises ``CalledProcessError`` when a rank fails
    and ``TimeoutExpired`` at ``timeout`` seconds, having stopped every
    rank and printed the end of each rank's log."""
    port = _free_port()
    log_dir = log_dir or tempfile.mkdtemp(prefix="prn_multihost_")
    os.makedirs(log_dir, exist_ok=True)
    procs, logs, files = [], [], []
    try:
        for rank in range(nproc):
            env = dict(os.environ, **(extra_env or {}))
            env["PYTHONPATH"] = os.pathsep.join(
                [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
            env["PRN_COORDINATOR_ADDRESS"] = f"localhost:{port}"
            env["PRN_NUM_PROCESSES"] = str(nproc)
            env["PRN_PROCESS_ID"] = str(rank)
            if platform == "cpu":
                env["PRN_PLATFORM"] = "cpu"
            if backend:
                env["PRN_BACKEND"] = backend
            logs.append(osp.join(log_dir, f"worker{rank}.log"))
            files.append(open(logs[-1], "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "planerecnet_tpu_torch.train",
                 "--multihost"] + list(train_args),
                env=env, stdout=files[-1], stderr=subprocess.STDOUT))
        codes = _wait(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            print(f"--- worker {rank} (exit {p.returncode}) {log} ---")
            with open(log) as f:
                sys.stdout.writelines(f"[p{rank}] {line}"
                                      for line in f.readlines()[-12:])
    bad = [c for c in codes if c != 0]
    if bad:
        raise subprocess.CalledProcessError(
            bad[0], "planerecnet_tpu_torch.train --multihost")
    return logs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="Default: NCCL on cuda, gloo on the CPU.")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments after '--' go to the train CLI")
    args = p.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    launch(args.nproc, train_args, platform=args.platform,
           backend=args.backend, log_dir=args.log_dir, timeout=args.timeout)
    print("all workers completed")


if __name__ == "__main__":
    main()
