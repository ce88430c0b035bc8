"""Local N-rank launcher for the port's train CLI.

Counterpart of ``tools/run_multihost.py``: starts ``--nproc`` processes,
each ``python -m planerecnet_tpu_torch.train --multihost`` (or another
module, ``launch(module=...)``) with its own
rank, joined through a TCP store on a free localhost port
(``parallel/spmd.py::initialize_distributed`` reads the ``PRN_*``
variables set here). Each rank writes its own log; if one fails, the
others are stopped, and the launch raises with the exit code of the
first rank to fail. The train CLI starts its ranks through ``launch``
where ``--n_devices`` asks for more than one card.

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
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
# Seconds the ranks get to exit after a ctrl-C is passed on to them.
INTERRUPT_GRACE_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, timeout: Optional[float]) -> Optional[int]:
    """The exit code of the first of ``procs`` to fail, None where none
    did; the others are killed as soon as one fails (they would wait for
    it in their next collective) or at ``timeout``. A ctrl-C here is
    passed on to the running ranks (the train CLI's ranks then write
    their interrupt checkpoint), which get ``INTERRUPT_GRACE_S`` seconds
    to exit before they are killed and it is raised again."""
    deadline = None if timeout is None else time.monotonic() + timeout
    first = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                first = failed[0]
                break
            if all(c is not None for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("run_multihost", timeout)
            time.sleep(0.2)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        end = time.monotonic() + INTERRUPT_GRACE_S
        while time.monotonic() < end and any(p.poll() is None
                                             for p in procs):
            time.sleep(0.2)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return first


def launch(nproc: int, train_args: List[str], platform: str = "cuda",
           backend: Optional[str] = None, log_dir: Optional[str] = None,
           timeout: Optional[float] = None,
           extra_env: Optional[dict] = None,
           module: str = "planerecnet_tpu_torch.train --multihost",
           stream_rank0: bool = False) -> List[Optional[str]]:
    """Run the N-rank job; returns the per-rank log paths. Each rank runs
    ``python -m`` ``module`` (the train CLI by default; the words after
    the module's name come first among its arguments) with
    ``train_args``. ``extra_env``
    is added to each rank's environment (the repository root goes in front
    of its ``PYTHONPATH``). With ``stream_rank0`` rank 0 writes to this
    process's output and has no log (None). Raises
    ``CalledProcessError`` with the exit code of the first rank to fail
    and ``TimeoutExpired`` at ``timeout`` seconds, having stopped every
    rank and printed the end of each rank's log (with ``stream_rank0``,
    of each failed rank's)."""
    port = _free_port()
    log_dir = log_dir or tempfile.mkdtemp(prefix="prn_multihost_")
    os.makedirs(log_dir, exist_ok=True)
    procs, logs, files = [], [], []
    first = None
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
            logs.append(None if stream_rank0 and rank == 0 else
                        osp.join(log_dir, f"worker{rank}.log"))
            out = None if logs[-1] is None else open(logs[-1], "w")
            files += [out] if out else []
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", *module.split()]
                + list(train_args),
                env=env, stdout=out,
                stderr=None if out is None else subprocess.STDOUT))
        first = _wait(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if log is None or (stream_rank0 and p.returncode == 0):
                continue
            print(f"--- worker {rank} (exit {p.returncode}) {log} ---")
            with open(log) as f:
                sys.stdout.writelines(f"[p{rank}] {line}"
                                      for line in f.readlines()[-12:])
    if first is not None:
        raise subprocess.CalledProcessError(first, module)
    return logs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="Default: NCCL on cuda, gloo on the CPU.")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("--module", default="planerecnet_tpu_torch.train "
                   "--multihost", help="what each rank runs with python -m")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments after '--' go to the module")
    args = p.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    launch(args.nproc, train_args, platform=args.platform,
           backend=args.backend, log_dir=args.log_dir, timeout=args.timeout,
           module=args.module)
    print("all workers completed")


if __name__ == "__main__":
    main()
