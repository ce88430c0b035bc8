"""The readings that set the limits of ``correct``: a cell's numbers on
many seeds, for the program as the cell runs it and for the control (the
program's own lower-precision path, ``compute_dtype="bfloat16"``, where
the configuration states f32), in one process.

    python3 -m benchmark.control --workload NAME --seeds 11 12 13 \\
        [--seconds 2] [--control-seeds 11 12 13] [--exact-seeds 14]
    python3 -m benchmark.control --workload NAME --seeds 11 12 13 \\
        --fault half_batch

Prints one JSON line a run: the side, the seed, every number (compared
or not) and where each was worst. ``--exact-seeds`` runs the program with
TF32 off as well (how much of a number TF32 makes); ``--fault`` reads a
planted fault (``benchmark/faults.py``) instead. A short window is
enough: the numbers come from set-up's steps (training) or from the
requests sampled in the window (serving).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import check
from benchmark.faults import FAULTS
from benchmark.run import execute
from benchmark.spec import find_cell

CONTROL = {"compute_dtype": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default=json.dumps(CONTROL),
                   help="the control's configuration fields, as JSON (a "
                        "cell that remats takes remat_backbone true too: "
                        "bf16 halves the input's bytes, so 'auto' would "
                        "not remat it)")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant this fault and read it on --seeds alone")
    p.add_argument("--exact-seeds", type=int, nargs="*", default=[],
                   help="also run the program with TF32 off on these seeds "
                        "(the look at what TF32 alone contributes)")
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    control_seeds = (args.seeds[:3] if args.control_seeds is None
                     else args.control_seeds)
    if args.fault:
        with FAULTS[args.fault]():
            for seed in args.seeds:
                report(cell, args.fault, seed, args.seconds, None)
        return 0
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, json.loads(args.control)) for s in control_seeds]
    runs += [("program_tf32_off", s, None) for s in args.exact_seeds]
    for side, seed, overrides in runs:
        if side == "program_tf32_off":
            with check.exact_f32():
                report(cell, side, seed, args.seconds, None)
        else:
            report(cell, side, seed, args.seconds, overrides)
    return 0


def report(cell, side, seed, seconds, overrides):
    t0 = time.perf_counter()
    r = execute(cell, seed, seconds, False, "cuda", t0, overrides)
    print(json.dumps({"side": side, "seed": seed, "correct": r["correct"],
                      "numbers": r["extra"]["numbers"],
                      "where": r["extra"].get("where"),
                      "diag": r["extra"].get("diag"),
                      "losses": r["extra"].get("losses"),
                      "run_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
