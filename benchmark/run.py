"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration, its traffic and
its per-layer readers are found by name (``benchmark/spec.py``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; then ``checks``, each number that decided ``correct``
beside its limit, which also close standard error.

It exits non-zero and prints no result when there is no card, fewer cards
than the cell asks for, or when, after the window, the process holds a
module of JAX or of the JAX package (by whole top-level name).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "planerecnet_tpu")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``planerecnet_tpu_torch`` is not ``planerecnet_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "unknown", "power_limit": "unknown"}


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float, overrides=None) -> dict:
    """Run ``cell`` and build its result object (without ``device``'s
    card fields); ``overrides`` replace fields of the program's
    configuration (the control's lower precision)."""
    import importlib

    from benchmark import check

    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    out_dir = HERE / "_out"
    out_dir.mkdir(exist_ok=True)
    r = kind.run(cell, seed, seconds, trace, device, t0, overrides, out_dir)
    ok, table = check.verdict(r["numbers"], cell.limits)
    if trace:
        ctx = r["ctx"]
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": r["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": bool(ok and r["failed"] == 0),
              "attempted": r["attempted"], "failed": r["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if str(device).startswith("cuda")
                         else "cpu", "count": cell.chips,
                         "memory_peak_bytes": r["memory_peak_bytes"]}}
    if trace:
        s = r["ctx"]["trace"]
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["extra"] = {k: r[k] for k in (
        "setup_s", "window_s", "remat", "steps", "requests",
        "serve_img_per_s", "checked", "numbers", "where", "losses", "diag",
        "host") if k in r}
    result["checks"] = table
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(HERE / "_cache" / sub))

    from benchmark.spec import find_cell
    import torch

    cell = find_cell(args.workload)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{visible} visible", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    info = card()
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["card"] = info
    result["checks"] = result.pop("checks")
    print(f"card: {info['name']}, power limit {info['power_limit']}",
          file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
