"""Device time by kernel from a ``torch.profiler`` chrome trace.

    python -m planerecnet_tpu_torch.tools.parse_trace TRACE [--top 30]
        [--runs 1]

Counterpart of ``tools/parse_trace.py``, which sums the ops of the device
timeline of a ``jax.profiler`` trace. TRACE is a trace file that
``torch.profiler``'s ``export_chrome_trace`` wrote (``.json`` or
``.json.gz``), or a directory, whose newest such file is read (not the
``*_kernels.json`` tables that ``record`` writes beside it). The device
events are those of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``: their time is summed by name, and printed for the top N
with their calls, ms and share of the device's time, per run where the
trace holds ``--runs`` runs of the same work. The device is busy where
any of them runs (the union of their intervals) and idle in the rest of
the traced window, which spans every complete event of the trace, host
and device. The file is read as it is: no device is touched.

``record`` runs a function under ``torch.profiler`` and writes the trace
and its table; ``chip_smoke.py``, ``profile_inference`` and
``profile_train`` profile through it.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> List[Dict]:
    """The trace events of a chrome trace file, or of the newest one in a
    directory."""
    if os.path.isdir(path):
        files = [f for pattern in ("*.json", "*.json.gz")
                 for f in glob.glob(os.path.join(path, "**", pattern),
                                    recursive=True)
                 if not f.endswith("_kernels.json")]
        if not files:
            raise FileNotFoundError(f"no chrome trace under {path}")
        path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize(events: List[Dict], runs: int = 1) -> Dict:
    """The device time of ``events`` by name: {"window_ms", "busy_ms",
    "idle_share", "device_ms", "kernels": [{"kernel", "calls", "ms",
    "share"}, ...]}, the times and calls per run, the kernels by
    descending time, share of ``device_ms`` (their sum)."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e in device:
        row = by_name[e.get("name", "?")]
        row[0] += 1
        row[1] += float(e.get("dur", 0.0))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in complete]
    window_us = (max(b for _, b in spans) - min(a for a, _ in spans)
                 if spans else 0.0)
    busy_us = _union_us((float(e["ts"]), float(e["ts"])
                         + float(e.get("dur", 0.0))) for e in device)
    device_us = sum(us for _, us in by_name.values())
    kernels = [{"kernel": name, "calls": calls / runs,
                "ms": us / 1e3 / runs,
                "share": us / device_us if device_us else 0.0}
               for name, (calls, us) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][1])]
    return {"window_ms": window_us / 1e3 / runs,
            "busy_ms": busy_us / 1e3 / runs,
            "idle_share": 1.0 - busy_us / window_us if window_us else 0.0,
            "device_ms": device_us / 1e3 / runs, "runs": runs,
            "kernels": kernels}


def calls_of(summary: Dict, name: str) -> float:
    """Calls per run of every kernel whose name holds ``name``."""
    return sum(k["calls"] for k in summary["kernels"] if name in k["kernel"])


def lines(summary: Dict, top: int = 30) -> List[str]:
    """The summary as text: the window line, then the top kernels."""
    out = [f"window {summary['window_ms']:.3f} ms, device busy "
           f"{summary['busy_ms']:.3f} ms, idle share "
           f"{summary['idle_share']:.3f} (per run, {summary['runs']} "
           f"run(s))"]
    for k in summary["kernels"][:top]:
        out.append(f"{k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<6g} "
                   f"{k['kernel'][:100]}")
    return out


def record(fn: Callable[[], object], runs: int, out_dir: str, stem: str,
           device) -> Dict:
    """Run ``fn()`` ``runs`` times under ``torch.profiler`` (CPU and, on a
    CUDA ``device``, CUDA activity), write the chrome trace to
    ``out_dir/profile_{stem}.json`` and the summary with the host-clocked
    wall time (``wall_ms``, per run) to ``profile_{stem}_kernels.json``;
    returns the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from planerecnet_tpu_torch.utils.timer import sync

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    trace = os.path.join(out_dir, f"profile_{stem}.json")
    prof.export_chrome_trace(trace)
    summary = dict(summarize(load(trace), runs), wall_ms=wall_ms,
                   trace=trace)
    with open(os.path.join(out_dir, f"profile_{stem}_kernels.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="a chrome trace file, or a directory "
                                 "holding one")
    p.add_argument("--top", default=30, type=int)
    p.add_argument("--runs", default=1, type=int,
                   help="runs of the same work the trace holds; times and "
                        "calls are given per run")
    args = p.parse_args(argv)
    summary = summarize(load(args.trace), args.runs)
    print("\n".join(lines(summary, args.top)))
    return summary


if __name__ == "__main__":
    main()
