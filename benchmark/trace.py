"""Device time from a ``torch.profiler`` trace of a short steady stretch.

``summarize`` is the program's ``tools/parse_trace.py::summarize`` with its
window taken from the benchmark: the device events are those of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the device is busy where
any of them runs (the union of their intervals) and idle in the rest of
the window. ``record`` traces the device alone, so that the host's
tracing does not slow the host and stretch the idle gaps, and takes the
window from the host clock (synchronised at both ends: every device event
of the stretch lies inside it). ``record(host=True)`` traces the host's
operators too, over the benchmark's window annotation, only to name the
gaps: ``idle_gaps`` names each gap by the innermost host event (an
operator or the benchmark's annotation, on any thread) running at its
middle.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.traced_window"


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[Dict], units: int,
              window_s: Optional[float] = None) -> Dict:
    """{"window_s", "busy_s", "kernels": {name: [calls, seconds]} per unit,
    "device_ops", "idle_gaps"}, over ``window_s`` (the host clock's,
    holding every device event of the trace; no gaps named), or else over
    the ``WINDOW`` annotation, with the gaps named. Either spans ``units``
    steps or requests."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    mark = None
    if window_s is None:
        marks = [e for e in complete if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError(f"no {WINDOW} annotation in the trace")
        mark = marks[0]
        w0 = float(mark["ts"])
        w1 = w0 + float(mark["dur"])
        window_s = float(mark["dur"]) * 1e-6
        device = [e for e in device if w0 <= float(e["ts"]) < w1]
    else:
        w1 = float("inf")
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e in device:
        row = by_name[e.get("name", "?")]
        row[0] += 1
        row[1] += float(e.get("dur", 0.0)) * 1e-6
    busy = _union((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = collections.defaultdict(float)
    if mark is not None:
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        mids = [((a + b) / 2, b - a) for a, b in zip(edges[0::2], edges[1::2])
                if b > a]
        # Each host thread's events nest (the autograd engine runs the
        # backward on a thread of its own), so one sweep a thread finds
        # its innermost event at each gap's middle; the gap goes to the
        # innermost of those over the threads.
        threads = collections.defaultdict(list)
        for e in complete:
            if e.get("cat") in HOST_CATEGORIES and e.get("pid") == \
                    mark.get("pid"):
                threads[e.get("tid")].append(e)
        best: List[Optional[Dict]] = [None] * len(mids)
        for events_t in threads.values():
            events_t.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
            stack: List[Dict] = []
            i = 0
            for j, (mid, _) in enumerate(mids):
                while i < len(events_t) and float(events_t[i]["ts"]) <= mid:
                    stack.append(events_t[i])
                    i += 1
                while stack and float(stack[-1]["ts"]) \
                        + float(stack[-1]["dur"]) < mid:
                    stack.pop()
                inner = next((e for e in reversed(stack) if float(e["ts"])
                              + float(e["dur"]) >= mid), None)
                if inner is not None and inner is not mark and (
                        best[j] is None or best[j] is mark
                        or float(inner["dur"]) < float(best[j]["dur"])):
                    best[j] = inner
                elif inner is mark and best[j] is None:
                    best[j] = mark
        for (_, length), e in zip(mids, best):
            gaps[e["name"] if e else "host: none"] += length * 1e-6
    kernels = {k: [v[0] / units, v[1] / units] for k, v in by_name.items()}
    return {"window_s": window_s, "busy_s": busy_s, "units": units,
            "kernels": kernels,
            "device_ops": sorted(([k, v[1]] for k, v in kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v / units] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10]}


def record(fn: Callable[[], None], units: int, path: str, device,
           host: bool = False) -> Dict:
    """Run ``fn`` (``units`` steps or requests) under the profiler,
    synchronised at both ends: the device's activity alone, or with
    ``host`` the host's too, inside the ``WINDOW`` annotation. The chrome
    trace goes to ``path`` and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return summarize(events, units, None if host or not cuda else window_s)


def kernel_time(summary: Dict, names) -> Tuple[float, float]:
    """(calls, seconds) per unit of the kernels whose name holds any of
    ``names``."""
    calls = secs = 0.0
    for k, (c, s) in summary["kernels"].items():
        if any(n in k for n in names):
            calls += c
            secs += s
    return calls, secs
