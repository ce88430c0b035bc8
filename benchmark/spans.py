"""The program's spans, read: each step's or request's work put down to the
layer of the program that did it.

The program marks its layers with spans (``planerecnet_tpu_torch/utils/
timer.py``; their sites and readers are listed in PERF.md section 3).
``train`` and ``serve`` take the train state or the runner, the ring and
the next index into it, and run two passes with the program's tracing on,
meant to follow a traced run's own passes:

* the host pass: ``span_steps`` / ``span_requests`` units with no
  profiler, which give each span's host milliseconds from its records;
* the device pass: ``trace_steps`` / ``trace_requests`` units under
  ``torch.profiler`` with CPU and CUDA activity, in which each span is a
  ``user_annotation`` on the kernels' clock. ``attribute`` puts each
  device event (``kernel``, ``gpu_memcpy``, ``gpu_memset``) down to the
  innermost span holding the runtime or driver call that launched it
  (the event of the same ``correlation`` id), on the call's thread,
  else on the root's (the backward launches from the autograd engine's
  thread, whose own spans are the recomputes); each
  idle gap of the device inside the units to the innermost span running
  at the gap's middle; and counts the launch, copy, memset and graph
  launch calls inside each root span. What no span holds is "outside".

They return the by-span table: per unit, for each span name, its host ms
and self host ms, its profiled wall ms, device ms (its own and its
descendants'), self device ms, idle ms (its own and its descendants')
and self idle ms, and its paced idle ms; and print it to standard error.
``readings`` names the per-layer quantities the table gives.

The profiler slows the host (1.5-2.2x on a host-bound H100 cell), so the
profiled idle ms measure the profiler as much as the program. The paced
idle ms tie a span's idle time to the host pass's pace. Of a span's own
time (less its children's) they take the lesser of two: the host ms
less the device's busy time inside it in the profiled pass (wall less
idle), where the profiler lengthened the span; and the profiled idle ms,
where the host pass waited longer in it on a busy device. A span's
paced idle ms hold its descendants'. That assumes the device does the
same work while the host is in a span in both passes.

    python3 -m benchmark.spans --workload CELL --seed N

sets up a cell as its traffic's driver does (nothing of the yardstick),
times units with the spans off and on in turns (the profiler off), runs
the two passes and prints one JSON line: the table, its coverage, the
cost and the readings. It is a stand-in until the traffic drivers call
``train`` and ``serve``; it goes then, with ``_cost``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

from benchmark.trace import DEVICE_CATEGORIES, _union

CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
OUTSIDE = "outside"
ROOTS = {"train": "trainer.step", "serve": "runner.request"}
COST_UNITS = 10         # units a block of ``_cost``'s timing
COST_ROUNDS = 3         # rounds of an off and an on block


def _holder(spans: List[Dict], among: Iterable[int]
            ) -> Callable[[float], Optional[int]]:
    """t -> the index of the innermost (shortest) span of ``among`` (indices
    into ``spans``) holding t, or None: by elementary intervals between
    the spans' edges."""
    among = list(among)
    edges = sorted({x for i in among for x in (spans[i]["t0"],
                                               spans[i]["t1"])})
    inner: List[Optional[int]] = []
    for a, b in zip(edges, edges[1:]):
        best = None
        for i in among:
            s = spans[i]
            if s["t0"] <= a and b <= s["t1"] and (
                    best is None or s["t1"] - s["t0"]
                    <= spans[best]["t1"] - spans[best]["t0"]):
                best = i
        inner.append(best)

    def find(t: float) -> Optional[int]:
        k = bisect.bisect_right(edges, t) - 1
        return inner[k] if 0 <= k < len(inner) else None
    return find


def attribute(events: List[Dict], names: Iterable[str]) -> Dict:
    """The device pass's chrome trace ``events`` put down to the program's
    spans (``user_annotation`` events named in ``names``), per unit (root
    span): {"units", "spans": {name: {"parent", "wall_ms", "device_ms",
    "self_device_ms", "idle_ms", "self_idle_ms"}}, "outside": {"device_ms",
    "idle_ms"}, "device_ms", "idle_ms", "launch_calls", "unmatched"}.

    A span's parent is the innermost span holding it on its own thread,
    else on any other (the autograd engine's spans nest under the root
    thread's). A device event goes to the innermost span holding its
    launching call on the call's thread, else on a thread that holds a
    root. Both assume one root open at a time, as the program's spans
    do."""
    names = set(names)
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    spans = sorted(({"name": e["name"], "tid": e.get("tid"),
                     "t0": float(e["ts"]),
                     "t1": float(e["ts"]) + float(e.get("dur", 0.0))}
                    for e in complete if e.get("cat") == "user_annotation"
                    and e.get("name") in names),
                   key=lambda s: (s["t0"], -s["t1"]))
    for i, s in enumerate(spans):
        held = [j for j in range(i) if spans[j]["t0"] <= s["t0"]
                and s["t1"] <= spans[j]["t1"]]
        mine = [j for j in held if spans[j]["tid"] == s["tid"]]
        s["parent"] = min(mine or held, key=lambda j: (
            spans[j]["t1"] - spans[j]["t0"], -j)) if held else None
        s["device"] = s["idle"] = 0.0
    roots = [s for s in spans if s["parent"] is None]
    units = len(roots)
    if not units:
        raise ValueError("no program span in the trace: was the program's "
                         "tracing on?")
    w0, w1 = roots[0]["t0"], max(s["t1"] for s in roots)
    find = _holder(spans, range(len(spans)))
    by_tid = collections.defaultdict(list)
    for i, s in enumerate(spans):
        by_tid[s["tid"]].append(i)
    on_thread = {tid: _holder(spans, ids) for tid, ids in by_tid.items()}
    root_tids = {r["tid"] for r in roots}
    on_roots = _holder(spans, [i for i, s in enumerate(spans)
                               if s["tid"] in root_tids])

    def launcher(call: Dict, at: float) -> Optional[int]:
        own = on_thread.get(call.get("tid"))
        held = own(at) if own is not None else None
        return on_roots(at) if held is None else held
    calls = {e["args"]["correlation"]: e for e in complete
             if e.get("cat") in CALL_CATEGORIES
             and "correlation" in e.get("args", {})}
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    out_device = out_idle = 0.0
    unmatched = 0
    for e in device:
        call = calls.get(e.get("args", {}).get("correlation"))
        at = float(e["ts"]) if call is None else (
            float(call["ts"]) + float(call.get("dur", 0.0)) / 2)
        if not w0 <= at <= w1:
            continue
        unmatched += call is None
        owner = None if call is None else launcher(call, at)
        if owner is None:
            out_device += float(e.get("dur", 0.0))
        else:
            spans[owner]["device"] += float(e.get("dur", 0.0))
    busy = _union((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))
                  for e in device if float(e["ts"]) < w1
                  and float(e["ts"]) + float(e.get("dur", 0.0)) > w0)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    total_idle = 0.0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        total_idle += b - a
        owner = find((a + b) / 2)
        if owner is None:
            out_idle += b - a
        else:
            spans[owner]["idle"] += b - a
    launches = sum(1 for e in complete if e.get("cat") in CALL_CATEGORIES
                   and any(w in e.get("name", "") for w in LAUNCH_WORDS)
                   and any(r["t0"] <= float(e["ts"]) <= r["t1"]
                           for r in roots))
    # Inclusive sums: each span's own time added to every ancestor's.
    total = collections.defaultdict(lambda: [0.0, 0.0])
    for i in range(len(spans)):
        own = (spans[i]["device"], spans[i]["idle"])
        j = i
        while j is not None:
            total[j][0] += own[0]
            total[j][1] += own[1]
            j = spans[j]["parent"]
    table: Dict[str, Dict] = {}
    ms = 1e-3 / units                     # trace microseconds -> ms a unit
    for i, s in enumerate(spans):
        row = table.setdefault(s["name"], {
            "parent": None if s["parent"] is None
            else spans[s["parent"]]["name"], "wall_ms": 0.0,
            "device_ms": 0.0, "self_device_ms": 0.0, "idle_ms": 0.0,
            "self_idle_ms": 0.0})
        row["wall_ms"] += (s["t1"] - s["t0"]) * ms
        row["device_ms"] += total[i][0] * ms
        row["self_device_ms"] += s["device"] * ms
        row["idle_ms"] += total[i][1] * ms
        row["self_idle_ms"] += s["idle"] * ms
    device_ms = (out_device + sum(s["device"] for s in spans)) * ms
    return {"units": units, "spans": table,
            "outside": {"device_ms": out_device * ms,
                        "idle_ms": out_idle * ms},
            "device_ms": device_ms, "idle_ms": total_idle * ms,
            "launch_calls": launches / units, "unmatched": unmatched}


def host_ms(records) -> Dict[str, Dict[str, float]]:
    """Each span name's host ms and self host ms (less its children's) a
    unit (root span), from the program's records."""
    from planerecnet_tpu_torch.utils.timer import self_ns

    ms = 1e-6 / max(1, sum(1 for r in records if r.parent is None))
    out: Dict[str, Dict[str, float]] = {}
    for r, own in zip(records, self_ns(records)):
        row = out.setdefault(r.name, {"host_ms": 0.0, "self_host_ms": 0.0})
        row["host_ms"] += (r.end_ns - r.start_ns) * ms
        row["self_host_ms"] += own * ms
    return out


def merge(table: Dict, host: Dict[str, Dict[str, float]]) -> Dict:
    """``table`` with each span's host ms and self host ms from ``host``
    (``host_ms``'s), and its paced idle ms: of its own (less its
    children's) time, the lesser of the profiled idle ms and the host
    ms less the device's busy time (wall less idle), at least 0; with
    its descendants'."""
    rows = table["spans"]
    for name, row in rows.items():
        row.update(host.get(name, {"host_ms": 0.0, "self_host_ms": 0.0}))
        wall = row["wall_ms"] - sum(r["wall_ms"] for r in rows.values()
                                    if r["parent"] == name)
        busy = max(0.0, wall - row["self_idle_ms"])
        row["paced_idle_ms"] = min(row["self_idle_ms"], max(
            0.0, row["self_host_ms"] - busy))
    for name in rows:                   # add each one's to its ancestors'
        own, up = rows[name]["paced_idle_ms"], rows[name]["parent"]
        while up is not None:
            rows[up]["paced_idle_ms"] += own
            up = rows[up]["parent"]
    return table


def coverage(table: Dict, root: str) -> Dict[str, float]:
    """The shares the acceptance asks of a traced run: the root's device
    time under its children, and the units' idle time under a span."""
    row = table["spans"][root]
    return {"root_children_device": 1.0 - row["self_device_ms"]
            / row["device_ms"] if row["device_ms"] else float("nan"),
            "idle_in_spans": 1.0 - table["outside"]["idle_ms"]
            / table["idle_ms"] if table["idle_ms"] else float("nan")}


def _profile(fn: Callable[[], None], path: str, device) -> List[Dict]:
    """The chrome trace's events of ``fn`` under the profiler (CPU and
    CUDA activity), synchronised at both ends; the file is deleted once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def passes(unit: Callable[[int], None], n_host: int, n_device: int,
           path: str, device) -> Dict:
    """The host pass (units 0 .. n_host - 1) and the device pass (the
    next n_device) of ``unit(i)`` with the program's tracing on; the
    by-span table, also printed to standard error."""
    import torch
    from planerecnet_tpu_torch.utils import timer

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    was = timer.tracing(True)
    try:
        timer.collect()
        sync()
        for i in range(n_host):
            unit(i)
        sync()
        host = host_ms(timer.collect())
        events = _profile(lambda: [unit(n_host + i) for i in range(n_device)],
                          path, device)
        names = {r.name for r in timer.collect()}
    finally:
        timer.tracing(was)
    table = merge(attribute(events, names), host)
    print(format_table(table), file=sys.stderr)
    return table


def train(state, ring, nxt: int, traffic: Dict, device, out_dir) -> Dict:
    """``passes`` over ``trainer.train_step`` from ``ring[nxt]`` on."""
    from planerecnet_tpu_torch import trainer

    return passes(lambda i: trainer.train_step(
        state, ring[(nxt + i) % len(ring)]), traffic["span_steps"],
        traffic["trace_steps"], str(out_dir / "spans.json"), device)


def serve(runner, ring, nxt: int, traffic: Dict, device, out_dir) -> Dict:
    """``passes`` over ``PlaneRecNetRunner.infer`` from ``ring[nxt]`` on,
    each request synchronised as the window's are."""
    import torch

    def request(i):
        runner.infer(ring[(nxt + i) % len(ring)])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    return passes(request, traffic["span_requests"],
                  traffic["trace_requests"], str(out_dir / "spans.json"),
                  device)


def format_table(table: Dict) -> str:
    rows = [f"{'span':<22} {'parent':<20} {'host':>9} {'self host':>9} "
            f"{'wall':>9} {'device':>9} {'self dev':>9} {'idle':>9} "
            f"{'self idle':>9} {'paced':>9}  "
            f"(ms a unit, {table['units']} units)"]
    for name, r in table["spans"].items():
        rows.append(f"{name:<22} {r['parent'] or '-':<20} "
                    f"{r.get('host_ms', 0.0):9.3f} "
                    f"{r.get('self_host_ms', 0.0):9.3f} "
                    f"{r['wall_ms']:9.3f} "
                    f"{r['device_ms']:9.3f} {r['self_device_ms']:9.3f} "
                    f"{r['idle_ms']:9.3f} {r['self_idle_ms']:9.3f} "
                    f"{r.get('paced_idle_ms', 0.0):9.3f}")
    o = table["outside"]
    rows.append(f"{OUTSIDE:<22} {'-':<20} {'':>9} {'':>9} {'':>9} "
                f"{o['device_ms']:9.3f} {o['device_ms']:9.3f} "
                f"{o['idle_ms']:9.3f} {o['idle_ms']:9.3f}")
    rows.append(f"device {table['device_ms']:.3f} ms, idle "
                f"{table['idle_ms']:.3f} ms, launch calls "
                f"{table['launch_calls']:.1f} a unit; device events with "
                f"no launching call: {table['unmatched']}")
    return "\n".join(rows)


def readings(table: Dict, kind: str, suffix: str) -> Dict[str, float]:
    """The per-layer quantities the table gives a cell of ``kind``
    (``train`` or ``serve``), named with the cell's ``suffix``."""
    s = table["spans"]

    def get(name, column):
        return s[name].get(column) if name in s else None

    if kind == "serve":
        out = {"upload_host_ms": get("runner.upload", "host_ms"),
               "forward_device_ms": get("runner.forward", "device_ms"),
               "forward_host_ms": get("runner.forward", "host_ms"),
               "forward_idle_ms": get("runner.forward", "paced_idle_ms"),
               "postprocess_host_ms": get("runner.postprocess", "host_ms")}
    else:
        out = {"upload_host_ms": get("trainer.upload", "host_ms"),
               "forward_device_ms": get("trainer.forward", "device_ms"),
               "loss_device_ms": get("trainer.loss", "device_ms"),
               "backward_device_ms": get("trainer.backward",
                                         "self_device_ms"),
               "optimizer_device_ms": get("trainer.apply_grads",
                                          "device_ms"),
               "finite_wait_ms": get("trainer.finite_read", "host_ms"),
               "apply_grads_idle_ms": get("trainer.apply_grads",
                                          "paced_idle_ms")}
        if suffix == "remat":
            out["recompute_device_ms"] = get("backbone.recompute",
                                             "device_ms")
    out["launch_calls"] = table["launch_calls"]
    return {f"{k}.{suffix}": v for k, v in out.items()}


def _cost(unit: Callable[[int], None], n: int, rounds: int, sync) -> Dict:
    """ms a unit with the spans off and on, in turns (off first in even
    rounds), the profiler off; and the spans a unit."""
    from planerecnet_tpu_torch.utils import timer

    times = {"off": [], "on": []}
    spans = 0
    i = 0
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            timer.tracing(on)
            sync()
            t = time.perf_counter()
            for _ in range(n):
                unit(i)
                i += 1
            sync()
            times["on" if on else "off"].append(
                (time.perf_counter() - t) * 1e3 / n)
            timer.tracing(False)
            spans = max(spans, len(timer.collect()))
    # One span's own cost, on and off, on this host: 20 blocks of 1000,
    # collected after each as a unit's are.
    each = {"off": 0.0, "on": 0.0}
    for on in (False, True) * 20:
        timer.tracing(on)
        t = time.perf_counter_ns()
        for _ in range(1000):
            with timer.span("cost"):
                pass
        each["on" if on else "off"] += (time.perf_counter_ns() - t) / 20e6
        timer.tracing(False)
        timer.collect()
    return {"unit_ms": times, "spans_a_unit": spans / n, "span_us": each,
            "next": i}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    import torch
    from pathlib import Path

    from benchmark import scenes
    from benchmark.run import card
    from benchmark.spec import find_cell
    from benchmark.weights import make_weights
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides)

    cell = find_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.spans: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    out_dir = Path(__file__).resolve().parent / "_out"
    out_dir.mkdir(exist_ok=True)
    tr, cfg = cell.traffic, cell.config["config"]
    h, w = tr["height"], tr["width"]
    pcfg = apply_overrides(PlaneRecNetConfig(), cfg)

    def sync():
        torch.cuda.synchronize(device)

    pool = scenes.render_pool(args.seed, tr["pool"], h, w)
    if tr["kind"] == "train":
        from planerecnet_tpu_torch import trainer

        b = tr["batch"]
        rows = scenes.make_rows(pool, b * tr["ring_batches"], args.seed)
        ring = [scenes.collate(rows[i * b:(i + 1) * b], cfg["max_instances"],
                               cfg["dataset"]["depth_resolution"])
                for i in range(tr["ring_batches"])]
        state = trainer.create_train_state(pcfg, seed=args.seed,
                                           device=device)
        state.model.load_state_dict(make_weights(
            cfg, cell.config["weights"], args.seed, device, False))

        def unit(i):
            trainer.train_step(state, ring[i % len(ring)])

        for i in range(tr["check_steps"]):
            unit(i)
        target, first = state, tr["check_steps"]
        suffix = "remat" if tr.get("rate_metric", "").endswith(
            ".remat") else "train"
    else:
        from planerecnet_tpu_torch.runner import PlaneRecNetRunner

        ring = [r["image"][None] for r in scenes.make_rows(
            pool, tr["ring"], args.seed)]
        runner = PlaneRecNetRunner(pcfg, seed=args.seed, device=device)
        runner.model.load_state_dict(make_weights(
            cfg, cell.config["weights"], args.seed, device, True))

        def unit(i):
            runner.infer(ring[i % len(ring)])
            sync()

        for i in range(tr["warmup"]):
            unit(i)
        target, first, suffix = runner, tr["warmup"], "serve"
    del pool
    sync()
    cost = _cost(lambda i: unit(first + i), COST_UNITS, COST_ROUNDS, sync)
    nxt = first + cost.pop("next")
    table = (train if tr["kind"] == "train" else serve)(
        target, ring, nxt, tr, device, out_dir)
    result = {"workload": args.workload, "seed": args.seed,
              "card": card(), "device": torch.cuda.get_device_name(device),
              "program": table,
              "coverage": coverage(table, ROOTS[tr["kind"]]),
              "cost": cost,
              "readings": readings(table, tr["kind"], suffix)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
