"""Nestable named-scope timer with stack semantics.

Counterpart of ``planerecnet_tpu/utils/timer.py``, with its API
(``with timer.env("backbone"): ...``): only the innermost scope
accumulates while nested, and the parent resumes on exit. A scope's
``sync`` payload is waited for before the clock is read:
``torch.cuda.synchronize`` when it holds a CUDA tensor, so that queued
device work is counted.

For kernel-level profiles use ``torch.profiler``; this is the light
per-stage wall-clock breakdown of the eval loop.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import torch

_total_times = defaultdict(float)
_start_times = defaultdict(lambda: -1.0)
_disabled_names = set()
_timer_stack = []
_running_timer = None
_disable_all = False


def _now() -> float:
    return time.perf_counter()


def disable_all():
    global _disable_all
    _disable_all = True


def enable_all():
    global _disable_all
    _disable_all = False


def disable(fn_name: str):
    _disabled_names.add(fn_name)


def enable(fn_name: str):
    _disabled_names.discard(fn_name)


def reset():
    global _running_timer
    _total_times.clear()
    _start_times.clear()
    _timer_stack.clear()
    _running_timer = None


def start(fn_name: str, use_stack: bool = True):
    """Start a scope; with use_stack the currently-running scope
    pauses."""
    global _running_timer
    if _disable_all:
        return
    if use_stack:
        if _running_timer is not None:
            _stop_accumulating(_running_timer)
            _timer_stack.append(_running_timer)
        _running_timer = fn_name
    _start_times[fn_name] = _now()


def stop(fn_name: Optional[str] = None, use_stack: bool = True,
         sync: Optional[object] = None):
    """Stop a scope. ``sync``: an optional tensor, or a dict, list or
    tuple of them; where any is on a CUDA device, the device is
    synchronised before the timestamp is taken, so that asynchronous
    dispatch does not undercount device work."""
    global _running_timer
    if _disable_all:
        return
    if sync is not None:
        _synchronize(sync)
    if use_stack:
        name = _running_timer
        if name is not None:
            _stop_accumulating(name)
            _running_timer = _timer_stack.pop() if _timer_stack else None
            if _running_timer is not None:
                _start_times[_running_timer] = _now()
    else:
        assert fn_name is not None
        _stop_accumulating(fn_name)


def _synchronize(payload) -> None:
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        for item in payload:
            _synchronize(item)
    elif isinstance(payload, torch.Tensor) and payload.is_cuda:
        torch.cuda.synchronize(payload.device)


def _stop_accumulating(fn_name: str):
    if _start_times[fn_name] >= 0:
        _total_times[fn_name] += _now() - _start_times[fn_name]
        _start_times[fn_name] = -1.0


def print_stats():
    """Per-scope totals table."""
    print()
    all_names = [k for k in _total_times if k not in _disabled_names]
    max_name = max((len(k) for k in all_names), default=4)
    format_str = " {:>%d} | {:>10.4f} " % max_name
    print((" {:>%d} | {:>10} " % max_name).format("Name", "Time (ms)"))
    sep = "-" * (max_name + 3) + "+" + "-" * 13
    print(sep)
    for name in all_names:
        print(format_str.format(name, _total_times[name] * 1000))
    print(sep)
    print(format_str.format("Total", total_time() * 1000))
    print()


def total_time() -> float:
    """Sum of all enabled scope totals, in seconds."""
    return sum(v for k, v in _total_times.items()
               if k not in _disabled_names)


class env:
    """``with timer.env('backbone'): ...``.

    ``sync``: the payload to wait for at exit, or a callable returning
    it.
    """

    def __init__(self, fn_name: str, use_stack: bool = True, sync=None):
        self.fn_name = fn_name
        self.use_stack = use_stack
        self.sync = sync

    def __enter__(self):
        start(self.fn_name, use_stack=self.use_stack)
        return self

    def __exit__(self, e, ev, t):
        payload = self.sync() if callable(self.sync) else self.sync
        stop(self.fn_name, use_stack=self.use_stack, sync=payload)


def sync(device) -> None:
    """Wait for the work queued on ``device`` where it is a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup``: on a CUDA
    ``device``, CUDA events recorded before the first call and after the
    last (the device's time for the queued work); on the CPU, the host
    clock."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = _now()
        for _ in range(iters):
            fn()
        return (_now() - t0) * 1e3 / iters
    stream = torch.cuda.current_stream(device)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record(stream)
    for _ in range(iters):
        fn()
    end_ev.record(stream)
    torch.cuda.synchronize(device)
    return start_ev.elapsed_time(end_ev) / iters
