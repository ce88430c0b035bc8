"""The port's tracing: spans at its layers' boundaries, and the nestable
scope timer of the JAX package.

Spans. ``with timer.span("trainer.forward"): ...`` marks a layer's work;
``timer.tracing(True)`` switches recording on (it is off by default) and
``timer.collect()`` returns and clears the records. Off, ``span`` checks
one module-level bool and returns a shared no-op context manager:
nothing is recorded and no profiler range is opened. On, each span keeps
one ``Span`` record in memory: its name, its parent's index in the
collected list, its thread, and its start and end from
``time.perf_counter_ns()``; a span with no parent is a root, and marks
one unit of work (a training step, a served request). While a
``torch.profiler`` profile is recording, each span is also a
``record_function`` range, so that it appears in the trace as a
``user_annotation`` on the kernels' clock and each device event and idle
gap can be put down to a span (``benchmark/spans.py``). Recording adds
no synchronisation and changes no number.

Spans nest per thread. A thread with no open span (the autograd
engine's, running a backward) nests under the innermost open span of the
thread that holds the open root. That assumes one root open at a time in
the process: where two threads each hold a root, such a thread nests
under the later one's.

The timer: counterpart of ``planerecnet_tpu/utils/timer.py``, with its
API (``with timer.env("backbone"): ...``): only the innermost scope
accumulates while nested, and the parent resumes on exit. A scope's
``sync`` payload is waited for before the clock is read:
``torch.cuda.synchronize`` when it holds a CUDA tensor, so that queued
device work is counted. It keeps its own stack, apart from the spans'.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_total_times = defaultdict(float)
_start_times = defaultdict(lambda: -1.0)
_disabled_names = set()
_timer_stack = []
_running_timer = None
_disable_all = False

_tracing = False
_OFF = contextlib.nullcontext()
_records: List["_Open"] = []
_stacks = threading.local()
_root_stack: Optional[list] = None  # the open spans of the root's thread


class Span(NamedTuple):
    """One recorded span; ``parent`` indexes the list ``collect`` gave."""
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _root_stack
        stack = getattr(_stacks, "open", None)
        if stack is None:
            stack = _stacks.open = []
        if stack:
            parent = stack[-1]
        else:       # one read: the root's thread may pop or close meanwhile
            roots = _root_stack
            held = roots[-1:] if roots is not None else []
            parent = held[0] if held else None
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        if parent is None:
            _root_stack = stack
        self.parent = parent
        self.thread = threading.get_ident()
        self.end_ns = -1
        stack.append(self)
        _records.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _root_stack
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stacks.open
        stack.pop()
        if not stack and _root_stack is stack:
            _root_stack = None
        return False


def span(name: str):
    """A context manager marking ``name``'s work."""
    if not _tracing:
        return _OFF
    return _Open(name)


def tracing(on: bool) -> bool:
    """Switch span recording on or off; returns whether it was on."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def collect() -> List[Span]:
    """The spans recorded since the last call, in the order they opened,
    and clear them. Call it with no span open."""
    records = _records[:]
    del _records[:len(records)]
    index = {id(r): i for i, r in enumerate(records)}
    return [Span(r.name, None if r.parent is None
                 else index.get(id(r.parent)), r.thread, r.start_ns,
                 r.end_ns) for r in records]


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's duration less its children's."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


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
