"""The measured window: a closed loop of calls until ``seconds`` have
passed, and the statistics taken over all of it."""

from __future__ import annotations

import resource
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


def closed_loop(call: Callable[[int], None], seconds: float,
                sync: Callable[[], None], each: bool,
                after: Optional[Callable[[int], None]] = None
                ) -> Tuple[List[float], float, dict]:
    """Call ``call(i)`` for i = 0, 1, ... until ``seconds`` have passed
    since the first call began; the window ends when the last call's
    work is done (``sync``). With ``each`` every call is synchronised and
    timed (a request's latency); without, only the window is. ``after(i)``
    runs after call i's clock has stopped (inside the window). Returns
    (latencies in s, empty without ``each``; the window in s; the
    process's host time over the window, every thread's, and how often
    the kernel took the processor from it: a host-bound loop's rate
    follows how much of a core it got)."""
    lat: List[float] = []
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        call(i)
        if each:
            sync()
            lat.append(time.perf_counter() - t)
        if after is not None:
            after(i)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window = time.perf_counter() - start
    usage = resource.getrusage(resource.RUSAGE_SELF)
    host = {"cpu_s": usage.ru_utime + usage.ru_stime - usage0.ru_utime
            - usage0.ru_stime,
            "involuntary_switches": usage.ru_nivcsw - usage0.ru_nivcsw}
    return lat, window, host


def rate(units: int, window_s: float) -> float:
    """Work per second over the whole window."""
    return units / window_s


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every request's latency (numpy's linear
    interpolation between order statistics), in ms."""
    return float(np.percentile(np.asarray(latencies_s, np.float64), 95)
                 * 1e3)
