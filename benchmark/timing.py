"""Host-clock timing of the window, and the union of device intervals."""

from __future__ import annotations

import gc
import os
import resource
import time
from typing import Callable, Iterable, List, Tuple


def run_window(seconds: float, step: Callable[[int], None],
               clock: Callable[[], float] = time.perf_counter,
               min_steps: int = 1):
    """Closed loop with one client: step(0), step(1), ... until `seconds`
    have passed and at least `min_steps` steps have run; the window ends
    when the last step started has ended.  Returns (window seconds, steps
    completed, each step's seconds)."""
    start = clock()
    durations: List[float] = []
    now = start
    while now - start < seconds or len(durations) < min_steps:
        t0 = now
        step(len(durations))
        now = clock()
        durations.append(now - t0)
    return now - start, len(durations), durations


class HostLoad:
    """What the host did over the window, for the log: the process's CPU
    seconds, its involuntary context switches (other load on its cores),
    the seconds Python's collector ran by generation, and the load average
    and mean CPU clock at the window's two ends."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    def __enter__(self):
        self.ends = [_host_now()]
        self.cpu0 = time.process_time()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu_s = time.process_time() - self.cpu0
        self.nivcsw = ru.ru_nivcsw - self.ru0.ru_nivcsw
        self.ends.append(_host_now())

    def summary(self) -> str:
        gcs = ", ".join(f"gen{g} {n} x {s:.3f} s" for g, (n, s) in
                        enumerate(zip(self.gc_n, self.gc_s)))
        return (f"cpu {self.cpu_s:.3f} s, involuntary switches "
                f"{self.nivcsw}, gc {gcs}; load, MHz at start "
                f"{self.ends[0]}, at end {self.ends[1]}")


def _host_now():
    """(1-minute load average, mean `cpu MHz` of /proc/cpuinfo or None)."""
    mhz = None
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(line.split(":")[1]) for line in f
                    if line.startswith("cpu MHz")]
        mhz = round(sum(vals) / len(vals)) if vals else None
    except OSError:
        pass
    return (round(os.getloadavg()[0], 2), mhz)


def per_step(window_s: float, steps: int) -> float:
    """The window over the steps it completed (not a median of steps)."""
    if steps <= 0:
        raise ValueError("the window completed no step")
    return window_s / steps


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end] intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Tuple[float, float]]):
    """The union as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of two unions, each given as disjoint
    sorted intervals (`merged`)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
