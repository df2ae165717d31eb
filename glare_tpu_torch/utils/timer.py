"""Wall-clock timers of the training log (the port's own copy of
``glare_tpu/utils/timer.py``; reference: code/utils/timer.py:17-62), and
:class:`ScopeTimer`, which prints the seconds a ``with`` block took."""

from __future__ import annotations

import time


class Timer:
    """Average iteration time."""

    def __init__(self):
        self.times = []
        self.t0 = None

    def tick(self):
        self.t0 = time.time()

    def tock(self):
        assert self.t0 is not None
        dt = time.time() - self.t0
        self.times.append(dt)
        self.t0 = None
        return dt

    def get_average_and_reset(self):
        if not self.times:
            return -1
        avg = sum(self.times) / len(self.times)
        self.times = []
        return avg

    def get_last_iteration(self):
        return self.times[-1] if self.times else 0


class TickTock:
    """Data-load time tracker."""

    def __init__(self):
        self.time_pairs = []
        self.current_time = None

    def tick(self):
        self.current_time = time.time()

    def tock(self):
        assert self.current_time is not None, "tick() must precede tock()"
        self.time_pairs.append([self.current_time, time.time()])
        self.current_time = None

    def get_average_and_reset(self):
        if not self.time_pairs:
            return -1
        avg = sum(t2 - t1 for t1, t2 in self.time_pairs) / len(self.time_pairs)
        self.time_pairs = []
        return avg

    def get_last_iteration(self):
        return self.time_pairs[-1][1] - self.time_pairs[-1][0] if self.time_pairs else 0


class ScopeTimer:
    """``with ScopeTimer(name) as t:`` prints ``"{name} {seconds:.4f}s"`` when the
    block ends (also when it raises) and keeps the seconds in ``t.dt``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.dt = time.time() - self.t0
        print(f"{self.name} {self.dt:.4f}s")
        return False
