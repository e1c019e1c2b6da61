"""Host spans and the device trace of a traced run.

Spans are the benchmark's own: (name, start, end) on the epoch clock in
nanoseconds, around its calls into the program's layers. The device trace
is `torch.profiler` with CUDA activity only, read straight from the kineto
events (whose timestamps are on the same clock), so no per-event Python
objects are built for the host's operators.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

TOP = 10


class Spans:
    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def wrap(self, obj, method: str, name: str) -> None:
        """Record a span around every call of `obj.method`, where it has one."""
        fn = getattr(obj, method, None)
        if fn is None:
            return

        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)

        setattr(obj, method, wrapped)


class DeviceTrace:
    """Kernels, copies and sets that ran on the device between `start` and
    `stop`, as (name, start ns, end ns)."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0
        self.ops: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        self.ops = [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0
        ]
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the ops' intervals, clipped to the window."""
        out: List[List[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def op_seconds(self, patterns: Sequence[str]) -> float:
        """Summed device time of the ops whose names contain any pattern."""
        return sum((b - a) for n, a, b in self.ops if any(p in n for p in patterns)) / 1e9

    def top_ops(self, k: int = TOP) -> List[List]:
        by = defaultdict(int)
        for n, a, b in self.ops:
            by[n] += b - a
        return [[n[:200], v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, spans: Spans, k: int = TOP) -> List[List]:
        """Idle time of the device, summed by the innermost host span open
        at the middle of each gap ("other" where none is)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        by: Dict[str, int] = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            open_ = [(s, n) for n, s, e in spans.items if s <= mid < e]
            by[max(open_)[1] if open_ else "other"] += b - a
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
