"""Host spans of the program, and the operator's trace exporter.

`Recorder` is the one span recorder. A span is a named stretch of host
time on `time.time_ns()`, the clock of `torch.profiler`'s kineto events,
so spans and device ops share one timeline. The recorder always adds each
span's duration and count into per-name sums: a dict update and two clock
reads, no device call and no object kept per span. While tracing is on it
also keeps the span list, each span as `(name, start_ns, end_ns, parent)`
(`parent` the list index of the enclosing span or -1), and opens a
`torch.profiler.record_function` of the span's name, so the names appear
in a trace. Tracing is on while a `torch.profiler` session is active or
inside `recording()`. A recorder checks it when a span opens with no span
open (the start of an engine run): on, it keeps its list or starts one;
off, it drops the list.

A recorder belongs to one thread: spans nest in the order they open.

`trace(logdir)`: a `torch.profiler` trace of the host and, where there is
a card, the device, written as a Chrome trace into `logdir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

_recording = 0  # depth of open recording() blocks


@contextlib.contextmanager
def recording():
    """Tracing on without a profiler: recorders whose outermost span opens
    inside keep their span list (for tests, and to measure what recording
    costs)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def tracing() -> bool:
    """A `torch.profiler` session is active, or `recording()` is open."""
    return _recording > 0 or torch._C._autograd._profiler_enabled()


class _Span:
    """The context manager of one span name (one per name and recorder,
    reused, so an untraced span allocates nothing)."""

    __slots__ = ("rec", "name")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if not rec._open:
            rec._watch()
        if rec.spans is None:
            rec._open.append(time.time_ns())
        else:
            rec._open.append(len(rec.spans))
            rec._fns.append(torch.profiler.record_function(self.name).__enter__())
            rec.spans.append([self.name, time.time_ns(), 0, rec._parents[-1]])
            rec._parents.append(rec._open[-1])

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        if rec.spans is None:
            t0 = rec._open.pop()
        else:
            i = rec._open.pop()
            rec._parents.pop()
            row = rec.spans[i]
            row[2], t0 = t1, row[1]
            rec._fns.pop().__exit__(*exc)
        rec.sums[self.name] = rec.sums.get(self.name, 0) + t1 - t0
        rec.counts[self.name] = rec.counts.get(self.name, 0) + 1
        return False


class Recorder:
    """Per-name sums (ns) and counts of host spans, always; the span list
    while tracing was on when the outermost span opened."""

    def __init__(self):
        self.sums: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.spans: Optional[List[list]] = None
        self._open: List[int] = []  # start ns (untraced) or list index (traced) of each open span
        self._parents: List[int] = [-1]
        self._fns: List = []
        self._names: Dict[str, _Span] = {}

    def _watch(self) -> None:
        if not tracing():
            self.spans = None
        elif self.spans is None:
            self.spans = []

    def span(self, name: str) -> _Span:
        """`with rec.span(name):` times the block under `name`."""
        s = self._names.get(name)
        if s is None:
            s = self._names[name] = _Span(self, name)
        return s

    def seconds(self) -> Dict[str, float]:
        return {k: v / 1e9 for k, v in self.sums.items()}

    def span_tuples(self) -> Optional[List[tuple]]:
        return None if self.spans is None else [tuple(s) for s in self.spans]


@contextlib.contextmanager
def trace(logdir: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
