"""Profiling / tracing utilities (the port's counterpart of
`padt_tpu/utils/profiling.py`, on `torch.profiler`):
  - `trace(logdir)`: a `torch.profiler` trace of the host and, where there
    is a card, the device, written as a Chrome trace into `logdir`,
  - `annotate(name)`: a named trace region (`record_function`),
  - `PhaseTimer`: host-side per-phase wall timers that synchronise the
    device of the tensors they are given before they stop,
  - `decode_stats`: prefill/decode split from two generation lengths.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait for the device work behind the tensors of `tree` (nested dicts,
    lists, tuples): synchronise each CUDA device they live on."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            sync(result_holder)
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: float(np.median(v)) for k, v in self.times.items()}


def decode_stats(run_fn, n_short: int, n_long: int, batch: int) -> Dict[str, float]:
    """run_fn(n_new) -> wall seconds (synced). Returns prefill/decode split."""
    t_s = run_fn(n_short)
    t_l = run_fn(n_long)
    step = (t_l - t_s) / max(n_long - n_short, 1)
    return {
        "decode_step_s": step,
        "decode_tokens_per_s": batch / step if step > 0 else float("inf"),
        "prefill_s": max(t_s - n_short * step, 0.0),
    }
