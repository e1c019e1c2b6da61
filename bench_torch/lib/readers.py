"""Arithmetic the per-layer metric files share."""

from __future__ import annotations

from typing import List, Optional

from . import counts
from .record import Record


def stat_sum(stats: List[dict], key: str) -> float:
    return float(sum(s[key] for s in stats if s))


def untraced_stats(rec: Record) -> List[dict]:
    """The program's stream statistics of the chunks that ran without the
    profiler (its overhead would weigh on every host-clock reading)."""
    return [rec.chunk_stats[i] for i in rec.untraced_chunks()]


def mfu(rec: Record) -> Optional[float]:
    """Model operations of the queries served outside the profiled part of
    the window, over their seconds at the bf16 peak, in percent."""
    served = [s for s in rec.served if not s.traced]
    seconds = sum(rec.chunk_wall_s[i] for i in rec.untraced_chunks())
    if not served or seconds <= 0:
        return None
    ops = sum(counts.query_flops(rec.model, s.grid, s.prompt_tokens, len(s.tokens)) for s in served)
    return 100.0 * ops / (seconds * counts.BF16_FLOPS)


def idle_share(rec: Record) -> Optional[float]:
    """Share of an untraced chunk's wall in which the device runs nothing:
    the device's busy time per traced chunk (the profiler's kernels, copies
    and sets) against the mean wall of the chunks that ran without it.
    Every chunk holds one block of the traffic, the same work; the
    profiler leaves the kernels' times as they are but slows the host, so
    the traced chunks' own walls would count its overhead as idle."""
    t = rec.trace
    traced, untraced = sum(rec.chunk_traced), rec.untraced_chunks()
    if t is None or not t.ops or not traced or not untraced:
        return None
    wall = sum(rec.chunk_wall_s[i] for i in untraced) / len(untraced)
    return 100.0 * (1.0 - t.busy_s() / traced / wall)
