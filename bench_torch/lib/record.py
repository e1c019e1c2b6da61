"""What a run's window leaves for the metric readers and the check."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .trace import DeviceTrace, Spans


@dataclass
class Served:
    """One query of the window, as the program finished it."""

    index: int
    grid: tuple  # (t, h, w) patches of the model input
    prompt_tokens: int  # real prompt tokens (no padding)
    tokens: np.ndarray  # the served tokens, EOS included where it came
    traced: bool = False  # finished inside the traced part of the window


@dataclass
class Record:
    model: Dict
    traffic: Dict
    window_s: float = 0.0
    setup_s: float = 0.0
    window_start: float = 0.0  # epoch seconds
    attempted: int = 0
    failed: int = 0
    served: List[Served] = field(default_factory=list)
    # per chunk of the stream loop: the program's own statistics
    # (`pop_stream_stats`), the chunk's wall and prefetch wait, and whether
    # it ran under the profiler
    chunk_stats: List[Dict] = field(default_factory=list)
    chunk_wall_s: List[float] = field(default_factory=list)
    chunk_wait_s: List[float] = field(default_factory=list)
    chunk_traced: List[bool] = field(default_factory=list)
    spans: Spans = field(default_factory=Spans)
    trace: Optional[DeviceTrace] = None

    def untraced_chunks(self) -> List[int]:
        return [i for i, t in enumerate(self.chunk_traced) if not t]
