"""`admission_graph_share.stream`, on synthetic records: the share of the
untraced chunks' admissions that replayed the serve engine's CUDA graph of
their bucket shape, and nothing (no error) from a program that has no
`admit_graph_replays` counter.

    python -m pytest bench_torch/tests -q
"""

import pytest

from bench_torch.lib.record import Record
from bench_torch.tests.test_program_metrics import _read, _record, _trace
from bench_torch.tests.tiny import tiny_model, tiny_traffic

NAME = "admission_graph_share.stream"


def test_admission_graph_share():
    """Admissions replayed from the engine's graphs over admissions, of the
    untraced chunks only (the traced one's replay is not read): 1 of 2 and
    3 of 3."""
    rec = _record()
    for st, replayed in zip(rec.chunk_stats, (1, 1, 3)):
        st["admit_graph_replays"] = replayed
    assert _read(NAME, rec) == pytest.approx(100 * 4 / 5)


def test_nothing_from_a_program_without_admit_graph_replays():
    """The parent program's statistics, with the spans, the admission
    counters and the decode graph's, and without `admit_graph_replays`: the
    reader gives nothing and raises nothing, with and without a trace, and
    with no chunks at all."""
    rec = _record()
    for st in rec.chunk_stats:
        st["graph_steps"] = st["decode_steps"]
    for trace in (None, _trace(0, 100, [("k", 10, 20)])):
        rec.trace = trace
        assert _read(NAME, rec) is None
    rec = Record(model=tiny_model(), traffic=tiny_traffic())
    rec.chunk_stats, rec.chunk_traced, rec.chunk_wall_s = [], [], []
    assert _read(NAME, rec) is None
