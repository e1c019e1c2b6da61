"""`decode_graph_share.stream`, on synthetic records: the share of the
untraced chunks' decode steps that replayed the serve engine's CUDA graph,
and nothing (no error) from a program that has no `graph_steps` counter.

    python -m pytest bench_torch/tests -q
"""

import pytest

from bench_torch.lib.record import Record
from bench_torch.tests.test_program_metrics import _read, _record, _trace
from bench_torch.tests.tiny import tiny_model, tiny_traffic

NAME = "decode_graph_share.stream"


def test_decode_graph_share():
    """Steps replayed from the engine's CUDA graph over decode steps, of the
    untraced chunks only (the traced one's 99 replays are not read)."""
    rec = _record()
    for st, replayed in zip(rec.chunk_stats, (9, 99, 30)):
        st["graph_steps"] = replayed
    assert _read(NAME, rec) == pytest.approx(100 * 39 / 40)


def test_nothing_from_a_program_without_graph_steps():
    """The parent program's statistics, with the spans and admission counters and without
    `graph_steps`: the reader gives nothing and raises nothing, with and
    without a trace, and with no chunks at all."""
    rec = _record()
    for trace in (None, _trace(0, 100, [("k", 10, 20)])):
        rec.trace = trace
        assert _read(NAME, rec) is None
    rec = Record(model=tiny_model(), traffic=tiny_traffic())
    rec.chunk_stats, rec.chunk_traced, rec.chunk_wall_s = [], [], []
    assert _read(NAME, rec) is None
