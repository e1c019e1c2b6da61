"""The port's span recorder (`padt_tpu_torch.utils.profiling`): sums and
counts always, the span list (on `time.time_ns()`, with parent indices)
only while tracing is on when the outermost span opens, and the span names
in a Chrome trace of `profiling.trace`. No time is asserted: the suite runs in
parallel workers."""

import time
import tracemalloc

import torch

from padt_tpu_torch.utils import profiling


def _nest(rec):
    with rec.span("outer"):
        with rec.span("a"):
            with rec.span("leaf"):
                torch.ones(4).sum()
        with rec.span("b"):
            pass
        with rec.span("a"):
            pass


def test_recorder_nesting_and_parent_indices():
    rec = profiling.Recorder()
    with profiling.recording():
        _nest(rec)
    names = [s[0] for s in rec.spans]
    assert names == ["outer", "a", "leaf", "b", "a"]
    parents = [s[3] for s in rec.spans]
    assert parents == [-1, 0, 1, 0, 0]
    for name, t0, t1, parent in rec.spans:
        assert t0 <= t1
        if parent >= 0:
            assert rec.spans[parent][1] <= t0 and t1 <= rec.spans[parent][2]
    # sums and counts agree with the list
    assert rec.counts == {"outer": 1, "a": 2, "leaf": 1, "b": 1}
    for name in rec.counts:
        assert rec.sums[name] == sum(t1 - t0 for n, t0, t1, _ in rec.spans if n == name)
    assert rec.span_tuples() == [tuple(s) for s in rec.spans]
    assert set(rec.seconds()) == set(rec.counts)


def test_recorder_off_keeps_only_sums():
    """Without tracing: no span list, sums and counts all the same, and
    the span of a name is one reused object, so many spans leave no memory
    behind."""
    rec = profiling.Recorder()
    assert not profiling.tracing()
    _nest(rec)
    assert rec.spans is None and rec.span_tuples() is None
    assert rec.counts == {"outer": 1, "a": 2, "leaf": 1, "b": 1}
    assert all(v >= 0 for v in rec.sums.values())
    assert rec.span("a") is rec.span("a")
    for _ in range(100):  # first use of each name, and the dicts' slots
        with rec.span("x"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(20000):
            with rec.span("x"):
                with rec.span("y"):
                    pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 4096, grown
    assert rec.counts["x"] == 20100 and rec.counts["y"] == 20000


def test_recording_keeps_the_list_on_time_ns():
    """`recording()` and a torch.profiler session both turn tracing on; a
    recorder checks it when its outermost span opens, keeping its list
    while tracing stays on and dropping it at the first outermost span
    after, and its spans lie on the clock of `time.time_ns()` (the clock
    of the profiler's events)."""
    rec = profiling.Recorder()
    _nest(rec)  # untraced: sums only
    assert rec.spans is None
    t_before = time.time_ns()
    with profiling.recording():
        assert profiling.tracing()
        with profiling.recording():
            pass
        assert profiling.tracing()  # nested blocks
        _nest(rec)
        _nest(rec)  # a second outermost span keeps the list
    t_after = time.time_ns()
    assert not profiling.tracing()
    assert len(rec.spans) == 10 and rec.counts["outer"] == 3  # the list while traced; sums throughout
    assert all(t_before <= t0 <= t1 <= t_after for _, t0, t1, _ in rec.spans)
    starts = [s[1] for s in rec.spans]
    assert starts == sorted(starts)
    with rec.span("outer"):
        with profiling.recording():
            with rec.span("inner"):  # tracing is checked at the outermost span only
                pass
    assert rec.spans is None and rec.counts["outer"] == 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
        _nest(rec)
    assert [s[0] for s in rec.spans] == ["outer", "a", "leaf", "b", "a"]


def test_span_names_in_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        rec = profiling.Recorder()
        with rec.span("serve.region"):
            with rec.span("decode.inner"):
                torch.ones(8) * 2
    (path,) = list((tmp_path / "trace").iterdir())
    text = path.read_text()
    assert "serve.region" in text and "decode.inner" in text
    assert [s[0] for s in rec.spans] == ["serve.region", "decode.inner"]
