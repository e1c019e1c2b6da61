"""The per-layer metrics that read the program's own spans and counters
(`pop_stream_stats()`: `host_s`, the admission counters, and the traced
chunk's `spans`), on synthetic records: the arithmetic, the chunks each
reads, and nothing (no error) from a program that has no span recorder.

    python -m pytest bench_torch/tests -q
"""

import pytest

from bench_torch.lib import harness
from bench_torch.lib.record import Record
from bench_torch.lib.trace import DeviceTrace, Spans
from bench_torch.tests.tiny import tiny_model, tiny_traffic

NEW = ("decode_host_ms_per_step.stream", "decode_readback_ms_per_step.stream", "admission_host_ms.stream",
       "tower_pad_share.stream", "prefill_pad_share.stream", "idle_in_launch_share.stream")


def _read(name, rec):
    return harness._reader("metrics", name)(rec)


def _chunk(steps, step_s, readback_s, flag_s, admit_s, admissions, tokens, token_slots, patches, patch_slots, spans=None):
    st = {
        "decode_steps": steps, "admissions": admissions, "prompt_tokens": tokens, "prompt_slots": token_slots,
        "patches": patches, "patch_slots": patch_slots, "engine_decode_s": 0.0, "generated_tokens": 0,
        "host_s": {"decode.step": step_s, "decode.readback": readback_s, "serve.flag_readback": flag_s,
                   "decode.emit.readback": step_s / 10, "serve.admit": admit_s, "serve.run": 1.0},
    }
    if spans is not None:
        st["spans"] = spans
    return st


def _record():
    """Three chunks; the second ran under the profiler, and its numbers
    (far off the others) must not reach the host-clock readers."""
    rec = Record(model=tiny_model(), traffic=tiny_traffic())
    rec.chunk_stats = [
        _chunk(10, 0.25, 0.01, 0.004, 0.3, 2, 300, 512, 700, 1024),
        _chunk(99, 9.0, 9.0, 9.0, 9.0, 1, 1, 9999, 1, 9999, spans=[]),
        _chunk(30, 0.75, 0.03, 0.006, 0.5, 3, 500, 768, 900, 1536),
    ]
    rec.chunk_traced = [False, True, False]
    rec.chunk_wall_s = [2.0, 9.0, 3.0]
    return rec


def test_host_split_per_step_and_per_admission():
    """A step's waits (`decode.emit.readback`, a tenth of `decode.step`
    here) move from launch to readback: the two add up to the step, the
    readback before it and the chunk's flag readback."""
    rec = _record()
    assert _read("decode_host_ms_per_step.stream", rec) == pytest.approx(1e3 * 0.9 / 40)
    assert _read("decode_readback_ms_per_step.stream", rec) == pytest.approx(1e3 * (0.04 + 0.01 + 0.1) / 40)
    assert _read("admission_host_ms.stream", rec) == pytest.approx(1e3 * 0.8 / 5)


def test_pad_shares():
    rec = _record()
    assert _read("prefill_pad_share.stream", rec) == pytest.approx(100 * (1 - 800 / 1280))
    assert _read("tower_pad_share.stream", rec) == pytest.approx(100 * (1 - 1600 / 2560))


def _trace(t0, t1, ops):
    t = DeviceTrace()
    t.t0, t.t1, t.ops = t0, t1, ops
    return t


def test_idle_in_launch_share_over_known_gaps():
    """Each idle gap goes to the innermost program span open at its middle:
    [0, 100) to admit.vision (launch), [200, 300) to serve.admit, [400,
    600) to decode.readback (a wait, not launch), [700, 950) to
    decode.layers (launch) and [980, 1100) to no span ("other"). Launch is
    350 of 770 ns of idle, and the idle attributed is the trace's idle.
    Spans of an untraced chunk are not read."""
    rec = _record()
    spans = [
        ("serve.run", 0, 1000, -1), ("serve.admit", 10, 500, 0), ("admit.vision", 20, 250, 1),
        ("serve.decode_chunk", 490, 1000, 0), ("decode.readback", 500, 560, 3),
        ("decode.step", 560, 1000, 3), ("decode.layers", 570, 900, 5),
    ]
    rec.chunk_stats[1]["spans"] = spans
    rec.chunk_stats[0]["spans"] = [("decode.layers", 0, 1100, -1)]  # never read: untraced chunk
    rec.trace = _trace(0, 1100, [("k", 100, 200), ("k", 300, 400), ("k", 600, 700), ("k", 950, 980)])
    assert _read("idle_in_launch_share.stream", rec) == pytest.approx(100 * 350 / 770)
    s = Spans()
    s.items = [sp[:3] for sp in spans]
    gaps = dict(rec.trace.idle_gaps(s, k=99))
    assert gaps == pytest.approx({"admit.vision": 100e-9, "serve.admit": 100e-9, "decode.readback": 200e-9,
                                  "decode.layers": 250e-9, "other": 120e-9})
    assert sum(gaps.values()) == pytest.approx(rec.trace.window_s - rec.trace.busy_s())
    # a traced chunk that kept no span list (no profiler session): the benchmark's own spans around
    # the engine's admission and decode-chunk methods stand in: [0, 100), [400, 600) and [700, 950)
    # lie under them
    rec.chunk_stats[1]["spans"] = []
    for name, t0, t1 in (("run_stream", 0, 1100), ("admission", 5, 150), ("decode_chunk", 450, 960)):
        rec.spans.items.append((name, t0, t1))
    assert _read("idle_in_launch_share.stream", rec) == pytest.approx(100 * (100 + 200 + 250) / 770)
    del rec.chunk_stats[1]["spans"]
    assert _read("idle_in_launch_share.stream", rec) == pytest.approx(100 * (100 + 200 + 250) / 770)


def test_nothing_from_a_program_without_spans_or_counters():
    """The parent program's statistics hold neither `host_s` nor the
    admission counters: every new reader gives nothing and raises nothing,
    with and without a trace."""
    rec = Record(model=tiny_model(), traffic=tiny_traffic())
    old = {"decode_steps": 10, "engine_decode_s": 0.3, "generated_tokens": 40, "build_s": 0.0, "run_s": 1.0,
           "tail_s": 0.1, "engine_prefill_s": 0.2, "suffix_passes": 0}
    rec.chunk_stats, rec.chunk_traced, rec.chunk_wall_s = [dict(old), dict(old)], [False, True], [1.0, 1.0]
    for trace in (None, _trace(0, 100, [("k", 10, 20)])):
        rec.trace = trace
        for name in NEW:
            assert _read(name, rec) is None, name
    rec.chunk_stats, rec.chunk_traced, rec.chunk_wall_s = [], [], []
    for name in NEW:
        assert _read(name, rec) is None, name
