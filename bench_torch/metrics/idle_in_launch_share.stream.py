"""Share of the device's idle time, in the traced chunk, during which the
host was launching work: each idle gap of the trace goes to the innermost
program span open at its middle (`DeviceTrace.idle_gaps` over the spans
the program kept in that chunk, `pop_stream_stats()["spans"]`, on the
trace's clock), and the share is the idle under `decode.*` and `admit.*`
spans other than the `*.readback` ones (where the host waits on the
device) over all the idle. Nothing where the program has no span recorder
(no `host_s` in its statistics). Where the traced chunk kept no span list
(a trace taken without a profiler session, as the harness's CPU tests
take it), the benchmark's own spans around the engine's admission and
decode-chunk methods stand in; they count the per-step readback as
launch."""

from bench_torch.lib.trace import Spans

LAUNCH = ("decode.", "admit.")
BENCH_LAUNCH = ("admission", "decode_chunk")  # loops/stream.py's `_wrap_engine`


def read(rec):
    t = rec.trace
    if t is None or not t.ops:
        return None
    traced = [st for st, tr in zip(rec.chunk_stats, rec.chunk_traced) if tr and st and "host_s" in st]
    if not traced:
        return None
    kept = [sp for st in traced for sp in st.get("spans") or ()]
    if kept:
        spans = Spans()
        spans.items = [(sp[0], sp[1], sp[2]) for sp in kept]
        launch = lambda n: n.startswith(LAUNCH) and not n.endswith(".readback")
    else:
        spans, launch = rec.spans, lambda n: n in BENCH_LAUNCH
    gaps = t.idle_gaps(spans, k=len(spans.items) + 1)
    idle = sum(v for _, v in gaps)
    if idle <= 0:
        return None
    return 100.0 * sum(v for n, v in gaps if launch(n)) / idle
