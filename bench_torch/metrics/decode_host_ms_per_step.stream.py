"""Host milliseconds a decode step spends launching its work: the
program's `decode.step` span (logits and sampling, the text layers, the
K/V store; `pop_stream_stats()["host_s"]`), less the waits inside it (its
`decode.<part>.readback` spans), over its decode steps, over the chunks
that ran without the profiler. Nothing where the program has no such
span."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "host_s" in s]
    steps = stat_sum(stats, "decode_steps")
    if not steps:
        return None
    launch = 0.0
    for s in stats:
        h = s["host_s"]
        launch += h.get("decode.step", 0.0) - sum(
            v for n, v in h.items() if n.startswith("decode.") and n.endswith(".readback") and n != "decode.readback"
        )
    return 1e3 * launch / steps
