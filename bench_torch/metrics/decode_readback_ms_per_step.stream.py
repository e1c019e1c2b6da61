"""Host milliseconds a decode step spends blocked on the device: every
`decode.*readback` span of the program (the per-step `active.any()` wait,
`decode.readback`, and the waits inside a step, `decode.<part>.readback`)
and `serve.flag_readback` (the chunk's flag readback), over its decode
steps, over the chunks that ran without the profiler. Nothing where the
program has no such spans."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "host_s" in s]
    steps = stat_sum(stats, "decode_steps")
    if not steps:
        return None
    wait = sum(
        v for s in stats for n, v in s["host_s"].items()
        if n == "serve.flag_readback" or (n.startswith("decode.") and n.endswith("readback"))
    )
    return 1e3 * wait / steps
