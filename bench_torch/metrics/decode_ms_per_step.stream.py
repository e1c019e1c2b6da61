"""The serve engine's device decode span per decode step
(`pop_stream_stats`: engine_decode_s / decode_steps), over the chunks that
ran without the profiler. The span runs between CUDA events, so it holds
the device's waits on the host too."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = untraced_stats(rec)
    steps = stat_sum(stats, "decode_steps")
    if not steps:
        return None
    return 1e3 * stat_sum(stats, "engine_decode_s") / steps
