"""Generated tokens over decode steps times slots (`pop_stream_stats`),
over the chunks that ran without the profiler."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = untraced_stats(rec)
    steps = stat_sum(stats, "decode_steps")
    if not steps:
        return None
    return 100.0 * stat_sum(stats, "generated_tokens") / (steps * rec.traffic["n_slots"])
