"""Share of the decode steps that replayed the serve engine's CUDA graph
of a step: 100 x `graph_steps` / `decode_steps` (`pop_stream_stats`),
over the chunks that ran without the profiler. Nothing where the program
has no such counter."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "graph_steps" in s]
    steps = stat_sum(stats, "decode_steps")
    if not steps:
        return None
    return 100.0 * stat_sum(stats, "graph_steps") / steps
