"""Share of the serve engine's admissions that replayed its CUDA graph of
their bucket shape: 100 x `admit_graph_replays` / `admissions`
(`pop_stream_stats`), over the chunks that ran without the profiler.
Nothing where the program has no such counter."""

from bench_torch.lib.readers import stat_sum, untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "admit_graph_replays" in s]
    admissions = stat_sum(stats, "admissions")
    if not admissions:
        return None
    return 100.0 * stat_sum(stats, "admit_graph_replays") / admissions
