"""Share of the text prefill's prompt rows that are padding: 1 -
`prompt_tokens` (real prompt tokens) / `prompt_slots` (prefill rows x
prompt bucket), the program's admission counters, over the chunks that ran
without the profiler. Nothing where the program has no such counters."""

from bench_torch.lib.readers import untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "prompt_slots" in s]
    slots = sum(s["prompt_slots"] for s in stats)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(s["prompt_tokens"] for s in stats) / slots)
