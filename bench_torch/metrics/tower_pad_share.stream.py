"""Share of the tower's patch rows that are padding: 1 - `patches` (real
patches) / `patch_slots` (prefill rows x patch bucket), the program's
admission counters, over the chunks that ran without the profiler.
Nothing where the program has no such counters."""

from bench_torch.lib.readers import untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "patch_slots" in s]
    slots = sum(s["patch_slots"] for s in stats)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(s["patches"] for s in stats) / slots)
