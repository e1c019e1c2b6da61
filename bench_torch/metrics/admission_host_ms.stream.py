"""Host milliseconds an admission takes: the program's `serve.admit` span
(stacking the bucket, its copies to the device, the tower, the text
prefill, the insert; the waits of its synchronous copies, the
`admit.*.readback` spans, included) over its `admissions` counter, over
the chunks that ran without the profiler. Nothing where the program has no
such span or counter."""

from bench_torch.lib.readers import untraced_stats


def read(rec):
    stats = [s for s in untraced_stats(rec) if s and "host_s" in s and "admissions" in s]
    n = sum(s["admissions"] for s in stats)
    if not n:
        return None
    return 1e3 * sum(s["host_s"].get("serve.admit", 0.0) for s in stats) / n
