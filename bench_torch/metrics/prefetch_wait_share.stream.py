"""Share of the chunk loop's time spent waiting for the next chunk's host
preprocessing (`infer_dataset`'s `host_prefetch_wait_s`), by the
benchmark's clock, over the chunks that ran without the profiler."""


def read(rec):
    idx = rec.untraced_chunks()
    wall = sum(rec.chunk_wall_s[i] for i in idx)
    if not idx or wall <= 0:
        return None
    return 100.0 * sum(rec.chunk_wait_s[i] for i in idx) / wall
