"""Share of the loop's time in which no kernel, copy or set runs on the
device: the busy time per chunk that `torch.profiler` (CUDA activity)
reads in the traced chunk, over the mean wall of the untraced chunks
(`lib/readers.py::idle_share`)."""

from bench_torch.lib.readers import idle_share


def read(rec):
    return idle_share(rec)
