"""H7 `int8_matmul`'s share of its roofline over the traced chunks: the
least time of the int8-weight text products those chunks needed, over the
summed device time of the kernels named below.

Work: every forward pass reads each int8 weight and its float32 column
scales once: one pass per decode step and one per admission (the
benchmark's own span around the serve engine's admission counts them);
the rows are the real prompt tokens of the traced queries and one row per
served token after each query's first. The least time is the larger of
bytes over 3.35 TB/s and operations over 989 TFLOP/s (H7 converts the
int8 weights to bf16 for the tensor cores)."""

from bench_torch.lib import counts
from bench_torch.lib.readers import stat_sum

KERNELS = ("gemm_kernel<true",)  # csrc/gemm_sm90.cuh's instances with int8 weights


def read(rec):
    t = rec.trace
    if t is None or rec.model["text_layer_weights"] != "int8" or not any(rec.chunk_traced):
        return None
    kernel_s = t.op_seconds(KERNELS)
    if kernel_s <= 0:
        return None
    admissions = sum(1 for n, a, b in rec.spans.items if n == "admission" and t.t0 <= a < t.t1)
    steps = stat_sum([st for st, t in zip(rec.chunk_stats, rec.chunk_traced) if t], "decode_steps")
    traced = [s for s in rec.served if s.traced]
    rows = sum(s.prompt_tokens + max(len(s.tokens) - 1, 0) for s in traced)
    ops, nbytes = counts.int8_product_work(rec.model, rows, int(steps) + admissions)
    return 100.0 * counts.least_seconds(ops, nbytes) / kernel_s
