"""H11 `expert_matmul`'s share of its roofline over the traced chunks: the
least time of the expert products those chunks needed, over the summed
device time of the kernel named below.

Work, from the program's counters of the traced chunks (`pop_stream_stats`:
the token-expert choices of real tokens and the (layer, expert) pairs they
hit), for the decode steps and for the admissions taken apart: operations
2 x choices x 3 x d x F; bytes, each expert hit read once in bf16 (9.44 MB
at Keye's widths) and each choice's bf16 activations in and out of both
products (the layout's `expert_work`). Counting only the experts that real
tokens hit, and only their rows, keeps the bound a lower one. The least
time of each part is the larger of operations over 989 TFLOP/s and bytes
over 3.35 TB/s. Nothing for a stack without experts, or a program without
the counters."""

from bench_torch.lib import counts, layout
from bench_torch.lib.readers import stat_sum

KERNELS = ("expert_gemm_kernel",)  # padt_tpu_torch/csrc/expert_matmul.cu, every instance


def read(rec):
    t = rec.trace
    if t is None or not any(rec.chunk_traced):
        return None
    work = getattr(layout.text_layout(rec.model), "expert_work", None)
    stats = [st for st, tr in zip(rec.chunk_stats, rec.chunk_traced) if tr and st and "decode_expert_rows" in st]
    kernel_s = t.op_seconds(KERNELS)
    if work is None or not stats or kernel_s <= 0:
        return None
    least = 0.0
    for phase in ("decode", "prefill"):
        ops, nbytes = work(rec.model, stat_sum(stats, f"{phase}_expert_rows"), stat_sum(stats, f"{phase}_experts_hit"))
        least += counts.least_seconds(ops, nbytes)
    return 100.0 * least / kernel_s
