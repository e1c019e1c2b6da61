"""Model operations of the queries served outside the profiled part of the
window (the tower over real patches, causal prefill over real prompt
tokens, a decode forward per served token after the first, the logits of
each) over their seconds at the H100's bf16 peak of 989 TFLOP/s."""

from bench_torch.lib.readers import mfu


def read(rec):
    return mfu(rec)
