"""Streaming bf16 matmul for the decode weight stream (port of
`padt_tpu/ops/matmul.py`): one layer's product `rms_norm(x, ln_w[li]) @
w[li] + bias[li]` read off the full (L, K, N) stack, with the layer's
RMS-norm optionally fused into the product. On the card it is the H10
kernel of `cuda_matmul`; CPU tensors take the plain version below.

The decode path's products go to `torch.matmul` (or H7 with int8 weights);
this op is what `tools/micro_stream_matmul.py` measures against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_matmul
from .cuda_attention import _on_cpu
from .norms import rms_norm


def stream_matmul_stacked(
    x: torch.Tensor,  # (M, K) or (..., K)
    w: torch.Tensor,  # (L, K, N): the full layer stack
    li,  # int or 0-d tensor: the layer
    ln_w: Optional[torch.Tensor] = None,  # (L, K): fuse rms_norm(x, ln_w[li])
    bias: Optional[torch.Tensor] = None,  # (L, N): + bias[li] in x's dtype
    eps: float = 1e-6,
) -> torch.Tensor:
    """`rms_norm(x, ln_w[li]) @ w[li] + bias[li]` -> (..., N) in x's dtype:
    the norm's fp32 mean of x^2, x * (1 / rms) rounded to x's dtype, times
    ln_w[li]; the product summed in fp32 and rounded; the bias added in x's
    dtype (the numerics of the JAX kernel's `_kernel`)."""
    lead, k = x.shape[:-1], x.shape[-1]
    li = int(li)  # a 0-d tensor is read to the host
    if _on_cpu(x, "stream_matmul"):
        return stream_matmul_stacked_ref(x, w, li, ln_w, bias, eps)
    out = cuda_matmul.stream_matmul(x.reshape(-1, k), w, li, ln_w, bias, eps)
    return out.view(*lead, w.shape[-1])


def stream_matmul_stacked_ref(x, w, li, ln_w=None, bias=None, eps: float = 1e-6):
    """The plain version, unfused: identical math to `stream_matmul_stacked`."""
    li = int(li)
    xx = rms_norm(x, ln_w[li], eps) if ln_w is not None else x
    out = torch.matmul(xx.float(), w[li].float()).to(x.dtype)
    if bias is not None:
        out = out + bias[li].to(x.dtype)
    return out
