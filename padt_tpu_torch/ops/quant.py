"""Int8 weight-only quantization for serving (port of `padt_tpu/ops/quant.py`):
per-output-channel symmetric int8 text-layer weights with fp32 scales, and
the products through them.

`int8_matmul` takes the plain twin beside it for CPU tensors and only there;
on a CUDA tensor it launches H7 (`cuda_quant.int8_matmul`) or raises. The
TPU kernel's padding of N to 128 and of M to its block, and its VMEM budget
for the K block (`_pick_blk_k`), are Mosaic layout needs the port does not
have: H7 predicates its tails.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cuda_quant
from .cuda_attention import _on_cpu


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) float -> {'q': int8 (in, out), 's': fp32 (1, out)}, per
    output channel: s = max|w| / 127 (at least 1e-12), q = round half to
    even of w / s, clipped to +-127."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ wq (K, N) times scale (N,) per column, in fp32 -> x.dtype."""
    return ((x.float() @ wq.float()) * scale.reshape(-1).float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(wq (K, N) int8, scale (N,) or (1, N) fp32) ->
    (..., N) in x.dtype; the sum in fp32, scaled once."""
    if _on_cpu(x, "int8_matmul"):
        return int8_matmul_plain(x, wq, scale)
    return cuda_quant.int8_matmul(x, wq, scale)


def linear(lp: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    """Layer weight `name` (e.g. 'o_w') applied to x: through `int8_matmul`
    when the layer holds `{name}_q` / `{name}_s`, else `x @ lp[name]`. The
    bias is not applied here."""
    if name + "_q" in lp:
        return int8_matmul(x, lp[name + "_q"], lp[name + "_s"])
    return x @ lp[name]
