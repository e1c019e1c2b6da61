"""The vision tower's packed-MLP activation: its Hopper kernel, the wrapper
and the plain twin.

| wrapper  | CUDA source     | replaces                                                    |
|----------|-----------------|-------------------------------------------------------------|
| `swiglu` | csrc/swiglu.cu  | none: XLA fuses `silu(gate) * up` (padt_tpu/models/vision.py |
|          |                 | :141-143) into one pass; eager PyTorch takes two            |

`swiglu` takes the plain twin (`swiglu_plain`) for CPU tensors and only
there: on a CUDA tensor it launches H12 or raises. It checks device, dtype,
shape and alignment, allocates the output with `torch.empty`, launches on the
current stream, raises on a CUDA error code, and adds one to
`launch_counts["swiglu"]`. Like every kernel wrapper it raises on CUDA
inputs that require grad (with grad mode on): the trained tower keeps the
unpacked MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, load_library
from .cuda_attention import _on_cpu, _require, _stream

launch_counts = {"swiglu": 0}
TALLIES = (launch_counts,)  # every dict a launch adds to


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def swiglu_plain(gu: torch.Tensor) -> torch.Tensor:
    """gu (..., 2 * ff) = [gate | up] -> silu(gate) * up (..., ff), in fp32,
    rounded once to gu's dtype."""
    g, u = gu.float().chunk(2, dim=-1)
    return (F.silu(g) * u).to(gu.dtype)


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """gu (..., 2 * ff) = [gate | up] -> silu(gate) * up (..., ff). On the card:
    bf16, contiguous, ff a multiple of 8."""
    name = "swiglu"
    if _on_cpu(gu, name):
        return swiglu_plain(gu)
    _require(name, not (gu.requires_grad and torch.is_grad_enabled()), "H12 has no backward: the input requires grad")
    _require(name, gu.dtype == torch.bfloat16, f"gu must be bf16, got {gu.dtype}")
    ff2 = gu.shape[-1]
    _require(name, ff2 > 0 and ff2 % 16 == 0, f"gu's width {ff2} must be twice a positive multiple of 8")
    _require(name, gu.is_contiguous() and gu.data_ptr() % 16 == 0, "gu must be contiguous and 16-byte aligned")
    lead, ff = gu.shape[:-1], ff2 // 2
    rows = gu.numel() // ff2
    out = torch.empty((*lead, ff), dtype=torch.bfloat16, device=gu.device)
    lib = load_library()
    check(lib, name, lib.padt_swiglu(gu.data_ptr(), out.data_ptr(), rows, ff, _stream(gu)))
    launch_counts[name] += 1
    return out
