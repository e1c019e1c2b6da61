"""The int8 weight matmul's Hopper kernel and its wrapper.

| wrapper       | CUDA source          | replaces (padt_tpu/ops/quant.py)                      |
|---------------|----------------------|-------------------------------------------------------|
| `int8_matmul` | csrc/int8_matmul.cu  | `int8_matmul` :70 (`pallas_call` :102, `_kernel` :33) |

The wrapper takes CUDA tensors only: `ops.quant.int8_matmul` sends CPU
tensors to the plain twin beside it (`ops.quant.int8_matmul_plain`). It
checks device, dtype, shape and strides, allocates the output with
`torch.empty`, launches on the current stream by its launch plan
(`launch_plan`, pure Python), raises on a CUDA error code, and adds one to
`launch_counts["int8_matmul"]`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check, load_library
from .cuda_attention import _require, _same_device, _stream
from .cuda_matmul import GemmPlan, gemm_plan

launch_counts = {"int8_matmul": 0}
launches_by_m = {}  # {M: launches}: the same launches split by the rows of x (decode or prefill)
TALLIES = (launch_counts, launches_by_m)  # every dict a launch adds to


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launches_by_m.clear()


def launch_plan(m: int, n: int, k: int) -> GemmPlan:
    """H7's launch plan (int8 weight): `cuda_matmul.gemm_plan`."""
    return gemm_plan(m, n, k, int8=True)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """x (..., K) bf16 @ dequant(wq (K, N) int8, scale (N,) or (1, N) fp32)
    -> (..., N) bf16 contiguous. x's rows may be strided (unit column
    stride, a row stride that is a multiple of 8); leading dims must flatten
    to rows without a copy."""
    name = "int8_matmul"
    _require(name, x.device.type == "cuda", f"H7 runs on CUDA tensors, got {x.device}")
    _same_device(name, x.device, wq, scale)
    _require(name, x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    _require(name, wq.dtype == torch.int8 and wq.dim() == 2, f"wq must be int8 (K, N), got {wq.dtype} {tuple(wq.shape)}")
    k, n = wq.shape
    _require(name, x.shape[-1] == k, f"x has {x.shape[-1]} columns for K = {k}")
    _require(name, scale.dtype == torch.float32 and scale.numel() == n, f"scale must be fp32 with N = {n} values")
    _require(name, k % 8 == 0 and n % 16 == 0, f"K = {k} must be a multiple of 8 and N = {n} of 16")
    _require(name, wq.is_contiguous() and scale.is_contiguous(), "wq and scale must be contiguous")
    lead = x.shape[:-1]
    try:
        x2 = x.view(-1, k)
    except RuntimeError:
        raise ValueError(f"{name}: x of shape {tuple(x.shape)} and strides {x.stride()} does not flatten to rows without a copy") from None
    m = x2.shape[0]
    _require(name, x2.stride(1) == 1 and x2.stride(0) % 8 == 0, f"x rows need unit column stride and a row stride that is a multiple of 8, got {x2.stride()}")
    for t in (x2, wq):
        _require(name, t.data_ptr() % 16 == 0, "x and wq must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    pl = plan or launch_plan(m, n, k)
    lib = load_library()
    rc = lib.padt_int8_matmul(
        x2.data_ptr(), x2.stride(0), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, n, k, int(pl.swap_ab), pl.nt, pl.splits, pl.stages, _stream(x),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    launches_by_m[m] = launches_by_m.get(m, 0) + 1
    return out.view(*lead, n)
