"""The int8 weight matmul's Hopper kernel and its wrapper.

| wrapper       | CUDA source          | replaces (padt_tpu/ops/quant.py)                      |
|---------------|----------------------|-------------------------------------------------------|
| `int8_matmul` | csrc/int8_matmul.cu  | `int8_matmul` :70 (`pallas_call` :102, `_kernel` :33) |

The wrapper takes CUDA tensors only: `ops.quant.int8_matmul` sends CPU
tensors to the plain twin beside it (`ops.quant.int8_matmul_plain`). It
checks device, dtype, shape and strides, allocates the output (and the fp32
split-K scratch) with `torch.empty`, launches on the current stream, raises
on a CUDA error code, and adds one to `launch_counts["int8_matmul"]`.
"""

from __future__ import annotations

import torch

from ._build import check, load_library
from .cuda_attention import _require, _same_device, _stream
from .cuda_kv import _FILL_CTAS

launch_counts = {"int8_matmul": 0}

_BM, _BN, _BK = 64, 128, 64  # the kernel's output tile and K step
_MAX_SPLITS = 16


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def k_splits(m: int, n: int, k: int) -> int:
    """K splits (grid.z): doubled from 1 while the output tiles give fewer
    than two CTAs per SM and each split keeps at least 4 K steps (decode:
    M = 8 gives one row of tiles; prefill fills the card with 1)."""
    tiles = -(-m // _BM) * -(-n // _BN)
    k_tiles = -(-k // _BK)
    split = 1
    while split < _MAX_SPLITS and tiles * split < _FILL_CTAS and k_tiles >= 8 * split:
        split *= 2
    return split


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
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
    split = k_splits(m, n, k)
    ws = torch.empty((split, m, n), dtype=torch.float32, device=x.device) if split > 1 else None
    lib = load_library()
    rc = lib.padt_int8_matmul(
        x2.data_ptr(), x2.stride(0), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, split, _stream(x),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out.view(*lead, n)
