"""The streaming decode matmul's Hopper kernel and its wrapper.

| wrapper         | CUDA source            | replaces (padt_tpu/ops/matmul.py)                                    |
|-----------------|------------------------|----------------------------------------------------------------------|
| `stream_matmul` | csrc/stream_matmul.cu  | `stream_matmul_stacked` :76 (`pallas_call` :125, `_kernel` :39)       |

The wrapper takes CUDA tensors only: `ops.matmul.stream_matmul_stacked`
sends CPU tensors to the plain twin beside it
(`ops.matmul.stream_matmul_stacked_ref`). It checks device, dtype, shape
and strides, raises on inputs that require grad (the raw-pointer output
would cut the autograd graph), allocates the output (and the fp32 row-norm
and split-K scratch) with `torch.empty`, launches on the current stream,
raises on a CUDA error code, and adds one to
`launch_counts["stream_matmul"]`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check, load_library
from .cuda_attention import _no_graph_cut, _require, _same_device, _stream

launch_counts = {"stream_matmul": 0}

_BM, _BN, _BK = 128, 128, 32  # the kernel's output tile and K step
_MAX_SPLITS = 16
_SMS = 132  # streaming multiprocessors of an H100


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def k_splits(m: int, n: int, k: int) -> int:
    """K splits (grid.z): doubled from 1 while the output tiles give fewer
    CTAs than the card has SMs, each split keeps at least 8 K steps, and the
    fp32 partial sums (splits x M x N x 4 bytes) stay within the weight's
    own bytes (K x N x 2). At M = 96: qkv and o 8, down 16, gate-up 1."""
    tiles = -(-m // _BM) * -(-n // _BN)
    k_tiles = -(-k // _BK)
    split = 1
    while split < _MAX_SPLITS and tiles * split < _SMS and k_tiles >= 8 * 2 * split and 2 * split * m * 2 <= k:
        split *= 2
    return split


def stream_matmul(
    x: torch.Tensor,  # (M, K) bf16, unit column stride
    w: torch.Tensor,  # (L, K, N) bf16: the full stack
    li: int,
    ln_w: Optional[torch.Tensor] = None,  # (L, K) bf16: fuse rms_norm(x, ln_w[li])
    bias: Optional[torch.Tensor] = None,  # (L, N) bf16: + bias[li]
    eps: float = 1e-6,
) -> torch.Tensor:
    """bf16(rms_norm(x, ln_w[li]) @ w[li]) + bias[li] -> (M, N) bf16
    contiguous. x's rows may be strided (a row stride that is a multiple of
    8)."""
    name = "stream_matmul"
    _require(name, x.device.type == "cuda", f"H10 runs on CUDA tensors, got {x.device}")
    _same_device(name, x.device, w, ln_w, bias)
    _no_graph_cut(name, x, w, ln_w, bias, hint="H10 has no backward: run it under torch.no_grad() or on detached tensors")
    _require(name, x.dtype == torch.bfloat16 and x.dim() == 2, f"x must be bf16 (M, K), got {x.dtype} {tuple(x.shape)}")
    _require(name, w.dtype == torch.bfloat16 and w.dim() == 3, f"w must be a bf16 (L, K, N) stack, got {w.dtype} {tuple(w.shape)}")
    nl, k, n = w.shape
    m = x.shape[0]
    _require(name, x.shape[1] == k, f"x has {x.shape[1]} columns for K = {k}")
    _require(name, k % 8 == 0 and n % 8 == 0, f"K = {k} and N = {n} must be multiples of 8")
    _require(name, 0 <= li < nl, f"layer {li} out of range [0, {nl})")
    _require(name, x.stride(1) == 1 and x.stride(0) % 8 == 0, f"x rows need unit column stride and a row stride that is a multiple of 8, got {x.stride()}")
    for t, shape in ((ln_w, (nl, k)), (bias, (nl, n))):
        if t is not None:
            _require(name, t.dtype == torch.bfloat16 and t.shape == shape and t.is_contiguous(),
                     f"ln_w / bias must be contiguous bf16 {shape}, got {t.dtype} {tuple(t.shape)}")
    _require(name, w.is_contiguous(), "w must be contiguous")
    for t in (x, w, ln_w):
        _require(name, t is None or t.data_ptr() % 16 == 0, "x, w and ln_w must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    split = k_splits(m, n, k)
    ws = torch.empty((split, m, n), dtype=torch.float32, device=x.device) if split > 1 else None
    rstd = torch.empty((m,), dtype=torch.float32, device=x.device) if ln_w is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    rc = lib.padt_stream_matmul(
        x.data_ptr(), x.stride(0), w.data_ptr(), ptr(ln_w), ptr(bias), out.data_ptr(), ptr(rstd), ptr(ws),
        m, n, k, nl, int(li), split, float(eps), _stream(x),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out
