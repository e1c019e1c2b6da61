"""The streaming decode matmul's Hopper kernel and its wrapper.

| wrapper         | CUDA source            | replaces (padt_tpu/ops/matmul.py)                                    |
|-----------------|------------------------|----------------------------------------------------------------------|
| `stream_matmul` | csrc/stream_matmul.cu  | `stream_matmul_stacked` :76 (`pallas_call` :125, `_kernel` :39)       |

The wrapper takes CUDA tensors only: `ops.matmul.stream_matmul_stacked`
sends CPU tensors to the plain twin beside it
(`ops.matmul.stream_matmul_stacked_ref`). It checks device, dtype, shape
and strides, raises on inputs that require grad (the raw-pointer output
would cut the autograd graph), allocates the output (and, with the norm
fused, the normalised rows) with `torch.empty`, launches on the current stream by its launch
plan (`launch_plan`, pure Python, shared with H7 through `gemm_plan`),
raises on a CUDA error code, and adds one to
`launch_counts["stream_matmul"]`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ._build import check, load_library
from .cuda_attention import SMEM_LIMIT, SMS, _no_graph_cut, _require, _same_device, _stream

launch_counts = {"stream_matmul": 0}
TALLIES = (launch_counts,)  # every dict a launch adds to

# csrc/gemm_sm90.cuh, the GEMM that H10 and H7 share
DECODE_M = 128  # M up to this takes swap-AB (out^T = W^T x^T)
SWAP_NT = (8, 16, 32, 64, 96, 128)  # wgmma's n under swap-AB: M rounded up to one of these
BK = 64  # K rows per stage
MAX_CLUSTER = 8  # the largest portable thread-block cluster: the most K splits
MAX_STAGES = 8
SM_SMEM = 228 * 1024  # shared memory of an SM; each CTA also takes 1 KB of it
SWAP_SMEM = 113 * 1024  # decode: at least two CTAs per SM
DECODE_CTAS = {False: 1, True: 2}  # CTAs per SM the K splits aim at under swap-AB: H10, H7
SM_CTAS = 3  # CTAs an SM holds at most under swap-AB: 8 warps of 70-90 registers
H7_CLUSTERS = (1, 2, 3, 4, 6, 8)  # H7's K splits at decode: its clusters of 5 and 7 ran slower (gemm_sweep)
_BARS, _COLS, _ALIGN = (2 * MAX_STAGES + 2 * 4) * 8, 256 * 4, 1024


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclass(frozen=True)
class GemmPlan:
    """How gemm_sm90.cuh runs one (M, N, K) product: the orientation, wgmma's
    n, the consumer warpgroups, the output tile per CTA, the K splits (the
    CTAs of one cluster), the ring's stages and the shared memory they take."""

    swap_ab: bool
    nt: int
    wgs: int
    tile_m: int
    tile_n: int
    splits: int
    stages: int
    k_tiles: int
    grid: Tuple[int, int, int]  # (splits, N tiles, M tiles)
    smem: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def k_rows(self, z: int, k: int) -> Tuple[int, int]:
        """The K rows [k0, k1) that split z sums (the kernel's own formula)."""
        return min(k, self.k_tiles * z // self.splits * BK), min(k, self.k_tiles * (z + 1) // self.splits * BK)


def _wave_share(ctas: int) -> float:
    """The share of the last wave's SM slots that CTAs fill, one CTA an SM."""
    return ctas / (-(-ctas // SMS) * SMS)


def gemm_plan(m: int, n: int, k: int, int8: bool, splits: Optional[int] = None,
              stages: Optional[int] = None) -> GemmPlan:
    """The launch plan of H10 (int8=False) or H7 (int8=True) for x (M, K) @
    W (K, N), from tools/gemm_sweep.py's times on an H100.
    M <= DECODE_M: swap-AB, n = M rounded up within SWAP_NT, one consumer
    warpgroup, 64 columns of N per CTA; the K splits (H7: the next size in
    H7_CLUSTERS) give DECODE_CTAS[int8] CTAs per SM (H10's CTAs stream the
    weight at what an SM takes; H7's are bound by their converter warps, so
    two of them run side by side).
    Above: two consumer warpgroups, 256 rows by 128 columns (each int8 W
    element H7 converts serves 256 rows); the fewest K splits (up to 4) whose
    CTAs fill the last wave to 80%. Every split keeps two stages of K, at
    most MAX_CLUSTER. The stages: at most the k tiles of a split; of those
    that fit, the count that runs the CTAs in the fewest waves, then the
    most. `splits` and `stages` override the choice."""
    swap = m <= DECODE_M
    k_tiles = -(-k // BK)
    if swap:
        nt = next(v for v in SWAP_NT if v >= m)
        wgs, tile_m, tile_n = 1, nt, 64
    else:
        nt, wgs, tile_m, tile_n = 128, 2, 256, 128
    tiles = -(-n // tile_n) * -(-m // tile_m)
    most = max(1, min(MAX_CLUSTER, k_tiles // 2))
    if splits is None and swap:
        want = min(most, -(-DECODE_CTAS[int8] * SMS // tiles))
        sizes = [c for c in (H7_CLUSTERS if int8 else range(1, MAX_CLUSTER + 1)) if c <= most]
        splits = next((c for c in sizes if c >= want), sizes[-1])
    elif splits is None:
        splits = next((c for c in range(1, min(most, 4) + 1) if _wave_share(tiles * c) >= 0.8), 1)
    # the ring's stage (x tile + the W tile as TMA lands it), H7's bf16 W tiles, the fp32 tile over them
    stage = tile_m * 128 + tile_n * BK * (1 if int8 else 2)
    conv = (4 if swap else 2) * tile_n * BK * 2 if int8 else 0
    staging = tile_m * (tile_n + (4 if swap else 8)) * 4
    smem = lambda st: max(st * stage + conv, staging) + _BARS + _COLS + _ALIGN
    if stages is None:
        budget = SWAP_SMEM if swap else SMEM_LIMIT
        top = min(MAX_STAGES, max(2, -(-k_tiles // splits)))
        fits = [st for st in range(2, top + 1) if smem(st) <= budget] or [2]
        ctas = splits * tiles
        # the fewest waves of CTAs (as many to an SM as its shared memory holds, at most SM_CTAS), then the
        # most stages
        stages = min(fits, key=lambda st: (-(-ctas // (SMS * min(SM_CTAS, SM_SMEM // (smem(st) + 1024)))), -st))
    return GemmPlan(swap, nt, wgs, tile_m, tile_n, splits, stages, k_tiles,
                    (splits, -(-n // tile_n), -(-m // tile_m)), smem(stages))


def launch_plan(m: int, n: int, k: int) -> GemmPlan:
    """H10's launch plan (bf16 weight)."""
    return gemm_plan(m, n, k, int8=False)


def stream_matmul(
    x: torch.Tensor,  # (M, K) bf16, unit column stride
    w: torch.Tensor,  # (L, K, N) bf16: the full stack
    li: int,
    ln_w: Optional[torch.Tensor] = None,  # (L, K) bf16: fuse rms_norm(x, ln_w[li])
    bias: Optional[torch.Tensor] = None,  # (L, N) bf16: + bias[li]
    eps: float = 1e-6,
    plan: Optional[GemmPlan] = None,  # launch_plan(M, N, K) unless given
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
    xn = torch.empty((m, k), dtype=torch.bfloat16, device=x.device) if ln_w is not None else None  # normalised rows
    ptr = lambda t: None if t is None else t.data_ptr()
    pl = plan or launch_plan(m, n, k)
    lib = load_library()
    rc = lib.padt_stream_matmul(
        x.data_ptr(), x.stride(0), w.data_ptr(), ptr(ln_w), ptr(bias), out.data_ptr(), ptr(xn),
        m, n, k, nl, int(li), float(eps), int(pl.swap_ab), pl.nt, pl.splits, pl.stages, _stream(x),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out
