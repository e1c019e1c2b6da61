"""H11, the grouped expert GEMM's Hopper kernel, and its wrapper.

| wrapper         | CUDA source             | replaces                                  |
|-----------------|-------------------------|-------------------------------------------|
| `expert_matmul` | csrc/expert_matmul.cu   | none: the JAX package has no MoE layer    |

Added for the sparse-expert text stacks (Keye-VL-2.0-30B-A3B: 128 experts
of width 768, 8 a token): no other kernel multiplies each token by a
device-chosen subset of E weight matrices (H7 and H10 multiply one matrix
a layer). The choices arrive grouped by expert (`ops.moe.group`): expert
e's rows are [ends[e-1], ends[e]). The kernel is gemm_sm90.cuh's mainloop
(wgmma on a TMA ring) on a static grid, so that a CUDA graph holds it:
(column tiles, `max_tiles` row tiles). Each CTA finds its expert and rows
from the counts in device memory; a CTA past the last tile, and so every
tile of an expert that got no rows, exits before it reads a weight.

What bounds it: at decode (a few rows an expert) the expert weights'
bytes, 9.44 MB an expert that any token chose; there it goes swap-AB
(`expert_plan`: the weight's 64 columns are wgmma's rows, an expert's rows
its n), so each expert's weights stream once. At prefill (some 160 rows an
expert for a bucket of 2560 tokens) the operations: 256 x 128 tiles. The
gate-up product computes the gate and the up columns of one output tile
together and writes silu(gate) * up (the SwiGLU fused into its epilogue);
its A rows are the choices' token rows, gathered in expert order first
(TMA reads whole tiles). The down product scales each row by its routing
weight and writes it at the choice's own place, so the combine is a sum
over a token's k rows in fixed order: no atomics, and a replay equals an
eager step bit for bit.

The wrapper takes CUDA tensors only (`ops.moe.expert_matmul` sends CPU
tensors to the plain twin), checks them, allocates the output, launches on
the current stream by its launch plan, raises on a CUDA error code, and
adds one to `launch_counts["expert_matmul"]`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._build import check, load_library
from .cuda_attention import SMEM_LIMIT, _no_graph_cut, _require, _same_device, _stream
from .cuda_matmul import BK, MAX_STAGES, SWAP_SMEM

launch_counts = {"expert_matmul": 0}
TALLIES = (launch_counts,)

SWAP_NT = (8, 16, 32, 64)  # wgmma's n under swap-AB (decode, at most 64 tokens): the tokens rounded up
PREFILL_ROWS = 256  # choices a CTA at prefill
_BARS, _INFO, _ALIGN = 2 * MAX_STAGES * 8, 16, 1024


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclass(frozen=True)
class ExpertPlan:
    """How csrc/expert_matmul.cu runs one product: swap-AB or not, wgmma's
    n, the choices (tile_m) and output columns (tile_n) of a CTA, the
    ring's stages, and the static grid (column tiles, row tiles)."""

    swap: bool
    nt: int
    tile_m: int
    tile_n: int
    stages: int
    grid: tuple


def max_tiles(n_rows: int, n_experts: int, tile_m: int) -> int:
    """The most row tiles that n_rows choices over n_experts experts can
    need: sum over experts of ceil(rows / tile_m), with at most min(E, N)
    experts holding rows."""
    return (n_rows + min(n_experts, n_rows) * (tile_m - 1)) // tile_m


def expert_plan(tokens: int, k: int, n_experts: int, k_dim: int, n_cols: int, gated: bool) -> ExpertPlan:
    """The plan for a product over `tokens` tokens of `k` choices each, a
    weight (E, K, n_cols). Swap-AB where a call holds at most 64 tokens,
    with n the tokens rounded up within SWAP_NT, so that one tile holds
    every row of an expert (no expert holds more rows than there are
    tokens) and its weights stream once; 64 output columns a CTA (their gate
    and up chunks for gate-up). Above: 256 x 128 tiles (64 output columns
    for gate-up: their gate and up chunks side by side). The stages: as many
    as fit, at most the k tiles, in SWAP_SMEM under swap-AB (two CTAs an
    SM), else in the block's limit."""
    swap = tokens <= SWAP_NT[-1]
    out_cols = n_cols // 2 if gated else n_cols
    if swap:
        nt = next(v for v in SWAP_NT if v >= tokens)
        tile_m, tile_n, chunks = nt, 64, 2 if gated else 1
    else:
        nt, tile_m, tile_n, chunks = 128, PREFILL_ROWS, 64 if gated else 128, 2
    stage = tile_m * 128 + chunks * BK * 128
    smem = lambda st: st * stage + _BARS + _INFO + _ALIGN
    budget = SWAP_SMEM if swap else SMEM_LIMIT
    k_tiles = -(-k_dim // BK)
    stages = max([st for st in range(2, max(2, min(MAX_STAGES, k_tiles)) + 1) if smem(st) <= budget] or [2])
    grid = (-(-out_cols // tile_n), max_tiles(tokens * k, n_experts, tile_m))
    return ExpertPlan(swap, nt, tile_m, tile_n, stages, grid)


def expert_matmul(a: torch.Tensor, w: torch.Tensor, g, mode: str) -> torch.Tensor:
    """H11 on CUDA tensors: `ops.moe.expert_matmul_plain`'s function, bf16
    in and out, the sums in float32. a: (T, K) token rows ("gateup") or
    (N, K) rows in expert order ("down"); w: (E, K, 2F) or (E, K, D); g:
    `ops.moe.Groups` of the N = T x k choices."""
    name = "expert_matmul"
    _require(name, a.device.type == "cuda", f"H11 runs on CUDA tensors, got {a.device}")
    _same_device(name, a.device, w, g.src, g.dst, g.scale, g.ends)
    _no_graph_cut(name, a, w, hint="H11 has no backward: run it under torch.no_grad() or on detached tensors")
    _require(name, a.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
             f"a and w must be bf16, got {a.dtype} and {w.dtype}")
    _require(name, a.dim() == 2 and a.is_contiguous(), f"a must be a contiguous (rows, K) matrix, got {tuple(a.shape)}")
    _require(name, w.dim() == 3 and w.is_contiguous(), f"w must be a contiguous (E, K, N) stack, got {tuple(w.shape)}")
    n_experts, k_dim, n_cols = w.shape
    n = g.src.numel()
    gated = mode == "gateup"
    _require(name, a.shape[1] == k_dim, f"a has {a.shape[1]} columns for K = {k_dim}")
    _require(name, k_dim % 8 == 0 and n_cols % 16 == 0, f"K = {k_dim} must be a multiple of 8, N = {n_cols} of 16")
    _require(name, g.ends.shape == (n_experts,) and g.ends.dtype == torch.int32, "ends must be (E,) int32")
    _require(name, g.dst.dtype == torch.int32 and g.scale.dtype == torch.float32, "dst must be int32, scale fp32")
    _require(name, gated or a.shape[0] == n, f"down: a needs the {n} choices' rows, got {a.shape[0]}")
    if gated:
        a = a.index_select(0, g.src)  # the choices' token rows in expert order
    pl = expert_plan(n // g.k, g.k, n_experts, k_dim, n_cols, gated)
    # gate-up: rows in expert order; down: at dst, a permutation of 0..N-1
    out = torch.empty((n, n_cols // 2 if gated else n_cols), dtype=torch.bfloat16, device=a.device)
    lib = load_library()
    rc = lib.padt_expert_matmul(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), g.ends.data_ptr(), g.dst.data_ptr(), g.scale.data_ptr(),
        n, k_dim, n_cols, n_experts, int(gated), int(pl.swap), pl.nt, pl.stages, pl.grid[1], _stream(a),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out
