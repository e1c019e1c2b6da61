"""The launch plans of H10 (`cuda_matmul.launch_plan`) and H7
(`cuda_quant.launch_plan`), both `cuda_matmul.gemm_plan`: pure Python, so
they are checked here on the CPU at every shape the main paths give the two
kernels (PaDT-3B's four decode products at M = 96 through H10; PaDT-7B's at
M = 4 and 8, decode, and 2560, a prefill bucket of 4 x 640, through H7) and
at the card tests' shapes (tests/test_torch_kernels.py): the K splits cover
every K row exactly once, a cluster holds at most 8 CTAs, swap-AB is taken
exactly at M <= DECODE_M, every decode shape gives every SM a CTA, and the
shared memory the plan asks for fits a block."""

import pytest

from padt_tpu_torch import padt_3b, padt_7b
from padt_tpu_torch.ops import cuda_matmul as CM
from padt_tpu_torch.ops import cuda_quant as Q


def _products(text):
    """(name, K, N) of a text layer's four products."""
    h, hd = text.hidden_size, text.head_dim
    return [
        ("qkv", h, (text.num_attention_heads + 2 * text.num_key_value_heads) * hd),
        ("o", text.num_attention_heads * hd, h),
        ("gate-up", h, 2 * text.intermediate_size),
        ("down", text.intermediate_size, h),
    ]


# (kernel, M, K, N, on a decode path)
PATH_SHAPES = [("H10", 96, k, n, True) for _, k, n in _products(padt_3b().text)] + [
    ("H7", m, k, n, m <= 8) for m in (4, 8, 2560) for _, k, n in _products(padt_7b().text)
]
# the card tests' (M, K, N) of test_int8_matmul_matches_plain / test_stream_matmul_matches_plain
CARD_H7 = [(1, 96, 64), (7, 96, 96), (65, 160, 96), (130, 128, 320), (8, 3584, 3584), (256, 3584, 4608),
           (300, 200, 48), (128, 512, 320), (129, 512, 320), (8, 4096, 1024), (8, 512, 1024), (8, 256, 1024),
           (8, 64, 1024), (8, 1000, 1008), (4, 3584, 4608)]
CARD_H10 = [(96, 2048, 2560), (96, 2048, 2048), (96, 2048, 22016), (96, 11008, 2048), (5, 96, 256),
            (130, 160, 96), (300, 200, 48), (128, 512, 320), (129, 512, 320), (8, 4096, 1024), (8, 512, 1024),
            (8, 256, 1024), (8, 64, 1024), (96, 1000, 1000)]
SHAPES = PATH_SHAPES + [("H7", m, k, n, False) for m, k, n in CARD_H7] + [("H10", m, k, n, False) for m, k, n in CARD_H10]


def _plan(kernel, m, n, k):
    return (Q.launch_plan if kernel == "H7" else CM.launch_plan)(m, n, k)


@pytest.mark.parametrize("kernel,m,k,n,decode", SHAPES)
def test_plan_covers_k_once_in_small_clusters(kernel, m, k, n, decode):
    p = _plan(kernel, m, n, k)
    assert 1 <= p.splits <= CM.MAX_CLUSTER and p.grid[0] == p.splits
    assert p.k_tiles == -(-k // CM.BK) and p.k_tiles >= p.splits
    covered = [0] * k
    for z in range(p.splits):
        k0, k1 = p.k_rows(z, k)
        assert k0 < k1, f"split {z} sums no K row"
        for r in range(k0, k1):
            covered[r] += 1
    assert covered == [1] * k
    assert p.grid[1] * p.tile_n >= n and p.grid[2] * p.tile_m >= m  # every output element has a CTA
    assert 2 <= p.stages <= CM.MAX_STAGES and p.smem <= CM.SMEM_LIMIT


@pytest.mark.parametrize("kernel,m,k,n,decode", SHAPES)
def test_plan_orientation_and_decode_fill(kernel, m, k, n, decode):
    p = _plan(kernel, m, n, k)
    assert p.swap_ab == (m <= CM.DECODE_M)
    if p.swap_ab:  # the decode rows are wgmma's n: one M tile, n the smallest instance that holds M
        assert p.nt in CM.SWAP_NT and p.nt >= m and p.grid[2] == 1 and p.tile_m == p.nt
        assert p.tile_n == 64 and p.wgs == 1
        assert all(v < m for v in CM.SWAP_NT if v < p.nt)
        assert p.smem <= CM.SWAP_SMEM  # two CTAs per SM
    else:
        assert (p.nt, p.wgs, p.tile_m, p.tile_n) == (128, 2, 256, 128)
    if decode:
        assert p.ctas >= CM.SMS, f"{p.ctas} CTAs leave SMs idle"


def test_plans_of_the_two_kernels_at_decode():
    """At decode H7 and H10 take the same orientation and tile; H7 splits K
    into at least as many CTAs (its CTAs are bound by their converter warps,
    so more of them run side by side)."""
    for _, m, k, n, _ in PATH_SHAPES:
        if m > CM.DECODE_M:
            continue
        a, b = CM.launch_plan(m, n, k), Q.launch_plan(m, n, k)
        assert (a.swap_ab, a.nt, a.tile_m, a.tile_n) == (b.swap_ab, b.nt, b.tile_m, b.tile_n)
        assert a.ctas <= b.ctas
