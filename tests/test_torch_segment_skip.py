"""H2's segment-tile skip on the CPU.

(a) `segment_tiles_plain`, the rule H2's producer warp applies at 128 x 128
tiles, at blocks of 64 and 128 on seeded layouts (causal left padding,
packed multi-segment rows, the vision window slots): every visible (query,
key) pair lies in a live tile, and every live tile lies in the k-block range
[lo, hi) of JAX's `_kblock_ranges` at the same blocks.

(a') the same rule for the backward kernels: H8 visits the key tiles of 64
of each query tile of 128, H9 the transpose, the query tiles of 64 of each
key tile of 128 from the causal diagonal on. At those tiles every visible
pair lies in a visited tile; at equal blocks of 64 and 128 (the only ones
`_flash_bwd_pallas` uses) every visited tile also lies in the range it
loops over: `_kblock_ranges(q_seg, k_seg, ...)` for dq, the transposed
`_kblock_ranges(k_seg, q_seg, ...)` with the causal lower bound for dk / dv.

(b) `segment_flash_fwd` on CPU tensors (its plain twin) against JAX's
`flash_attention` (Pallas in TPU interpret mode) on the window-slot layout at
hd 80, float32: 1e-5 relative to the largest output (only the order of sums
differs)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import close, jax_mode
from padt_tpu.ops import pallas_attention as JPA
from padt_tpu_torch.models.vision_geom import vision_geometry
from padt_tpu_torch.ops import cuda_attention as C


def _layout(kind: str, seed: int):
    """(seg (B, S) int32, causal)."""
    r = np.random.RandomState(seed)
    if kind == "left_pad":  # a causal prefill bucket, rows left-padded
        seg = np.zeros((3, 640), np.int32)
        for i, pad in enumerate(r.randint(0, 300, 3)):
            seg[i, :pad] = -1
        if seed % 2:
            seg[2] = -1  # a row that is all padding
        return seg, True
    if kind == "packed":  # several sequences per row, then padding
        seg = np.sort(r.randint(0, 6, (2, 768)), axis=1).astype(np.int32)
        seg[:, 768 - r.randint(1, 200) :] = -1
        return seg, seed % 2 == 0
    grids = {"windows": [(1, 20, 28), (1, 14, 14)], "windows_3b": [(1, 46, 46)] * 2}[kind]
    geo = vision_geometry(grids, 768 if kind == "windows" else 2304)
    assert geo.pack_index is not None
    return geo.seg_win, False


@pytest.mark.parametrize("kind,seed", [("left_pad", 0), ("left_pad", 1), ("packed", 2), ("packed", 3),
                                       ("windows", 0), ("windows_3b", 0)])
@pytest.mark.parametrize("blk", [64, 128])
def test_skip_rule_covers_visible_pairs_within_jax_ranges(kind, seed, blk):
    seg, causal = _layout(kind, seed)
    live = C.segment_tiles_plain(torch.as_tensor(seg), torch.as_tensor(seg), blk, blk, causal).numpy()
    b, s = seg.shape
    n = s // blk
    assert live.shape == (b, n, n)

    vis = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
    if causal:
        vis &= np.tril(np.ones((s, s), bool))[None]
    tile_has_pair = vis.reshape(b, n, blk, n, blk).any(axis=(2, 4))
    assert not (tile_has_pair & ~live).any(), "a visible pair lies in a skipped tile"

    lo, hi = (np.asarray(x) for x in JPA._kblock_ranges(jnp.asarray(seg), jnp.asarray(seg), blk, blk, causal))
    kb = np.arange(n)[None, None, :]
    in_range = (kb >= lo[:, :, None]) & (kb < hi[:, :, None])
    assert not (live & ~in_range).any(), "a live tile lies outside JAX's [lo, hi)"

    if kind.startswith("windows"):  # the skip's point: a query tile of window slots visits its own tile only
        assert live.sum(-1).max() == 1 and (live.sum(-1) == 1).sum() >= b * n // 2


@pytest.mark.parametrize("kind,seed", [("left_pad", 0), ("left_pad", 1), ("packed", 2), ("packed", 3),
                                       ("windows", 0), ("windows_3b", 0)])
@pytest.mark.parametrize("blk_q,blk_k", [(128, 64), (64, 128), (64, 64), (128, 128)])
def test_backward_skip_rules_cover_visible_pairs_within_jax_ranges(kind, seed, blk_q, blk_k):
    seg, causal = _layout(kind, seed)
    b, s = seg.shape
    nq, nk = s // blk_q, s // blk_k
    live = C.segment_tiles_plain(torch.as_tensor(seg), torch.as_tensor(seg), blk_q, blk_k, causal).numpy()
    assert live.shape == (b, nq, nk)
    vis = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
    if causal:
        vis &= np.tril(np.ones((s, s), bool))[None]
    tile_has_pair = vis.reshape(b, nq, blk_q, nk, blk_k).any(axis=(2, 4))
    assert not (tile_has_pair & ~live).any(), "a visible pair lies in a skipped tile"
    visits = live.transpose(0, 2, 1)  # H9: (B, key tiles, query tiles)
    qb = np.arange(nq)[None, None, :]
    if causal:  # H9 starts at the key tile's diagonal query tile
        assert not (visits & (qb < ((np.arange(nk) * blk_k) // blk_q)[None, :, None])).any()
    if blk_q != blk_k:
        return

    # H8 (dq): key tiles per query tile, inside _bwd_dq_kernel's [lo, hi)
    lo, hi = (np.asarray(x) for x in JPA._kblock_ranges(jnp.asarray(seg), jnp.asarray(seg), blk_q, blk_k, causal))
    kb = np.arange(nk)[None, None, :]
    assert not (live & ~((kb >= lo[:, :, None]) & (kb < hi[:, :, None]))).any(), "H8 visits a tile outside [lo, hi)"

    # H9 (dk, dv): query tiles per key tile, inside _bwd_dkv_kernel's [qlo, qhi)
    qlo, qhi = (np.asarray(x) for x in JPA._kblock_ranges(jnp.asarray(seg), jnp.asarray(seg), blk_k, blk_q, False))
    if causal:
        qlo = np.maximum(qlo, (np.arange(nk) * blk_k) // blk_q)
    assert not (visits & ~((qb >= qlo[:, :, None]) & (qb < qhi[:, :, None]))).any(), "H9 visits a tile outside [qlo, qhi)"


def test_skip_rule_query_tiles_with_no_valid_row_visit_nothing():
    seg = torch.full((2, 256), -1, dtype=torch.int32)
    seg[1, 200:] = 0
    live = C.segment_tiles_plain(seg, seg, 128, 128, True)
    assert not live[0].any() and not live[1, 0].any() and live[1, 1, 1] and not live[1, 1, 0]


def test_segment_flash_twin_matches_jax_on_window_slots():
    seg, _ = _layout("windows", 0)
    b, s = seg.shape
    h, hd = 2, 80
    r = np.random.RandomState(5)
    q, k, v = (r.randn(b, s, h, hd).astype(np.float32) for _ in range(3))
    scale = hd**-0.5
    with jax_mode("pallas"):
        ref = JPA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), jnp.asarray(seg),
                                  False, scale)
    T = torch.as_tensor
    out = C.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), False, scale)
    assert out.shape == (b, s, h, hd) and out.dtype == torch.float32
    close(out, np.asarray(ref))
    assert float(out[torch.as_tensor(seg) < 0].abs().max()) == 0.0  # pad rows see no key
