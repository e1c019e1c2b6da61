"""Host-side (numpy) geometry for the Qwen2.5-VL vision tower (the port's
copy of `padt_tpu/models/vision_geom.py`).

The reference computes window indices / cu_seqlens / rope positions inside the
model forward every call (`padt.py:60-87` via transformers `get_window_index` /
`rot_pos_emb`). On TPU these are pure index arithmetic on tiny arrays that would
force dynamic shapes under jit, so we precompute them per sample on the host and
pass static padded arrays into the jitted tower.

Exact order parity with the reference window shuffle is critical: the PaDT
decoder consumes `high_res_hidden_states` and `visual_pe` in WINDOW order
(`padt.py:101-106`) and the released checkpoints were trained with that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass
class VisionGeometry:
    """Static per-batch geometry, shapes padded to (B, S_max) / (B, M_max=S_max/4).

    All "token order" arrays are in the sequence order the vision blocks see:
    PACKED window order by default, or 64-token-aligned SLOT order when
    `pack_index` is set (see `vision_geometry(window_slots=...)`).
    """

    window_index: np.ndarray  # (B, M_max) int32 — merge-group gather: window<-raster
    inv_window_index: np.ndarray  # (B, M_max) int32 — raster<-window (argsort)
    seg_win: np.ndarray  # (B, S_max) int32 window id per token, -1 padding
    seg_full: np.ndarray  # (B, S_max) int32 frame id for valid tokens, -1 padding
    hpos: np.ndarray  # (B, S_max) int32 rope h position per token (window order)
    wpos: np.ndarray  # (B, S_max) int32 rope w position per token (window order)
    num_patches: np.ndarray  # (B,) int32 valid 14px-patch tokens
    num_merged: np.ndarray  # (B,) int32 valid merged patches
    grid_thw: np.ndarray  # (B, 3) int32
    # SLOT layout only (None in packed mode): merge-group gather from slot
    # order back to PACKED window order — the order the decoder contract
    # (high_res + visual PE pairs) is defined in.
    pack_index: "np.ndarray | None" = None


def _single_image_geometry(
    t: int,
    h: int,
    w: int,
    spatial_merge_size: int = 2,
    window_size: int = 112,
    patch_size: int = 14,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (window_index (M,), window_id_per_group (M,), hpos (S,), wpos (S,))
    for one image; token arrays are in window order.

    Replicates the reference padding-with-full-window quirk: when the grid is an
    exact multiple of the merger window, an entire pad window is appended and
    then dropped (transformers `get_window_index`; behavior kept so the
    resulting permutation is bit-identical).
    """
    m = spatial_merge_size
    unit = m * m
    llm_h, llm_w = h // m, w // m
    vit_ws = window_size // m // patch_size  # merger window size in merged units

    index = np.arange(t * llm_h * llm_w, dtype=np.int64).reshape(t, llm_h, llm_w)
    pad_h = vit_ws - llm_h % vit_ws
    pad_w = vit_ws - llm_w % vit_ws
    num_wh = (llm_h + pad_h) // vit_ws
    num_ww = (llm_w + pad_w) // vit_ws
    padded = np.full((t, llm_h + pad_h, llm_w + pad_w), -100, dtype=np.int64)
    padded[:, :llm_h, :llm_w] = index
    padded = padded.reshape(t, num_wh, vit_ws, num_ww, vit_ws)
    padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, num_wh * num_ww, vit_ws, vit_ws)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)  # merged patches per window
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]  # (M,)

    # window id per merge group, in window order (skipping empty windows is
    # irrelevant for segment ids — empty windows contribute no tokens)
    win_id_per_group = np.repeat(np.arange(seqlens.shape[0]), seqlens)

    # rope positions in pre-window ("merge-group raster") order (transformers
    # rot_pos_emb): positions arranged by 2x2 merge blocks
    hp = np.broadcast_to(np.arange(h, dtype=np.int64)[:, None], (h, w))
    hp = hp.reshape(llm_h, m, llm_w, m).transpose(0, 2, 1, 3).reshape(-1)
    wp = np.broadcast_to(np.arange(w, dtype=np.int64)[None, :], (h, w))
    wp = wp.reshape(llm_h, m, llm_w, m).transpose(0, 2, 1, 3).reshape(-1)
    hp = np.tile(hp, t)
    wp = np.tile(wp, t)

    # apply window reorder at merge-group granularity
    hp = hp.reshape(-1, unit)[window_index].reshape(-1)
    wp = wp.reshape(-1, unit)[window_index].reshape(-1)
    return (
        window_index.astype(np.int32),
        win_id_per_group.astype(np.int32),
        hp.astype(np.int32),
        wp.astype(np.int32),
        seqlens.astype(np.int32),  # merge groups per window (zeros included)
    )


def vision_geometry(
    grid_thw: Sequence[Tuple[int, int, int]],
    max_patches: int,
    spatial_merge_size: int = 2,
    window_size: int = 112,
    patch_size: int = 14,
    window_slots: "bool | str" = "auto",
) -> VisionGeometry:
    """Batched, padded geometry for one image per sample.

    `window_slots`: lay tokens out in 64-token-ALIGNED window slots instead of
    packing windows back to back. Every (nonempty) window w occupies slots
    [w*64, w*64+len_w); pad slots carry seg=-1. Windowed attention layers then
    need only their own diagonal 64-block — no cross-window masking, ~12x less
    score work per 768-token tile (ops/pallas_attention.py window kernel). The
    un-permute (`inv_window_index`) and the PACK gather (`pack_index`, slot ->
    packed window order) restore the reference layer contracts exactly, so the
    layout is invisible outside `vision_forward`. "auto": use slots whenever
    every sample's windows fit the bucket (n_windows*64 <= max_patches).
    """
    unit = spatial_merge_size * spatial_merge_size
    assert max_patches % unit == 0
    b = len(grid_thw)
    m_max = max_patches // unit
    vit_ws = window_size // spatial_merge_size // patch_size
    wg = vit_ws * vit_ws  # merge groups per full window (16 -> 64 tokens)

    geo = []
    for (t, h, w) in grid_thw:
        n = t * h * w
        if n == 0:
            geo.append(None)
            continue
        if n > max_patches:
            raise ValueError(f"image with {n} patches exceeds bucket {max_patches}")
        geo.append(_single_image_geometry(t, h, w, spatial_merge_size, window_size, patch_size))

    if window_slots == "auto":
        ok = True
        for g in geo:
            if g is None:
                continue
            n_win = int((g[4] > 0).sum())
            if n_win * wg > m_max:
                ok = False
                break
        window_slots = ok
    elif window_slots and any(
        g is not None and int((g[4] > 0).sum()) * wg > m_max for g in geo
    ):
        raise ValueError("window_slots layout does not fit the patch bucket")

    window_index = np.tile(np.arange(m_max, dtype=np.int32), (b, 1))
    inv_window_index = np.tile(np.arange(m_max, dtype=np.int32), (b, 1))
    pack_index = np.tile(np.arange(m_max, dtype=np.int32), (b, 1)) if window_slots else None
    seg_win = np.full((b, max_patches), -1, dtype=np.int32)
    seg_full = np.full((b, max_patches), -1, dtype=np.int32)
    hpos = np.zeros((b, max_patches), dtype=np.int32)
    wpos = np.zeros((b, max_patches), dtype=np.int32)
    num_patches = np.zeros((b,), dtype=np.int32)
    num_merged = np.zeros((b,), dtype=np.int32)
    grids = np.zeros((b, 3), dtype=np.int32)

    for i, ((t, h, w), g) in enumerate(zip(grid_thw, geo)):
        if g is None:  # text-only sample: all padding
            continue
        n = t * h * w
        nm = n // unit
        wi, win_id, hp, wp, seqlens = g
        hp4 = hp.reshape(nm, unit)
        wp4 = wp.reshape(nm, unit)

        if window_slots:
            # slot position per packed merge group: k-th nonempty window's
            # groups land at [k*wg, k*wg + len); window ORDER preserved
            nz = seqlens > 0
            slot_rank = np.cumsum(nz) - 1  # window id -> nonempty-window rank
            starts = np.cumsum(seqlens) - seqlens  # packed group start per window
            j = np.arange(nm)
            slot_of_group = (slot_rank[win_id] * wg + (j - starts[win_id])).astype(np.int32)
            window_index[i, slot_of_group] = wi
            inv_window_index[i, wi] = slot_of_group
            pack_index[i, :nm] = slot_of_group
            tok = (slot_of_group[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
            seg_win[i, tok] = np.repeat(win_id, unit)
            # frame id per token (window shuffle keeps frames contiguous)
            seg_full[i, tok] = np.repeat(np.repeat(np.arange(t, dtype=np.int32), h * w // unit)[wi], unit)
            hpos[i, tok] = hp4.reshape(-1)
            wpos[i, tok] = wp4.reshape(-1)
        else:
            window_index[i, :nm] = wi
            # padding groups gather from themselves (stay zeros)
            inv_window_index[i, :nm] = np.argsort(wi).astype(np.int32)
            seg_win[i, :n] = np.repeat(win_id, unit)
            # full-attention segments are PER FRAME (transformers builds fullatt
            # cu_seqlens as repeat_interleave(h*w, t)); window reorder keeps
            # frames contiguous (t is the outer dim of the window shuffle), so
            # raster frame spans remain valid in window order
            seg_full[i, :n] = np.repeat(np.arange(t, dtype=np.int32), h * w)
            hpos[i, :n] = hp
            wpos[i, :n] = wp
        num_patches[i] = n
        num_merged[i] = nm
        grids[i] = (t, h, w)

    return VisionGeometry(
        window_index=window_index,
        inv_window_index=inv_window_index,
        seg_win=seg_win,
        seg_full=seg_full,
        hpos=hpos,
        wpos=wpos,
        num_patches=num_patches,
        num_merged=num_merged,
        grid_thw=grids,
        pack_index=pack_index,
    )
