"""Host-side M-RoPE 3D position-id computation (the port's copy of
`padt_tpu/models/mrope_index.py`).

Reimplements the semantics of Qwen2.5-VL `get_rope_index` (used by the
reference at `padt.py:256-277`): text spans advance all three (t/h/w) position
streams together; each image span gets t=const, h=row, w=col offset from the
current text position; the following text resumes at max(position)+1.

Computed once per batch on the host in numpy (the reference computes it once at
prefill too). One visual (image OR video) per sample — the reference trainer
asserts one image per sample (`padt_sft_trainer.py:341`); pure-text samples are
supported. Video spans get the Qwen2.5 time-aligned t stream:
`t_index = floor(frame_grid_index * second_per_grid_t * tokens_per_second)`
(transformers Qwen2_5_VLModel.get_rope_index video branch).

Returns (position_ids (3, B, L) int32, rope_deltas (B,) int32) where
`decode position = prefill_len + step + rope_delta` (padt.py:267-277).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,  # (B, L) int
    attention_mask: np.ndarray,  # (B, L) {0,1}
    grid_thw: Optional[np.ndarray],  # (B, 3) or None; rows may be all-zero (no image)
    image_token_id: int,
    spatial_merge_size: int = 2,
    video_token_id: Optional[int] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,  # (B,); 0 for images
    tokens_per_second: float = 2.0,  # Qwen2.5-VL vision_config.tokens_per_second
) -> Tuple[np.ndarray, np.ndarray]:
    b, l = input_ids.shape
    position_ids = np.ones((3, b, l), dtype=np.int32)
    rope_deltas = np.zeros((b,), dtype=np.int32)

    for i in range(b):
        mask = attention_mask[i].astype(bool)
        ids = input_ids[i][mask]
        n = ids.shape[0]
        pos_chunks = []
        st = 0
        st_idx = 0
        is_vis = ids == image_token_id
        if video_token_id is not None:
            is_vis = is_vis | (ids == video_token_id)
        has_image = grid_thw is not None and grid_thw[i].prod() > 0 and is_vis.any()
        if has_image:
            t, h, w = (int(x) for x in grid_thw[i])
            llm_t, llm_h, llm_w = t, h // spatial_merge_size, w // spatial_merge_size
            ed = int(np.argmax(is_vis))  # first image/video pad
            text_len = ed - st
            if text_len > 0:
                rng = np.arange(text_len, dtype=np.int32) + st_idx
                pos_chunks.append(np.stack([rng, rng, rng]))
            base = st_idx + text_len
            spg = float(second_per_grid_ts[i]) if second_per_grid_ts is not None else 0.0
            if video_token_id is not None and ids[ed] == video_token_id and spg > 0:
                # time-aligned temporal positions (video): frame k of the grid
                # sits at floor(k * seconds_per_grid * tokens_per_second).
                # Quirk parity: transformers casts second_per_grid_t to the
                # integer dtype of range_tensor BEFORE multiplying
                # (modeling_qwen2_5_vl.py:1093-1100), truncating fractional
                # seconds — replicated so position ids match bit-for-bit.
                t_vals = (
                    np.arange(llm_t, dtype=np.int64) * int(spg) * tokens_per_second
                ).astype(np.int32)
            else:
                t_vals = np.arange(llm_t, dtype=np.int32)
            t_idx = np.repeat(t_vals, llm_h * llm_w)
            h_idx = np.tile(np.repeat(np.arange(llm_h, dtype=np.int32), llm_w), llm_t)
            w_idx = np.tile(np.arange(llm_w, dtype=np.int32), llm_t * llm_h)
            pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + base)
            st = ed + llm_t * llm_h * llm_w
            st_idx = int(pos_chunks[-1].max()) + 1
        text_len = n - st
        if text_len > 0:
            rng = np.arange(text_len, dtype=np.int32) + st_idx
            pos_chunks.append(np.stack([rng, rng, rng]))
        pos = np.concatenate(pos_chunks, axis=1) if pos_chunks else np.zeros((3, 0), np.int32)
        position_ids[:, i, mask] = pos
        rope_deltas[i] = (int(pos.max()) + 1 - l) if pos.size else -l
    return position_ids, rope_deltas
