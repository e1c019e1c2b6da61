"""Qwen2.5-VL vision tower (port of `padt_tpu/models/vision.py`).

patch embed -> window reorder -> depth blocks (windowed or full attention,
chosen per layer from `fullatt_block_indexes`) -> merger. Returns the PaDT
triple: (merged raster order, high_res window order, (cos, sin) window
order). Parameters are the JAX tree's stacked (depth, in, out) weights,
applied as `x @ w`. Heads keep their real width (80 at 3B): there is no
128-lane head padding on this card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import VisionConfig
from ..ops.attention import fused_vision_attention_qkv, window_attention_qkv
from ..ops.norms import rms_norm
from ..ops.rope import vision_rope_cos_sin
from .params import normal, ones, zeros

_WIN_TOKENS = 64  # one vision window slot: (112px / 14px)^2 patch tokens


def init_vision_params(cfg: VisionConfig, generator: torch.Generator, device, dtype):
    """Random init with the JAX tree's keys, shapes and dtypes."""
    d, ff, depth = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    merged_dim = d * cfg.spatial_merge_unit
    g = lambda *shape: normal(generator, shape, device, dtype)
    blocks = {
        "norm1_w": ones((depth, d), device, dtype),
        "norm2_w": ones((depth, d), device, dtype),
        "qkv_w": g(depth, d, 3 * d),
        "qkv_b": zeros((depth, 3 * d), device, dtype),
        "proj_w": g(depth, d, d),
        "proj_b": zeros((depth, d), device, dtype),
        "gate_w": g(depth, d, ff),
        "gate_b": zeros((depth, ff), device, dtype),
        "up_w": g(depth, d, ff),
        "up_b": zeros((depth, ff), device, dtype),
        "down_w": g(depth, ff, d),
        "down_b": zeros((depth, d), device, dtype),
    }
    return {
        "patch_embed": {"w": g(cfg.patch_input_dim, d)},
        "blocks": blocks,
        "merger": {
            "ln_q_w": ones((d,), device, dtype),
            "fc1": {"w": g(merged_dim, merged_dim), "b": zeros((merged_dim,), device, dtype)},
            "fc2": {"w": g(merged_dim, cfg.out_hidden_size), "b": zeros((cfg.out_hidden_size,), device, dtype)},
        },
    }


def _take_groups(t: torch.Tensor, index: torch.Tensor, unit: int) -> torch.Tensor:
    """Gather merge groups of `unit` consecutive tokens: (B, S, C) by a
    (B, M) group index -> (B, S, C)."""
    b, s, c = t.shape
    m = s // unit
    idx = index.long()[:, :, None, None].expand(b, m, unit, c)
    return torch.gather(t.reshape(b, m, unit, c), 1, idx).reshape(b, s, c)


def _block(x, lp, cos, sin, seg, cfg: VisionConfig, windowed: bool):
    h, hd = cfg.num_heads, cfg.head_dim
    xn = rms_norm(x, lp["norm1_w"], cfg.rms_norm_eps)
    qkv = xn @ lp["qkv_w"] + lp["qkv_b"]  # (B, S, 3*H*hd), pre-rope
    attn_fn = window_attention_qkv if windowed else fused_vision_attention_qkv
    attn = attn_fn(qkv, cos, sin, seg, h, scale=1.0 / (hd**0.5), rope_dim=hd)
    x = x + (attn @ lp["proj_w"] + lp["proj_b"])
    xn = rms_norm(x, lp["norm2_w"], cfg.rms_norm_eps)
    gate = F.silu(xn @ lp["gate_w"] + lp["gate_b"])
    up = xn @ lp["up_w"] + lp["up_b"]
    return x + (gate * up) @ lp["down_w"] + lp["down_b"]


def vision_forward(
    params,
    cfg: VisionConfig,
    pixels: torch.Tensor,  # (B, S, patch_input_dim)
    window_index: torch.Tensor,  # (B, M)
    inv_window_index: torch.Tensor,  # (B, M)
    seg_win: torch.Tensor,  # (B, S) int32
    seg_full: torch.Tensor,  # (B, S) int32
    hpos: torch.Tensor,  # (B, S)
    wpos: torch.Tensor,  # (B, S)
    remat: bool = False,
    pack_index: Optional[torch.Tensor] = None,  # (B, M) slot -> packed (slot layout)
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (merged (B, M, out) raster order, high_res (B, S, D) window
    order, (cos, sin) (B, S, head_dim) window order).

    `pack_index` given => the 64-token window-slot layout: windowed layers
    run the per-slot kernel, and high_res/cos/sin are gathered back to the
    packed window order before returning (the decoder's contract).
    remat: with grad mode on, each block runs under a non-reentrant
    `torch.utils.checkpoint` (JAX's `jax.checkpoint` of the scan body), so
    the backward keeps only the blocks' inputs and recomputes one block at
    a time."""
    b, s, _ = pixels.shape
    unit = cfg.spatial_merge_unit
    m = s // unit
    w_embed = params["patch_embed"]["w"]
    x = pixels.to(w_embed.dtype) @ w_embed
    x = _take_groups(x, window_index, unit)
    cos, sin = vision_rope_cos_sin(hpos, wpos, cfg.head_dim)
    seg_win, seg_full = seg_win.to(torch.int32).contiguous(), seg_full.to(torch.int32).contiguous()

    blocks = params["blocks"]
    full = set(cfg.fullatt_block_indexes)
    slot_mode = pack_index is not None
    remat = remat and torch.is_grad_enabled()
    for li in range(cfg.depth):
        lp = {k: v[li] for k, v in blocks.items()}
        is_full = li in full
        seg = seg_full if is_full else seg_win
        args = (x, lp, cos, sin, seg, cfg, slot_mode and not is_full)
        x = checkpoint(_block, *args, use_reentrant=False) if remat else _block(*args)

    if slot_mode:
        high_res = _take_groups(x, pack_index, unit)
        cos, sin = _take_groups(cos, pack_index, unit), _take_groups(sin, pack_index, unit)
    else:
        high_res = x
    mp = params["merger"]
    y = rms_norm(x, mp["ln_q_w"], cfg.rms_norm_eps).reshape(b, m, unit * cfg.hidden_size)
    y = F.gelu(y @ mp["fc1"]["w"] + mp["fc1"]["b"], approximate="none")
    merged = y @ mp["fc2"]["w"] + mp["fc2"]["b"]  # (B, M, out) window order
    idx = inv_window_index.long()[:, :, None].expand(b, m, merged.shape[-1])
    merged = torch.gather(merged, 1, idx)
    return merged, high_res, (cos, sin)
