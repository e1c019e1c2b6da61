"""Qwen2.5-VL vision tower (port of `padt_tpu/models/vision.py`).

patch embed -> window reorder -> depth blocks (windowed or full attention,
chosen per layer from `fullatt_block_indexes`) -> merger. Returns the PaDT
triple: (merged raster order, high_res window order, (cos, sin) window
order). Parameters are the JAX tree's stacked (depth, in, out) weights,
applied as `x @ w`. Heads keep their real width (80 at 3B): there is no
128-lane head padding on this card.

For serving, `pack_vision_blocks` gives the blocks' MLP one packed layout
whose rows are 16-byte aligned (the tower's ff, 3420, is not a multiple of
8, so every GEMM over the plain layout ran a slow unaligned kernel); a block
given the packed leaves runs each product as one GEMM with its bias in the
epilogue and the SwiGLU as one kernel (H12). The plain layout (training,
the parity tests) runs as before.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import VisionConfig
from ..ops.attention import fused_vision_attention_qkv, window_attention_qkv
from ..ops.cuda_mlp import swiglu
from ..ops.norms import rms_norm
from ..ops.rope import vision_rope_cos_sin
from .params import normal, ones, zeros

_WIN_TOKENS = 64  # one vision window slot: (112px / 14px)^2 patch tokens
# the packed MLP's width: ff rounded up to a multiple of this, the least that aligns its rows (3420 -> 3424). At
# PaDT-3B's 4 x 2304 rows one block's packed MLP took 0.4135 ms at 3424 and 0.4141 ms at 3456 (NVIDIA H100 80GB
# HBM3, 700 W): the same library GEMM tiles run at either width, so the least padding is kept.
FF_MULTIPLE = 8


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


def packed_ff(ff: int, multiple: int = FF_MULTIPLE) -> int:
    """The packed MLP's width: ff rounded up to a multiple of `multiple`."""
    return -(-ff // multiple) * multiple


@torch.no_grad()
def pack_vision_blocks(blocks: Dict[str, torch.Tensor], multiple: int = FF_MULTIPLE) -> Dict[str, torch.Tensor]:
    """The blocks' MLP in its serving layout, at width F' = `packed_ff(ff)`:
    `gateup_w` (depth, d, 2F') = [gate | up], each half zero-padded from ff
    to F'; `gateup_b` (depth, 2F') likewise; `down_w` (depth, F', d) with
    zero rows appended. Exact: a padded unit's gate and up are 0, silu(0) *
    0 = 0, and its down row is 0. Idempotent (packed blocks come back as
    they are); the other leaves are shared with `blocks`, which is left as
    it was."""
    if "gateup_w" in blocks:
        return blocks
    out = dict(blocks)
    gate_w, up_w, down_w = out.pop("gate_w"), out.pop("up_w"), out.pop("down_w")
    gate_b, up_b = out.pop("gate_b"), out.pop("up_b")
    depth, d, ff = gate_w.shape
    fp = packed_ff(ff, multiple)
    gateup_w, gateup_b = gate_w.new_zeros((depth, d, 2 * fp)), gate_b.new_zeros((depth, 2 * fp))
    gateup_w[..., :ff], gateup_w[..., fp : fp + ff] = gate_w, up_w
    gateup_b[:, :ff], gateup_b[:, fp : fp + ff] = gate_b, up_b
    out["gateup_w"], out["gateup_b"] = gateup_w, gateup_b
    out["down_w"] = down_w.new_zeros((depth, fp, d))
    out["down_w"][:, :ff] = down_w
    return out


def _take_groups(t: torch.Tensor, index: torch.Tensor, unit: int) -> torch.Tensor:
    """Gather merge groups of `unit` consecutive tokens: (B, S, C) by a
    (B, M) group index -> (B, S, C)."""
    b, s, c = t.shape
    m = s // unit
    idx = index.long()[:, :, None, None].expand(b, m, unit, c)
    return torch.gather(t.reshape(b, m, unit, c), 1, idx).reshape(b, s, c)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) + b (N,) as one GEMM over the 2-D view of x,
    the bias added in the GEMM's epilogue (`torch.addmm` with a 1-D bias)."""
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[-1])


def _plain_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def _mlp(x, xn, lp):
    """x + the block's MLP of xn (x after its norm): on the packed leaves
    two GEMMs with their biases in the epilogue around H12, else the plain
    products."""
    if "gateup_w" in lp:
        return x + _linear(swiglu(_linear(xn, lp["gateup_w"], lp["gateup_b"])), lp["down_w"], lp["down_b"])
    gate = F.silu(xn @ lp["gate_w"] + lp["gate_b"])
    up = xn @ lp["up_w"] + lp["up_b"]
    return x + (gate * up) @ lp["down_w"] + lp["down_b"]


def _block(x, lp, cos, sin, seg, cfg: VisionConfig, windowed: bool):
    """One tower block. The leaves choose the path: `gateup_w` present (the
    packed layout of `pack_vision_blocks`) => every product a GEMM with its
    bias in the epilogue and the SwiGLU one kernel; else the plain products."""
    h, hd = cfg.num_heads, cfg.head_dim
    linear = _linear if "gateup_w" in lp else _plain_linear
    xn = rms_norm(x, lp["norm1_w"], cfg.rms_norm_eps)
    qkv = linear(xn, lp["qkv_w"], lp["qkv_b"])  # (B, S, 3*H*hd), pre-rope
    attn_fn = window_attention_qkv if windowed else fused_vision_attention_qkv
    attn = attn_fn(qkv, cos, sin, seg, h, scale=1.0 / (hd**0.5), rope_dim=hd)
    x = x + linear(attn, lp["proj_w"], lp["proj_b"])
    return _mlp(x, rms_norm(x, lp["norm2_w"], cfg.rms_norm_eps), lp)


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
