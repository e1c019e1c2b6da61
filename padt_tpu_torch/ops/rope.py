"""Rotary position embeddings (port of `padt_tpu/ops/rope.py`): the 2D
vision rope, the 3-stream text M-RoPE, and the fp32 rotate-half rotation.

The inverse-frequency vectors are computed in numpy with the same
expressions as the JAX package, so both sides start from identical tables.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., L, D); cos/sin broadcastable to x. fp32 inside, x's dtype out."""
    xf = x.float()
    out = xf * cos.float() + rotate_half(xf) * sin.float()
    return out.to(x.dtype)


def vision_rope_cos_sin(
    hpos: torch.Tensor, wpos: torch.Tensor, head_dim: int, theta: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> fp32 cos/sin (B, S, head_dim): head_dim//4
    frequencies per axis, [h | w] concatenated, then duplicated."""
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.as_tensor(inv_freq, device=hpos.device)
    fh = hpos.float()[..., None] * inv
    fw = wpos.float()[..., None] * inv
    freqs = torch.cat([fh, fw], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def mrope_cos_sin(
    position_ids: torch.Tensor,  # (3, B, L) t/h/w position streams
    head_dim: int,
    mrope_section: Tuple[int, int, int],
    theta: float = 1_000_000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin (B, L, head_dim); frequency slot k reads the position
    stream that `mrope_section` assigns it (the sections sum to head_dim//2)."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv = torch.as_tensor(inv_freq, device=position_ids.device)
    freqs = position_ids.float()[..., None] * inv  # (3, B, L, half)
    sec = np.zeros((half,), dtype=np.int64)
    start = 0
    for axis, width in enumerate(mrope_section):
        sec[start : start + width] = axis
        start += width
    if start != half:
        raise ValueError("mrope_section must sum to head_dim // 2")
    idx = torch.as_tensor(sec, device=position_ids.device)
    freqs = freqs[idx, :, :, torch.arange(half, device=position_ids.device)]  # (half, B, L)
    freqs = freqs.permute(1, 2, 0)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)
