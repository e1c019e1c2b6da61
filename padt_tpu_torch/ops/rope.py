"""Rotary position embeddings (port of `padt_tpu/ops/rope.py`): the 2D
vision rope, the 3-stream text M-RoPE, and the fp32 rotate-half rotation.

The inverse-frequency vectors are computed in numpy with the same
expressions as the JAX package, so both sides start from identical tables.
Each table reaches a device once and is kept there: a copy from the host a
call would wait for the device's queue to drain each time.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """1 / theta^(2i / dim), i < dim / 2, on `device`."""
    return torch.as_tensor(1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)), device=device)


@functools.lru_cache(maxsize=None)
def _mrope_slots(mrope_section: Tuple[int, ...], half: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(position stream of each frequency slot, the slots 0..half-1) on `device`."""
    sec = np.zeros((half,), dtype=np.int64)
    start = 0
    for axis, width in enumerate(mrope_section):
        sec[start : start + width] = axis
        start += width
    if start != half:
        raise ValueError("mrope_section must sum to head_dim // 2")
    return torch.as_tensor(sec, device=device), torch.arange(half, device=device)


def vision_rope_cos_sin(
    hpos: torch.Tensor, wpos: torch.Tensor, head_dim: int, theta: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> fp32 cos/sin (B, S, head_dim): head_dim//4
    frequencies per axis, [h | w] concatenated, then duplicated."""
    inv = _inv_freq(head_dim // 2, theta, hpos.device)
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
    dev = position_ids.device
    idx, slots = _mrope_slots(tuple(mrope_section), head_dim // 2, dev)
    freqs = position_ids.float()[..., None] * _inv_freq(head_dim, theta, dev)  # (3, B, L, half)
    freqs = freqs[idx, :, :, slots]  # (half, B, L)
    freqs = freqs.permute(1, 2, 0)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)
