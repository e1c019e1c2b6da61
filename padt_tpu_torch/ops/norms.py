"""Normalization ops (port of `padt_tpu/ops/norms.py`): fp32 statistics
inside, the input's dtype outside."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    return weight.to(dtype) * y.to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Standard LayerNorm with the population variance (the prototype
    projection's ZeroInitLayerNorm)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)
