"""Leaf constructors for random parameter init: the JAX package's
`normal(key, shape, f32) * scale -> dtype`, ones and zeros, drawn from an
explicit `torch.Generator` on the target device. The random values differ
from JAX's (different generators); keys, shapes and dtypes match."""

from __future__ import annotations

import torch


def normal(generator: torch.Generator, shape, device, dtype, scale: float = 0.02) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def ones(shape, device, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), device=device, dtype=dtype)


def zeros(shape, device, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=device, dtype=dtype)
