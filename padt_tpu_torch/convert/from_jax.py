"""Bridge between the JAX parameter tree and the port's.

The port keeps the JAX tree's keys and layouts (stacked (L, in, out)
weights applied as `x @ w`), so the bridge is a plain copy leaf by leaf,
through numpy. bf16 leaves (numpy's `bfloat16` from ml_dtypes, which torch
cannot read) pass through float32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf_to_torch(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))  # a copy torch owns
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device="cpu", dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict with numpy-convertible leaves (e.g. a JAX param tree) ->
    the same keys with torch tensors on `device`; floating leaves are cast to
    `dtype` when it is given."""
    return {
        k: params_from_numpy(v, device, dtype) if isinstance(v, dict) else _leaf_to_torch(v, device, dtype)
        for k, v in tree.items()
    }


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: torch leaves -> numpy (bf16 as float32, exactly)."""
    return {
        k: params_to_numpy(v) if isinstance(v, dict)
        else (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
        for k, v in tree.items()
    }
