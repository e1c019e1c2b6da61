"""Int8 KV cache (port of `padt_tpu/ops/kv_cache.py`, the forms the serve
path runs): per-token, per-kv-head symmetric int8 quantization, and the
decode / verify attention and row stores over the stacked cache.

Cache layout (L, B, Hkv, C, hd) int8 with (L, B, Hkv, C) fp32 scales. The
attention functions read the PRE-update cache and take the new tokens' K/V
as `fresh_kv`; the caller then lands every layer's new rows with one store
after the layer loop. On the card the three go through the H4 / H5 / H6
kernels of `cuda_kv` (their wrappers take the plain twins for CPU tensors).

Not in this slice: the unstacked and tiled decode forms and the older
multi-query and single-layer store forms (K13-K18 of ROADMAP.md), and the
int8 x int8 score variant (`quantize_q`, PADT_DECODE_QI8 in the JAX
package), which raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_kv

_QI8_LATER = (
    "quantize_q (the int8 x int8 score variant, PADT_DECODE_QI8) is not ported: "
    "it comes with the last group of int8 decode kernels (ROADMAP.md, K13-K16)"
)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 values, fp32 scales (...,)), per-token symmetric;
    round half to even, as jnp.round. Both outputs are contiguous."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q.contiguous(), scale.contiguous()


def empty_scale() -> float:
    """The scale `quantize_kv` gives an all-zero row (padding)."""
    return float(torch.tensor(1e-8, dtype=torch.float32) / 127.0)


def decode_attention_int8(
    q: torch.Tensor,  # (B, 1, H, hd)
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, pre-update
    ks: torch.Tensor,  # (L, B, Hkv, C) fp32
    v8: torch.Tensor,
    vs: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool, without the current position
    *,
    layer: int,
    fresh_kv,  # (k8n (B, Hkv, 1, hd), ksn (B, Hkv, 1), v8n, vsn): the current token
    quantize_q: bool = False,
) -> torch.Tensor:
    """One-step GQA attention over layer `layer` of the int8 cache with the
    current token composited as an extra softmax column -> (B, 1, H, hd).
    The JAX forms without `layer` / `fresh_kv` are K13-K16 of ROADMAP.md."""
    if quantize_q:
        raise NotImplementedError(_QI8_LATER)
    b, _, h, hd = q.shape
    hkv = k8.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)  # kv head j serves q heads [jG, (j+1)G)
    k8n, ksn, v8n, vsn = fresh_kv
    out = cuda_kv.int8_decode_attn(qg.contiguous(), k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, int(layer))
    return out.reshape(b, 1, h, hd)


def decode_attention_int8_multi(
    q: torch.Tensor,  # (B, K, H, hd): K verify / suffix queries
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, pre-update
    ks: torch.Tensor,
    v8: torch.Tensor,
    vs: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool, without the K new positions
    write_pos: torch.Tensor,  # (B,) first new position (unused with fresh_kv, as in JAX)
    *,
    layer: int,
    fresh_kv,  # (k8n (B, Hkv, K, hd), ksn (B, Hkv, K), v8n, vsn)
    quantize_q: bool = False,
) -> torch.Tensor:
    """K-query attention over layer `layer` of the int8 cache plus the K
    new tokens as fresh columns, causal inside the block -> (B, K, H, hd)."""
    if quantize_q:
        raise NotImplementedError(_QI8_LATER)
    b, kq, h, hd = q.shape
    hkv = k8.shape[2]
    g = h // hkv
    # row r = gi*kq + i (head-major): (B, K, H, hd) -> (B, Hkv, G*K, hd)
    qg = q.transpose(1, 2).reshape(b, hkv, g * kq, hd).contiguous()
    k8n, ksn, v8n, vsn = fresh_kv
    out = cuda_kv.int8_verify_attn(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, int(layer), kq)
    # (B, Hkv, G, K, hd) -> (B, K, Hkv, G, hd) -> (B, K, H, hd)
    return out.reshape(b, hkv, g, kq, hd).permute(0, 3, 1, 2, 4).reshape(b, kq, h, hd)


def store_kv_rows_all_layers(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos: torch.Tensor):
    """IN PLACE (the JAX version returns new arrays): each slot's one new row
    (k8r (L, B, Hkv, 1, hd), ksr (L, B, Hkv, 1)) lands at row pos[b] of every
    layer. Returns the updated (k8, ks, v8, vs)."""
    n = torch.ones_like(pos, dtype=torch.int32)
    cuda_kv.store_kv_rows(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos.to(torch.int32).contiguous(), n)
    return k8, ks, v8, vs


def store_kv_rows_k_all_layers(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos: torch.Tensor, n_rows: Optional[torch.Tensor] = None):
    """IN PLACE: K consecutive rows per slot (k8r (L, B, Hkv, K, hd)) land at
    rows pos[b].. of every layer; only the first n_rows[b] of them (default
    K) are written, so a slot with n_rows 0 keeps every byte. Returns the
    updated (k8, ks, v8, vs)."""
    kq = k8r.shape[3]
    if kq > cuda_kv.MAX_STORE_ROWS:
        raise ValueError(f"{kq} rows per slot exceed {cuda_kv.MAX_STORE_ROWS}")
    n = torch.full_like(pos, kq, dtype=torch.int32) if n_rows is None else n_rows.to(torch.int32).contiguous()
    cuda_kv.store_kv_rows(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos.to(torch.int32).contiguous(), n)
    return k8, ks, v8, vs
