"""Int8 KV cache (port of `padt_tpu/ops/kv_cache.py`): per-token,
per-kv-head symmetric int8 quantization, the decode / multi-query attention
over the cache and the row stores, in every form the JAX module has.

Cache layout (L, B, Hkv, C, hd) int8 with (L, B, Hkv, C) fp32 scales (with
`layer=`), or one layer of it, (B, Hkv, C, hd) and (B, Hkv, C) (without).
The serve path's forms read the PRE-update stacked cache and take the new
tokens' K/V as `fresh_kv`; the caller then lands every layer's new rows with
one all-layer store after the layer loop. The older forms (no `fresh_kv`:
K13-K18 of ROADMAP.md) read a cache that already holds the new rows and
store one layer at a time. On the card every form goes through the H4 / H5 /
H6 kernels of `cuda_kv` (their wrappers take the plain twins for CPU
tensors); an unstacked cache or a single layer is handed over as a one-layer
view, with no copy.

`quantize_q` (PADT_DECODE_QI8=1, read once at import as the JAX module
does) scores with q quantized to int8 per row: implemented for the
single-token `fresh_kv` form only. Every other form refuses it, as JAX's
does, rather than mix the two score types under one flag.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import cuda_kv

# int8 x int8 score dots, read once at import (kv_cache.py:34 of the JAX package)
_QI8_DEFAULT = os.environ.get("PADT_DECODE_QI8", "0") == "1"
_KV_TILE = 256  # K15 reads whole 256-row tiles; a capacity that is no multiple of it gives K13

_QI8_FRESH_ONLY = (
    "quantize_q (PADT_DECODE_QI8) is only implemented for the fresh_kv decode paths; "
    "this stacked/tiled/plain path would silently run bf16 score dots."
)
_QI8_NOT_MULTI = (
    "quantize_q (PADT_DECODE_QI8) is only implemented for the single-step fresh_kv decode "
    "paths; the multi-query (speculative verify / suffix prefill) kernels run bf16 score dots. "
    "Unset PADT_DECODE_QI8 for engine/spec-decode workloads."
)


def quantize_kv(x: torch.Tensor, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 values, fp32 scales (...,)), per-token symmetric;
    round half to even, as jnp.round. Both outputs are contiguous. `out`
    (int8 values, fp32 scales) receives them instead, with the same bytes:
    `int8_layers` quantizes each layer's new rows into its slice of one
    stacked buffer, so H6 reads every layer's rows with no stacking copy."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if out is None:
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
        return q.contiguous(), scale.contiguous()
    q8, scale = out
    torch.div(torch.clamp(amax, min=1e-8), 127.0, out=scale)
    q8.copy_(torch.clamp(torch.round(xf / scale[..., None]), -127, 127))  # integral values: the cast is exact
    return q8, scale


def empty_scale() -> float:
    """The scale `quantize_kv` gives an all-zero row (padding)."""
    return float(torch.tensor(1e-8, dtype=torch.float32) / 127.0)


def _stack_view(k8, ks, v8, vs, layer):
    """(one-layer or full stacks, layer index): an unstacked cache becomes a
    stack of one at layer 0, as a view."""
    if layer is None:
        return tuple(t.unsqueeze(0) for t in (k8, ks, v8, vs)), 0
    return (k8, ks, v8, vs), int(layer)


def decode_attention_int8(
    q: torch.Tensor,  # (B, 1, H, hd)
    k8: torch.Tensor,  # (B, Hkv, C, hd) int8; (L, B, Hkv, C, hd) with layer=
    ks: torch.Tensor,  # (B, Hkv, C) fp32; (L, B, Hkv, C) with layer=
    v8: torch.Tensor,
    vs: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool (without the current position with fresh_kv)
    n_valid=None,  # int or (B,) int: live length per slot; columns at or past it are never read
    layer=None,  # int or 0-d tensor: read layer `layer` of the full stacks
    fresh_kv=None,  # (k8n (B, Hkv, 1, hd), ksn (B, Hkv, 1), v8n, vsn): the current token; needs layer=
    quantize_q: Optional[bool] = None,  # int8 x int8 scores; default PADT_DECODE_QI8
) -> torch.Tensor:
    """One-step GQA attention over the int8 cache -> (B, 1, H, hd).

    With `fresh_kv` the cache is the pre-update one and the current token is
    composited as an extra softmax column (K6). Without it: K13 (unstacked),
    K14 (`layer=`), and K15 (unstacked with `n_valid`, when C is a multiple
    of 256 as JAX requires; a row with no live key then gives 0 instead of
    the mean of the V rows). As in JAX, `n_valid` is read only in the
    unstacked form."""
    if quantize_q is None:
        quantize_q = _QI8_DEFAULT
    if quantize_q and fresh_kv is None:
        raise NotImplementedError(_QI8_FRESH_ONLY)
    if fresh_kv is not None and layer is None:
        raise ValueError("fresh_kv requires layer= (the stacked cache)")
    b, _, h, hd = q.shape
    (k8, ks, v8, vs), li = _stack_view(k8, ks, v8, vs, layer)
    hkv = k8.shape[2]
    nv = None
    if n_valid is not None and layer is None and k8.shape[3] % _KV_TILE == 0:
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=q.device).reshape(-1).expand(b).contiguous()
    qg = q.reshape(b, hkv, h // hkv, hd).contiguous()  # kv head j serves q heads [jG, (j+1)G)
    fresh = fresh_kv if fresh_kv is not None else (None,) * 4
    out = cuda_kv.int8_decode_attn(qg, k8, ks, v8, vs, *fresh, valid, li, n_valid=nv, quantize_q=bool(quantize_q))
    return out.reshape(b, 1, h, hd)


def decode_attention_int8_multi(
    q: torch.Tensor,  # (B, K, H, hd): K verify / suffix queries
    k8: torch.Tensor,  # (B, Hkv, C, hd) int8; (L, B, Hkv, C, hd) with layer=
    ks: torch.Tensor,
    v8: torch.Tensor,
    vs: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool: with the K new positions, or without them with fresh_kv
    write_pos: torch.Tensor,  # (B,) first new position (unused with fresh_kv, as in JAX)
    layer=None,
    fresh_kv=None,  # (k8n (B, Hkv, K, hd), ksn (B, Hkv, K), v8n, vsn); needs layer=
    quantize_q: Optional[bool] = None,  # refused, also when it comes from PADT_DECODE_QI8
) -> torch.Tensor:
    """K-query attention over the int8 cache -> (B, K, H, hd). With
    `fresh_kv` the cache is the pre-update one and the K new tokens are
    fresh columns, causal inside the block (K8). Without it the cache already
    holds the K new rows and query i sees the valid positions
    <= write_pos + i (K16, unstacked or `layer=`)."""
    if quantize_q is None:
        quantize_q = _QI8_DEFAULT
    if quantize_q:
        raise NotImplementedError(_QI8_NOT_MULTI)
    if fresh_kv is not None and layer is None:
        raise ValueError("fresh_kv requires layer= (the stacked cache)")
    b, kq, h, hd = q.shape
    (k8, ks, v8, vs), li = _stack_view(k8, ks, v8, vs, layer)
    hkv = k8.shape[2]
    g = h // hkv
    # row r = gi*kq + i (head-major): (B, K, H, hd) -> (B, Hkv, G*K, hd)
    qg = q.transpose(1, 2).reshape(b, hkv, g * kq, hd).contiguous()
    if fresh_kv is not None:
        out = cuda_kv.int8_verify_attn(qg, k8, ks, v8, vs, *fresh_kv, valid, li, kq)
    else:
        wp = write_pos.to(device=q.device, dtype=torch.int32).contiguous()
        out = cuda_kv.int8_verify_attn(qg, k8, ks, v8, vs, None, None, None, None, valid, li, kq, write_pos=wp)
    # (B, Hkv, G, K, hd) -> (B, K, Hkv, G, hd) -> (B, K, H, hd)
    return out.reshape(b, hkv, g, kq, hd).permute(0, 3, 1, 2, 4).reshape(b, kq, h, hd)


def _store(k8, ks, v8, vs, rows, pos, n, layer):
    """H6 on a one-layer view: the unstacked cache, or layer `layer`."""
    bufs = (k8, ks, v8, vs) if layer is None else tuple(t[int(layer)] for t in (k8, ks, v8, vs))
    new = tuple(t.unsqueeze(0).contiguous() for t in rows)
    cuda_kv.store_kv_rows(*(t.unsqueeze(0) for t in bufs), *new, pos.to(torch.int32).contiguous(), n)
    return k8, ks, v8, vs


def store_kv_rows(k8, ks, v8, vs, k8n, ksn, v8n, vsn, pos: torch.Tensor, layer=None):
    """IN PLACE (the JAX version returns new arrays): each slot's new row
    (k8n (B, Hkv, 1, hd), ksn (B, Hkv, 1)) lands at row pos[b] of the
    unstacked cache, or of layer `layer` of the full stacks (K17). Positions
    lie inside the capacity, as the callers give them. Returns the updated
    (k8, ks, v8, vs), the tensors passed in."""
    n = torch.ones(pos.shape, dtype=torch.int32, device=pos.device)
    return _store(k8, ks, v8, vs, (k8n, ksn, v8n, vsn), pos, n, layer)


def store_kv_rows_k(k8, ks, v8, vs, k8n, ksn, v8n, vsn, pos: torch.Tensor, layer=None):
    """IN PLACE: K <= 32 consecutive new rows per slot (k8n (B, Hkv, K, hd))
    land at rows pos[b].. of the unstacked cache, or of layer `layer` (K18),
    for pos[b] <= C - K. Returns the updated (k8, ks, v8, vs)."""
    kq = k8n.shape[2]
    if kq > cuda_kv.MAX_STORE_ROWS:
        raise ValueError(f"{kq} rows per slot exceed {cuda_kv.MAX_STORE_ROWS}")
    n = torch.full(pos.shape, kq, dtype=torch.int32, device=pos.device)
    return _store(k8, ks, v8, vs, (k8n, ksn, v8n, vsn), pos, n, layer)


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
