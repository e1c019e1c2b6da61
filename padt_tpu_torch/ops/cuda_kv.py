"""The int8 KV cache's Hopper kernels, their wrappers, and their plain twins.

| wrapper            | CUDA source       | replaces (padt_tpu/ops/kv_cache.py)                                  |
|--------------------|-------------------|----------------------------------------------------------------------|
| `int8_decode_attn` | csrc/int8_kv.cu   | `_decode_kernel_stacked_fresh` :206, `_decode_kernel_stacked_fresh_bb` :288 |
| `int8_verify_attn` | csrc/int8_kv.cu   | `_decode_kernel_multi_stacked_fresh` :402                            |
| `store_kv_rows`    | csrc/int8_kv.cu   | `_store_rows_kernel_all_layers` :750, `_store_rows_k_kernel_all_layers` :856 |

Layout (the JAX package's): k8/v8 (L, B, Hkv, C, hd) int8, ks/vs
(L, B, Hkv, C) fp32 per-token scales, valid (B, C) bool.

Each wrapper takes the plain PyTorch twin beside it (`*_plain`) for tensors
on the CPU and only there: on a CUDA tensor it launches its kernel or raises.
The twins are the plain branches of the JAX functions
(`decode_attention_int8` :1601-1643, `decode_attention_int8_multi`
:1426-1451, `store_kv_rows_k_all_layers` :924-939) with their bf16
roundings in the same places; they return the query's dtype.
"""

from __future__ import annotations

import torch

from ._build import check, load_library
from .attention import NEG_INF
from .cuda_attention import _on_cpu, _require, _same_device, _stream

KV_HEAD_DIMS = (16, 32, 64, 128, 256)  # head dims the attention kernel is built for
MAX_STORE_ROWS = 32  # rows per slot that one store writes (the suffix pass width)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper

launch_counts = {"int8_decode_attn": 0, "int8_verify_attn": 0, "store_kv_rows": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_cache(name, k8, ks, v8, vs, valid, layer: int):
    """Shape, dtype and layout checks shared by the attention wrappers;
    returns (L, B, Hkv, C, hd)."""
    _require(name, k8.dim() == 5 and v8.shape == k8.shape, f"k8/v8 shapes {tuple(k8.shape)} {tuple(v8.shape)}")
    nl, b, hkv, c, hd = k8.shape
    _require(name, k8.dtype == torch.int8 and v8.dtype == torch.int8, "k8/v8 must be int8")
    _require(name, ks.dtype == torch.float32 and vs.dtype == torch.float32, "ks/vs must be fp32")
    _require(name, ks.shape == (nl, b, hkv, c) and vs.shape == ks.shape, f"ks/vs shapes {tuple(ks.shape)}")
    _require(name, valid.dtype == torch.bool and valid.shape == (b, c), f"valid must be bool (B, C), got {valid.dtype} {tuple(valid.shape)}")
    _require(name, hd in KV_HEAD_DIMS, f"head dim {hd} not in {KV_HEAD_DIMS}")
    _require(name, 0 <= layer < nl, f"layer {layer} out of range [0, {nl})")
    for t in (k8, ks, v8, vs, valid):
        _require(name, t.is_contiguous() and t.data_ptr() % 16 == 0, "cache tensors must be contiguous and 16-byte aligned")
    return nl, b, hkv, c, hd


def _check_fresh(name, fresh, b, hkv, kq, hd):
    k8n, ksn, v8n, vsn = fresh
    for t8, ts in ((k8n, ksn), (v8n, vsn)):
        _require(name, t8.dtype == torch.int8 and t8.shape == (b, hkv, kq, hd), f"fresh rows must be int8 {(b, hkv, kq, hd)}, got {t8.dtype} {tuple(t8.shape)}")
        _require(name, ts.dtype == torch.float32 and ts.shape == (b, hkv, kq), f"fresh scales must be fp32 {(b, hkv, kq)}")
        _require(name, t8.is_contiguous() and ts.is_contiguous(), "fresh rows and scales must be contiguous")


_ATTN_ROWS = 8  # query rows per CTA of the attention kernel
_FILL_CTAS = 264  # two CTAs per SM of an H100 (132 SMs)


def _column_split(b: int, hkv: int, rows: int) -> int:
    """CTAs per cluster over the cache columns: doubled from 1 up to 8 while
    the grid has fewer than two CTAs per SM (decode: G = 8 rows per slot and
    kv head; a suffix pass has 32x the rows and keeps 1)."""
    ctas, split = b * hkv * -(-rows // _ATTN_ROWS), 1
    while split < 8 and ctas * split < _FILL_CTAS:
        split *= 2
    return split


def _attn_smem_bytes(c: int, kq: int, hd: int, split: int) -> int:
    """Shared memory of one CTA (`attn_smem_floats` in csrc/int8_kv.cu)."""
    rows, groups, chunk = _ATTN_ROWS, 128 // (hd // 4), -(-c // split)
    return 4 * (rows * hd + rows * (chunk + kq) + groups * rows * hd + rows * hd + 2 * rows)


# ---------------------------------------------------------------------------
# H4 int8_decode_attn
# ---------------------------------------------------------------------------

def int8_decode_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer: int):
    k8l, ksl, v8l, vsl = k8[layer], ks[layer], v8[layer], vs[layer]
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    qb = qg.to(torch.bfloat16).float()
    scores = torch.einsum("bkgd,bkcd->bkgc", qb, k8l.float()) * (ksl * scale)[:, :, None, :]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    s_f = torch.einsum("bkgd,bkrd->bkgr", qb, k8n.float()) * (ksn * scale)[:, :, None, :]  # (B, Hkv, G, 1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_f)
    p = torch.exp(scores - m)
    p_f = torch.exp(s_f - m)
    denom = p.sum(dim=-1, keepdim=True) + p_f
    pv = (p / denom * vsl[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkgc,bkcd->bkgd", pv, v8l.float())
    out = out + (p_f / denom) * (v8n.float() * vsn[:, :, :, None])
    return out.to(qg.dtype)


def int8_decode_attn(
    qg: torch.Tensor,  # (B, Hkv, G, hd): kv head j serves q heads [jG, (j+1)G)
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, pre-update
    ks: torch.Tensor,  # (L, B, Hkv, C) fp32
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8n: torch.Tensor,  # (B, Hkv, 1, hd) int8: the current token's K
    ksn: torch.Tensor,  # (B, Hkv, 1) fp32
    v8n: torch.Tensor,
    vsn: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool, without the current position
    layer: int,
) -> torch.Tensor:
    """One-token GQA attention over layer `layer` of the int8 cache, the
    current token's K/V composited as one extra softmax column ->
    (B, Hkv, G, hd) contiguous."""
    name = "int8_decode_attn"
    if _on_cpu(qg, name):
        return int8_decode_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer)
    _same_device(name, qg.device, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid)
    nl, b, hkv, c, hd = _check_cache(name, k8, ks, v8, vs, valid, layer)
    _require(name, qg.dtype == torch.bfloat16 and qg.dim() == 4 and qg.shape[:2] == (b, hkv) and qg.shape[3] == hd,
             f"q must be bf16 (B, Hkv, G, hd), got {qg.dtype} {tuple(qg.shape)}")
    _require(name, qg.is_contiguous(), "q must be contiguous")
    g = qg.shape[2]
    _check_fresh(name, (k8n, ksn, v8n, vsn), b, hkv, 1, hd)
    split = _column_split(b, hkv, g)
    _require(name, _attn_smem_bytes(c, 1, hd, split) <= _SMEM_LIMIT, f"capacity {c} needs more shared memory than a block has")
    out = torch.empty_like(qg)
    lib = load_library()
    rc = lib.padt_int8_decode_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        k8n.data_ptr(), ksn.data_ptr(), v8n.data_ptr(), vsn.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, hkv, g, c, hd, int(layer), split, hd**-0.5, _stream(qg),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# H5 int8_verify_attn
# ---------------------------------------------------------------------------

def int8_verify_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer: int, kq: int):
    k8l, ksl, v8l, vsl = k8[layer], ks[layer], v8[layer], vs[layer]
    rows = qg.shape[2]
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    scores = torch.einsum("bkrd,bkcd->bkrc", qg.to(torch.bfloat16).float(), k8l.float()) * (ksl * scale)[:, :, None, :]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    s_f = torch.einsum("bkrd,bkjd->bkrj", qg.float(), k8n.float()) * (ksn * scale)[:, :, None, :]  # (B, Hkv, R, kq)
    row_i = (torch.arange(rows, device=qg.device) % kq)[:, None]
    s_f = torch.where(row_i >= torch.arange(kq, device=qg.device)[None, :], s_f, NEG_INF)
    full = torch.cat([scores, s_f], dim=-1)
    p = torch.exp(full - full.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    c = scores.shape[-1]
    p_c, p_f = probs[..., :c], probs[..., c:]
    # unlike H4, the fresh probabilities round through bf16 like the cache's
    out = torch.einsum("bkrc,bkcd->bkrd", (p_c * vsl[:, :, None, :]).to(torch.bfloat16).float(), v8l.float())
    out = out + torch.einsum("bkrj,bkjd->bkrd", (p_f * vsn[:, :, None, :]).to(torch.bfloat16).float(), v8n.float())
    return out.to(qg.dtype)


def int8_verify_attn(
    qg: torch.Tensor,  # (B, Hkv, G*kq, hd), rows head-major: r = gi*kq + i
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, pre-update
    ks: torch.Tensor,
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8n: torch.Tensor,  # (B, Hkv, kq, hd) int8: the kq new tokens' K
    ksn: torch.Tensor,  # (B, Hkv, kq) fp32
    v8n: torch.Tensor,
    vsn: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool, without the kq new positions
    layer: int,
    kq: int,
) -> torch.Tensor:
    """kq-query int8 attention over layer `layer` of the cache plus kq fresh
    columns; query row r sees fresh column j iff r % kq >= j ->
    (B, Hkv, G*kq, hd) contiguous."""
    name = "int8_verify_attn"
    if _on_cpu(qg, name):
        return int8_verify_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer, kq)
    _same_device(name, qg.device, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid)
    nl, b, hkv, c, hd = _check_cache(name, k8, ks, v8, vs, valid, layer)
    _require(name, qg.dtype == torch.bfloat16 and qg.dim() == 4 and qg.shape[:2] == (b, hkv) and qg.shape[3] == hd,
             f"q must be bf16 (B, Hkv, G*kq, hd), got {qg.dtype} {tuple(qg.shape)}")
    _require(name, qg.is_contiguous(), "q must be contiguous")
    rows = qg.shape[2]
    _require(name, kq >= 1 and rows % kq == 0, f"{rows} query rows are not a multiple of kq={kq}")
    _check_fresh(name, (k8n, ksn, v8n, vsn), b, hkv, kq, hd)
    split = _column_split(b, hkv, rows)
    _require(name, _attn_smem_bytes(c, kq, hd, split) <= _SMEM_LIMIT, f"capacity {c} needs more shared memory than a block has")
    out = torch.empty_like(qg)
    lib = load_library()
    rc = lib.padt_int8_verify_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        k8n.data_ptr(), ksn.data_ptr(), v8n.data_ptr(), vsn.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, hkv, rows, kq, c, hd, int(layer), split, hd**-0.5, _stream(qg),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# H6 store_kv_rows
# ---------------------------------------------------------------------------

def _put_rows(buf, new, j: int, rows, keep):
    """buf[:, b, :, rows[b]] = new[:, b, :, j] where keep[b] (all layers)."""
    bi = torch.arange(buf.shape[1], device=buf.device)
    ri = rows.clamp(0, buf.shape[3] - 1)
    cur = buf[:, bi, :, ri]  # advanced indices first: (B, L, Hkv[, hd])
    nj = new[:, :, :, j].transpose(0, 1)
    m = keep.view(-1, *([1] * (cur.dim() - 1)))
    buf[:, bi, :, ri] = torch.where(m, nj, cur)


def store_kv_rows_plain(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows):
    c = k8.shape[3]
    for j in range(k8r.shape[3]):
        rows = pos.long() + j
        keep = (j < n_rows) & (rows >= 0) & (rows < c)
        for buf, new in ((k8, k8r), (ks, ksr), (v8, v8r), (vs, vsr)):
            _put_rows(buf, new, j, rows, keep)


def store_kv_rows(
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, written in place
    ks: torch.Tensor,  # (L, B, Hkv, C) fp32, written in place
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8r: torch.Tensor,  # (L, B, Hkv, kq, hd) int8: every layer's new rows
    ksr: torch.Tensor,  # (L, B, Hkv, kq) fp32
    v8r: torch.Tensor,
    vsr: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32: first row position per slot
    n_rows: torch.Tensor,  # (B,) int32: rows to write per slot (<= kq)
) -> None:
    """IN PLACE: rows j < n_rows[b] of every layer's new K/V and scales land
    at cache rows pos[b] + j. Rows at or past n_rows[b], and rows whose
    position falls outside [0, C), are never written: the caller clamps its
    positions so that the rows it means to write fit."""
    name = "store_kv_rows"
    if _on_cpu(k8, name):
        return store_kv_rows_plain(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows)
    _same_device(name, k8.device, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows)
    _require(name, k8.dim() == 5 and v8.shape == k8.shape, f"k8/v8 shapes {tuple(k8.shape)} {tuple(v8.shape)}")
    nl, b, hkv, c, hd = k8.shape
    kq = k8r.shape[3] if k8r.dim() == 5 else -1
    _require(name, k8.dtype == torch.int8 and v8.dtype == torch.int8, "k8/v8 must be int8")
    _require(name, k8r.dtype == torch.int8 and v8r.dtype == torch.int8, "k8r/v8r must be int8")
    _require(name, k8r.shape == (nl, b, hkv, kq, hd) and v8r.shape == k8r.shape, f"new rows shape {tuple(k8r.shape)}")
    _require(name, 1 <= kq <= MAX_STORE_ROWS, f"{kq} rows per slot (at most {MAX_STORE_ROWS})")
    _require(name, hd % 16 == 0, f"head dim {hd} is not a multiple of 16")
    for t, shape in ((ks, (nl, b, hkv, c)), (vs, (nl, b, hkv, c)), (ksr, (nl, b, hkv, kq)), (vsr, (nl, b, hkv, kq))):
        _require(name, t.dtype == torch.float32 and t.shape == shape, f"scales must be fp32 {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (pos, n_rows):
        _require(name, t.dtype == torch.int32 and t.shape == (b,), "pos/n_rows must be int32 (B,)")
    for t in (k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows):
        _require(name, t.is_contiguous() and t.data_ptr() % 16 == 0, "tensors must be contiguous and 16-byte aligned")
    lib = load_library()
    rc = lib.padt_store_kv_rows(
        k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        k8r.data_ptr(), ksr.data_ptr(), v8r.data_ptr(), vsr.data_ptr(),
        pos.data_ptr(), n_rows.data_ptr(), nl, b, hkv, c, kq, hd, _stream(k8),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
